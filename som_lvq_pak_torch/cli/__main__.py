"""`python -m som_lvq_pak_torch.cli <tool> [flags...]` (som_lvq_pak_tpu/cli/__main__.py)."""

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main())
