"""Framework configuration (reference: config.h, lvq_pak.c:618-661).

The port's copy of som_lvq_pak_tpu/config.py; tests hold the two equal.

Three tiers, mirroring the reference:
  * module defaults (this file; reference compile-time config.h)
  * environment variables  LVQSOM_MASK_STR, LVQSOM_COMPRESS_COMMAND,
    LVQSOM_UNCOMPRESS_COMMAND (reference lvq_pak.c:625-653)
  * per-call overrides (CLI flags -mask_str / -compress_cmd)
"""

from __future__ import annotations

import os

# String that marks a masked/missing vector component in data files
# (reference datafile.h:33-35, config.h:28-35).
DEFAULT_MASKED_VALUE = "x"

# Tokens are split on these (reference datafile.h:40-43). "\n" terminates.
SEPARATOR_CHARS = " \r\t"

# Compression commands (reference config.h:45-50). We use Python's gzip
# module for .gz; these are retained for the pipe-based escape hatch.
DEFAULT_COMPRESS_COMMAND = "gzip -9 -c >%s"
DEFAULT_UNCOMPRESS_COMMAND = "gzip -d -c %s"

# INV_ALPHA_CONSTANT for the inverse-t learning-rate schedule
# (reference lvq_pak.c:908-910).
INV_ALPHA_CONSTANT = 100.0


def masked_string() -> str:
    """Current masked-component marker (env override like lvq_pak.c:647-649)."""
    return os.environ.get("LVQSOM_MASK_STR", DEFAULT_MASKED_VALUE)


def compress_command() -> str:
    return os.environ.get("LVQSOM_COMPRESS_COMMAND", DEFAULT_COMPRESS_COMMAND)


def uncompress_command() -> str:
    return os.environ.get("LVQSOM_UNCOMPRESS_COMMAND", DEFAULT_UNCOMPRESS_COMMAND)
