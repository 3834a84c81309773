"""som_lvq_pak_torch — the PyTorch/CUDA port of som_lvq_pak_tpu.

The JAX package is the reference; this package grows beside it, slice by
slice.  It imports torch, never jax, and nothing of the JAX package: it
keeps its own copies of the host modules it needs.

Layers (mirroring the JAX package):
  config, data/, utils/  host side: the SOM_PAK file format, Dataset,
            StreamingReader, CRandom, checkpoints (copies, held equal to
            the JAX package's by tests)
  ops/      winner search, the fused SOM step, the two-kernel update and
            the K-steps-per-launch group: hand-written CUDA kernels (csrc/,
            built on first use by _build) with plain-PyTorch twins
  models/   the SOM and LVQ trainers, initialisers and evaluators, the
            U-matrix and the Sammon projection
  viz/      the EPS/PS writers of sammon, planes and umat (host text)
  cli/      `somvq-torch <tool>`: every reference program, the parity
            tools byte for byte with the JAX CLI, `-fast` on the card
  convert   Datasets and device tensors; as_port_dataset

Entry points run on "cuda" unless the caller asks for "cpu".  A CPU tensor
runs the plain versions; a CUDA tensor runs the kernels.
"""

__version__ = "0.1.0"

# Version string parity: reference version.c:5-11 reports
# "SOM/LVQ_PAK library version 3.2alpha".
REFERENCE_VERSION = "3.2alpha"


def get_version() -> str:
    """Framework version string (reference: version.c:5-11;
    som_lvq_pak_tpu/__init__.py:20-27), naming this package."""
    return f"som_lvq_pak_torch {__version__} (capability parity with SOM/LVQ_PAK {REFERENCE_VERSION})"
