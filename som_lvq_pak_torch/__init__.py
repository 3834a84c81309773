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
  models/   SOMTrainer (single device), randinit, find_qerror (fast)
  convert   Datasets and device tensors; as_port_dataset

Entry points run on "cuda" unless the caller asks for "cpu".  A CPU tensor
runs the plain versions; a CUDA tensor runs the kernels.
"""

__version__ = "0.1.0"
