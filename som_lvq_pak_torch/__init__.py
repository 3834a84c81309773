"""som_lvq_pak_torch — the PyTorch/CUDA port of som_lvq_pak_tpu.

The JAX package is the reference; this package grows beside it, slice by
slice.  It imports torch and never jax: the host modules it shares with
the JAX package (config, data, utils) load without jax.

Layers (mirroring the JAX package):
  ops/      winner search and the fused SOM step: hand-written CUDA kernels
            (csrc/, built on first use by _build) with plain-PyTorch twins
  models/   SOMTrainer (single device), randinit, find_qerror (fast)
  convert   codebooks between host Datasets and device tensors

A CPU tensor runs the plain versions; a CUDA tensor runs the kernels.
"""

__version__ = "0.1.0"
