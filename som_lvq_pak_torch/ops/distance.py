"""Batched squared distances and 1-NN winners in plain PyTorch — the
counterparts of som_lvq_pak_tpu/ops/distance.py (unmasked), and the
reference the winner kernels are held against.

    D[b, n] = ||x_b||^2 - 2 x_b . m_n + ||m_n||^2

Matrix products run in full float32: `fp32_matmul()` turns TF32 off, which
the expanded form needs (it cancels catastrophically for near-winners).
"""

from __future__ import annotations

from typing import Tuple

import torch


def fp32_matmul() -> None:
    """Pin float32 matmuls and convolutions to full float32 (no TF32) on
    CUDA; the plain references are only meaningful at that precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sq_distances(x: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(B, N) squared euclidean distances."""
    fp32_matmul()
    x2 = (x * x).sum(-1, keepdim=True)
    c2 = (codes * codes).sum(-1)[None, :]
    return x2 - 2.0 * (x @ codes.T) + c2


def find_winners(x: torch.Tensor, codes: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched 1-NN: (indices (B,), sq-dists (B,)); ties go to the lowest
    index (torch.argmin returns the first minimum)."""
    d = sq_distances(x, codes)
    idx = torch.argmin(d, dim=-1)
    return idx, d.gather(1, idx[:, None])[:, 0]
