"""Batched squared distances and 1-NN winners in plain PyTorch — the
counterparts of som_lvq_pak_tpu/ops/distance.py:sq_distances and
find_winners, and the reference the winner kernels are held against.

    D[b, n] = ||x_b||^2 - 2 x_b . m_n + ||m_n||^2

With a mask (B, D), nonzero = component masked off (the reference's 'x'
entries, lvq_pak.c:63-72), masked components are zeroed in x and the
||m||^2 term becomes keep @ (M o M)^T, so they are left out of the distance.
A sample with every component masked scores 0 against every code.

Matrix products run in full float32: `fp32_matmul()` turns TF32 off, which
the expanded form needs (it cancels catastrophically for near-winners).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def fp32_matmul() -> None:
    """Pin float32 matmuls and convolutions to full float32 (no TF32) on
    CUDA; the plain references are only meaningful at that precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def keep_of(mask: torch.Tensor) -> torch.Tensor:
    """Float32 keep flags of a mask (nonzero = masked): 1 where a
    component takes part, 0 where it is masked."""
    return (mask == 0).to(torch.float32)


def mask_bytes(mask: torch.Tensor) -> torch.Tensor:
    """A mask as the contiguous uint8 array the kernels read (nonzero =
    masked)."""
    return (mask if mask.dtype == torch.uint8 else mask != 0).to(torch.uint8).contiguous()


def sq_distances(x: torch.Tensor, codes: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N) squared euclidean distances over unmasked components."""
    fp32_matmul()
    if mask is None:
        x2 = (x * x).sum(-1, keepdim=True)
        c2 = (codes * codes).sum(-1)[None, :]
        return x2 - 2.0 * (x @ codes.T) + c2
    keep = keep_of(mask)
    xk = x * keep
    x2 = (xk * xk).sum(-1, keepdim=True)
    return x2 - 2.0 * (xk @ codes.T) + keep @ (codes * codes).T


def find_winners(x: torch.Tensor, codes: torch.Tensor,
                 mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched 1-NN: (indices (B,), sq-dists (B,)); ties go to the lowest
    index (torch.argmin returns the first minimum)."""
    d = sq_distances(x, codes, mask)
    idx = torch.argmin(d, dim=-1)
    return idx, d.gather(1, idx[:, None])[:, 0]


def topk_winners(x: torch.Tensor, codes: torch.Tensor, k: int,
                 mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched k-NN: (indices (B, k), sq-dists (B, k)) by ascending
    distance, equal distances lowest index first, as `lax.top_k` orders them
    (the JAX package's reference_ties=False).  Built from k first-minimum
    `argmin`s, each pick masked out with +inf: `torch.topk` promises no
    order among equal values."""
    if not 1 <= k <= codes.shape[0]:
        raise ValueError(f"k = {k} needs 1 <= k <= {codes.shape[0]} codes")
    d = sq_distances(x, codes, mask)
    work = d.clone()
    idx = torch.empty((x.shape[0], k), dtype=torch.int64, device=x.device)
    for j in range(k):
        idx[:, j] = torch.argmin(work, dim=-1)
        work.scatter_(1, idx[:, j:j + 1], float("inf"))
    return idx, d.gather(1, idx)
