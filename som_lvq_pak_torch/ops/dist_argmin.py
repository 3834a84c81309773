"""Fused 1-NN winner search: kernels K1 (`dist_argmin`) and K2
(`dist_argmin_t`), counterparts of som_lvq_pak_tpu/ops/pallas_distance.py.

Both return (sq_dists (B,) float32, indices (B,) int32): the kernel's
partial distance plus ||x||^2, clamped at 0.  Ties go to the lowest index.

* `dist_argmin` scores ||m||^2 - 2 x.m with a strict-< running min
  (replaces `_dist_argmin_kernel`); the trainer's prologue winner.
* `dist_argmin_t` scores x.m - ||m||^2 / 2 with a strict-> running max and
  reports -2 * best (replaces `_dist_argmin_t_kernel`); the fast qerror's
  winner search.  The two forms round differently, so near-tie winners may
  differ between them, as they do in the JAX package.

A CUDA tensor launches the kernel in `csrc/dist_argmin.cu`; a CPU tensor
runs the plain version beside it.  Any other device raises.  Each wrapper
counts its kernel launches in its `launches` attribute.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .distance import fp32_matmul


def _rows_per_chunk(n: int) -> int:
    # keep each (rows, N) score block of the plain versions near 1 GiB
    return max(1, (1 << 28) // max(1, n))


def _check(x: torch.Tensor, codes: torch.Tensor) -> str:
    if x.dim() != 2 or codes.dim() != 2 or x.shape[1] != codes.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and codes {tuple(codes.shape)} "
                         "must be (B, D) and (N, D)")
    if x.dtype != torch.float32 or codes.dtype != torch.float32:
        raise TypeError("x and codes must be float32")
    if x.device != codes.device:
        raise ValueError(f"x on {x.device}, codes on {codes.device}")
    if codes.shape[0] == 0:
        raise ValueError("empty codebook")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def dist_argmin_plain(x: torch.Tensor, codes: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K1: argmin of ||m||^2 - 2 x.m, first index on ties."""
    fp32_matmul()
    m2 = (codes * codes).sum(-1)
    vals, idxs = [], []
    step = _rows_per_chunk(codes.shape[0])
    for s in range(0, x.shape[0], step):
        xc = x[s:s + step]
        d = m2[None, :] - 2.0 * (xc @ codes.T)
        i = torch.argmin(d, dim=1)
        x2 = (xc * xc).sum(-1)
        vals.append(torch.clamp(d.gather(1, i[:, None])[:, 0] + x2, min=0.0))
        idxs.append(i.to(torch.int32))
    return torch.cat(vals), torch.cat(idxs)


def dist_argmin_t_plain(x: torch.Tensor, codes: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K2: argmax of x.m - ||m||^2 / 2, first index on ties."""
    fp32_matmul()
    m2h = 0.5 * (codes * codes).sum(-1)
    vals, idxs = [], []
    step = _rows_per_chunk(codes.shape[0])
    for s in range(0, x.shape[0], step):
        xc = x[s:s + step]
        sc = (xc @ codes.T) - m2h[None, :]
        i = torch.argmax(sc, dim=1)
        x2 = (xc * xc).sum(-1)
        vals.append(torch.clamp(-2.0 * sc.gather(1, i[:, None])[:, 0] + x2,
                                min=0.0))
        idxs.append(i.to(torch.int32))
    return torch.cat(vals), torch.cat(idxs)


def _launch(entry: str, wrapper, x: torch.Tensor, codes: torch.Tensor):
    x = x.contiguous()
    codes = codes.contiguous()
    B, D = x.shape
    N = codes.shape[0]
    val = torch.empty((B,), dtype=torch.float32, device=x.device)
    idx = torch.empty((B,), dtype=torch.int32, device=x.device)
    if B == 0:
        return val, idx
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.call(entry, x.data_ptr(), codes.data_ptr(), B, N, D,
                val.data_ptr(), idx.data_ptr(), stream)
    wrapper.launches += 1
    # the kernel returns the partial distance; add ||x||^2 here
    return torch.clamp(val + (x * x).sum(-1), min=0.0), idx


def dist_argmin(x: torch.Tensor, codes: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN winners of x (B, D) in codes (N, D): (sq_dists, int32 idx)."""
    if _check(x, codes) == "cpu":
        return dist_argmin_plain(x, codes)
    return _launch("somvq_dist_argmin", dist_argmin, x, codes)


def dist_argmin_t(x: torch.Tensor, codes: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN winners in the max-score form: (sq_dists, int32 idx)."""
    if _check(x, codes) == "cpu":
        return dist_argmin_t_plain(x, codes)
    return _launch("somvq_dist_argmin_t", dist_argmin_t, x, codes)


dist_argmin.launches = 0
dist_argmin_t.launches = 0
