"""Fused 1-NN winner search: kernels K1 (`dist_argmin`), K2
(`dist_argmin_t`) and K4 (`dist_argmin_masked`), counterparts of
som_lvq_pak_tpu/ops/pallas_distance.py.

All return (sq_dists (B,) float32, indices (B,) int32): the kernel's
partial distance plus ||x||^2, clamped at 0.  Ties go to the lowest index.

* `dist_argmin` scores ||m||^2 - 2 x.m with a strict-< running min
  (replaces `_dist_argmin_kernel`); the trainer's prologue winner, the LVQ
  steps' and every sharded winner search's.  Given a `mask` it runs
  `dist_argmin_masked`.
* `dist_argmin_t` scores x.m - ||m||^2 / 2 with a strict-> running max and
  reports -2 * best (replaces `_dist_argmin_t_kernel`); the fast qerror's
  winner search.
* K1 and K2 run one kernel body on the tensor cores
  (`csrc/dist_argmin_t.cu`): split-TF32 products (float32 accuracy), the
  codebook split across CTAs in whole waves of 128-sample CTAs
  (`k2_splits`).  Halving and doubling are exact, so
  -2 fl(x.m - ||m||^2 / 2) = fl(||m||^2 - 2 x.m): the two return the same
  values and winners bit for bit, on the card and in their plain versions
  alike.  The JAX package's two forms differ (its K1 takes an XLA-computed
  ||m||^2), so near-tie winners may differ from its `dist_argmin`.
* `dist_argmin_masked` scores keep.(m o m) - 2 (x keep).m, where `mask`
  (B, D) is nonzero on masked components (replaces
  `_dist_argmin_masked_kernel`); ||x keep||^2 is added back, so a sample
  with every component masked gets index 0 and value 0.  The masked
  training step's and the masked qerror's winner search.  Its kernel (K4,
  `csrc/dist_argmin.cu`) runs K1's CTA shape on the tensor cores: (x keep).m
  by three split-TF32 products, keep.(m o m) by two (keep is exact in
  TF32), the codebook split by `k4_splits`.  Two runs are bit-equal.

A CUDA tensor launches the kernel; a CPU tensor runs the plain version
beside it.  Any other device raises.  Each wrapper counts its kernel
launches in its `launches` attribute.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from .distance import fp32_matmul, keep_of, mask_bytes


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


def _check_mask(x: torch.Tensor, mask: torch.Tensor) -> None:
    if mask.shape != x.shape:
        raise ValueError(f"mask {tuple(mask.shape)} must match x {tuple(x.shape)}")
    if mask.device != x.device:
        raise ValueError(f"x on {x.device}, mask on {mask.device}")


def dist_argmin_masked_plain(x: torch.Tensor, codes: torch.Tensor,
                             mask: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K4: argmin of keep.(m o m) - 2 (x keep).m, first index on
    ties."""
    fp32_matmul()
    keep = keep_of(mask)
    xk = x * keep
    mm = codes * codes
    vals, idxs = [], []
    step = _rows_per_chunk(codes.shape[0])
    for s in range(0, x.shape[0], step):
        xc, kc = xk[s:s + step], keep[s:s + step]
        d = kc @ mm.T - 2.0 * (xc @ codes.T)
        i = torch.argmin(d, dim=1)
        x2 = (xc * xc).sum(-1)
        vals.append(torch.clamp(d.gather(1, i[:, None])[:, 0] + x2, min=0.0))
        idxs.append(i.to(torch.int32))
    return torch.cat(vals), torch.cat(idxs)


def dist_argmin_plain(x: torch.Tensor, codes: torch.Tensor,
                      mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K1 (K4 given a mask): argmin of ||m||^2 - 2 x.m, first index
    on ties."""
    if mask is not None:
        return dist_argmin_masked_plain(x, codes, mask)
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


def k2_splits(B: int, N: int, device: torch.device) -> int:
    """K1's and K2's codebook splits (K8's, K10's and K16's too, on the same
    walk): enough spans of whole 64-row tiles for about two CTAs of 128
    samples per SM, rounded down to whole waves: exactly two of them fit on
    an SM (their registers), so a count that leaves a partial second wave
    costs a whole one (at B 4096, 9 splits would be 288 CTAs on 264 slots
    of an H100)."""
    return _whole_waves(B, N, device, 2)


def k4_splits(B: int, N: int, D: int, device: torch.device) -> int:
    """K4's codebook splits (K9's too, on the same walk): K1's CTAs of 128
    samples, in whole waves of the CTAs an SM holds: two up to D 64 (its
    registers and 100 KB of shared memory each), one past it (the slab walk
    keeps the tile's sums of both contractions in registers)."""
    return _whole_waves(B, N, device, 2 if D <= 64 else 1)


def _whole_waves(B: int, N: int, device: torch.device, per_sm: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    b_tiles, n_tiles = -(-B // 128), -(-N // 64)
    return max(1, min(n_tiles, per_sm * sms // b_tiles))


def _launch(entry: str, wrapper, splits, x: torch.Tensor, codes: torch.Tensor):
    x = x.contiguous()
    codes = codes.contiguous()
    B, D = x.shape
    N = codes.shape[0]
    val = torch.empty((B,), dtype=torch.float32, device=x.device)
    idx = torch.empty((B,), dtype=torch.int32, device=x.device)
    if B == 0:
        return val, idx
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # the kernel splits the codebook and folds the splits into a (B,) u64
    # key scratch
    keys = torch.empty((B,), dtype=torch.int64, device=x.device)
    _build.call(entry, x.data_ptr(), codes.data_ptr(), B, N, D,
                splits(B, N, x.device), keys.data_ptr(),
                val.data_ptr(), idx.data_ptr(), stream)
    wrapper.launches += 1
    # the kernel returns the partial distance; add ||x||^2 here
    return torch.clamp(val + (x * x).sum(-1), min=0.0), idx


def dist_argmin(x: torch.Tensor, codes: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN winners of x (B, D) in codes (N, D): (sq_dists, int32 idx).
    `mask` (B, D), nonzero = masked, runs `dist_argmin_masked`."""
    if mask is not None:
        return dist_argmin_masked(x, codes, mask)
    if _check(x, codes) == "cpu":
        return dist_argmin_plain(x, codes)
    return _launch("somvq_dist_argmin", dist_argmin, k2_splits, x, codes)


def dist_argmin_masked(x: torch.Tensor, codes: torch.Tensor,
                       mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN winners over the unmasked components of each sample:
    (sq_dists, int32 idx)."""
    device = _check(x, codes)
    _check_mask(x, mask)
    if device == "cpu":
        return dist_argmin_masked_plain(x, codes, mask)
    x = x.contiguous()
    codes = codes.contiguous()
    m8 = mask_bytes(mask)
    B, D = x.shape
    N = codes.shape[0]
    val = torch.empty((B,), dtype=torch.float32, device=x.device)
    idx = torch.empty((B,), dtype=torch.int32, device=x.device)
    if B == 0:
        return val, idx
    keys = torch.empty((B,), dtype=torch.int64, device=x.device)
    _build.call("somvq_dist_argmin_masked", x.data_ptr(), m8.data_ptr(),
                codes.data_ptr(), B, N, D, k4_splits(B, N, D, x.device),
                keys.data_ptr(), val.data_ptr(), idx.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
    dist_argmin_masked.launches += 1
    xk = x * keep_of(m8)
    return torch.clamp(val + (xk * xk).sum(-1), min=0.0), idx


def dist_argmin_t(x: torch.Tensor, codes: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN winners in the max-score form: (sq_dists, int32 idx)."""
    if _check(x, codes) == "cpu":
        return dist_argmin_t_plain(x, codes)
    return _launch("somvq_dist_argmin_t", dist_argmin_t, k2_splits, x, codes)


dist_argmin.launches = 0
dist_argmin_masked.launches = 0
dist_argmin_t.launches = 0
