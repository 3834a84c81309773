"""The SOM neighbourhood update of the two-kernel step: kernels K5
(`som_neighborhood_update_idx`) and K6 (`som_neighborhood_update_idx_masked`),
counterparts of som_lvq_pak_tpu/ops/pallas_som.py:som_neighborhood_update_idx.

    codes = som_neighborhood_update_idx(codes, xb, bmu, xdim, hexa, alpha,
                                        radius, gaussian, mask=None)

W (noc, B) comes from the flat BMU indices with the exact-f32 grid algebra
of `_neighborhood_w` (ops.som_step.neighborhood_w); `bmu < 0` gives weight
0; `alpha` is a scalar or a per-sample (B,) vector.  Without a mask the
update is the guarded blend of W.X with the weight mass W.1 (replaces
`_som_update_kernel`).  With a mask (B, D), nonzero = masked, it is the
blend of W.(X o K) with the per-(unit, component) mass W.K, K the keep
flags (replaces `_som_update_masked_kernel`): a sample's masked components
leave every unit's matching component untouched (lvq_pak.c:349-356).

The codebook is updated IN PLACE, as by K3 (the caller owns the resident
codebook; each CUDA block reads and writes only its own rows), and returned.

A CUDA tensor launches the kernel, both on K3's Hopper walk
(`csrc/fused_step_sm90.cuh`): split-TF32 products (float32 accuracy) on TF32
`wgmma` fed by TMA, each CTA 128 rows and one feature slab on gridDim.y, so
any D.  K5 (`csrc/som_update_sm90.cu`) is K3's update with its blend: K3's
prologue splits the batch into TF32 hi and lo once a call, transposed, with
K3's per-sample table, into a scratch (`update_scratch`;
`ops.tf32x3.split_sm90_plain` is its plain version), the slabs are
`update_slabs`; its codebook is K3's rows on the same winners bit for bit
(`ops.tf32x3.som_update_tf32x3` emulates it; K11, `ops.som_accum`, is the
same walk with the sums written out).  K6 (`csrc/som_update_masked_sm90.cu`)
runs W.(X o K) and the mass W.K on the same walk: its prologue splits X o K
into TF32 hi and lo and K once a call, transposed, with K3's per-sample
table, into a scratch (`k6_scratch`; `ops.tf32x3.split_k6_plain` is its
plain version), each CTA one slab of at most 64 features (`k6_slabs`), in
the order `ops.tf32x3.som_update_masked_tf32x3` emulates.  A CPU tensor runs
the plain version below.  The wrappers count their kernel launches in their
`launches` attributes.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .. import _build
from .dist_argmin import split_codes_dp
from .distance import fp32_matmul, keep_of, mask_bytes
from .som_step import guarded_blend, neighborhood_w


def som_neighborhood_update_idx_plain(codes, xb, bmu, xdim, hexa, alpha,
                                      radius, gaussian=False, mask=None):
    """Plain K5 (K6 given a mask); same arguments and contract as
    `som_neighborhood_update_idx`."""
    fp32_matmul()
    dev = codes.device
    aw = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    aw = aw.expand(xb.shape[0]) if aw.dim() == 0 else aw
    r = torch.tensor(radius, dtype=torch.float32, device=dev)
    units = torch.arange(codes.shape[0], dtype=torch.int32, device=dev)
    w = neighborhood_w(bmu.to(torch.int32), aw, r, units, xdim, hexa, gaussian)
    if mask is None:
        acc, wsum = w @ xb, w.sum(1, keepdim=True)
    else:
        keep = keep_of(mask)
        acc, wsum = w @ (xb * keep), w @ keep
    return codes.copy_(guarded_blend(codes, acc, wsum))


def update_slab(D: int) -> int:
    """The feature slab of K5's and K11's CTAs on gridDim.y
    (csrc/fused_step_sm90.cuh: update_slab): 32 features up to D 32, 64 up
    to D 64, else 128."""
    if D < 1:
        raise ValueError(f"K5 and K11 take D >= 1, got {D}")
    return 32 if D <= 32 else 64 if D <= 64 else 128


def update_slabs(D: int) -> list:
    """The feature ranges [lo, hi) of K5's and K11's CTAs on gridDim.y:
    whole `update_slab(D)` slabs over the prologue's padded rows, the last
    cut at D."""
    F = update_slab(D)
    return [(f0, min(D, f0 + F)) for f0 in range(0, D, F)]


def update_scratch(B: int, D: int, dev) -> torch.Tensor:
    """Scratch of K5's and K11's prologue (K3's, csrc/fused_step_sm90.cuh:
    split_sm90_kernel with no next batch): the batch transposed, (Dp, Bp),
    split into its TF32 hi and lo planes, then K3's per-sample float4 table
    (Bp,); Dp = D padded to whole `update_slab(D)` slabs, Bp = B rounded up
    to 64 (`ops.tf32x3.split_sm90_plain(xb, xb[:0], Dp, bmu=...)` fills
    it)."""
    Bp, F = -(-B // 64) * 64, update_slab(D)
    return torch.empty((2 * -(-D // F) * F * Bp + 4 * Bp,), dtype=torch.float32,
                       device=dev)


def k6_scratch(B: int, D: int, dev) -> torch.Tensor:
    """Scratch of K6's prologue (csrc/som_update_masked_sm90.cu:
    split_masked_batch_kernel): three planes of (Dp, Bp), X o K's TF32 hi and
    lo and K, then K3's per-sample float4 table (Bp,); Dp =
    `split_codes_dp(D)` (whole 64-feature slabs past 32), Bp = B rounded up
    to 64."""
    Bp = -(-B // 64) * 64
    return torch.empty((3 * split_codes_dp(D) * Bp + 4 * Bp,), dtype=torch.float32,
                       device=dev)


def k6_slabs(D: int) -> list:
    """The feature ranges [lo, hi) of K6's CTAs on gridDim.y
    (csrc/som_update_masked_sm90.cu's launch): slabs of 32 features up to D
    32, else of 64, over the prologue's `split_codes_dp(D)` rows; the last
    cut at D."""
    F = 32 if D <= 32 else 64
    return [(f0, min(D, f0 + F)) for f0 in range(0, split_codes_dp(D), F)]


def _prepare(codes, xb, bmu, alpha, mask):
    """Check the arguments; returns (bmu int32, alpha (B,) float32)."""
    dev = codes.device
    if codes.dim() != 2 or xb.dim() != 2:
        raise ValueError("codes and xb must be 2-D")
    B = xb.shape[0]
    if xb.shape[1] != codes.shape[1] or bmu.shape != (B,):
        raise ValueError(f"shape mismatch: codes {tuple(codes.shape)}, xb "
                         f"{tuple(xb.shape)}, bmu {tuple(bmu.shape)}")
    if codes.dtype != torch.float32 or xb.dtype != torch.float32:
        raise TypeError("codes and xb must be float32")
    if any(t.device != dev for t in (xb, bmu)):
        raise ValueError("codes, xb and bmu must share one device")
    if mask is not None and (mask.shape != xb.shape or mask.device != dev):
        raise ValueError(f"mask {tuple(mask.shape)} on {mask.device} must "
                         f"match xb {tuple(xb.shape)} on {dev}")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous (updated in place)")
    if B == 0:
        raise ValueError("empty batch")
    aw = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    aw = aw.expand(B).contiguous() if aw.dim() == 0 else aw.contiguous()
    if aw.shape != (B,):
        raise ValueError(f"alpha must be a scalar or ({B},)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return bmu.to(torch.int32).contiguous(), aw


def som_neighborhood_update_idx(
    codes: torch.Tensor,
    xb: torch.Tensor,
    bmu: torch.Tensor,
    xdim: int,
    hexa: bool,
    alpha: Union[float, torch.Tensor],
    radius: float,
    gaussian: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Update `codes` (noc, D) in place with batch `xb` (B, D) whose BMUs
    are `bmu` (B,) and return it.  `mask` runs
    `som_neighborhood_update_idx_masked`."""
    if mask is not None:
        return som_neighborhood_update_idx_masked(
            codes, xb, bmu, mask, xdim, hexa, alpha, radius, gaussian)
    bmu, aw = _prepare(codes, xb, bmu, alpha, None)
    if codes.device.type == "cpu":
        return som_neighborhood_update_idx_plain(codes, xb, bmu, xdim, hexa,
                                                 aw, radius, gaussian)
    xb = xb.contiguous()
    B, D = xb.shape
    xs = update_scratch(B, D, codes.device)
    _build.call("somvq_som_update", codes.data_ptr(), codes.shape[0], D,
                xb.data_ptr(), bmu.data_ptr(), aw.data_ptr(), B, int(xdim),
                int(bool(hexa)), int(bool(gaussian)), float(radius),
                xs.data_ptr(), torch.cuda.current_stream(codes.device).cuda_stream)
    som_neighborhood_update_idx.launches += 1
    return codes


def som_neighborhood_update_idx_masked(
    codes: torch.Tensor,
    xb: torch.Tensor,
    bmu: torch.Tensor,
    mask: torch.Tensor,
    xdim: int,
    hexa: bool,
    alpha: Union[float, torch.Tensor],
    radius: float,
    gaussian: bool = False,
) -> torch.Tensor:
    """The masked update: `mask` (B, D), nonzero = masked."""
    bmu, aw = _prepare(codes, xb, bmu, alpha, mask)
    if codes.device.type == "cpu":
        return som_neighborhood_update_idx_plain(codes, xb, bmu, xdim, hexa,
                                                 aw, radius, gaussian, mask)
    xb = xb.contiguous()
    m8 = mask_bytes(mask)
    B, D = xb.shape
    xs = k6_scratch(B, D, codes.device)
    _build.call("somvq_som_update_masked", codes.data_ptr(), codes.shape[0], D,
                xb.data_ptr(), m8.data_ptr(), bmu.data_ptr(), aw.data_ptr(), B,
                int(xdim), int(bool(hexa)), int(bool(gaussian)), float(radius),
                xs.data_ptr(), torch.cuda.current_stream(codes.device).cuda_stream)
    som_neighborhood_update_idx_masked.launches += 1
    return codes


som_neighborhood_update_idx.launches = 0
som_neighborhood_update_idx_masked.launches = 0
