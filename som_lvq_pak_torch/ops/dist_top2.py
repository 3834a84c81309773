"""Fused 2-NN winner search: kernels K8 (`dist_top2`) and K9
(`dist_top2_masked`), counterparts of
som_lvq_pak_tpu/ops/pallas_distance.py:252-423, the lvq2.1/lvq3 step's
winner pair.

Both return (d1, i1, d2, i2), each (B,): the best and second-best codes'
true squared distances (the kernel's partial distance plus ||x||^2,
clamped at 0), float32, and their int32 indices.  The pair is the two
smallest (value, index) pairs in lexicographic order over the partial
distances: equal values go to the lower index, on the best and on the
second.

* `dist_top2` scores ||m||^2 - 2 x.m (replaces `_dist_top2_kernel`).
  Given a `mask` it runs `dist_top2_masked`.
* `dist_top2_masked` scores keep.(m o m) - 2 (x keep).m, where `mask`
  (B, D) is nonzero on masked components (replaces
  `_dist_top2_masked_kernel`); ||x keep||^2 is added back, so a sample with
  every component masked gets (0, 0, 0, 1).

The JAX wrapper pads the codebook with +inf norms, so for one code it
returns a padding row as the second; here fewer than two codes raise
ValueError (the lvq2.1 window needs two).

A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
Any other device raises.  Each wrapper counts its kernel launches in its
`launches` attribute.  K8 is K1's Hopper walk with a top-2 fold
(`csrc/argmin_sm90.cu`'s `top2_sm90_kernel`): one C call runs K1's
prologue (counted on `ops.dist_argmin.split_codes.launches` too), the walk
on TF32 `wgmma` with the codebook split by `k1_sm90_splits`, and the
merge of the splits; its best pair is K1's (value, index) and its pairs
K10's at k = 2 (`ops.dist_topk.dist_topk`, on the mma.sync walk) bit for
bit on the same inputs.  K9 is K4's Hopper walk with the same top-2 fold
(`csrc/argmin_masked_sm90.cu`'s `masked_top2_sm90_kernel`): one C call runs
K4's prologue, the walk on TF32 `wgmma` with the codebook split by
`k4_sm90_splits`, and the merge of the splits; its best pair is
`dist_argmin_masked`'s (value, index) bit for bit on the same inputs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from .dist_argmin import (_check, _check_mask, _rows_per_chunk, k1_sm90_splits,
                          k4_sm90_splits, split_codes, split_codes_dp)
from .distance import fp32_matmul, keep_of, mask_bytes

Top2 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check_top2(x: torch.Tensor, codes: torch.Tensor) -> str:
    device = _check(x, codes)
    if codes.shape[0] < 2:
        raise ValueError(f"dist_top2 needs at least two codes, got {codes.shape[0]}")
    return device


def dist_top2_plain(x: torch.Tensor, codes: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> Top2:
    """Plain K8 (K9 given a mask): the two first minima of the partial
    distance, the second found with the first masked out by +inf."""
    _check_top2(x, codes)
    fp32_matmul()
    if mask is None:
        xk, keep, m2 = x, None, (codes * codes).sum(-1)
    else:
        _check_mask(x, mask)
        keep = keep_of(mask)
        xk, mm = x * keep, codes * codes
    rows = []
    step = _rows_per_chunk(codes.shape[0])
    for s in range(0, x.shape[0], step):
        xc = xk[s:s + step]
        norms = m2[None, :] if keep is None else keep[s:s + step] @ mm.T
        d = norms - 2.0 * (xc @ codes.T)
        x2 = (xc * xc).sum(-1)
        row = []
        for _ in range(2):
            i = torch.argmin(d, dim=1, keepdim=True)
            row += [torch.clamp(d.gather(1, i)[:, 0] + x2, min=0.0),
                    i[:, 0].to(torch.int32)]
            d.scatter_(1, i, float("inf"))
        rows.append(row)
    return tuple(torch.cat(col) for col in zip(*rows))


def _pair_outputs(x: torch.Tensor) -> Top2:
    B = x.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    i32 = dict(dtype=torch.int32, device=x.device)
    return (torch.empty((B,), **f32), torch.empty((B,), **i32),
            torch.empty((B,), **f32), torch.empty((B,), **i32))


def _launch(x: torch.Tensor, codes: torch.Tensor) -> Top2:
    x = x.contiguous()
    codes = codes.contiguous()
    B, D = x.shape
    N = codes.shape[0]
    v1, i1, v2, i2 = _pair_outputs(x)
    if B == 0:
        return v1, i1, v2, i2
    Dp = split_codes_dp(D)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = k1_sm90_splits(B, N, sms)
    # one C call: K1's prologue, the walk, the split merge; one scratch holds
    # the prologue's hi, lo (N, Dp), m2 (N, padded to 4) and the (splits, B,
    # 2) pairs of the splits
    scratch = torch.empty((2 * N * Dp + -(-N // 4) * 4 + 4 * splits * B,),
                          dtype=torch.float32, device=x.device)
    _build.call("somvq_dist_top2", x.data_ptr(), codes.data_ptr(), B, N, D, Dp, splits,
                scratch.data_ptr(), v1.data_ptr(), i1.data_ptr(), v2.data_ptr(),
                i2.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    split_codes.launches += 1
    dist_top2.launches += 1
    # the kernel returns partial distances; add ||x||^2 here, summed as
    # dist_argmin sums it
    x2 = (x * x).sum(-1)
    return torch.clamp(v1 + x2, min=0.0), i1, torch.clamp(v2 + x2, min=0.0), i2


def _launch_masked(x: torch.Tensor, codes: torch.Tensor, m8: torch.Tensor) -> Top2:
    x = x.contiguous()
    codes = codes.contiguous()
    B, D = x.shape
    N = codes.shape[0]
    v1, i1, v2, i2 = _pair_outputs(x)
    if B == 0:
        return v1, i1, v2, i2
    Dp = split_codes_dp(D)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = k4_sm90_splits(B, N, sms)
    # one C call: K4's prologue, the walk, the split merge; one scratch holds
    # the prologue's hi, lo, qhi, qlo (N, Dp) and the (splits, B, 2) pairs
    # of the splits
    scratch = torch.empty((4 * N * Dp + 4 * splits * B,), dtype=torch.float32,
                          device=x.device)
    _build.call("somvq_dist_top2_masked", x.data_ptr(), m8.data_ptr(),
                codes.data_ptr(), B, N, D, Dp, splits, scratch.data_ptr(),
                v1.data_ptr(), i1.data_ptr(), v2.data_ptr(), i2.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
    dist_top2_masked.launches += 1
    # the kernel returns partial distances; add ||x keep||^2 here, summed as
    # dist_argmin_masked sums it
    xk = x * keep_of(m8)
    x2 = (xk * xk).sum(-1)
    return torch.clamp(v1 + x2, min=0.0), i1, torch.clamp(v2 + x2, min=0.0), i2


def dist_top2(x: torch.Tensor, codes: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> Top2:
    """Best and second-best codes of x (B, D) in codes (N >= 2, D):
    (d1, i1, d2, i2).  `mask` (B, D), nonzero = masked, runs
    `dist_top2_masked`."""
    if mask is not None:
        return dist_top2_masked(x, codes, mask)
    if _check_top2(x, codes) == "cpu":
        return dist_top2_plain(x, codes)
    return _launch(x, codes)


def dist_top2_masked(x: torch.Tensor, codes: torch.Tensor,
                     mask: torch.Tensor) -> Top2:
    """Best and second-best codes over the unmasked components of each
    sample: (d1, i1, d2, i2)."""
    device = _check_top2(x, codes)
    _check_mask(x, mask)
    if device == "cpu":
        return dist_top2_plain(x, codes, mask)
    return _launch_masked(x, codes, mask_bytes(mask))


dist_top2.launches = 0
dist_top2_masked.launches = 0
