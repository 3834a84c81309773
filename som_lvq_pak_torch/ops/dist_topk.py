"""Fused k-NN winner search, k <= 16: kernel K10 (`dist_topk`), the
counterpart of som_lvq_pak_tpu/ops/pallas_distance.py:dist_topk; the
sharded lvq2.1/lvq3 step's per-shard top-2 (parallel.sharded.sharded_top2).

    vals, idx = dist_topk(x, codes, k)

Returns (sq_dists (B, k) float32, indices (B, k) int32), ascending: the k
smallest (value, index) pairs, equal values lowest index first.  The kernel
ranks the partial distance ||m||^2 - 2 x.m and reports max(partial +
||x||^2, 0), as the JAX wrapper does.  k outside 1..16 raises ValueError, as
there; so does k > N.

The plain version is ops.distance.topk_winners (k first-minimum argmins of
the full distance, each pick masked out, never `torch.topk`, which promises
no order among equal values), its values clamped at 0.  A CUDA tensor
launches the kernel: K1's Hopper walk (`csrc/argmin_sm90.cu`'s
`dist_topk_sm90_kernel`: a TMA ring fed by a producer, TF32 `wgmma`) with
a fold of KM in {2, 4, 8, 16} (score, code) pairs per lane and sample, KM
the smallest that holds k.  One C call runs K1's prologue (the codebook
split into TF32 hi and lo once, with ||m||^2; counted on
`ops.dist_argmin.split_codes.launches` too), the walk with the codebook
split by `k1_sm90_splits`, and the merge of the splits.  A row's score is
K1's float, so the first column is K1's (value, index) bit for bit on the
same inputs, and at k = 2 the pairs are K8's (`ops.dist_top2.dist_top2`,
the same walk at KM 2).  A CPU tensor runs the plain version.  The wrapper
counts its kernel launches in its `launches` attribute.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .dist_argmin import _check, k1_sm90_splits, split_codes, split_codes_dp
from .distance import topk_winners


def dist_topk_plain(x: torch.Tensor, codes: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K10: `topk_winners`, values clamped at 0."""
    idx, vals = topk_winners(x, codes, k)
    return torch.clamp(vals, min=0.0), idx.to(torch.int32)


def dist_topk(x: torch.Tensor, codes: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest codes of x (B, D) in codes (N, D): (sq_dists (B, k),
    int32 idx (B, k)), ascending."""
    if not 1 <= k <= 16:
        raise ValueError(f"dist_topk: k={k} out of range (1..16)")
    device = _check(x, codes)
    N = codes.shape[0]
    if k > N:
        raise ValueError(f"dist_topk: k={k} > {N} codes")
    if device == "cpu":
        return dist_topk_plain(x, codes, k)
    x = x.contiguous()
    vo, io = _launch(x, codes, k)
    # the kernel returns partial distances; add ||x||^2 here, summed as
    # dist_argmin sums it
    return torch.clamp(vo + (x * x).sum(-1)[:, None], min=0.0), io


def dist_topk_reference(x: torch.Tensor, rev: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`dist_topk` with equal distances highest index first, given `rev`,
    the codebook in reverse row order (`codes.flip(0)`, made once by a
    caller that walks it for many query blocks): (sq_dists (B, k), int32
    idx (B, k) into the codebook in file order), ascending."""
    vals, idx = dist_topk(x, rev, k)
    return vals, rev.shape[0] - 1 - idx


def topk_scratch_floats(B: int, N: int, D: int, k: int, splits: int) -> int:
    """The floats of K10's one scratch buffer: the prologue's hi and lo (N,
    Dp), ||m||^2 (N, padded to 4), then the splits' (splits, B, k) pair
    values and indices."""
    return 2 * N * split_codes_dp(D) + -(-N // 4) * 4 + 2 * splits * B * k


def _launch(x: torch.Tensor, codes: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch `somvq_dist_topk` on checked CUDA tensors (x contiguous): the
    k smallest partial distances ||m||^2 - 2 x.m (B, k) and their int32
    indices."""
    codes = codes.contiguous()
    B, D = x.shape
    N = codes.shape[0]
    vo = torch.empty((B, k), dtype=torch.float32, device=x.device)
    io = torch.empty((B, k), dtype=torch.int32, device=x.device)
    if B == 0:
        return vo, io
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = k1_sm90_splits(B, N, sms)
    scratch = torch.empty((topk_scratch_floats(B, N, D, k, splits),),
                          dtype=torch.float32, device=x.device)
    _build.call("somvq_dist_topk", x.data_ptr(), codes.data_ptr(), B, N, D,
                split_codes_dp(D), k, splits, scratch.data_ptr(), vo.data_ptr(),
                io.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    split_codes.launches += 1
    dist_topk.launches += 1
    return vo, io


dist_topk.launches = 0
