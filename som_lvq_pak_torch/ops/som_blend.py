"""Blend the summed accumulators into a codebook shard and find the next
batch's winners in one pass: kernel K12 (`som_blend_winner`), the
counterpart of som_lvq_pak_tpu/ops/pallas_som.py:som_blend_winner.

    codes, val, idx = som_blend_winner(codes, acc, wsum, xn)

The codebook shard (n_local, D) becomes the guarded blend
(ops.som_step.guarded_blend) of acc (n_local, D) and wsum (n_local, 1), IN
PLACE (the caller owns the resident shard), and is returned.  Then for each
row of xn (B', D), the max-score winner against the blended rows:
score = x.m - ||m||^2 / 2, the first (lowest) row of the largest score;
`val` = -2 * score (the partial distance ||m||^2 - 2 x.m, in this rounding)
and `idx` the LOCAL row, int32, as the JAX wrapper returns them.

A CUDA tensor launches the kernel the route `k12_route` names: up to D 128
`csrc/som_blend_winner_sm90.cu`, K3's Hopper walk without its update (the
next batch split once, the blend from acc and wsum in K3's register layout,
the winners on TF32 `wgmma` fed by a TMA ring), past it
`csrc/som_blend_winner.cu`, K3's split-TF32 `mma.sync` blend-and-winner half
(csrc/fused_step_tc.cuh); either way the winners in distance form through
split-TF32 products, so K11 then K12 on a shard give K3's rows, values and
winners bit for bit; a CPU tensor runs the plain version below.  The wrapper
counts its kernel launches in its `launches` attribute.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .distance import fp32_matmul
from .som_step import _split_scratch, guarded_blend, k3_route, sm90_scratch


def som_blend_winner_plain(codes, acc, wsum, xn):
    """Plain K12; same arguments and contract as `som_blend_winner`."""
    fp32_matmul()
    newc = guarded_blend(codes, acc, wsum)
    score = newc @ xn.T - 0.5 * (newc * newc).sum(1, keepdim=True)  # (n, B')
    idx = torch.argmax(score, dim=0)  # first (lowest) row on ties
    val = -2.0 * score.gather(0, idx[None, :])[0]
    codes.copy_(newc)
    return codes, val, idx.to(torch.int32)


def k12_route(D: int) -> str:
    """K12's kernel for D features, K3's rule (`ops.som_step.k3_route`):
    "sm90", K3's Hopper walk without the update
    (csrc/som_blend_winner_sm90.cu), up to D 128; "mma_sync"
    (csrc/som_blend_winner.cu) past it.  Both give the same floats."""
    return k3_route(D)


def som_blend_winner(codes: torch.Tensor, acc: torch.Tensor,
                     wsum: torch.Tensor, xn: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blend `acc`/`wsum` into `codes` in place; return (codes, val (B',),
    local idx (B',) int32) for the next batch `xn`."""
    dev = codes.device
    if codes.dim() != 2 or acc.shape != codes.shape:
        raise ValueError(f"codes {tuple(codes.shape)} and acc {tuple(acc.shape)} "
                         "must be the same (n_local, D)")
    n_local, D = codes.shape
    if wsum.shape != (n_local, 1) or xn.dim() != 2 or xn.shape[1] != D:
        raise ValueError(f"wsum {tuple(wsum.shape)} must be ({n_local}, 1), xn "
                         f"{tuple(xn.shape)} (B', {D})")
    if any(t.dtype != torch.float32 for t in (codes, acc, wsum, xn)):
        raise TypeError("codes, acc, wsum and xn must be float32")
    if any(t.device != dev for t in (acc, wsum, xn)):
        raise ValueError("codes, acc, wsum and xn must share one device")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous (updated in place)")
    if n_local == 0 or xn.shape[0] == 0:
        raise ValueError("empty codebook shard or batch")
    if dev.type == "cpu":
        return som_blend_winner_plain(codes, acc, wsum, xn)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    acc, wsum, xn = acc.contiguous(), wsum.contiguous(), xn.contiguous()
    Bn = xn.shape[0]
    walk = k12_route(D) == "sm90"
    xs = sm90_scratch(0, Bn, D, dev, table=False) if walk else _split_scratch(0, Bn, D, dev)
    keys = torch.empty((Bn,), dtype=torch.int64, device=dev)
    val = torch.empty((Bn,), dtype=torch.float32, device=dev)
    idx = torch.empty((Bn,), dtype=torch.int32, device=dev)
    _build.call("somvq_som_blend_winner_sm90" if walk else "somvq_som_blend_winner",
                codes.data_ptr(), n_local, D,
                acc.data_ptr(), wsum.data_ptr(), xn.data_ptr(), Bn, xs.data_ptr(),
                keys.data_ptr(), val.data_ptr(), idx.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    som_blend_winner.launches += 1
    return codes, val, idx


som_blend_winner.launches = 0
