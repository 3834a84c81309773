"""The neighbourhood accumulators of a codebook shard: kernel K11
(`som_neighborhood_accumulate`), the counterpart of
som_lvq_pak_tpu/ops/pallas_som.py:som_neighborhood_accumulate.

    acc, wsum = som_neighborhood_accumulate(xb, bmu, n_local, xdim, hexa,
                                            alpha, radius, gaussian,
                                            unit_offset)

acc = W^T X (n_local, D) and wsum = W^T 1 (n_local, 1) for the codebook rows
unit_offset .. unit_offset + n_local - 1 of an xdim-wide map, W[row, b] the
neighbourhood weight of global unit unit_offset + row for sample b with
global BMU bmu[b] (ops.som_step.neighborhood_w: the exact-f32 grid algebra;
bmu < 0 gives 0).  `alpha` is a scalar or a per-sample (B,) vector.  No
codebook is read: the mixed data x model step sums these over the data axis
before K12 blends them in (parallel.sharded).

A CUDA tensor launches the kernel in `csrc/som_accum_sm90.cu`: K3's update
on its Hopper walk (csrc/fused_step_sm90.cuh), K5's without the blend (K3's
prologue into `ops.som_update.update_scratch`, one feature slab of
`ops.som_update.update_slabs` per CTA, any D), split-TF32 products on TF32
`wgmma` summed per 32-sample chunk into float32 registers, so a row's sums
are the floats K3 blends into it and do not depend on the rows beside it
(a shard accumulated in row pieces gives the bits of the whole shard); a
CPU tensor runs the plain version below.  The wrapper counts its kernel
launches in its `launches` attribute.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from .. import _build
from .distance import fp32_matmul
from .som_step import neighborhood_w
from .som_update import update_scratch


def som_neighborhood_accumulate_plain(xb, bmu, n_local, xdim, hexa, alpha,
                                      radius, gaussian=False, unit_offset=0):
    """Plain K11; same arguments and contract as
    `som_neighborhood_accumulate`."""
    fp32_matmul()
    dev = xb.device
    aw = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    aw = aw.expand(xb.shape[0]) if aw.dim() == 0 else aw
    r = torch.tensor(radius, dtype=torch.float32, device=dev)
    units = unit_offset + torch.arange(n_local, dtype=torch.int32, device=dev)
    w = neighborhood_w(bmu.to(torch.int32), aw, r, units, xdim, hexa, gaussian)
    return w @ xb, w.sum(1, keepdim=True)


def som_neighborhood_accumulate(
    xb: torch.Tensor,
    bmu: torch.Tensor,
    n_local: int,
    xdim: int,
    hexa: bool,
    alpha: Union[float, torch.Tensor],
    radius: float,
    gaussian: bool = False,
    unit_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(acc (n_local, D), wsum (n_local, 1)) float32 for batch `xb` (B, D)
    with global BMUs `bmu` (B,)."""
    dev = xb.device
    if xb.dim() != 2 or xb.dtype != torch.float32:
        raise ValueError("xb must be a 2-D float32 tensor")
    B, D = xb.shape
    if bmu.shape != (B,) or bmu.device != dev:
        raise ValueError(f"bmu {tuple(bmu.shape)} must be ({B},) on {dev}")
    if n_local <= 0 or B == 0 or unit_offset < 0:
        raise ValueError(f"n_local {n_local}, B {B}, unit_offset {unit_offset}")
    aw = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    aw = aw.expand(B).contiguous() if aw.dim() == 0 else aw.contiguous()
    if aw.shape != (B,):
        raise ValueError(f"alpha must be a scalar or ({B},)")
    bmu = bmu.to(torch.int32).contiguous()
    if dev.type == "cpu":
        return som_neighborhood_accumulate_plain(xb, bmu, n_local, xdim, hexa,
                                                 aw, radius, gaussian,
                                                 unit_offset)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    xb = xb.contiguous()
    xs = update_scratch(B, D, dev)
    acc = torch.empty((n_local, D), dtype=torch.float32, device=dev)
    wsum = torch.empty((n_local, 1), dtype=torch.float32, device=dev)
    _build.call("somvq_som_accum", int(n_local), D, xb.data_ptr(),
                bmu.data_ptr(), aw.data_ptr(), B, int(xdim), int(bool(hexa)),
                int(bool(gaussian)), float(radius), int(unit_offset),
                xs.data_ptr(), acc.data_ptr(), wsum.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    som_neighborhood_accumulate.launches += 1
    return acc, wsum


som_neighborhood_accumulate.launches = 0
