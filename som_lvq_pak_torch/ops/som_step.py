"""One fused SOM training step: kernel K3 (`som_fused_train_step`), the
counterpart of som_lvq_pak_tpu/ops/pallas_som.py:som_fused_train_step.

One call applies batch t's neighbourhood update to the codebook and finds
batch t+1's winners against the UPDATED codebook (the software-pipelined
form the trainer runs):

    codes, bmu_next, val_next = som_fused_train_step(
        codes, x[t], bmu, x[t + 1], xdim, hexa, alpha, radius, gaussian)

The codebook is updated IN PLACE (the caller owns the resident codebook;
this saves a second codebook-sized buffer per step) and returned.
`val_next` is the partial distance ||m||^2 - 2 m.x, without ||x||^2, as in
the JAX package.  `unit_offset` (default 0) is the global unit of row 0 when
`codes` is a model-axis shard of a larger map: the neighbourhood weights are
taken at the global units, while `bmu_next` stays local rows, as the JAX
wrapper returns them (parallel.sharded adds the offset).

A CUDA tensor launches the kernel in `csrc/som_fused_step.cu`; a CPU tensor
runs the plain version below, built from the plain counterparts of
`_grid_xy`, `_neighborhood_w` and `_guarded_blend` (pallas_som.py:48-113).
The wrapper counts its kernel launches in its `launches` attribute.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

from .. import _build
from .distance import fp32_matmul

MAX_D = 256  # widest feature dimension the CUDA kernel takes
_SQRT075 = math.sqrt(0.75)


def grid_xy(idx: torch.Tensor, xdim: int, hexa: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid coordinates of flat unit indices (`_grid_xy`): hexa odd rows
    at x + 0.5, y scaled by sqrt(0.75).  For display and coordinate
    tables only: the neighbourhood weights use `grid_sq_dists`, whose terms
    are exact in float32."""
    col = (idx % xdim).to(torch.float32)
    row = idx // xdim
    if hexa:
        return (col + 0.5 * (row % 2).to(torch.float32),
                row.to(torch.float32) * _SQRT075)
    return col, row.to(torch.float32)


def grid_sq_dists(units: torch.Tensor, bmu: torch.Tensor, xdim: int,
                  hexa: bool) -> torch.Tensor:
    """Squared grid distance between unit and BMU flat indices (broadcast
    against each other), computed EXACTLY in float32 as `_neighborhood_w`
    does: dx from columns and 0.5 offsets, hexa dy^2 = rowdiff^2 * 0.75.
    Bubble inclusion at exact-boundary distances depends on this form."""
    ucol = (units % xdim).to(torch.float32)
    urow = units // xdim
    bcol = (bmu % xdim).to(torch.float32)
    brow = bmu // xdim
    rd = (urow - brow).to(torch.float32)
    if hexa:
        dx = ((ucol + 0.5 * (urow % 2).to(torch.float32))
              - (bcol + 0.5 * (brow % 2).to(torch.float32)))
        return dx * dx + (rd * rd) * 0.75
    dx = ucol - bcol
    return dx * dx + rd * rd


def neighborhood_w(bmu: torch.Tensor, alpha: torch.Tensor,
                   radius: torch.Tensor, units: torch.Tensor, xdim: int,
                   hexa: bool, gaussian: bool) -> torch.Tensor:
    """(len(units), B) adaptation weights (`_neighborhood_w`): bubble
    alpha where d2 <= r^2, gaussian alpha * exp(-d2 / (2 r r)); 0 where
    bmu < 0.  `alpha` is the (B,) per-sample effective alpha, `radius` a
    float32 scalar tensor."""
    d2 = grid_sq_dists(units[:, None], bmu[None, :], xdim, hexa)
    a = alpha[None, :]
    if gaussian:
        w = a * torch.exp(-d2 / (2.0 * radius * radius))
    else:
        w = torch.where(d2 <= radius * radius, a, torch.zeros_like(a))
    return torch.where(bmu[None, :] < 0, torch.zeros_like(w), w)


def guarded_blend(c: torch.Tensor, acc: torch.Tensor, wsum: torch.Tensor
                  ) -> torch.Tensor:
    """Saturating update (`_guarded_blend`): exact c + acc - wsum * c while
    wsum <= 1, full blend to the weighted mean acc / wsum beyond."""
    safe = torch.clamp(wsum, min=1e-30)
    blend = torch.clamp(wsum, max=1.0)
    return c + blend * (acc / safe - c)


def som_fused_train_step_plain(codes, xb, bmu, xb_next, xdim, hexa, alpha,
                               radius, gaussian=False, unit_offset=0):
    """Plain K3; same arguments and contract as `som_fused_train_step`."""
    fp32_matmul()
    dev = codes.device
    aw = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    aw = aw.expand(xb.shape[0]) if aw.dim() == 0 else aw
    r = torch.tensor(radius, dtype=torch.float32, device=dev)
    units = unit_offset + torch.arange(codes.shape[0], dtype=torch.int32,
                                       device=dev)
    w = neighborhood_w(bmu.to(torch.int32), aw, r, units, xdim, hexa, gaussian)
    newc = guarded_blend(codes, w @ xb, w.sum(1, keepdim=True))
    d_t = (newc * newc).sum(1, keepdim=True) - 2.0 * (newc @ xb_next.T)
    idx = torch.argmin(d_t, dim=0)  # first (lowest) row on ties
    val = d_t.gather(0, idx[None, :])[0]
    codes.copy_(newc)
    return codes, idx.to(torch.int32), val


def som_fused_train_step(
    codes: torch.Tensor,
    xb: torch.Tensor,
    bmu: torch.Tensor,
    xb_next: torch.Tensor,
    xdim: int,
    hexa: bool,
    alpha: Union[float, torch.Tensor],
    radius: float,
    gaussian: bool = False,
    unit_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Update `codes` (noc, D) in place with batch `xb` (B, D) whose BMUs
    are `bmu` (B,); return (codes, bmu_next (B',) int32, val_next (B',))
    for `xb_next` (B', D).  `alpha` is a scalar or (B,) per-sample alpha."""
    dev = codes.device
    if codes.dim() != 2 or xb.dim() != 2 or xb_next.dim() != 2:
        raise ValueError("codes, xb and xb_next must be 2-D")
    noc, D = codes.shape
    B = xb.shape[0]
    if xb.shape[1] != D or xb_next.shape[1] != D or bmu.shape != (B,):
        raise ValueError(f"shape mismatch: codes {tuple(codes.shape)}, xb "
                         f"{tuple(xb.shape)}, bmu {tuple(bmu.shape)}, xb_next "
                         f"{tuple(xb_next.shape)}")
    if any(t.dtype != torch.float32 for t in (codes, xb, xb_next)):
        raise TypeError("codes, xb and xb_next must be float32")
    if any(t.device != dev for t in (xb, bmu, xb_next)):
        raise ValueError("codes, xb, bmu and xb_next must share one device")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous (updated in place)")
    if B == 0 or xb_next.shape[0] == 0:
        raise ValueError("empty batch")
    if unit_offset < 0:
        raise ValueError(f"unit_offset {unit_offset} < 0")
    aw = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    aw = aw.expand(B).contiguous() if aw.dim() == 0 else aw.contiguous()
    if aw.shape != (B,):
        raise ValueError(f"alpha must be a scalar or ({B},)")
    bmu = bmu.to(torch.int32).contiguous()
    if dev.type == "cpu":
        return som_fused_train_step_plain(codes, xb, bmu, xb_next, xdim, hexa,
                                          aw, radius, gaussian, unit_offset)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if D > MAX_D:
        raise ValueError(f"som_fused_train_step: D={D} > {MAX_D}, the "
                         "widest the CUDA kernel takes")
    xb = xb.contiguous()
    xn = xb_next.contiguous()
    Bn = xn.shape[0]
    keys = torch.empty((Bn,), dtype=torch.int64, device=dev)
    val = torch.empty((Bn,), dtype=torch.float32, device=dev)
    idx = torch.empty((Bn,), dtype=torch.int32, device=dev)
    _build.call("somvq_som_fused_step", codes.data_ptr(), noc, D,
                xb.data_ptr(), bmu.data_ptr(), aw.data_ptr(), B,
                xn.data_ptr(), Bn, int(xdim), int(bool(hexa)),
                int(bool(gaussian)), float(radius), int(unit_offset),
                keys.data_ptr(), val.data_ptr(), idx.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    som_fused_train_step.launches += 1
    return codes, idx, val


som_fused_train_step.launches = 0
