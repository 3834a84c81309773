"""Minibatch SOM building blocks — counterparts of
som_lvq_pak_tpu/models/fast.py (`unit_coords`, `grid_sq_dists_idx`,
`_guarded_sum_update`, `som_batch_step`).  The fused step's plain version is
built from the same algebra (ops.som_step)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..ops.dist_argmin import dist_argmin
from ..ops.som_step import grid_sq_dists, grid_xy
# `_guarded_sum_update`: codes + (wx - wsum * codes), saturated at the
# batch weighted mean once a unit's weight mass exceeds 1
from ..ops.som_step import guarded_blend as guarded_sum_update  # noqa: F401
from ..ops.som_update import som_neighborhood_update_idx


def unit_coords(xdim: int, ydim: int, hexa: bool,
                device: torch.device | str = "cuda") -> torch.Tensor:
    """(noc, 2) float32 effective grid coordinates: hexa odd rows at
    x + 0.5, y scaled by sqrt(0.75) (som_rout.c:434-455)."""
    idx = torch.arange(xdim * ydim, dtype=torch.int64, device=device)
    x, y = grid_xy(idx, xdim, hexa)
    return torch.stack([x, y], dim=1)


def grid_sq_dists_idx(bmu: torch.Tensor, noc: int, xdim: int,
                      hexa: bool) -> torch.Tensor:
    """(B, noc) squared grid distances computed exactly in float32 from
    flat unit indices (see ops.som_step.grid_sq_dists)."""
    units = torch.arange(noc, dtype=bmu.dtype, device=bmu.device)
    return grid_sq_dists(units[None, :], bmu[:, None], xdim, hexa)


def effective_alpha(alpha: Union[float, torch.Tensor], n: int,
                    device: torch.device | str,
                    weights: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n,) float32 per-sample alpha (som_rout.c:622-624): a `weight=`
    token w > 0 scales alpha as 1 - (1 - alpha)^w (w <= 0, the "no token"
    sentinel, counts as 1); a sample with every component masked gets 0."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device).expand(n)
    if weights is not None:
        w = torch.where(weights > 0.0, weights, 1.0).to(torch.float32)
        a = 1.0 - torch.pow(1.0 - a, w)
    if mask is not None:
        a = torch.where((mask != 0).all(dim=-1), 0.0, a)
    return a.contiguous()


def som_batch_step(
    codes: torch.Tensor,
    xb: torch.Tensor,
    xdim: int,
    hexa: bool,
    alpha: Union[float, torch.Tensor],
    radius: float,
    gaussian: bool = False,
    mask: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    fixed_bmu: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One minibatch SOM step, the two-kernel form of the JAX package's
    `som_batch_step(use_pallas=True, xdim=, hexa=)`: winners of `xb`
    (`dist_argmin`, masked when `mask` is given), then the neighbourhood
    update (`som_neighborhood_update_idx`).  `codes` is updated IN PLACE
    and returned.

    `weights` (B,) scale each sample's alpha, `fixed_bmu` (B,) int32 >= 0
    replaces a sample's winner (fixed= tokens, som_rout.c:612-640), and
    `mask` (B, D), nonzero = masked, leaves masked components out of both
    the winner distance and the update; a sample with every component
    masked teaches nothing."""
    a = effective_alpha(alpha, xb.shape[0], xb.device, weights, mask)
    _, bmu = dist_argmin(xb, codes, mask=mask)
    if fixed_bmu is not None:
        bmu = torch.where(fixed_bmu >= 0, fixed_bmu.to(torch.int32), bmu)
    return som_neighborhood_update_idx(codes, xb, bmu, xdim, hexa, a, radius,
                                       gaussian, mask=mask)
