"""Minibatch SOM building blocks in plain PyTorch — counterparts of
som_lvq_pak_tpu/models/fast.py (`unit_coords`, `grid_sq_dists_idx`,
`_guarded_sum_update`).  The fused step's plain version is built from the
same algebra (ops.som_step)."""

from __future__ import annotations

import torch

from ..ops.som_step import grid_sq_dists, grid_xy
# `_guarded_sum_update`: codes + (wx - wsum * codes), saturated at the
# batch weighted mean once a unit's weight mass exceeds 1
from ..ops.som_step import guarded_blend as guarded_sum_update  # noqa: F401


def unit_coords(xdim: int, ydim: int, hexa: bool,
                device: torch.device | str = "cpu") -> torch.Tensor:
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
