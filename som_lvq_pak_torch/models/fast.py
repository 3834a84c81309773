"""Minibatch SOM and LVQ building blocks — counterparts of
som_lvq_pak_tpu/models/fast.py (`unit_coords`, `grid_sq_dists_idx`,
`_guarded_sum_update`, `som_batch_step`, `som_train_fast`,
`olvq1_batch_step`, `lvq1_batch_step`, `lvq23_batch_step`).  The fused
step's plain version is built from the same algebra (ops.som_step).

The LVQ steps update the codebook IN PLACE and return it.  Their segment
sums (`ops.segment_sum`) add each code's rows in ascending sample order from
0.0 into a (noc, D) buffer, added to the codebook afterwards, so every float
expression keeps the JAX package's order (`codes + segment_sum(...)`) and
two runs on the card, or on the CPU, are bit-equal.  olvq1's three sums
share one call (the update and the two hit counts as columns of one array):
each column's sum is the same as alone."""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Union

import numpy as np
import torch

from ..convert import codebook_to_torch
from ..data.dataset import Dataset, Neighborhood, Topology
from ..ops.dist_argmin import dist_argmin
from ..ops.dist_top2 import dist_top2
from ..ops.segment_sum import segment_sum
from ..ops.som_step import grid_sq_dists, grid_xy
# `_guarded_sum_update`: codes + (wx - wsum * codes), saturated at the
# batch weighted mean once a unit's weight mass exceeds 1
from ..ops.som_step import guarded_blend as guarded_sum_update  # noqa: F401
from ..ops.som_update import som_neighborhood_update_idx
from .common import alpha_schedule, radius_schedule


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


def train_fast_indices(nb: int, batch_size: int, n: int, seed: int) -> torch.Tensor:
    """(nb, batch_size) int64 sample indices of `som_train_fast`, drawn
    uniformly from [0, n) by a CPU torch.Generator seeded with `seed`: the
    same batches on every device (the JAX function draws with
    jax.random.randint, so the two packages take different batches)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, n, (nb, batch_size), generator=g)


def som_train_fast(
    codes: Dataset,
    data: Dataset,
    rlen: int,
    alpha: float,
    radius: float,
    batch_size: int = 1024,
    update: str = "sum",
    seed: int = 0,
    device: Union[torch.device, str] = "cuda",
) -> Dataset:
    """Minibatch SOM training loop (som_lvq_pak_tpu/models/fast.py:
    371-420): `rlen` counts samples like the reference, trained as
    max(1, rlen // batch_size) batches of `batch_size` samples drawn by
    `train_fast_indices`; alpha and radius follow the reference's linear
    decay evaluated at each batch's first sample.  Each batch is one
    `som_batch_step` on `device` (K1 then K5 on the card).  `update` is
    accepted and does nothing, as in the JAX package ("sum" and "mean"
    coincide under the guarded blend); the data's masks, weights and fixed
    points are not used, as there."""
    if not codes.is_map:
        raise ValueError("not a map codebook")
    gaussian = codes.neigh == Neighborhood.GAUSSIAN
    hexa = codes.topol == Topology.HEXA
    nb = max(1, rlen // batch_size)
    talp = alpha_schedule(rlen, alpha)[:: max(1, batch_size)][:nb]
    trad = radius_schedule(rlen, radius)[:: max(1, batch_size)][:nb]
    M = codebook_to_torch(codes, device)[0]
    dev = M.device
    X = torch.from_numpy(np.ascontiguousarray(data.points, np.float32)).to(dev)
    steps = train_fast_indices(nb, batch_size, data.n, seed).to(dev)
    talp_d = torch.from_numpy(talp).to(dev)
    for b in range(nb):
        som_batch_step(M, X.index_select(0, steps[b]), codes.xdim, hexa, talp_d[b],
                       float(trad[b]), gaussian=gaussian)
    return replace(codes, points=M.cpu().numpy(), comments=[])


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def olvq1_batch_step(
    codes: torch.Tensor,
    code_labels: torch.Tensor,
    alphas: torch.Tensor,
    xb: torch.Tensor,
    xlabels: torch.Tensor,
    clip: float = 0.3,
    mask: Optional[torch.Tensor] = None,
    m2: Optional[torch.Tensor] = None,
):
    """One minibatch olvq1 step (som_lvq_pak_tpu/models/fast.py:228-281):
    winners for B samples (`dist_argmin`, masked given a mask), the signed
    segment-sum update, and the per-code alpha recurrences once per hit,
    a/(1+k a) and a/(1-k a), saturated at `clip` where the batched
    denominator leaves (0, clip] (lvq_rout.c:650-673).  Returns (codes,
    new alphas); `codes` is updated in place.

    `m2` = a maintained ||m||^2 (N,): returned updated as a third output,
    only the winner rows re-normed.  The winner kernel computes its norms
    from the tiles it stages, so it does not read `m2`."""
    _, bmu = dist_argmin(xb, codes, mask=mask)
    bmu = bmu.long()
    noc = codes.shape[0]
    correct = code_labels[bmu] == xlabels
    a = alphas[bmu]
    sign = torch.where(correct, a, -a)
    delta = sign[:, None] * (xb - codes[bmu])
    if mask is not None:
        delta = torch.where(mask != 0, 0.0, delta)
    D = codes.shape[1]
    sums = segment_sum(torch.cat([delta, correct[:, None].to(torch.float32),
                                  (~correct)[:, None].to(torch.float32)], 1),
                       bmu, noc)
    upd, ncorrect, nwrong = sums[:, :D], sums[:, D], sums[:, D + 1]
    clip32 = _f32(clip, codes.device)
    new_a = alphas / (1.0 + ncorrect * alphas)
    denom = 1.0 - nwrong * new_a
    ok = denom > 1e-6
    grown = torch.where(ok, new_a / torch.where(ok, denom, 1.0), clip32)
    new_a = torch.where(nwrong > 0, torch.minimum(grown, clip32), new_a)
    codes.add_(upd)
    if m2 is None:
        return codes, new_a
    m2[bmu] = (codes[bmu] ** 2).sum(1)
    return codes, new_a, m2


def lvq1_batch_step(
    codes: torch.Tensor,
    code_labels: torch.Tensor,
    xb: torch.Tensor,
    xlabels: torch.Tensor,
    alpha,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One minibatch lvq1 step (som_lvq_pak_tpu/models/fast.py:285-311):
    each sample pulls its winner toward it (same label) or pushes it away,
    by `alpha`; `codes` is updated in place and returned."""
    _, bmu = dist_argmin(xb, codes, mask=mask)
    bmu = bmu.long()
    a = _f32(alpha, codes.device)
    correct = code_labels[bmu] == xlabels
    sign = torch.where(correct, a, -a)
    delta = sign[:, None] * (xb - codes[bmu])
    if mask is not None:
        delta = torch.where(mask != 0, 0.0, delta)
    return codes.add_(segment_sum(delta, bmu, codes.shape[0]))


def lvq23_batch_step(
    codes: torch.Tensor,
    code_labels: torch.Tensor,
    xb: torch.Tensor,
    xlabels: torch.Tensor,
    alpha,
    winlen,
    epsilon=0.0,
    lvq3: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One minibatch lvq2.1 / lvq3 step (som_lvq_pak_tpu/models/fast.py:
    314-368, lvq_rout.c:702-916 batched): the winner pair from `dist_top2`
    (K8, or K9 given a mask), the window rule d1/d2 > (1-w)/(1+w) in
    float32, and the signed pair update; lvq3 adds the same-class epsilon
    pull.  `codes` is updated in place and returned."""
    d1, i1, d2, i2 = dist_top2(xb, codes, mask=mask)
    i1, i2 = i1.long(), i2.long()
    dev, noc = codes.device, codes.shape[0]
    a, w = _f32(alpha, dev), _f32(winlen, dev)
    l1, l2 = code_labels[i1], code_labels[i2]
    wl = (1.0 - w) / (1.0 + w)
    in_window = d1 / torch.clamp(d2, min=1e-30) > wl
    differ = l1 != l2
    one_matches = (l1 == xlabels) | (l2 == xlabels)
    window_rule = differ & one_matches & in_window
    # orient: b = the code matching the sample's label
    swap = l2 == xlabels
    b_idx = torch.where(swap, i2, i1)
    nb_idx = torch.where(swap, i1, i2)
    a_b = torch.where(window_rule, a, 0.0)[:, None]
    if mask is not None:
        keep = 1.0 - mask.to(torch.float32)
        a_b, neg_b = a_b * keep, -a_b * keep
    else:
        neg_b = -a_b
    delta = (segment_sum(a_b * (xb - codes[b_idx]), b_idx, noc)
             + segment_sum(neg_b * (xb - codes[nb_idx]), nb_idx, noc))
    if lvq3:
        same = (l1 == l2) & (l1 == xlabels)
        ae = torch.where(same, a * _f32(epsilon, dev), 0.0)[:, None]
        if mask is not None:
            ae = ae * keep
        delta = (delta + segment_sum(ae * (xb - codes[i1]), i1, noc)
                 + segment_sum(ae * (xb - codes[i2]), i2, noc))
    return codes.add_(delta)
