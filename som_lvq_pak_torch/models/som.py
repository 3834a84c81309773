"""Self-organizing map: random initialisation and the fast quantization
error — counterparts of som_lvq_pak_tpu/models/som.py.

`randinit` is a copy of som_lvq_pak_tpu/models/som.py:39-72; tests hold
the two bit-equal.  The host types it takes (Dataset, Topology,
Neighborhood, CRandom) are the port's own (data/, utils/), re-exported here
for callers.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..convert import codebook_to_torch, samples_to_torch
from ..data.dataset import Dataset, Neighborhood, Topology
from ..ops.dist_argmin import dist_argmin, dist_argmin_t
from ..ops.distance import keep_of
from ..utils.rng import CRandom

__all__ = ["CRandom", "Dataset", "Neighborhood", "Topology", "find_qerror",
           "randinit"]

F32 = np.float32
FLT_MIN = np.float32(1.17549435e-38)
FLT_MAX = np.float32(3.4028235e38)


def randinit(
    data: Dataset,
    topol: Topology,
    neigh: Neighborhood,
    xdim: int,
    ydim: int,
    rng: CRandom,
) -> Dataset:
    """Uniform-random codebook in the per-component data [min, max] box
    (randinit_codes, som_rout.c:34-162), consuming the LCG stream in the
    C order (code-major, component-minor)."""
    noc = xdim * ydim
    pts = data.points
    if data.mask is not None:
        keep = data.mask == 0
    else:
        keep = np.ones_like(pts, dtype=bool)
    compcnt = keep.sum(axis=0)
    # C initializes the running max to FLT_MIN (not -FLT_MAX!)
    maval = np.where(keep, pts, -np.inf).max(axis=0).astype(F32)
    maval = np.maximum(maval, FLT_MIN)
    mival = np.where(keep, pts, np.inf).min(axis=0).astype(F32)
    mival = np.minimum(mival, FLT_MAX)

    dim = data.dim
    draws = rng.orand_array(noc * dim).reshape(noc, dim)
    # C: mival + (maval - mival) * ((float)orand() / 32768.0)  — the
    # subtraction is float, the rest double, rounded to float on store.
    span = (maval - mival).astype(F32)
    vals = mival.astype(np.float64) + span.astype(np.float64) * (
        draws.astype(F32).astype(np.float64) / 32768.0
    )
    codes = np.where(compcnt > 0, vals, 0.0).astype(F32)
    return Dataset(points=codes, topol=topol, neigh=neigh, xdim=xdim, ydim=ydim)


def find_qerror(codes: Union[Dataset, torch.Tensor], data,
                mode: str = "fast", mask: Optional[torch.Tensor] = None,
                device: Union[torch.device, str] = "cuda") -> float:
    """Total quantization error, sum over samples of the distance to the
    winner (find_qerror, som_rout.c:678-731); divide by N for the
    per-sample figure.

    The fast path of `_find_qerror_fast`/`_qerror_whole_step`
    (som_lvq_pak_tpu/models/som.py:471-592): winners from one winner
    search over the whole array, then the winner's distance recomputed
    exactly in float32, square-rooted and summed on the device.  Unmasked
    data searches with `dist_argmin_t`; masked data with the masked
    `dist_argmin`, and then only the unmasked components count, so a sample
    with every component masked adds 0 (the reference skips it).

    `codes` and `data` are host Datasets or tensors, or `data` is a
    data.streaming.StreamingReader: the codebook is then uploaded once and
    each chunk of one lap adds its sum to one float32 total on the device,
    fetched once at the end (som_lvq_pak_tpu/models/som.py:433-453); a
    masked chunk takes the masked winner search.  A Dataset's mask is its
    own; `mask` (N, D), nonzero = masked, goes with a `data` tensor.
    Tensors stay where they are (keep evaluation data resident as a
    tensor); a Dataset is copied to the other argument's device, or to
    `device` when no argument is a tensor ("cuda" unless the caller asks for
    "cpu"; without a GPU that raises)."""
    if mode != "fast":
        raise NotImplementedError(
            "find_qerror(mode='parity') is the host path of "
            "som_lvq_pak_tpu.models.som; the port has mode='fast' only")
    tensors = [t for t in (codes, data) if isinstance(t, torch.Tensor)]
    device = tensors[0].device if tensors else device
    M = codebook_to_torch(codes, device)[0] if isinstance(codes, Dataset) else codes
    if hasattr(data, "_chunks_one_lap"):  # a StreamingReader
        if mask is not None:
            raise ValueError("mask= goes with a data tensor; a stream's chunks "
                             "carry their own masks")
        total = torch.zeros((), dtype=torch.float32, device=M.device)
        for chunk in data.chunks(laps=1):
            X, mk = samples_to_torch(chunk, M.device)[:2]
            total = total + _qerror_sum(X, M, mk)
        return float(total)
    if isinstance(data, Dataset):
        if mask is not None:
            raise ValueError("mask= goes with a data tensor; a Dataset "
                             "carries its own mask")
        X, mask = samples_to_torch(data, device)[:2]
    else:
        X = data
    if X.device != M.device:
        raise ValueError(f"codes on {M.device}, data on {X.device}")
    return float(_qerror_sum(X, M, mask))


def _qerror_sum(X: torch.Tensor, M: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The float32 device sum of the winner distances of X's samples."""
    if X.shape[0] == 0:
        return torch.zeros((), dtype=torch.float32, device=M.device)
    if mask is None:
        _, idx = dist_argmin_t(X, M)
        diff = X - M[idx.long()]
    else:
        _, idx = dist_argmin(X, M, mask=mask)
        diff = (X - M[idx.long()]) * keep_of(mask)
    mind = (diff * diff).sum(-1)
    return torch.sqrt(torch.clamp(mind, min=0.0)).sum()
