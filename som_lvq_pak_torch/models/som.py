"""Self-organizing map: initialisers, trainers and quantization errors —
the counterparts of som_lvq_pak_tpu/models/som.py (all of it).

Reference behaviour: som_rout.c (randinit :34-162, lininit/eigenvectors
:167-429, training :556-671, qerror :678-891).  Two paths, as in the JAX
package:

* parity — host NumPy with the C package's exact float32 op order
  (ops.exact, ops.neighborhood): `randinit`, `lininit`,
  `som_train(mode="parity")` (in memory and over a StreamingReader),
  `find_qerror(mode="parity")` and `find_qerror2(mode="parity")` are copies
  of som_lvq_pak_tpu/models/som.py:39-374, 459-469 and 663-701, held
  bit-equal to them by tests (and through them to the C package's goldens).
  They need no device.
* fast — the device, "cuda" unless the caller asks for "cpu" (the plain
  versions of the kernels): `som_train(mode="fast")`, the online scan, one
  sample per step with its winner from `dist_argmin` (K1; K4 under a mask);
  `find_qerror` (K2, or K4 masked); `find_qerror2` (winners from K1/K4, the
  (B, noc) distances by a float32 matmul); `vfind_trials` (every trial one
  two-kernel step per batch, `models.fast.som_batch_step`: K1 + K5).

The fast paths are the port's defaults (`mode="fast"`); the JAX package's
are the parity paths.  The host types (Dataset, Topology, Neighborhood,
CRandom) are the port's own (data/, utils/), re-exported here for callers.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..convert import codebook_to_torch, fixed_flat, samples_to_torch
from ..data.dataset import Dataset, Neighborhood, Topology
from ..data.streaming import streamed_samples
from ..ops import exact
from ..ops.dist_argmin import dist_argmin, dist_argmin_t
from ..ops.distance import fp32_matmul, keep_of
from ..ops.neighborhood import grid_distance_matrix
from ..utils.rng import CRandom
from .common import (ALPHA_LINEAR, alpha_schedule, effective_alpha, radius_schedule,
                     sample_order, scan_blocks)
from .fast import som_batch_step, unit_coords

__all__ = ["CRandom", "Dataset", "Neighborhood", "Topology", "find_eigenvectors",
           "find_qerror", "find_qerror2", "lininit", "randinit", "som_train",
           "vfind_codebooks", "vfind_trials"]

F32 = np.float32
FLT_MIN = np.float32(1.17549435e-38)
FLT_MAX = np.float32(3.4028235e38)

Device = Union[torch.device, str]


def _is_stream(data) -> bool:
    return hasattr(data, "_chunks_one_lap")  # a data.streaming.StreamingReader


# ---------------------------------------------------------------------------
# Initializers (host)
# ---------------------------------------------------------------------------

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


def find_eigenvectors(data: Dataset, rng: CRandom) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mean + two principal eigenvectors by the reference's 10-round
    power iteration with Gram-Schmidt (som_rout.c:211-345), float32 math
    (including the reference's mu carry-over quirk between the two
    eigenvalue estimates). Returns (mean, e1, e2) float32 (dim,)."""
    pts = data.points
    n = data.dim
    k = pts.shape[0]
    if k < 3:
        raise ValueError("find_eigenvectors: need at least 3 samples")
    if data.mask is not None:
        keep = data.mask == 0
    else:
        keep = np.ones_like(pts, dtype=bool)

    # mean: float32 accumulation in data order, / count
    m = np.zeros(n, dtype=F32)
    for row, krow in zip(pts, keep):
        m = np.where(krow, (m + row).astype(F32), m)
    k2 = keep.sum(axis=0)
    m = (m / k2.astype(F32)).astype(F32)

    # autocorrelation (upper triangle accumulated in float32, data order)
    r = np.zeros((n, n), dtype=F32)
    iu, ju = np.triu_indices(n)
    for row, krow in zip(pts, keep):
        d = (row - m).astype(F32)
        contrib = (d[iu] * d[ju]).astype(F32)
        ok = krow[iu] & krow[ju]
        upd = np.where(ok, (r[iu, ju] + contrib).astype(F32), r[iu, ju])
        r[iu, ju] = upd
    r_full = r.copy()
    r_full = (r_full / F32(k)).astype(F32)
    r_full[ju, iu] = r_full[iu, ju]
    r = r_full

    # two random start vectors from the LCG: orand()/16384.0 - 1.0
    u = np.empty((2, n), dtype=F32)
    mu = np.ones(2, dtype=F32)
    for i in range(2):
        draws = rng.orand_array(n).astype(np.float64)
        u[i] = (draws / 16384.0 - 1.0).astype(F32)
        u[i] = _normalize_f32(u[i])

    v = np.empty_like(u)
    for _ in range(10):
        for i in range(2):
            # v = mu_i * (R u_i) + u_i, float32 dot products per row
            dots = _dot_rows_f32(r, u[i])
            v[i] = (mu[i] * dots + u[i]).astype(F32)
        v = _gram_schmidt_f32(v)
        s = F32(0.0)
        for i in range(2):
            dots = _dot_rows_f32(r, v[i])
            contrib = np.abs((v[i] / dots).astype(np.float64))
            # C: float sum += fabs(...) accumulated sequentially
            for c in contrib:
                s = F32(s + c)
            mu[i] = F32(s / F32(n))
        u = v.copy()

    if mu[0] == 0.0 or mu[1] == 0.0:
        raise ValueError("find_eigenvectors: power iteration degenerated")
    e1 = (u[0].astype(np.float64) / math.sqrt(mu[0])).astype(F32)
    e2 = (u[1].astype(np.float64) / math.sqrt(mu[1])).astype(F32)
    return m, e1, e2


def _normalize_f32(v: np.ndarray) -> np.ndarray:
    s = F32(0.0)
    for x in v:
        s = F32(s + F32(x) * F32(x))
    s = F32(np.sqrt(np.float64(s)))
    return (v / s).astype(F32)


def _dot_rows_f32(r: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Per-row float32 sequential dot product (dotprod, som_rout.c:178-185)."""
    acc = np.zeros(r.shape[0], dtype=F32)
    for j in range(r.shape[1]):
        acc = (acc + r[:, j] * u[j]).astype(F32)
    return acc


def _gram_schmidt_f32(v: np.ndarray) -> np.ndarray:
    """gram_schmidt (som_rout.c:188-209), float32 op order."""
    e, n = v.shape
    w = np.zeros_like(v)
    for i in range(e):
        for t in range(n):
            s = F32(v[i, t])
            for j in range(i):
                # sum -= w[j,t] * sum_p w[j,p] * v[i,p], accumulated per p
                for p in range(n):
                    s = F32(s - F32(w[j, t]) * F32(w[j, p]) * F32(v[i, p]))
            w[i, t] = s
        w[i] = _normalize_f32(w[i])
    return w


def lininit(
    data: Dataset,
    topol: Topology,
    neigh: Neighborhood,
    xdim: int,
    ydim: int,
    rng: CRandom,
) -> Dataset:
    """Grid initialization along the two principal eigenvectors
    (lininit_codes, som_rout.c:347-429)."""
    m, e1, e2 = find_eigenvectors(data, rng)
    noc = xdim * ydim
    idx = np.arange(noc)
    # xf/yf are float variables in C (som_rout.c:352,412-414): the double
    # expression rounds to float32, and the combination below is all-float.
    xf = (4.0 * (idx % xdim).astype(F32).astype(np.float64) / (xdim - 1.0) - 2.0).astype(F32)
    yf = (4.0 * (idx // xdim).astype(F32).astype(np.float64) / (ydim - 1.0) - 2.0).astype(F32)
    pts = (
        (m[None, :] + xf[:, None] * e1[None, :]).astype(F32) + yf[:, None] * e2[None, :]
    ).astype(F32)
    return Dataset(points=pts, topol=topol, neigh=neigh, xdim=xdim, ydim=ydim)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def som_train(
    codes: Dataset,
    data,
    rlen: int,
    alpha: float,
    radius: float,
    alpha_type: str = ALPHA_LINEAR,
    random_order: bool = False,
    rng: Optional[CRandom] = None,
    use_weights: bool = False,
    use_fixed: bool = False,
    mode: str = "fast",
    snapshot=None,
    progress=None,
    buffer: int = 0,
    device: Device = "cuda",
) -> Dataset:
    """SOM training (som_training, som_rout.c:556-671;
    som_lvq_pak_tpu/models/som.py:202-264).

    mode='parity': host float32 path, bit-identical to the C package.
    mode='fast':   the online scan on `device`, one sample per step
                   (`_som_loop_fast`); the same order, schedules, weights,
                   masks and fixed winners, float32 results equal to the
                   parity path's to rounding.
    `snapshot`: optional callable (iteration, Dataset) -> None invoked
    every `snapshot.interval` steps (parity only, as in the JAX package);
    `progress`: the countdown hook (parity only).  `data` may be a
    StreamingReader: the bounded-memory parity path."""
    if not codes.is_map:
        raise ValueError("som_train: codebook is not a map (topol < hexa)")
    if _is_stream(data):
        return _som_train_streamed(
            codes, data, rlen, alpha, radius, alpha_type, random_order,
            rng, use_weights, use_fixed, mode, snapshot, progress)
    if codes.dim != data.dim:
        raise ValueError("code dimension != data dimension")
    order = sample_order(data.n, rlen, random_order, rng, buffer=buffer)
    talp = alpha_schedule(rlen, alpha, alpha_type)
    trad = radius_schedule(rlen, radius)
    # per-sample weighting folded into the schedule
    if use_weights and data.weight is not None:
        talp = effective_alpha(talp, data.weight[order], True)

    gd = grid_distance_matrix(Topology(codes.topol), codes.xdim, codes.ydim)
    gaussian = codes.neigh == Neighborhood.GAUSSIAN

    X = data.points
    M = data.mask
    fixed_bmu = (fixed_flat(data.fixed, codes.xdim)
                 if use_fixed and data.fixed is not None else None)

    if mode == "parity":
        new_pts = _som_loop_parity(
            codes.points.copy(), X, M, order, talp, trad, gd, gaussian, fixed_bmu,
            snapshot=snapshot, codes_meta=codes, progress=progress,
        )
    elif mode == "fast":
        new_pts = _som_loop_fast(
            codes.points, X, M, order, talp, trad, gd, gaussian, fixed_bmu, device
        )
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return replace(codes, points=new_pts, comments=[])


def _som_train_streamed(codes, reader, rlen, alpha, radius, alpha_type,
                        random_order, rng, use_weights, use_fixed, mode,
                        snapshot, progress):
    """Bounded-memory SOM training over a StreamingReader: the
    reference's buffered training loop (som_rout.c:556-671 over
    LOADMODE_BUFFER refills, datafile.c:237-344) — memory stays at
    ~buffer entries however large the file, and the sample order is
    index-identical to the full-load path's sample_order(...,
    buffer=B), so results are bit-equal to som_train(data, ...,
    buffer=B) (parity mode; the C package byte-contract)."""
    if mode != "parity":
        raise ValueError(
            "streamed som_train is the bounded-memory parity path; for "
            "fast device training over a stream use SOMTrainer.fit("
            "reader.chunks(laps=None), ...)")
    if codes.dim != reader.dim:
        raise ValueError("code dimension != data dimension")
    talp_all = alpha_schedule(rlen, alpha, alpha_type)
    trad = radius_schedule(rlen, radius)
    gd = grid_distance_matrix(Topology(codes.topol), codes.xdim, codes.ydim)
    gaussian = codes.neigh == Neighborhood.GAUSSIAN
    pts = codes.points.copy()
    le = 0
    for chunk, s in streamed_samples(reader, rlen, random_order, rng):
        if progress is not None:
            progress(rlen - le)
        x = chunk.points[s]
        xm = chunk.mask[s] if chunk.mask is not None else None
        a = talp_all[le]
        if use_weights and chunk.weight is not None:
            a = effective_alpha(np.asarray([a]), chunk.weight[s : s + 1],
                                True)[0]
        r = trad[le]
        bmu = -1
        if use_fixed and chunk.fixed is not None:
            fx, fy = int(chunk.fixed[s, 0]), int(chunk.fixed[s, 1])
            if fx >= 0 and fy >= 0:
                bmu = fy * codes.xdim + fx
        if bmu < 0:
            bmu, _ = exact.find_winner_euc(x, pts, xm)
        if bmu < 0:  # empty (all-masked) sample: skip teaching
            _maybe_snapshot(snapshot, le, pts, codes)
            le += 1
            continue
        d = gd[bmu]
        if gaussian:
            num = -(d * d)  # float32
            den = (2.0 * np.float64(r)) * np.float64(r)
            alp = (F32(a) * np.exp(num.astype(np.float64) / den).astype(F32)
                   ).astype(F32)
            upd = pts + alp[:, None] * (x - pts)
        else:
            sel = d <= r
            upd = np.where(sel[:, None], pts + F32(a) * (x - pts), pts)
        if xm is not None:
            upd = np.where(xm[None, :] != 0, pts, upd)
        pts = upd.astype(F32)
        _maybe_snapshot(snapshot, le, pts, codes)
        le += 1
    if progress is not None:
        progress(0)
    return replace(codes, points=pts, comments=[])


def _som_loop_parity(
    codes, X, M, order, talp, trad, gd, gaussian, fixed_bmu, snapshot=None,
    codes_meta=None, progress=None,
):
    rlen = order.shape[0]
    for le in range(rlen):
        if progress is not None:  # mprint hook (som_rout.c:660-661)
            progress(rlen - le)
        s = order[le]
        x = X[s]
        xm = M[s] if M is not None else None
        a = talp[le]
        r = trad[le]
        if fixed_bmu is not None and fixed_bmu[s] >= 0:
            bmu = int(fixed_bmu[s])
        else:
            bmu, _ = exact.find_winner_euc(x, codes, xm)
            if bmu < 0:  # empty (all-masked) sample: skip teaching
                _maybe_snapshot(snapshot, le, codes, codes_meta)
                continue
        d = gd[bmu]
        if gaussian:
            num = -(d * d)  # float32
            den = (2.0 * np.float64(r)) * np.float64(r)
            alp = (F32(a) * np.exp(num.astype(np.float64) / den).astype(F32)).astype(F32)
            upd = codes + alp[:, None] * (x - codes)
        else:
            sel = d <= r
            upd = np.where(sel[:, None], codes + F32(a) * (x - codes), codes)
        if xm is not None:
            upd = np.where(xm[None, :] != 0, codes, upd)
        codes = upd.astype(F32)
        _maybe_snapshot(snapshot, le, codes, codes_meta)
    if progress is not None:
        progress(0)
    return codes


def _maybe_snapshot(snapshot, le, codes, codes_meta):
    if snapshot is not None and le > 0 and (le % snapshot.interval) == 0:
        snapshot(le, replace(codes_meta, points=codes.copy(), comments=[]))


def _som_loop_fast(codes, X, M, order, talp, trad, gd, gaussian, fixed_bmu,
                   device: Device = "cuda"):
    """The online SOM of som_lvq_pak_tpu/models/som.py:377-418 on `device`:
    one sample per step, in `order`.  Each step's winner is `dist_argmin`
    of the one sample (K1 at B 1; K4 under a mask) unless the sample has a
    fixed winner; then every unit moves by alp (x - m), with alp = a exp(-g^2
    / (2 r^2)) (gaussian) or a [g <= r] (bubble) from the winner's row g of
    the grid-distance matrix, masked components untouched and a sample with
    every component masked teaching nothing.  The float32 expressions are
    the JAX scan's.

    The order, schedules, fixed winners and the whole (noc, noc) grid
    distance matrix are uploaded once (built on the host as the JAX scan
    builds it: 64 MiB at 64x64, 1 GiB at 128x128, 16 GiB at 256x256); no
    step fetches anything to the host, so the steps queue on the device
    without a synchronisation.  Each step is about a dozen launches: the
    scan is bound by launches, not by the card's arithmetic."""
    dev = torch.device(device)
    C = torch.tensor(np.asarray(codes, F32), device=dev)
    Xd = torch.from_numpy(np.ascontiguousarray(X, F32)).to(dev)
    Md = None if M is None else torch.from_numpy(np.ascontiguousarray(M)).to(dev)
    gdd = torch.from_numpy(gd).to(dev)
    order_d = torch.from_numpy(np.asarray(order, np.int64)).to(dev)
    talp_d = torch.from_numpy(np.asarray(talp, F32)).to(dev)
    trad_d = torch.from_numpy(np.asarray(trad, F32)).to(dev)
    fb = None if fixed_bmu is None else torch.from_numpy(fixed_bmu).to(dev)
    for (xs, ms, fbs), (a_blk, r_blk) in scan_blocks(order_d, (Xd, Md, fb),
                                                      (talp_d, trad_d)):
        if ms is not None:  # an empty (all-masked) sample teaches nothing
            a_blk = torch.where((ms != 0).all(dim=-1), 0.0, a_blk)
        den_blk = (2.0 * r_blk) * r_blk
        for j in range(xs.shape[0]):
            x = xs[j:j + 1]
            xm = None if ms is None else ms[j:j + 1]
            _, bmu = dist_argmin(x, C, mask=xm)
            if fbs is not None:
                f = fbs[j:j + 1]
                bmu = torch.where(f >= 0, f, bmu)
            grow = gdd.index_select(0, bmu)[0]
            a = a_blk[j:j + 1]
            if gaussian:
                alp = a * torch.exp(-(grow * grow) / den_blk[j:j + 1])
            else:
                alp = torch.where(grow <= r_blk[j:j + 1], a, 0.0)
            delta = (x - C).mul_(alp[:, None])
            if xm is not None:
                delta = torch.where(xm != 0, 0.0, delta)
            C.add_(delta)
    return C.cpu().numpy()


# ---------------------------------------------------------------------------
# Quantization error
# ---------------------------------------------------------------------------

def find_qerror(codes: Union[Dataset, torch.Tensor], data,
                mode: str = "fast", mask: Optional[torch.Tensor] = None,
                device: Device = "cuda") -> float:
    """Total quantization error, sum over samples of the distance to the
    winner (find_qerror, som_rout.c:678-731); divide by N for the
    per-sample figure.

    mode='parity': `_qerror_parity_accum` on the host, bit-equal to the
    C package (som_lvq_pak_tpu/models/som.py:454-469); `codes` a Dataset,
    `data` a Dataset or a StreamingReader, whose chunks continue the one
    float32 total.

    mode='fast': the path of `_find_qerror_fast`/`_qerror_whole_step`
    (som_lvq_pak_tpu/models/som.py:471-592): winners from one winner
    search over the whole array, then the winner's distance recomputed
    exactly in float32, square-rooted and summed on the device.  Unmasked
    data searches with `dist_argmin_t`; masked data with the masked
    `dist_argmin`, and then only the unmasked components count, so a sample
    with every component masked adds 0 (the reference skips it).

    In fast mode `codes` and `data` are host Datasets or tensors, or `data`
    is a data.streaming.StreamingReader: the codebook is then uploaded once
    and each chunk of one lap adds its sum to one float32 total on the
    device, fetched once at the end (som_lvq_pak_tpu/models/som.py:433-453);
    a masked chunk takes the masked winner search.  A Dataset's mask is its
    own; `mask` (N, D), nonzero = masked, goes with a `data` tensor.
    Tensors stay where they are (keep evaluation data resident as a
    tensor); a Dataset is copied to the other argument's device, or to
    `device` when no argument is a tensor ("cuda" unless the caller asks for
    "cpu"; without a GPU that raises)."""
    if mode == "parity":
        if not isinstance(codes, Dataset) or isinstance(data, torch.Tensor):
            raise TypeError("find_qerror(mode='parity') takes a host Dataset codebook "
                            "and a Dataset or StreamingReader")
        blocks = data.chunks(laps=1) if _is_stream(data) else [data]
        # the C loop rounds the total to float32 after every sample, so the
        # chunks continue one accumulation
        q = F32(0.0)
        for block in blocks:
            q = _qerror_parity_accum(q, codes, block)
        return float(q)
    if mode != "fast":
        raise ValueError(f"unknown mode {mode!r}")
    tensors = [t for t in (codes, data) if isinstance(t, torch.Tensor)]
    device = tensors[0].device if tensors else device
    M = codebook_to_torch(codes, device)[0] if isinstance(codes, Dataset) else codes
    if _is_stream(data):
        if mask is not None:
            raise ValueError("mask= goes with a data tensor; a stream's chunks "
                             "carry their own masks")
        total = torch.zeros((), dtype=torch.float32, device=M.device)
        for chunk in data.chunks(laps=1):
            X, mk = samples_to_torch(chunk, M.device)[:2]
            total = total + _qerror_sum(X, M, mk)
        return float(total)
    X, mask = _data_tensors(data, mask, M.device)
    return float(_qerror_sum(X, M, mask))


def _data_tensors(data, mask: Optional[torch.Tensor], device
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(X, mask) of a Dataset (copied to `device`) or of a data tensor and
    its `mask`, which must lie on `device`."""
    if isinstance(data, Dataset):
        if mask is not None:
            raise ValueError("mask= goes with a data tensor; a Dataset "
                             "carries its own mask")
        return tuple(samples_to_torch(data, device)[:2])
    if data.device != torch.device(device):
        raise ValueError(f"codes on {device}, data on {data.device}")
    return data, mask


def _qerror_parity_accum(q, codes: Dataset, data: Dataset):
    """Continue the C per-sample qerror accumulation (som_rout.c:704-722)
    from running float32 total `q` over `data`'s samples in file order."""
    for i in range(data.n):
        xm = data.mask[i] if data.mask is not None else None
        if xm is not None and xm.all():
            continue
        _, diff = exact.find_winner_euc(data.points[i], codes.points, xm)
        q = F32(np.float64(q) + np.sqrt(np.float64(diff)))
    return q


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


def find_qerror2(codes: Dataset, data, radius: float, mode: str = "fast",
                 mask: Optional[torch.Tensor] = None,
                 device: Device = "cuda") -> float:
    """Neighbourhood-weighted quantization error (-qetype 1;
    find_qerror2/bubble_qerror/gaussian_qerror, som_rout.c:734-891;
    som_lvq_pak_tpu/models/som.py:639-772): for each sample, the squared
    distances to every unit weighted by the winner's neighbourhood at
    `radius`, summed.

    mode='parity' replicates the C package's two-level float32
    accumulation bit for bit on the host (`codes` and `data` host Datasets,
    or `data` a StreamingReader).  mode='fast' is the device path
    (`_qerror2_total`); `data` a Dataset, a StreamingReader (each chunk's
    total fetched and the chunks summed in Python, as the JAX package sums
    them) or a tensor on `device` with its `mask`.  `codes` is a map
    Dataset: its geometry sets the weights."""
    if mode == "parity":
        if isinstance(data, torch.Tensor):
            raise TypeError("find_qerror2(mode='parity') takes a Dataset or a "
                            "StreamingReader")
        blocks = data.chunks(laps=1) if _is_stream(data) else [data]
        q = F32(0.0)
        for block in blocks:
            q = _qerror2_parity_accum(q, codes, block, radius)
        return float(q)
    if mode != "fast":
        raise ValueError(f"unknown mode {mode!r}")
    if isinstance(data, torch.Tensor):
        device = data.device
    M = codebook_to_torch(codes, device)[0]
    if _is_stream(data):
        if mask is not None:
            raise ValueError("mask= goes with a data tensor; a stream's chunks "
                             "carry their own masks")
        return sum(float(_qerror2_total(codes, M, *samples_to_torch(c, M.device)[:2],
                                        radius))
                   for c in data.chunks(laps=1))
    X, mask = _data_tensors(data, mask, M.device)
    return float(_qerror2_total(codes, M, X, mask, radius))


def _qerror2_parity_accum(q, codes: Dataset, data: Dataset, radius: float):
    """Continue the C qetype-1 accumulation (find_qerror2,
    som_rout.c:843-891) from running float32 total `q`."""
    gd = grid_distance_matrix(Topology(codes.topol), codes.xdim, codes.ydim)
    gaussian = codes.neigh == Neighborhood.GAUSSIAN
    for i in range(data.n):
        xm = data.mask[i] if data.mask is not None else None
        if xm is not None and xm.all():
            continue
        bmu, _ = exact.find_winner_euc(data.points[i], codes.points, xm)
        if bmu < 0:
            continue
        # distance() here is vector_dist_euc: float accum + double sqrt
        dvec = exact.pairwise_dist_euc(
            data.points[i : i + 1], codes.points,
            None if xm is None else xm[None, :], None,
        )[0]
        grow = gd[bmu]
        # C accumulates a per-sample float32 subtotal in bubble_qerror/
        # gaussian_qerror and adds it to the float32 total in find_qerror2
        # (som_rout.c:868-877) — two-level float32 accumulation.
        qs = F32(0.0)
        if gaussian:
            # C (som_rout.c:806-812): float alp = exp(double arg);
            # qerror += alp * d * d  — all float32 products and adds
            num = -(grow * grow)  # float32
            den = (2.0 * np.float64(F32(radius))) * np.float64(F32(radius))
            alp = np.exp(num.astype(np.float64) / den).astype(F32)
            contrib = ((alp * dvec) * dvec).astype(F32)
            for c_ in contrib:
                qs = F32(qs + c_)
        else:
            # C (som_rout.c:760-768): qerror += d*d in float32
            sel = grow <= F32(radius)
            contrib = (dvec * dvec).astype(F32)
            for j in np.nonzero(sel)[0]:
                qs = F32(qs + contrib[j])
        q = F32(q + qs)
    return q


# the fast qerror2's (B, noc) blocks hold at most this many entries
# (module-level so tests can take a chunk remainder at small sizes)
_QERROR2_ELEMS = 1 << 27


def _qerror2_total(codes: Dataset, M: torch.Tensor, X: torch.Tensor,
                   mask: Optional[torch.Tensor], radius: float) -> torch.Tensor:
    """The fast qerror2 of X's samples as a float32 device scalar
    (`_find_qerror2_fast`, som_lvq_pak_tpu/models/som.py:707-772).  Per
    chunk of max(8, min(N, 2^27 // noc)) samples (2048 at 256x256, a
    (2048, 65536) float32 block of 512 MiB; the chunk rule of the JAX
    package): the (B, noc) squared distances ||x||^2 - 2 x.m + ||m||^2 (over
    the unmasked components) by a float32 matmul, each sample's winner from
    `dist_argmin` (K1; K4 under a mask), the weights from the winner's
    scaled grid coordinates (`unit_coords`: gaussian exp(-g^2 / (2 r^2)),
    bubble g^2 <= r^2), sum(max(d^2, 0) w) per sample, and a sample with
    every component masked weighted 0.  Three (B, noc) blocks are live at
    a time.  A near-tie winner may differ from the argmin of the distance
    block; the bit-exact figure is mode='parity'."""
    fp32_matmul()
    dev = M.device
    gaussian = codes.neigh == Neighborhood.GAUSSIAN
    coords = unit_coords(codes.xdim, codes.ydim, codes.topol == Topology.HEXA, dev)
    ux, uy = coords[:, 0].contiguous(), coords[:, 1].contiguous()
    r = F32(radius)
    rr = float(r * r)
    # 2 r^2 as a device scalar: dividing by a host number takes its
    # reciprocal on CUDA, not the quotient
    den = torch.tensor(F32(F32(2.0) * r) * r, device=dev)
    m2 = (M * M).sum(-1)
    mm = None if mask is None else M * M
    n, noc = X.shape[0], M.shape[0]
    chunk = int(max(8, min(n, _QERROR2_ELEMS // max(1, noc))))
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        xs = X[s:s + chunk]
        xm = None if mask is None else mask[s:s + chunk]
        # ||x||^2 - 2 x.m + ||m||^2 in the JAX package's order, in place
        if xm is None:
            xk, c2 = xs, m2[None, :]
        else:
            keep = keep_of(xm)
            xk, c2 = xs * keep, keep @ mm.T
        d2 = (xk @ M.T).mul_(-2.0).add_((xk * xk).sum(-1, keepdim=True)).add_(c2)
        del c2
        _, bmu = dist_argmin(xs, M, mask=xm)
        gx = ux.index_select(0, bmu)[:, None] - ux[None, :]
        gy = uy.index_select(0, bmu)[:, None] - uy[None, :]
        gd2 = gx.mul_(gx).add_(gy.mul_(gy))
        del gy
        if gaussian:
            w = gd2.neg_().div_(den).exp_()
        else:
            w = (gd2 <= rr).to(torch.float32)
        part = d2.clamp_(min=0.0).mul_(w).sum(-1)
        del d2, gd2, w
        if xm is not None:
            part = part * (~(xm != 0).all(dim=-1)).to(torch.float32)
        total = total + part.sum()
    return total


# ---------------------------------------------------------------------------
# Best-of-N-trials search (vfind)
# ---------------------------------------------------------------------------

def vfind_codebooks(data: Dataset, trials: Sequence[int], topol: Topology,
                    neigh: Neighborhood, xdim: int, ydim: int, phases,
                    alpha_type: str = ALPHA_LINEAR, batch_size: int = 128,
                    device: Device = "cuda") -> List[torch.Tensor]:
    """The trained codebooks of `vfind_trials`, one (noc, D) tensor on
    `device` for each trial number in `trials` (in that order): each starts
    from `randinit` with `CRandom(trial)` and goes through `phases`
    ((length, alpha, radius) each) in minibatches of `batch_size` samples
    taken in file order by one cursor shared across phases, a phase's
    last short batch filled out with samples of alpha 0
    (som_lvq_pak_tpu/models/som.py:821-860).  Every batch takes one
    two-kernel step per trial (`models.fast.som_batch_step`: K1 then K5 on
    the card); the trials share nothing, so a trial's codebook does not
    depend on which other trials run beside it."""
    dev = torch.device(device)
    gaussian = neigh == Neighborhood.GAUSSIAN
    hexa = topol == Topology.HEXA
    Ms = [codebook_to_torch(randinit(data, topol, neigh, xdim, ydim, CRandom(t)), dev)[0]
          for t in trials]
    X = torch.from_numpy(np.ascontiguousarray(data.points, F32)).to(dev)
    n = data.n
    pos = 0  # sequential sample cursor across phases (reference file order)
    for length, alpha, radius in phases:
        if length <= 0:
            continue
        bs = max(1, min(batch_size, n))
        ar = torch.arange(bs, device=dev)
        # ceil division with a zero-alpha-padded final short batch: every
        # phase trains exactly `length` samples
        nb = -(-length // bs)
        talp = torch.from_numpy(alpha_schedule(length, alpha, alpha_type)[::bs][:nb]).to(dev)
        trad = radius_schedule(length, radius)[::bs][:nb]
        for b in range(nb):
            take = min(bs, length - b * bs)
            lo = pos % n
            xb = X[lo:lo + bs] if lo + bs <= n else X.index_select(0, (ar + lo) % n)
            pos += take
            a_b = talp[b]
            if take < bs:
                a_b = torch.where(ar < take, a_b, 0.0)
            for M in Ms:
                som_batch_step(M, xb, xdim, hexa, a_b, float(trad[b]), gaussian=gaussian)
    return Ms


def vfind_trials(
    data: Dataset,
    testdata: Dataset,
    ntrials: int,
    topol: Topology,
    neigh: Neighborhood,
    xdim: int,
    ydim: int,
    phases,
    alpha_type: str = ALPHA_LINEAR,
    qmode: int = 0,
    batch_size: int = 128,
    device: Device = "cuda",
) -> Tuple[Optional[Dataset], int, float, Dict[int, float]]:
    """Best-of-N-trials SOM search, the fast path of vfind (vfind.c:247-306;
    som_lvq_pak_tpu/models/som.py:779-877).  Trials are numbered down from
    `ntrials` and seeded by their number (`vfind_codebooks`); each trained
    map is scored on `testdata` by the fast `find_qerror2(radius=1.0)`
    (qmode > 0) or `find_qerror`, and the best is chosen by strict < in
    countdown order (the higher trial number wins an exact tie).

    `phases` is a sequence of (length, alpha, radius) training phases.
    Returns (best_codes, best_trial, best_qerror, {trial: qerror});
    ntrials <= 0 runs nothing and returns (None, 0, inf, {})."""
    if ntrials <= 0:
        # the reference's countdown loop never runs (vfind.c:247)
        return None, 0, float("inf"), {}
    trials = list(range(ntrials, 0, -1))
    Ms = vfind_codebooks(data, trials, topol, neigh, xdim, ydim, phases,
                         alpha_type, batch_size, device)
    Xt, mt = samples_to_torch(testdata, Ms[0].device)[:2]
    result = []
    for trial, M in zip(trials, Ms):
        cd = Dataset(points=M.cpu().numpy(), topol=topol, neigh=neigh,
                     xdim=xdim, ydim=ydim)
        if qmode > 0:
            q = float(_qerror2_total(cd, M, Xt, mt, 1.0))
        else:
            q = float(_qerror_sum(Xt, M, mt))
        result.append((trial, q, cd))
    best_trial, best_q, best_codes = result[0]
    for trial, q, cd in result[1:]:
        if q < best_q:
            best_trial, best_q, best_codes = trial, q, cd
    return best_codes, best_trial, best_q, {t: q for t, q, _ in result}
