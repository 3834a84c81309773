"""Sammon projection to 2-D (sammon.c:100-247).

Newton-style iteration with MAGIC=0.2.  The C arithmetic mixes float and
double in load-bearing ways (e.g. `sqrt((double)xd*xd + yd*yd)` squares
xd in double but yd in float); the parity path reproduces each op's
precision and the k-sequential float32 accumulation exactly (vectorized
over j, sequential over k — same rounding as the C loops).

A batched fast path is trivial (the whole update is dense (noc, noc)
work) but noc is small for visualization, so parity is the default.

The port's copy of som_lvq_pak_tpu/models/sammon.py: `remove_identicals`,
`sammon_iterate`, `mapping_error` and `sammon` (:1-138) bit for bit (tests
hold the golden `sammon.sam` and `sammon_map.sam`); `sammon_fast`
(:141-203) is the same iteration in PyTorch on `device` ("cuda" unless the
caller asks for "cpu").  The JAX function is one jitted XLA body with no
Pallas kernel, so the port's is plain PyTorch on the device too.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..data.dataset import Dataset
from ..ops import exact
from ..utils.rng import CRandom

F32 = np.float32
F64 = np.float64
MAGIC = 0.2


def remove_identicals(codes: Dataset) -> Dataset:
    """Drop later entries at exactly zero distance from an earlier one
    (remove_identicals, sammon.c:84-128)."""
    d = exact.pairwise_dist_euc(codes.points, codes.points, codes.mask, codes.mask)
    n = codes.n
    keep = np.ones(n, dtype=bool)
    for i in range(n):
        if not keep[i]:
            continue
        dup = (d[i] == 0.0) & (np.arange(n) > i)
        keep[dup] = False
    return codes.take(np.nonzero(keep)[0])


def initial_layout(noc: int, rng: CRandom) -> Tuple[np.ndarray, np.ndarray]:
    """The starting layout of sammon_iterate (sammon.c:100-247), x =
    (orand() % noc)/noc and y = i/noc in float, drawn from `rng`."""
    draws = rng.orand_array(noc)
    x = ((draws % noc).astype(F32) / F32(noc)).astype(F32)
    y = (np.arange(noc, dtype=F32) / F32(noc)).astype(F32)
    return x, y


def sammon_iterate(
    codes: Dataset, length: int, rng: CRandom
) -> Dataset:
    """The projection loop (sammon_iterate, sammon.c:100-247)."""
    noc = codes.n
    x, y = initial_layout(noc, rng)

    # mutual distances (float accum + double sqrt, pair order irrelevant
    # since each is independent)
    dmat = exact.pairwise_dist_euc(codes.points, codes.points, codes.mask, codes.mask)
    jj = np.arange(noc)

    for _ in range(length):
        e1x = np.zeros(noc, dtype=F32)
        e1y = np.zeros(noc, dtype=F32)
        e2x = np.zeros(noc, dtype=F32)
        e2y = np.zeros(noc, dtype=F32)
        # vectorized over j, sequential over k (the C inner loop order)
        for k in range(noc):
            xd = (x - x[k]).astype(F32)
            yd = (y - y[k]).astype(F32)
            # C: dpj = (float) sqrt((double)xd*xd + yd*yd)
            #   -> xd^2 in double, yd^2 in float then promoted
            dpj = np.sqrt(xd.astype(F64) * xd.astype(F64)
                          + (yd * yd).astype(F32).astype(F64)).astype(F32)
            dt = dmat[:, k]
            dq = (dt - dpj).astype(F32)
            dr = (dt * dpj).astype(F32)
            with np.errstate(divide="ignore", invalid="ignore"):
                t1x = ((xd * dq).astype(F32) / dr).astype(F32)
                t1y = ((yd * dq).astype(F32) / dr).astype(F32)
                # C: (dq - xd*xd*(1.0 + dq/dpj)/dpj)/dr   (double math from
                # the 1.0 onward, accumulated into float)
                inner = 1.0 + (dq / dpj).astype(F32).astype(F64)
                t2x = (dq.astype(F64)
                       - (xd * xd).astype(F32).astype(F64) * inner / dpj.astype(F64)
                       ) / dr.astype(F64)
                t2y = (dq.astype(F64)
                       - (yd * yd).astype(F32).astype(F64) * inner / dpj.astype(F64)
                       ) / dr.astype(F64)
            sel = jj != k
            e1x = np.where(sel, (e1x + t1x).astype(F32), e1x)
            e1y = np.where(sel, (e1y + t1y).astype(F32), e1y)
            e2x = np.where(sel, (e2x + t2x).astype(F32), e2x)
            e2y = np.where(sel, (e2y + t2y).astype(F32), e2y)
        # xu = x + 0.2 * e1x / |e2x|   (double from the 0.2 onward)
        xu = (x.astype(F64) + MAGIC * e1x.astype(F64) / np.abs(e2x.astype(F64))).astype(F32)
        yu = (y.astype(F64) + MAGIC * e1y.astype(F64) / np.abs(e2y.astype(F64))).astype(F32)
        # center of mass (float32 sequential accumulation)
        xx = F32(np.cumsum(xu, dtype=F32)[-1] if noc else 0.0)
        yy = F32(np.cumsum(yu, dtype=F32)[-1] if noc else 0.0)
        xx = F32(xx / F32(noc))
        yy = F32(yy / F32(noc))
        x = (xu - xx).astype(F32)
        y = (yu - yy).astype(F32)

    pts = np.stack([x, y], axis=1).astype(F32)
    return Dataset(
        points=pts,
        labels=None if codes.labels is None else codes.labels.copy(),
        topol=codes.topol,
        neigh=codes.neigh,
        xdim=codes.xdim,
        ydim=codes.ydim,
    )


def mapping_error(proj: Dataset, dmat: np.ndarray) -> float:
    """Sammon stress (sammon.c:228-242), float32 accumulation in the
    C pair order (j from 1, k < j)."""
    x, y = proj.points[:, 0], proj.points[:, 1]
    e = F32(0.0)
    tot = F32(0.0)
    noc = proj.n
    for j in range(1, noc):
        for k in range(j):
            d = dmat[j, k]
            tot = F32(tot + d)
            xd = F32(x[j] - x[k])
            yd = F32(y[j] - y[k])
            dp = F32(np.sqrt(F64(xd) * F64(xd) + F64(F32(yd * yd))))
            ee = F32(d - dp)
            e = F32(e + F32(F32(ee * ee) / d))
    return float(F32(e / tot))


def sammon(
    codes: Dataset, length: int, rng: CRandom
) -> Tuple[Dataset, Dataset]:
    """Full sammon tool behavior: dedup + iterate.  Returns
    (projection, deduped_codes)."""
    deduped = remove_identicals(codes)
    return sammon_iterate(deduped, length, rng), deduped


def _pairwise_dist_euc_t(P: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """`exact.pairwise_dist_euc(P, P, mask, mask)` on P's device: the
    squared differences summed component by component in float32, each a
    separate elementwise op (no contraction), the root taken in float64 and
    rounded to float32, so the bits are the host function's."""
    n, dim = P.shape
    acc = torch.zeros((n, n), dtype=torch.float32, device=P.device)
    for i in range(dim):
        diff = P[:, None, i] - P[None, :, i]
        d2 = diff * diff
        if mask is not None:
            m = mask[:, i] != 0
            d2 = d2.masked_fill(m[:, None] | m[None, :], 0.0)
        acc = acc + d2
    return torch.sqrt(acc.double()).float()


def _identicals_kept(dmat: torch.Tensor) -> np.ndarray:
    """remove_identicals' keep flags from the device distance matrix: its
    row walk (a kept row drops every later row at distance 0) over the
    zero pairs only, fetched in row order."""
    n = dmat.shape[0]
    keep = np.ones(n, dtype=bool)
    pairs = torch.triu(dmat == 0, diagonal=1).nonzero().cpu().numpy()
    for i, j in pairs:
        if keep[i]:
            keep[j] = False
    return keep


def sammon_fast(
    codes: Dataset, length: int, seed: int = 1,
    device: Union[torch.device, str] = "cuda",
) -> Tuple[Dataset, Dataset]:
    """Device-speed Sammon projection (som_lvq_pak_tpu/models/sammon.py:
    141-203): the same MAGIC=0.2 Newton-style iteration vectorized over all
    (j, k) pairs, O(noc^2) tensor work per iteration on `device`, one host
    loop over the iterations.  The distance matrix and the removal of
    identical entries run on the device too (bit-equal to
    `exact.pairwise_dist_euc` and `remove_identicals`).  Results match the C
    algorithm's fixed points, not its float-ordering bit pattern (use
    sammon() for byte parity).  The initial layout draws the same LCG
    stream as the parity path.  Each iteration holds about ten (noc, noc)
    float32 temporaries (1 GiB each at 16,384 units)."""
    P = torch.from_numpy(codes.points).to(device)
    mask = None if codes.mask is None else torch.from_numpy(codes.mask).to(device)
    dmat = _pairwise_dist_euc_t(P, mask)
    keep = _identicals_kept(dmat)
    deduped = codes.take(np.nonzero(keep)[0])
    if not keep.all():
        idx = torch.from_numpy(np.nonzero(keep)[0]).to(device)
        dmat = dmat.index_select(0, idx).index_select(1, idx)
    del P, mask
    noc = deduped.n
    rng = CRandom()
    rng.init_random(seed)
    x0, y0 = initial_layout(noc, rng)
    eye = torch.eye(noc, dtype=torch.bool, device=dmat.device)

    def body(x, y):
        xd = x[None, :] - x[:, None]   # xd[k, j] = x_j - x_k
        yd = y[None, :] - y[:, None]
        dpj = torch.sqrt(xd * xd + yd * yd)
        dq = dmat - dpj
        dr = torch.where(eye, 1.0, dmat * dpj)
        safe_dpj = torch.where(dpj == 0, 1.0, dpj)
        del dpj
        inner = 1.0 + dq / safe_dpj
        e1x = torch.where(eye, 0.0, xd * dq / dr).sum(0)
        e1y = torch.where(eye, 0.0, yd * dq / dr).sum(0)
        e2x = torch.where(eye, 0.0, (dq - xd * xd * inner / safe_dpj) / dr).sum(0)
        e2y = torch.where(eye, 0.0, (dq - yd * yd * inner / safe_dpj) / dr).sum(0)
        xu = x + MAGIC * e1x / e2x.abs()
        yu = y + MAGIC * e1y / e2y.abs()
        return xu - xu.mean(), yu - yu.mean()

    x = torch.from_numpy(x0).to(dmat.device)
    y = torch.from_numpy(y0).to(dmat.device)
    for _ in range(length):
        x, y = body(x, y)
    pts = torch.stack([x, y], dim=1).cpu().numpy().astype(F32)
    proj = Dataset(
        points=pts,
        labels=None if deduped.labels is None else deduped.labels.copy(),
        topol=deduped.topol,
        neigh=deduped.neigh,
        xdim=deduped.xdim,
        ydim=deduped.ydim,
    )
    return proj, deduped
