"""The remaining toolbox: setlabel, elimin, vcal, visual, extract,
showlabs, and the mindist/stddev reports — the counterpart of
som_lvq_pak_tpu/models/tools.py (all of it).

Reference behavior: setlabel.c:41-96, elimin.c:51-130, vcal.c:45-167,
visual.c:48-155, extract.c:41-75, showlabs.c:36-56, mindist.c:57-106,
stddev.c:36-80.  `setlabel` and `elimin` take their k nearest neighbours
from ops.distance.pairwise_topk_mode: mode='fast' (the port's default;
K10 on `device` above SOMVQ_AUTO_TOPK_PAIRS pairs, the exact host path
below) or mode='parity' (the host at every size, as the JAX package's
default).  `vcal`, `visual` and the reports are host code in the JAX
package too (their winners come from ops.exact), copied so they stay
bit-equal to it.
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Union

import numpy as np
import torch

from ..data.dataset import Dataset
from ..data.labels import GLOBAL_LABELS, LABEL_EMPTY, LabelTable
from ..ops import exact
from ..ops.distance import pairwise_topk_mode
from ..utils.hitlist import Hitlist
from .lvq import class_nearest_stats, deviations

F32 = np.float32

Device = Union[torch.device, str]


def setlabel(codes: Dataset, data, knn: int = 5, mode: str = "fast",
             device: Device = "cuda") -> Dataset:
    """Relabel each codebook vector by kNN majority vote against the
    data (find_labels, setlabel.c:41-96 — note the codes query the data,
    with find_winner_knn tie semantics).

    `data` may be a data.streaming.StreamingReader: the codebook stays
    resident while the data streams refill-by-refill, each chunk's
    per-code top-k merged into the running k best by the C insertion
    key (distance asc, GLOBAL index desc) — per-pair distances don't
    depend on chunking, so the merged result is the full-load answer
    with bounded memory."""
    if knn < 1:
        knn = 1

    if hasattr(data, "_chunks_one_lap"):  # StreamingReader
        run_v = np.full((codes.n, knn), np.inf, dtype=np.float64)
        run_i = np.full((codes.n, knn), -1, dtype=np.int64)
        run_l = np.zeros((codes.n, knn), dtype=np.int32)
        base = 0
        for chunk in data.chunks(laps=1):
            k_c = min(knn, chunk.n)
            idx, val = pairwise_topk_mode(codes.points, chunk.points, k_c,
                                          codes.mask, mode=mode, device=device)
            labs = chunk.first_labels()[idx]              # (noc, k_c)
            gidx = idx.astype(np.int64) + base
            cand_v = np.concatenate([run_v, val.astype(np.float64)], axis=1)
            cand_i = np.concatenate([run_i, gidx], axis=1)
            cand_l = np.concatenate([run_l, labs], axis=1)
            # C insertion key across the whole data set: distance asc,
            # later (higher) GLOBAL index wins exact ties — lexsort with
            # the secondary key -index reproduces it per row
            order = np.lexsort((-cand_i, cand_v), axis=1)[:, :knn]
            run_v = np.take_along_axis(cand_v, order, axis=1)
            run_i = np.take_along_axis(cand_i, order, axis=1)
            run_l = np.take_along_axis(cand_l, order, axis=1)
            base += chunk.n
        new_labels = np.zeros(codes.n, dtype=np.int32)
        for i in range(codes.n):
            valid = run_i[i] >= 0
            hl = Hitlist.from_labels(run_l[i][valid])
            new_labels[i] = hl.head[0]
        return replace(codes, labels=new_labels[:, None], comments=[])

    idx, _ = pairwise_topk_mode(codes.points, data.points, knn, codes.mask,
                                mode=mode, device=device)
    dlabels = data.first_labels()
    new_labels = np.zeros(codes.n, dtype=np.int32)
    for i in range(codes.n):
        hl = Hitlist.from_labels(dlabels[idx[i]])
        new_labels[i] = hl.head[0]
    return replace(codes, labels=new_labels[:, None], comments=[])


def elimin(data: Dataset, knn: int = 5, mode: str = "fast",
           device: Device = "cuda") -> Dataset:
    """Drop data vectors misclassified by self-kNN: keep an entry only
    if strictly more of its k nearest neighbors (itself included) share
    its label (eliminate_codes, elimin.c:51-130; knn capped at 10)."""
    if knn > 10:
        knn = 10
    idx, _ = pairwise_topk_mode(data.points, data.points, knn, data.mask,
                                mode=mode, device=device)
    labels = data.first_labels()
    neigh = labels[idx]  # (N, knn)
    correct = (neigh == labels[:, None]).sum(axis=1)
    keep = correct > (knn - correct)
    return data.take(np.nonzero(keep)[0])


def vcal(
    codes: Dataset,
    data,
    numlabs: int = 1,
) -> Dataset:
    """Label each SOM unit by majority vote of the data samples whose
    BMU it is (find_labels, vcal.c:45-167).  numlabs = max labels per
    unit, 0 = all, in hitlist order.  Unlabeled samples are ignored;
    unit hit-less units end up with no labels.  `data` may be a
    StreamingReader.  (The JAX package's `parity=` argument does nothing
    there and has no counterpart.)"""
    if numlabs < 0:
        numlabs = 0
    hits = [Hitlist() for _ in range(codes.n)]
    if hasattr(data, "_chunks_one_lap"):  # StreamingReader (bounded RSS)
        for chunk in data.chunks(laps=1):
            _vcal_accum(hits, codes, chunk)
    else:
        _vcal_accum(hits, codes, data)
    width = max(1, max((len(h) if numlabs == 0 else min(len(h), numlabs)) for h in hits))
    labs = np.zeros((codes.n, width), dtype=np.int32)
    for u, h in enumerate(hits):
        items = h.items()
        n = len(items) if numlabs == 0 else min(len(items), numlabs)
        for k in range(n):
            labs[u, k] = items[k][0]
    return replace(codes, labels=labs, comments=[])


def _vcal_accum(hits, codes: Dataset, data: Dataset) -> None:
    """Fold one data block's BMU hits into the per-unit hitlists
    (the streamable inner loop of find_labels, vcal.c:45-167)."""
    d = exact.pairwise_sq_distances(data.points, codes.points, data.mask)
    bmu = d.argmin(axis=1)
    if data.mask is not None:
        valid = ~data.mask.all(axis=1)
    else:
        valid = np.ones(data.n, dtype=bool)
    dlabels = data.first_labels()
    for i in range(data.n):
        if valid[i] and dlabels[i] != LABEL_EMPTY:
            hits[int(bmu[i])].add_hit(int(dlabels[i]))


def visual(
    codes: Dataset,
    data: Dataset,
    labels: Optional[LabelTable] = None,
) -> Dataset:
    """Map each sample to `bx by sqrt(qerr)` with the winner's labels
    (compute_visual_data, visual.c:48-155).  All-masked samples (loaded
    with -noskip) become `-1 -1 -1` labeled EMPTY_LINE."""
    table = labels if labels is not None else GLOBAL_LABELS
    emptylab = table.to_index("EMPTY_LINE")
    pts = np.zeros((data.n, 3), dtype=F32)
    width = codes.labels.shape[1] if codes.labels is not None else 1
    labs = np.zeros((data.n, width), dtype=np.int32)
    for i in range(data.n):
        xm = data.mask[i] if data.mask is not None else None
        if xm is not None and xm.all():
            pts[i] = (-1.0, -1.0, -1.0)
            labs[i, 0] = emptylab
            continue
        w, diff = exact.find_winner_euc(data.points[i], codes.points, xm)
        pts[i, 0] = F32(w % codes.xdim)
        pts[i, 1] = F32(w // codes.xdim)
        pts[i, 2] = F32(np.sqrt(np.float64(diff)))
        if codes.labels is not None:
            labs[i] = codes.labels[w]
    return Dataset(
        points=pts,
        labels=labs,
        topol=codes.topol,
        neigh=codes.neigh,
        xdim=codes.xdim,
        ydim=codes.ydim,
    )


def extract(data: Dataset, label: int) -> Dataset:
    """Entries of one class (extract_codes, extract.c:41-75)."""
    keep = data.first_labels() == label
    return data.take(np.nonzero(keep)[0])


def showlabs(data: Dataset, labels: Optional[LabelTable] = None) -> str:
    """Class histogram report (labels(), showlabs.c:36-56)."""
    table = labels if labels is not None else GLOBAL_LABELS
    hl = Hitlist.from_labels(data.first_labels())
    lines = []
    for lab, freq in hl.items():
        lines.append("In class %s are %d units" % (table.to_label(lab), freq))
    return "\n".join(lines) + "\n"


def mindist_report(
    codes: Dataset,
    data: Optional[Dataset] = None,
    labels: Optional[LabelTable] = None,
) -> str:
    """Per-class median shortest same-class distance (+ stddev of the
    data when given), mindist.c:57-106.  NOTE: the reference crashes
    when -din contains labels absent from the codebook (deviations()
    indexes past its class table); we skip unknown labels instead."""
    table = labels if labels is not None else GLOBAL_LABELS
    cls_labels, dists, noe = class_nearest_stats(codes, median=True)
    devs = None
    if data is not None:
        devs = _safe_deviations(data, cls_labels)
    lines = []
    for i, lab in enumerate(cls_labels):
        line = "In class %9s %3d units, min dist.: %6.3f" % (
            table.to_label(lab), noe[i], dists[i],
        )
        if devs is not None:
            line += ", stand. dev.: %6.3f " % devs[i]
        lines.append(line)
    return "\n".join(lines) + "\n"


def stddev_report(data: Dataset, labels: Optional[LabelTable] = None) -> str:
    """Per-class median distance + RMS deviation (stddev.c:36-80)."""
    table = labels if labels is not None else GLOBAL_LABELS
    cls_labels, dists, noe = class_nearest_stats(data, median=True)
    devs = deviations(data, cls_labels, noe)
    lines = []
    for i, lab in enumerate(cls_labels):
        lines.append(
            "In class %9s %3d units, med dist.: %6.3f, stand. dev.: %6.3f "
            % (table.to_label(lab), noe[i], dists[i], devs[i])
        )
    return "\n".join(lines) + "\n"


def _safe_deviations(data: Dataset, cls_labels: List[int]) -> np.ndarray:
    mask = np.isin(data.first_labels(), cls_labels)
    sub = data.take(np.nonzero(mask)[0])
    sub_labels = sub.first_labels()
    noe = np.asarray(
        [max(1, int((sub_labels == l).sum())) for l in cls_labels], dtype=np.int64
    )
    return deviations(sub, cls_labels, noe)
