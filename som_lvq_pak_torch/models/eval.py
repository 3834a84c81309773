"""Evaluation tools: `accuracy`, `classify`, `knn_accuracy`,
`confusion_matrix` and `mcnemar` — the counterparts of
som_lvq_pak_tpu/models/eval.py (all of it).

Reference behaviour: accuracy.c:39-137, classify.c:41-95,
knntest.c:41-157, cmatr.c:41-170, mcnemar.c:43-132.  With parity=False
(the port's default) each sample's 1-NN winner comes from one
`dist_argmin` over the data on `device` (K1, or K4 for masked data): full
float32 and the first index on ties, as the JAX package's XLA
`find_winners`.  With parity=True (the JAX package's default) the winners
come from the host's C-order float32 distances (ops.exact), bit-equal to
the JAX package's and needing no device.  `knn_accuracy` takes its k
nearest codes from ops.distance.pairwise_topk_mode: mode='fast' (the
port's default; K10 on the device above SOMVQ_AUTO_TOPK_PAIRS pairs, the
exact host path below) or mode='parity' (the host at every size).  The
report text is byte-identical to the JAX package's for the same winners;
its per-class lines keep the reference's hitlist order (utils.hitlist),
computed here in closed form (`hitlist_order`), as are the tallies.

Data and codebook labels are compared as ids, so both must come from one
label table (see convert.labeled_samples_to_torch).
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..convert import codebook_to_torch, samples_to_torch
from ..data.dataset import Dataset
from ..data.labels import GLOBAL_LABELS, LabelTable
from ..ops import exact
from ..ops.dist_argmin import dist_argmin
from ..ops.distance import pairwise_topk_mode
from ..utils.hitlist import majority_label_matrix

Device = Union[torch.device, str]


def _winner_labels(data: Dataset, codes: Dataset, parity: bool,
                   device: Device) -> np.ndarray:
    """(N,) first label of each sample's 1-NN code (ties: first index):
    on the host in C order (parity), else by `dist_argmin` on `device`."""
    if parity:
        d = exact.pairwise_sq_distances(data.points, codes.points, data.mask)
        return codes.first_labels()[d.argmin(axis=1)]
    x, mask = samples_to_torch(data, device)[:2]
    _, idx = dist_argmin(x, codebook_to_torch(codes, device)[0], mask=mask)
    return codes.first_labels()[idx.cpu().numpy()]


def hitlist_order(labels: np.ndarray) -> np.ndarray:
    """The distinct labels of a sequence in the order a Hitlist fed it
    holds them (labels.c:278-443): count descending, equal counts by the
    position of the label's last occurrence (where it reached its count)."""
    labels = np.asarray(labels)
    if labels.size == 0:
        return labels[:0]
    uniq, inv, counts = np.unique(labels, return_inverse=True, return_counts=True)
    last = np.zeros(uniq.size, np.int64)
    last[inv] = np.arange(labels.size)  # the last write of each label wins
    return uniq[np.lexsort((last, -counts))]


def _blocks(data):
    """A Dataset, or the chunks of one lap of a StreamingReader."""
    return data.chunks(laps=1) if hasattr(data, "_chunks_one_lap") else [data]


def _class_lines(dlabels: np.ndarray, ok: np.ndarray):
    """(label, entries, correct) per class of `dlabels`, in hitlist order."""
    for lab in hitlist_order(dlabels).tolist():
        mine = dlabels == lab
        yield lab, int(mine.sum()), int(ok[mine].sum())


def accuracy(data, codes: Dataset, labels: Optional[LabelTable] = None,
             parity: bool = False, device: Device = "cuda"
             ) -> Tuple[float, str, np.ndarray]:
    """1-NN recognition accuracy (compute_accuracy, accuracy.c:39-137).

    Returns (total_percent, report_text, per_sample_correct uint8), the
    last the -cfout stream.  `data` is a Dataset or a
    data.streaming.StreamingReader, evaluated chunk by chunk (the same
    tallies and report).  parity=True runs on the host, without `device`."""
    table = labels if labels is not None else GLOBAL_LABELS
    parts_lab: List[np.ndarray] = []
    parts_ok: List[np.ndarray] = []
    for block in _blocks(data):
        cl = block.first_labels()
        parts_lab.append(cl)
        parts_ok.append((_winner_labels(block, codes, parity, device) == cl).astype(np.uint8))
    dlabels = np.concatenate(parts_lab) if parts_lab else np.zeros((0,), np.int32)
    ok = np.concatenate(parts_ok) if parts_ok else np.zeros((0,), np.uint8)
    total = int(dlabels.shape[0])

    stotal = int(ok.sum())
    lines = ["", "Recognition accuracy:", ""]
    for lab, tot, res in _class_lines(dlabels, ok):
        lines.append("%9s: %4d entries %6.2f %%"
                     % (table.to_label(lab), tot, 100.0 * np.float32(res) / tot))
    lines.append("")
    lines.append("Total accuracy: %5d entries %6.2f %%"
                 % (total, 100.0 * np.float32(stotal) / total))
    lines.append("")
    pct = 100.0 * stotal / total
    return pct, "\n".join(lines) + "\n", ok


def classify(data: Dataset, codes: Dataset, labels: Optional[LabelTable] = None,
             parity: bool = False, device: Device = "cuda"
             ) -> Tuple[Dataset, List[str]]:
    """Label every sample with its 1-NN code's label
    (compute_classifications, classify.c:41-95); a sample with every
    component masked gets "# empty datavector".  Returns the relabelled
    Dataset and the -cfout label strings.  parity=True runs on the host,
    without `device`."""
    table = labels if labels is not None else GLOBAL_LABELS
    wlabels = _winner_labels(data, codes, parity, device).astype(np.int32)
    if data.mask is not None:
        empty = data.mask.all(axis=1)
        if empty.any():
            wlabels = np.where(empty, table.to_index("# empty datavector"), wlabels)
    out = replace(data, labels=wlabels[:, None].copy(), comments=[])
    names = [table.to_label(int(l)) or "" for l in wlabels]
    return out, names


def knn_accuracy(data, codes: Dataset, knn: int = 5,
                 labels: Optional[LabelTable] = None, mode: str = "fast",
                 device: Device = "cuda") -> Tuple[float, str]:
    """k-NN majority-vote accuracy (compute_knnaccuracy, knntest.c:41-157):
    each sample's knn nearest codes in the reference tie order, their
    labels' hitlist head its vote.  Returns (total_percent, report_text).
    `data` is a Dataset or a StreamingReader, evaluated chunk by chunk.
    mode='parity' runs on the host, without `device`."""
    table = labels if labels is not None else GLOBAL_LABELS
    if knn < 1:
        knn = 1
    clabels = codes.first_labels()
    parts_lab: List[np.ndarray] = []
    parts_ok: List[np.ndarray] = []
    for block in _blocks(data):
        idx, _ = pairwise_topk_mode(block.points, codes.points, knn, block.mask,
                                    mode=mode, device=device)
        dl = block.first_labels()
        num = int(max(clabels.max(initial=0), dl.max(initial=0))) + 1
        parts_lab.append(dl)
        parts_ok.append(majority_label_matrix(clabels[idx], num) == dl)
    dlabels = np.concatenate(parts_lab) if parts_lab else np.zeros((0,), np.int32)
    ok = np.concatenate(parts_ok) if parts_ok else np.zeros((0,), bool)
    total = int(dlabels.shape[0])
    stotal = int(ok.sum())

    lines = ["", "Recognition accuracy:", ""]
    for lab, tot, res in _class_lines(dlabels, ok):
        lines.append("%14s: %6.2f %%" % (table.to_label(lab), 100.0 * np.float32(res) / tot))
    lines.append("")
    lines.append("Total accuracy: %6.2f %%" % (100.0 * np.float32(stotal) / total))
    lines.append("")
    return 100.0 * stotal / total, "\n".join(lines) + "\n"


def confusion_matrix(data, codes: Dataset, labels: Optional[LabelTable] = None,
                     parity: bool = False, device: Device = "cuda"
                     ) -> Tuple[str, np.ndarray, np.ndarray]:
    """Confusion matrix by the 1-NN rule (compute_cmatr, cmatr.c:41-170),
    over the samples not entirely masked.  Returns (report, matrix,
    per_sample_correct): the matrix (classes x classes, hitlist order of
    the data labels, rows the data label, columns the winner's), the last
    the -cfout 0/1 stream over those samples (cmatr.c:96-106).  `data` is a
    Dataset or a StreamingReader.  parity=True runs on the host, without
    `device`."""
    table = labels if labels is not None else GLOBAL_LABELS
    parts_d: List[np.ndarray] = []
    parts_w: List[np.ndarray] = []
    for block in _blocks(data):
        wl = _winner_labels(block, codes, parity, device)
        valid = (~block.mask.all(axis=1) if block.mask is not None
                 else np.ones(block.n, dtype=bool))
        parts_d.append(block.first_labels()[valid])
        parts_w.append(wl[valid])
    dlabels = np.concatenate(parts_d) if parts_d else np.zeros((0,), np.int32)
    wlabels = np.concatenate(parts_w) if parts_w else np.zeros((0,), np.int32)
    ok = (dlabels == wlabels).astype(np.uint8)
    total = int(dlabels.shape[0])
    stotal = int(ok.sum())

    lines = ["", "Recognition accuracy:", ""]
    for lab, tot, res in _class_lines(dlabels, ok):
        lines.append("%9s: %4d entries %6.2f %%"
                     % (table.to_label(lab), tot, 100.0 * np.float32(res) / tot))
    lines.append("")
    lines.append("Total accuracy: %5d entries %6.2f %%"
                 % (total, 100.0 * np.float32(stotal) / total))
    lines.append("")
    lines.append("Confusion matrix:")
    lines.append("")
    order = hitlist_order(dlabels).tolist()
    lines.append("          " + "".join(" %4s" % table.to_label(lab) for lab in order))
    lines.append("")
    mat = np.zeros((len(order), len(order)), dtype=np.int64)
    for i, li in enumerate(order):
        row = "%9s: " % table.to_label(li)
        mine = wlabels[dlabels == li]
        for j, lj in enumerate(order):
            mat[i, j] = int((mine == lj).sum())
            row += "%4d " % mat[i, j]
        lines.append(row)
    lines.append("")
    return "\n".join(lines) + "\n", mat, ok


MCNEMAR_ALPHA = (0.05, 0.025, 0.01, 0.005)
MCNEMAR_CHI_SQ = (3.84, 5.02, 6.63, 7.88)


def mcnemar(c1: np.ndarray, c2: np.ndarray) -> str:
    """McNemar chi^2 significance between two 0/1 classification streams
    (mcnemar.c:43-132). Returns the report text."""
    c1 = np.asarray(c1, dtype=np.int64)
    c2 = np.asarray(c2, dtype=np.int64)
    if c1.shape != c2.shape:
        raise ValueError("Unequal numbers of classifications in files.")
    if not (np.isin(c1, (0, 1)).all() and np.isin(c2, (0, 1)).all()):
        raise ValueError("Files contain other than 0's and 1's.")
    tbl = np.zeros((2, 2), dtype=np.int64)
    for a, b in zip(1 - c1, 1 - c2):
        tbl[a, b] += 1
    cnt = tbl[0, 1] + tbl[1, 0]
    lines = []
    if cnt:
        lines.append("")
        lines.append("Statistics of the results of the two classifiers:")
        lines.append("             1st correct,  1st errors")
        lines.append("2nd correct:      %6d       %6d" % (tbl[0, 0], tbl[1, 0]))
        lines.append("2nd errors:       %6d       %6d" % (tbl[0, 1], tbl[1, 1]))
        tmp = float(tbl[0, 1] - tbl[1, 0])
        testv = tmp * tmp / cnt
        sig = -1
        for i in range(3, -1, -1):
            if testv > MCNEMAR_CHI_SQ[i]:
                sig = i
                break
        lines.append("")
        if sig >= 0:
            lines.append(
                "Test statistics (%.3f) is significant at risk level %.3f"
                % (testv, MCNEMAR_ALPHA[sig])
            )
            lines.append("The classifiers are significantly different!")
        else:
            lines.append("Test statistics (%.3f) is not significant!" % testv)
            lines.append("The classifiers are not significantly different!")
    else:
        lines.append("")
        lines.append("Recognition result files are equal!")
    return "\n".join(lines) + "\n"
