"""1-NN evaluation: `accuracy` and `classify` — the counterparts of
som_lvq_pak_tpu/models/eval.py:25-116.

Reference behaviour: accuracy.c:39-137, classify.c:41-95.  With
parity=False (the port's default) each sample's winner comes from one
`dist_argmin` over the data on `device` (K1, or K4 for masked data): full
float32 and the first index on ties, as the JAX package's XLA
`find_winners`.  With parity=True (the JAX package's default) the winners
come from the host's C-order float32 distances (ops.exact), bit-equal to
the JAX package's and needing no device.  The report text is
byte-identical to the JAX package's for the same winners; its per-class
lines keep the reference's hitlist order (utils.hitlist), computed here in
closed form.

Data and codebook labels are compared as ids, so both must come from one
label table (see convert.labeled_samples_to_torch).

Not ported yet: `knn_accuracy`, `confusion_matrix` and `mcnemar`.
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


def accuracy(data, codes: Dataset, labels: Optional[LabelTable] = None,
             parity: bool = False, device: Device = "cuda"
             ) -> Tuple[float, str, np.ndarray]:
    """1-NN recognition accuracy (compute_accuracy, accuracy.c:39-137).

    Returns (total_percent, report_text, per_sample_correct uint8), the
    last the -cfout stream.  `data` is a Dataset or a
    data.streaming.StreamingReader, evaluated chunk by chunk (the same
    tallies and report).  parity=True runs on the host, without `device`."""
    table = labels if labels is not None else GLOBAL_LABELS
    blocks = data.chunks(laps=1) if hasattr(data, "_chunks_one_lap") else [data]
    parts_lab: List[np.ndarray] = []
    parts_ok: List[np.ndarray] = []
    for block in blocks:
        cl = block.first_labels()
        parts_lab.append(cl)
        parts_ok.append((_winner_labels(block, codes, parity, device) == cl).astype(np.uint8))
    dlabels = np.concatenate(parts_lab) if parts_lab else np.zeros((0,), np.int32)
    ok = np.concatenate(parts_ok) if parts_ok else np.zeros((0,), np.uint8)
    total = int(dlabels.shape[0])

    stotal = int(ok.sum())
    lines = ["", "Recognition accuracy:", ""]
    for lab in hitlist_order(dlabels).tolist():
        mine = dlabels == lab
        tot, res = int(mine.sum()), int(ok[mine].sum())
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
