"""Ordered label-frequency lists with the reference's exact ordering rules.

The reference keeps (label, freq) pairs in a doubly-linked list sorted by
frequency, promoting an entry past its predecessor only when its count
becomes *strictly* greater (labels.c:278-443).  The resulting order — and
in particular the head element used for majority votes in correct_by_knn,
setlabel, vcal and cmatr — therefore breaks frequency ties by *which label
reached the shared count first*.

We replicate the list semantics exactly (cheap host work), and also expose
the closed-form tie-break used by the vectorized device paths:
the winner is the label with (max count, then smallest index of its final
occurrence) — proven equivalent to the linked-list promotion rule.

The port's copy of som_lvq_pak_tpu/utils/hitlist.py (NumPy only); tests
hold the two equal.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np


class Hitlist:
    """Exact replica of reference hitlist behavior (labels.c:278-443)."""

    def __init__(self) -> None:
        # list of [label, freq], maintained in reference order
        self._items: List[List[int]] = []

    def __len__(self) -> int:
        return len(self._items)

    @property
    def entries(self) -> int:
        return len(self._items)

    def add_hit(self, label: int) -> int:
        items = self._items
        pos = None
        for i, it in enumerate(items):
            if it[0] == label:
                pos = i
                break
        if pos is None:
            items.append([label, 1])
            return 1
        items[pos][1] += 1
        freq = items[pos][1]
        # bubble towards the head while strictly greater than predecessor
        while pos > 0 and items[pos - 1][1] < freq:
            items[pos - 1], items[pos] = items[pos], items[pos - 1]
            pos -= 1
        return freq

    def find_hit(self, label: int) -> Optional[List[int]]:
        for it in self._items:
            if it[0] == label:
                return it
        return None

    def label_freq(self, label: int) -> int:
        it = self.find_hit(label)
        return it[1] if it else 0

    @property
    def head(self) -> Optional[Tuple[int, int]]:
        return tuple(self._items[0]) if self._items else None

    def items(self) -> List[Tuple[int, int]]:
        return [tuple(it) for it in self._items]

    @classmethod
    def from_labels(cls, labels: Iterable[int]) -> "Hitlist":
        hl = cls()
        for lab in labels:
            hl.add_hit(int(lab))
        return hl


def majority_label(labels: np.ndarray) -> int:
    """Head label of a hitlist fed `labels` in order, in closed form.

    Equivalent to Hitlist.from_labels(labels).head[0]: maximum count wins;
    count ties are broken by the smaller index of the label's *last*
    occurrence in the sequence (the label that reached the tied count
    first stays ahead because promotion requires strictly-greater freq).
    """
    labels = np.asarray(labels)
    if labels.size == 0:
        raise ValueError("majority_label of empty sequence")
    uniq, last_idx, counts = _label_stats(labels)
    order = np.lexsort((last_idx, -counts))  # count desc, then last_idx asc
    return int(uniq[order[0]])


def _label_stats(labels: np.ndarray):
    uniq = []
    counts = []
    last_idx = []
    for i, lab in enumerate(labels.tolist()):
        try:
            k = uniq.index(lab)
        except ValueError:
            uniq.append(lab)
            counts.append(1)
            last_idx.append(i)
        else:
            counts[k] += 1
            last_idx[k] = i
    return np.asarray(uniq), np.asarray(last_idx), np.asarray(counts)


def majority_label_matrix(neighbor_labels: np.ndarray, num_labels: int) -> np.ndarray:
    """Vectorized majority vote over rows of (B, k) neighbor labels.

    Returns (B,) winning label per row using the hitlist head rule:
    (count desc, last-occurrence index asc).  `num_labels` is the size of
    the label id space (ids are small intern-table indices).
    """
    B, k = neighbor_labels.shape
    onehot = neighbor_labels[..., None] == np.arange(num_labels)[None, None, :]
    counts = onehot.sum(axis=1)  # (B, num_labels)
    pos = np.arange(k)[None, :, None]
    last = np.where(onehot, pos, -1).max(axis=1)  # (B, num_labels); -1 if absent
    # score: maximize count, then minimize last occurrence
    score = counts.astype(np.int64) * (k + 1) + (k - last)
    score = np.where(counts > 0, score, -1)
    return score.argmax(axis=1)
