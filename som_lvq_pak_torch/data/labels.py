"""Label interning: string <-> small integer ids.

The reference keeps one process-global string table; ids are assigned in
order of first appearance, starting at 1, with 0 reserved for the empty
label (labels.c:75-128, labels.h:25).  Pipelines that read several files
share the table, and some tools (balance's class bookkeeping) depend on
the id assignment order, so we keep the same process-global model with an
explicit reset for tests.

The port's copy of som_lvq_pak_tpu/data/labels.py.  The port keeps its own
table: labels cross between the packages as strings
(convert.as_port_dataset).
"""

from __future__ import annotations

from typing import List, Optional

LABEL_EMPTY = 0


class LabelTable:
    def __init__(self) -> None:
        self._labels: List[str] = []
        self._index = {}

    def to_index(self, lab: Optional[str]) -> int:
        """find_conv_to_ind (labels.c:75-113): intern, ids start at 1."""
        if lab is None or lab == "":
            return LABEL_EMPTY
        idx = self._index.get(lab)
        if idx is None:
            self._labels.append(lab)
            idx = len(self._labels)  # 1-based
            self._index[lab] = idx
        return idx

    def to_label(self, ind: int) -> Optional[str]:
        """find_conv_to_lab (labels.c:118-128). None for empty/unknown."""
        if ind == LABEL_EMPTY or ind < 0 or ind > len(self._labels):
            return None
        return self._labels[ind - 1]

    def number_of_labels(self) -> int:
        """Table size including the empty label (labels.c:130-134)."""
        return len(self._labels) + 1

    def reset(self) -> None:
        self._labels.clear()
        self._index.clear()


# Process-global table, mirroring the reference's globals in labels.c.
GLOBAL_LABELS = LabelTable()
