"""Dense-array dataset container — the framework's universal data model.

Replaces the reference's linked-list `struct entries` / `struct data_entry`
(datafile.h:47-103, lvq_pak.h:73-113) with padded arrays:

    points  float32 (N, dim)   vector components (masked components are 0,
                               exactly as the reference stores them)
    mask    uint8   (N, dim)   1 = component masked off ('x' in the file)
    labels  int32   (N, L)     interned label ids, 0-padded (LABEL_EMPTY);
                               L = max labels on any one line
    weight  float32 (N,)       `weight=W` token, default 1.0
    fixed   int32   (N, 2)     `fixed=x,y` token, (-1,-1) when absent

plus the header metadata (dimension, topology, neighborhood, xdim/ydim).
Entry order is file order, which downstream parity paths depend on.

The port's copy of som_lvq_pak_tpu/data/dataset.py.  The port's Dataset is
a host NumPy object only; device tensors live in the trainer and the
evaluation (convert.py).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import List, Optional

import numpy as np


class Topology(enum.IntEnum):
    """Reference topol ids (lvq_pak.h:210-214)."""

    UNKNOWN = 0
    DATA = 1
    LVQ = 2
    HEXA = 3
    RECT = 4


class Neighborhood(enum.IntEnum):
    """Reference neigh ids (lvq_pak.h:217-219)."""

    UNKNOWN = 0
    BUBBLE = 1
    GAUSSIAN = 2


TOPOL_NAMES = {
    Topology.DATA: "data",
    Topology.LVQ: "lvq",
    Topology.HEXA: "hexa",
    Topology.RECT: "rect",
}
TOPOL_IDS = {v: k for k, v in TOPOL_NAMES.items()}
NEIGH_NAMES = {Neighborhood.BUBBLE: "bubble", Neighborhood.GAUSSIAN: "gaussian"}
NEIGH_IDS = {v: k for k, v in NEIGH_NAMES.items()}


@dataclass
class Dataset:
    points: np.ndarray  # float32 (N, dim)
    mask: Optional[np.ndarray] = None  # uint8 (N, dim); None = nothing masked
    labels: Optional[np.ndarray] = None  # int32 (N, L); None = unlabeled
    weight: Optional[np.ndarray] = None  # float32 (N,)
    fixed: Optional[np.ndarray] = None  # int32 (N, 2)
    topol: Topology = Topology.DATA
    neigh: Neighborhood = Neighborhood.UNKNOWN
    xdim: int = 0
    ydim: int = 0
    comments: List[str] = field(default_factory=list)

    def __post_init__(self):
        self.points = np.ascontiguousarray(self.points, dtype=np.float32)
        if self.points.ndim != 2:
            raise ValueError("points must be (N, dim)")
        if self.mask is not None:
            self.mask = np.ascontiguousarray(self.mask, dtype=np.uint8)
            if not self.mask.any():
                self.mask = None
        if self.labels is not None:
            self.labels = np.ascontiguousarray(self.labels, dtype=np.int32)
            if self.labels.ndim == 1:
                self.labels = self.labels[:, None]

    # --- basic properties -------------------------------------------------
    @property
    def n(self) -> int:
        return self.points.shape[0]

    def __len__(self) -> int:
        return self.n

    @property
    def dim(self) -> int:
        return self.points.shape[1]

    @property
    def noc(self) -> int:
        """Number of codebook vectors (alias used for codebooks)."""
        return self.n

    def label(self, i: int) -> int:
        """First label id of entry i (reference get_entry_label)."""
        if self.labels is None:
            return 0
        return int(self.labels[i, 0])

    def first_labels(self) -> np.ndarray:
        """(N,) first label id per entry; zeros if unlabeled."""
        if self.labels is None:
            return np.zeros(self.n, dtype=np.int32)
        return self.labels[:, 0]

    def mask_or_zeros(self) -> np.ndarray:
        if self.mask is None:
            return np.zeros_like(self.points, dtype=np.uint8)
        return self.mask

    def weights_or_ones(self) -> np.ndarray:
        """Effective per-sample weights: entries without a weight= token
        carry the sentinel 0.0 (datafile.c:497) and behave as weight 1."""
        if self.weight is None:
            return np.ones(self.n, dtype=np.float32)
        return np.where(self.weight > 0.0, self.weight, np.float32(1.0)).astype(
            np.float32
        )

    @property
    def is_map(self) -> bool:
        return self.topol >= Topology.HEXA

    # --- manipulation -----------------------------------------------------
    def take(self, idx) -> "Dataset":
        """New Dataset with rows selected/reordered by `idx`."""
        idx = np.asarray(idx)
        return replace(
            self,
            points=self.points[idx].copy(),
            mask=None if self.mask is None else self.mask[idx].copy(),
            labels=None if self.labels is None else self.labels[idx].copy(),
            weight=None if self.weight is None else self.weight[idx].copy(),
            fixed=None if self.fixed is None else self.fixed[idx].copy(),
            comments=[],
        )

    def like(self, points: np.ndarray, labels: Optional[np.ndarray] = None) -> "Dataset":
        """New Dataset sharing this one's header metadata (copy_entries)."""
        return Dataset(
            points=points,
            labels=labels,
            topol=self.topol,
            neigh=self.neigh,
            xdim=self.xdim,
            ydim=self.ydim,
        )

    def concat(self, other: "Dataset") -> "Dataset":
        def cat(a, b, fill, width=None):
            if a is None and b is None:
                return None
            n_a, n_b = self.n, other.n
            if a is None:
                a = np.full((n_a,) + b.shape[1:], fill, dtype=b.dtype)
            if b is None:
                b = np.full((n_b,) + a.shape[1:], fill, dtype=a.dtype)
            if a.ndim == 2 and a.shape[1] != b.shape[1]:
                w = max(a.shape[1], b.shape[1])
                a = np.pad(a, ((0, 0), (0, w - a.shape[1])), constant_values=fill)
                b = np.pad(b, ((0, 0), (0, w - b.shape[1])), constant_values=fill)
            return np.concatenate([a, b], axis=0)

        return replace(
            self,
            points=np.concatenate([self.points, other.points], axis=0),
            mask=cat(self.mask, other.mask, 0),
            labels=cat(self.labels, other.labels, 0),
            weight=cat(self.weight, other.weight, 1.0),
            fixed=cat(self.fixed, other.fixed, -1),
            comments=[],
        )

    def grid_coords(self) -> np.ndarray:
        """(noc, 2) int array of (x, y) unit coordinates in map order
        (unit index i lives at (i % xdim, i // xdim), som_rout.c:493-494)."""
        idx = np.arange(self.n)
        return np.stack([idx % self.xdim, idx // self.xdim], axis=1)
