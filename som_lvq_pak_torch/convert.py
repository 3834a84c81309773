"""Host `Dataset`s and device tensors.

    codes, meta = codebook_to_torch(ds)           # (noc, D) float32, on CUDA
    ds2 = to_dataset(codes, meta)                 # back to a host Dataset
    x, mask, weight, fixed = samples_to_torch(ds, "cuda", xdim,
                                              use_weights, use_fixed)
    ds3 = as_port_dataset(other)                  # any Dataset-like object

    kw = class_blocked_state(jax_blocked_olvq1)   # ClassBlockedOLVQ1(mesh, **kw)

The device is CUDA unless the caller names another ("cpu" runs the plain
versions).  `meta` is the Dataset with its points emptied: it carries the
header (topology, neighbourhood, xdim, ydim), labels, masks and comments.
The port's checkpoints have the JAX package's `Checkpointer`/`TrainState`
file format, so codebooks cross between the packages through files, and
in memory through `as_port_dataset`.  Mesh runs of either package
checkpoint the whole codebook in that format, so a checkpoint written by a
JAX mesh run, a port mesh run or a single device resumes on any mesh (the
trainers take their rows of it).

A data set's per-sample extras travel as: mask (N, D) uint8, nonzero =
masked; weight (N,) float32, the `weight=` token (0.0 = no token); fixed
(N,) int32, the `fixed=x,y` token as a flat unit index y * xdim + x, -1
where absent (SOMTrainer.fit's fixed_flat, trainer.py:179-186).  Each is
None where the data set has none or the caller does not use it.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Tuple

import numpy as np
import torch

from .data.dataset import Dataset, Neighborhood, Topology
from .data.labels import GLOBAL_LABELS, LabelTable


def as_port_dataset(ds, labels: Optional[LabelTable] = None,
                    source_labels=None) -> Dataset:
    """The port's Dataset with the fields of `ds`, any object that has the
    Dataset's fields (NumPy arrays, int topology and neighbourhood ids,
    int32 label ids), such as the JAX package's Dataset.  Label ids are
    carried across as strings: each nonzero id is named by
    `source_labels.to_label(id)` (the source's label table) and interned
    again in `labels` (the port's global table by default).  Arrays are
    copied, never shared."""
    lab = None
    if ds.labels is not None:
        ids = np.asarray(ds.labels, np.int32)
        if ids.any() and source_labels is None:
            raise ValueError("the data set has label ids: pass its label "
                             "table as source_labels")
        table = labels if labels is not None else GLOBAL_LABELS
        # ascending source ids intern in the source's first-seen order
        lut = np.zeros(int(ids.max(initial=0)) + 1, np.int32)
        for i in np.unique(ids[ids != 0]):
            lut[i] = table.to_index(source_labels.to_label(int(i)))
        lab = lut[ids]

    def copy(a, dtype):
        return None if a is None else np.array(a, dtype=dtype, copy=True)

    return Dataset(points=copy(ds.points, np.float32), mask=copy(ds.mask, np.uint8),
                   labels=lab, weight=copy(ds.weight, np.float32),
                   fixed=copy(ds.fixed, np.int32), topol=Topology(int(ds.topol)),
                   neigh=Neighborhood(int(ds.neigh)), xdim=int(ds.xdim),
                   ydim=int(ds.ydim), comments=list(ds.comments))


def codebook_to_torch(ds: Dataset, device: torch.device | str = "cuda"
                      ) -> Tuple[torch.Tensor, Dataset]:
    """(codes, meta): a float32 (noc, D) copy of `ds.points` on `device`
    (never sharing the host array, since trainers update it in place)."""
    codes = torch.tensor(np.asarray(ds.points, dtype=np.float32),
                         dtype=torch.float32, device=device)
    meta = replace(ds, points=np.empty((0, ds.dim), np.float32))
    return codes, meta


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over `a` without a copy where NumPy allows writing
    (torch tensors cannot be read-only); a copy otherwise."""
    return torch.from_numpy(a) if a.flags.writeable else torch.tensor(a)


def to_dataset(codes: torch.Tensor, meta: Dataset) -> Dataset:
    """A host Dataset holding `codes` with `meta`'s header and labels."""
    if codes.dim() != 2 or codes.shape[1] != meta.dim:
        raise ValueError(f"codes {tuple(codes.shape)} do not match the "
                         f"codebook dimension {meta.dim}")
    pts = codes.detach().to("cpu", torch.float32).numpy()
    return replace(meta, points=pts)


def fixed_flat(fixed: np.ndarray, xdim: int) -> np.ndarray:
    """(N, 2) `fixed=x,y` tokens, (-1, -1) where absent, to (N,) int32 flat
    unit indices, -1 where absent."""
    return np.where((fixed[:, 0] >= 0) & (fixed[:, 1] >= 0),
                    fixed[:, 1] * xdim + fixed[:, 0], -1).astype(np.int32)


def sample_arrays(ds: Dataset, xdim: int = 0, use_weights: bool = False,
                  use_fixed: bool = False
                  ) -> Tuple[np.ndarray, Optional[np.ndarray],
                             Optional[np.ndarray], Optional[np.ndarray]]:
    """Host (points, mask, weight, fixed) of `ds` in the layout above."""
    weight = ds.weight if use_weights and ds.weight is not None else None
    fixed = (fixed_flat(ds.fixed, xdim)
             if use_fixed and ds.fixed is not None else None)
    return (np.ascontiguousarray(ds.points, dtype=np.float32), ds.mask,
            None if weight is None else np.ascontiguousarray(weight, np.float32),
            fixed)


def lvq_codebook_to_torch(ds: Dataset, device: torch.device | str = "cuda"
                          ) -> Tuple[torch.Tensor, torch.Tensor, Dataset]:
    """(codes, code labels, meta): `codebook_to_torch` plus each code's
    first label id as int32 on `device`."""
    codes, meta = codebook_to_torch(ds, device)
    return codes, torch.tensor(ds.first_labels(), dtype=torch.int32,
                               device=device), meta


def labeled_samples_to_torch(ds: Dataset, device: torch.device | str = "cuda"
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        Optional[torch.Tensor]]:
    """(x, labels, mask) on `device`: points, each sample's first label id
    as int32, and the uint8 mask (None without one).

    LVQ compares code labels with data labels as ids, so a codebook and its
    data must be interned in ONE label table.  Carrying both across from
    the JAX package, pass the same `labels=` table (and the JAX
    `source_labels=`) to both `as_port_dataset` calls: with two tables the
    ids disagree and no sample is ever counted correct."""
    x, mask = samples_to_torch(ds, device)[:2]
    return x, torch.tensor(ds.first_labels(), dtype=torch.int32, device=device), mask


def samples_to_torch(ds: Dataset, device: torch.device | str = "cuda",
                     xdim: int = 0, use_weights: bool = False,
                     use_fixed: bool = False
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                Optional[torch.Tensor], Optional[torch.Tensor]]:
    """`sample_arrays` of `ds` as tensors on `device`."""
    return tuple(None if a is None else host_tensor(a).to(device)
                 for a in sample_arrays(ds, xdim, use_weights, use_fixed))


def class_blocked_state(blocked) -> dict:
    """The state of a class-blocked olvq1 run (the JAX package's
    ClassBlockedOLVQ1, or the port's) in the original row order:
    {"codes", "code_labels", "alphas"} as NumPy arrays, the keyword
    arguments of the port's parallel.sharded.ClassBlockedOLVQ1, which lays
    them out again in the same class-blocked order (a stable sort of the
    label ids)."""
    def host(a, dtype):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        return a.astype(dtype)

    inv = np.argsort(np.asarray(blocked.order))
    return {"codes": host(blocked.codes(), np.float32),
            "code_labels": host(blocked._labels, np.int32)[inv],
            "alphas": host(blocked.alphas(), np.float32)}
