"""Host `Dataset`s (shared with the JAX package) and device tensors.

    codes, meta = codebook_to_torch(ds, device)   # (noc, D) float32 tensor
    ds2 = to_dataset(codes, meta)                 # back to a host Dataset
    x, mask, weight, fixed = samples_to_torch(ds, device, xdim,
                                              use_weights, use_fixed)

`meta` is the Dataset with its points emptied: it carries the header
(topology, neighbourhood, xdim, ydim), labels, masks and comments.  The
port's checkpoints are the JAX package's `Checkpointer`/`TrainState`
files, so codebooks cross between the packages through either route.

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

from som_lvq_pak_tpu.data.dataset import Dataset


def codebook_to_torch(ds: Dataset, device: torch.device | str = "cpu"
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


def samples_to_torch(ds: Dataset, device: torch.device | str = "cpu",
                     xdim: int = 0, use_weights: bool = False,
                     use_fixed: bool = False
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                Optional[torch.Tensor], Optional[torch.Tensor]]:
    """`sample_arrays` of `ds` as tensors on `device`."""
    return tuple(None if a is None else host_tensor(a).to(device)
                 for a in sample_arrays(ds, xdim, use_weights, use_fixed))
