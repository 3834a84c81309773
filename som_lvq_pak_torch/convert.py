"""Codebooks between the host `Dataset` (shared with the JAX package) and
device tensors.

    codes, meta = codebook_to_torch(ds, device)   # (noc, D) float32 tensor
    ds2 = to_dataset(codes, meta)                 # back to a host Dataset

`meta` is the Dataset with its points emptied: it carries the header
(topology, neighbourhood, xdim, ydim), labels, masks and comments.  The
port's checkpoints are the JAX package's `Checkpointer`/`TrainState`
files, so codebooks cross between the packages through either route.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Tuple

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
