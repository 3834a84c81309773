"""Learning-rate and radius schedules, the sample order and the weighted
alpha (host NumPy), and the block gather of the per-sample scans.

The host part is a copy of som_lvq_pak_tpu/models/common.py:24-112 (the
port imports nothing of the JAX package); tests hold both copies
bit-equal.  Schedules keep the C package's expression structure (alpha
functions lvq_pak.c:901-921, radius decay som_rout.c:615).
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import INV_ALPHA_CONSTANT
from ..utils.rng import CRandom

F32 = np.float32

ALPHA_LINEAR = "linear"
ALPHA_INVERSE_T = "inverse_t"


def alpha_schedule(length: int, alpha: float, kind: str = ALPHA_LINEAR) -> np.ndarray:
    """(length,) float32 per-step alpha.

    linear (lvq_pak.c:903-906):    alpha * (length-iter) / length
    inverse_t (lvq_pak.c:914-921): alpha * c / (c + iter), c = length/100
    """
    it = np.arange(length, dtype=np.int64)
    if kind == ALPHA_LINEAR:
        # C: float alpha * (float)(length-iter) / (float)length
        num = (F32(alpha) * (length - it).astype(F32)).astype(F32)
        return (num / F32(length)).astype(F32)
    if kind == ALPHA_INVERSE_T:
        c = F32(length / INV_ALPHA_CONSTANT)
        num = (F32(alpha) * c).astype(F32)
        den = (c + it.astype(F32)).astype(F32)
        return (num / den).astype(F32)
    raise ValueError(f"unknown alpha type {kind!r}")


def radius_schedule(length: int, radius: float) -> np.ndarray:
    """(length,) float32 per-step neighborhood radius, decaying linearly
    to one (som_rout.c:615):  1 + (radius-1) * (length-le) / length.

    C computes (radius - 1.0) and the final sum in double, with the
    (float) casts on the length terms.
    """
    le = np.arange(length, dtype=np.int64)
    # C association: ((radius - 1.0) * (float)(length - le)) / (float)length
    prod = (np.float64(F32(radius)) - 1.0) * (length - le).astype(F32).astype(np.float64)
    trad = 1.0 + prod / np.float64(F32(length))
    return trad.astype(F32)


def sample_order(
    n: int,
    length: int,
    random_order: bool = False,
    rng: Optional[CRandom] = None,
    buffer: int = 0,
) -> np.ndarray:
    """(length,) int32 data indices visited by a trainer.

    The reference walks the data cyclically; with -rand and full loading
    (LOADMODE_ALL) the list is shuffled ONCE at load time — not per lap —
    and then cycled (read_entries is only invoked on the first rewind,
    datafile.c:237-344, 787-840).

    With buffered loading (-buffer B, 0 < B < n) each read_entries refill
    loads exactly B entries (the tail chunk shorter) and shuffles THAT
    chunk with the continuing LCG stream (datafile.c:268-270, 338-341);
    every lap's rewind reloads and reshuffles all chunks.  B > n
    switches buffering off after the first load (datafile.c:330-333) —
    identical to LOADMODE_ALL.  B == n stays buffered (the refill
    breaks on noc >= buffer before EOF is seen), so the single
    whole-file chunk is reshuffled every lap.
    """
    if random_order:
        if rng is None:
            raise ValueError("random_order needs the CRandom stream")
        if 0 < buffer <= n:
            laps = -(-length // n)
            parts = []
            for _ in range(laps):
                for lo in range(0, n, buffer):
                    chunk = np.arange(lo, min(lo + buffer, n), dtype=np.int64)
                    parts.append(chunk[rng.shuffle_order(len(chunk))])
            return np.concatenate(parts)[:length].astype(np.int32)
        base = rng.shuffle_order(n)
    else:
        base = np.arange(n, dtype=np.int64)
    reps = -(-length // n)
    return np.tile(base, reps)[:length].astype(np.int32)


def effective_alpha(
    talp: np.ndarray, weights: Optional[np.ndarray], use_weights: bool
) -> np.ndarray:
    """Weighted-sample correction (som_rout.c:622-624):
    talp = 1 - (1-talp)^weight, in double, rounded to float32.
    `talp` is per-step alpha already gathered per sample."""
    if not use_weights or weights is None:
        return talp
    t = talp.astype(np.float64)
    w = weights.astype(np.float64)
    # C: talp = 1.0 - (float) pow((double)(1.0 - talp), (double) weight);
    # the pow() result is truncated to float BEFORE the subtraction.
    p = np.power(1.0 - t, w).astype(F32).astype(np.float64)
    out = np.where(w > 0.0, 1.0 - p, t)
    return out.astype(F32)


# the per-sample scans (models.som's online SOM, models.lvq's LVQ scans)
# gather their inputs a block of steps at a time, so a step reads views
SCAN_BLOCK = 8192


def scan_blocks(order: torch.Tensor, rows: Sequence[Optional[torch.Tensor]],
                steps: Sequence[torch.Tensor] = ()) -> Iterator[Tuple[list, list]]:
    """Blocks of SCAN_BLOCK steps of a scan over `order` (a device tensor of
    sample indices): for each, the per-sample tensors `rows` gathered at the
    block's samples by one index_select each (None stays None), and the
    per-step tensors `steps` sliced to the block."""
    for lo in range(0, order.shape[0], SCAN_BLOCK):
        idx = order[lo:lo + SCAN_BLOCK]
        yield ([None if r is None else r.index_select(0, idx) for r in rows],
               [s[lo:lo + SCAN_BLOCK] for s in steps])
