"""Learning-rate and radius schedules (host NumPy).

A copy of som_lvq_pak_tpu/models/common.py:24-56 (the port imports
nothing of the JAX package); tests hold both copies bit-equal.  Schedules
keep the C package's expression structure (alpha functions
lvq_pak.c:901-921, radius decay som_rout.c:615).
"""

from __future__ import annotations

import numpy as np

from ..config import INV_ALPHA_CONSTANT

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
