"""SOM grid geometry on the host: unit-to-unit grid distances with the C
package's exact float semantics and the NumPy neighbourhood weights — the
port's copy of som_lvq_pak_tpu/ops/neighborhood.py:21-81 (without its
jax.numpy branch), held bit-equal to it by tests.

The reference computes grid distances per (bmu, unit) pair on the fly
(hexa_dist/rect_dist, som_rout.c:434-468).  The (noc, noc) matrix here is
built once on the host; the parity paths read its rows, and the online
device scan (models.som) uploads it whole.
"""

from __future__ import annotations

import numpy as np

from ..data.dataset import Topology

F32 = np.float32


def hexa_dist_matrix(xdim: int, ydim: int) -> np.ndarray:
    """(noc, noc) float32 grid distances, hexagonal lattice.

    Exact replica of hexa_dist (som_rout.c:434-455): odd row-parity pairs
    shift x by ±0.5, y scaled by sqrt(0.75); the 0.75*diff*diff term and
    the sqrt are computed in double and rounded to float like the C code.
    """
    noc = xdim * ydim
    idx = np.arange(noc)
    bx, by = idx % xdim, idx // xdim
    dx = (bx[:, None] - bx[None, :]).astype(F32)  # diff = bx - tx (float)
    by_b, by_t = by[:, None], by[None, :]
    parity_differs = ((by_b - by_t) % 2) != 0  # C % sign is irrelevant for !=0
    b_even = (by_b % 2) == 0
    shift = np.where(parity_differs, np.where(b_even, F32(-0.5), F32(0.5)), F32(0.0))
    diff = (dx + shift).astype(F32)
    ret = (diff * diff).astype(F32)  # float
    dy = (by_b - by_t).astype(F32)
    # ret += 0.75 * diff * diff  (0.75 is a double constant -> double math)
    ret64 = ret.astype(np.float64) + 0.75 * dy.astype(np.float64) * dy.astype(np.float64)
    ret = ret64.astype(F32)
    return np.sqrt(ret.astype(np.float64)).astype(F32)


def rect_dist_matrix(xdim: int, ydim: int) -> np.ndarray:
    """(noc, noc) float32 grid distances, rectangular lattice
    (rect_dist, som_rout.c:457-468)."""
    noc = xdim * ydim
    idx = np.arange(noc)
    bx, by = idx % xdim, idx // xdim
    dx = (bx[:, None] - bx[None, :]).astype(F32)
    dy = (by[:, None] - by[None, :]).astype(F32)
    ret = (dx * dx).astype(F32)
    ret = (ret + dy * dy).astype(F32)
    return np.sqrt(ret.astype(np.float64)).astype(F32)


def grid_distance_matrix(topol: Topology, xdim: int, ydim: int) -> np.ndarray:
    if topol == Topology.HEXA:
        return hexa_dist_matrix(xdim, ydim)
    if topol == Topology.RECT:
        return rect_dist_matrix(xdim, ydim)
    raise ValueError(f"not a map topology: {topol!r}")


def neighborhood_weights(grid_dists: np.ndarray, bmu, radius, alpha,
                         gaussian: bool) -> np.ndarray:
    """Per-unit adaptation factor for a (batch of) BMU(s).

    bubble (som_rout.c:472-506):   alpha * [griddist <= radius]
    gaussian (som_rout.c:511-549): alpha * exp(-d^2 / (2 r^2)) for all units

    grid_dists is (noc, noc), bmu scalar or (B,); returns (noc,) or
    (B, noc).
    """
    d = grid_dists[bmu]
    if gaussian:
        return alpha * np.exp(-(d * d) / (2.0 * radius * radius))
    return np.where(d <= radius, alpha, 0.0 * alpha)
