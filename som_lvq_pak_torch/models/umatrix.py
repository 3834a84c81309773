"""U-matrix computation + smoothing (map.c:130-989, median.c:5-99).

The U-matrix lives on a (2x-1) x (2y-1) grid: odd positions hold
inter-unit distances (neighbor geometry differs for rect/hexa lattices),
even positions (the units themselves) get the median of their
surrounding values, and everything is scaled to [0,1] *inverted*
(1 = close/white).  Component differences round to float32 before
squaring (C: float-float subtraction assigned to double, map.c:141);
squares accumulate left-to-right in double, like the C code.

Degenerate 1-row/1-column maps: the reference's unit-cell fill reads
past its array there (heap garbage in the output); we use only the
in-bounds neighbors instead.

Arrays here are indexed [x][y] matching the reference's uvalue layout.

The port's copy of som_lvq_pak_tpu/models/umatrix.py (all of it, 378
lines, host NumPy); tests hold the umat tool's output equal to the JAX
CLI's byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..data.dataset import Dataset, Topology

F32 = np.float32


@dataclass
class UMatrix:
    codes: Dataset
    uvalue: np.ndarray  # float32 (uxdim, uydim)

    @property
    def mxdim(self) -> int:
        return self.codes.xdim

    @property
    def mydim(self) -> int:
        return self.codes.ydim

    @property
    def uxdim(self) -> int:
        return 2 * self.mxdim - 1

    @property
    def uydim(self) -> int:
        return 2 * self.mydim - 1

    @property
    def topol(self) -> Topology:
        return Topology(self.codes.topol)


def calc_umatrix(codes: Dataset, xswap: bool = False, yswap: bool = False) -> UMatrix:
    """calc_umatrix (map.c:130-500)."""
    if not codes.is_map:
        raise ValueError("umatrix needs a map codebook")
    mx, my = codes.xdim, codes.ydim
    ux, uy = 2 * mx - 1, 2 * my - 1
    u = np.zeros((ux, uy), dtype=F32)
    M = codes.points.reshape(my, mx, codes.dim)  # float32, file order

    def d(a, b):
        # C: double temp = (float)a - (float)b (float32 subtraction),
        # dist += temp*temp accumulated left-to-right in double
        diff = (a - b).astype(np.float64)
        total = 0.0
        for t in diff:
            total += t * t
        return total

    if codes.topol == Topology.RECT:
        for j in range(my):
            for i in range(mx):
                if i < mx - 1:
                    u[2 * i + 1, 2 * j] = F32(np.sqrt(d(M[j, i], M[j, i + 1])))
                if j < my - 1:
                    u[2 * i, 2 * j + 1] = F32(np.sqrt(d(M[j, i], M[j + 1, i])))
                if i < mx - 1 and j < my - 1:
                    dz1 = np.sqrt(d(M[j, i], M[j + 1, i + 1]))
                    dz2 = np.sqrt(d(M[j + 1, i], M[j, i + 1]))
                    u[2 * i + 1, 2 * j + 1] = F32(
                        (dz1 / np.sqrt(2.0) + dz2 / np.sqrt(2.0)) / 2
                    )
    else:  # HEXA (map.c:185-268)
        for j in range(my):
            for i in range(mx):
                if i < mx - 1:
                    u[2 * i + 1, 2 * j] = F32(np.sqrt(d(M[j, i], M[j, i + 1])))
                if j < my - 1:
                    if j % 2:  # odd row: up-right neighbor straight down
                        u[2 * i, 2 * j + 1] = F32(np.sqrt(d(M[j, i], M[j + 1, i])))
                        if i < mx - 1:
                            u[2 * i + 1, 2 * j + 1] = F32(
                                np.sqrt(d(M[j, i], M[j + 1, i + 1]))
                            )
                    else:  # even row
                        if i > 0:
                            u[2 * i - 1, 2 * j + 1] = F32(
                                np.sqrt(d(M[j, i], M[j + 1, i - 1]))
                            )
                        u[2 * i, 2 * j + 1] = F32(np.sqrt(d(M[j, i], M[j + 1, i])))

    _fill_unit_cells(u, ux, uy, codes.topol)

    if xswap:  # note: C's "xswap" flips the Y axis of uvalue (map.c:470-478)
        u = u[:, ::-1].copy()
    if yswap:
        u = u[::-1, :].copy()

    mx_, mn_ = float(u.max()), float(u.min())
    bw = mx_ - mn_
    if bw == 0.0:
        # flat map: every inter-unit distance equal.  The reference
        # divides 0/0 here (NaN cells rendered as garbage ints); treat
        # a flat map as uniformly close instead.
        u = np.ones_like(u)
    else:
        u = (1.0 - (u.astype(np.float64) - mn_) / bw).astype(F32)
    return UMatrix(codes=codes, uvalue=u)


def _med(vals) -> float:
    arr = sorted(float(v) for v in vals)
    return arr[len(arr) // 2]


def _fill_unit_cells(u: np.ndarray, ux: int, uy: int, topol: Topology) -> None:
    """Unit cells = median (or corner mean) of surrounding inter-unit
    values (map.c:271-466).  Reads only odd positions, so order-free."""
    src = u  # neighbors read are never unit cells, no copy needed
    if ux < 3 or uy < 3:
        # 1-row / 1-column map: the reference's edge branches index past
        # the array here (undefined behavior); use the in-bounds
        # 4-neighborhood instead
        for j in range(0, uy, 2):
            for i in range(0, ux, 2):
                vals = [
                    float(src[a, b])
                    for a, b in ((i - 1, j), (i + 1, j), (i, j - 1), (i, j + 1))
                    if 0 <= a < ux and 0 <= b < uy
                ]
                if not vals:
                    continue
                m = sorted(vals)
                n = len(m)
                u[i, j] = F32(m[n // 2] if n % 2 else (m[n // 2 - 1] + m[n // 2]) / 2.0)
        return
    if topol == Topology.RECT:
        for j in range(0, uy, 2):
            for i in range(0, ux, 2):
                if 0 < i < ux - 1 and 0 < j < uy - 1:
                    m = sorted([src[i - 1, j], src[i + 1, j], src[i, j - 1], src[i, j + 1]])
                    u[i, j] = F32((float(m[1]) + float(m[2])) / 2.0)
                elif j == 0 and 0 < i < ux - 1:
                    u[i, j] = F32(_med([src[i - 1, j], src[i + 1, j], src[i, j + 1]]))
                elif j == uy - 1 and 0 < i < ux - 1:
                    u[i, j] = F32(_med([src[i - 1, j], src[i + 1, j], src[i, j - 1]]))
                elif i == 0 and 0 < j < uy - 1:
                    u[i, j] = F32(_med([src[i + 1, j], src[i, j - 1], src[i, j + 1]]))
                elif i == ux - 1 and 0 < j < uy - 1:
                    u[i, j] = F32(_med([src[i - 1, j], src[i, j - 1], src[i, j + 1]]))
                elif i == 0 and j == 0:
                    u[i, j] = F32((float(src[i + 1, j]) + float(src[i, j + 1])) / 2.0)
                elif i == ux - 1 and j == 0:
                    u[i, j] = F32((float(src[i - 1, j]) + float(src[i, j + 1])) / 2.0)
                elif i == 0 and j == uy - 1:
                    u[i, j] = F32((float(src[i + 1, j]) + float(src[i, j - 1])) / 2.0)
                elif i == ux - 1 and j == uy - 1:
                    u[i, j] = F32((float(src[i - 1, j]) + float(src[i, j - 1])) / 2.0)
    else:  # HEXA (map.c:352-466)
        for j in range(0, uy, 2):
            for i in range(0, ux, 2):
                if 0 < i < ux - 1 and 0 < j < uy - 1:
                    if j % 4 == 0:
                        m = sorted([src[i - 1, j], src[i + 1, j], src[i - 1, j - 1],
                                    src[i, j - 1], src[i - 1, j + 1], src[i, j + 1]])
                    else:
                        m = sorted([src[i - 1, j], src[i + 1, j], src[i, j - 1],
                                    src[i + 1, j - 1], src[i, j + 1], src[i + 1, j + 1]])
                    u[i, j] = F32((float(m[2]) + float(m[3])) / 2.0)
                elif j == 0 and 0 < i < ux - 1:
                    m = sorted([src[i - 1, j], src[i + 1, j], src[i, j + 1], src[i - 1, j + 1]])
                    u[i, j] = F32((float(m[1]) + float(m[2])) / 2.0)
                elif j == uy - 1 and 0 < i < ux - 1:
                    if j % 4 == 0:
                        m = sorted([src[i - 1, j], src[i + 1, j], src[i - 1, j - 1], src[i, j - 1]])
                    else:
                        m = sorted([src[i - 1, j], src[i + 1, j], src[i, j - 1], src[i + 1, j - 1]])
                    u[i, j] = F32((float(m[1]) + float(m[2])) / 2.0)
                elif i == 0 and 0 < j < uy - 1:
                    if j % 4 == 0:
                        u[i, j] = F32(_med([src[i + 1, j], src[i, j - 1], src[i, j + 1]]))
                    else:
                        u[i, j] = F32(_med([src[i + 1, j], src[i, j - 1],
                                            src[i + 1, j - 1], src[i, j + 1], src[i + 1, j + 1]]))
                elif i == ux - 1 and 0 < j < uy - 1:
                    if j % 4:
                        u[i, j] = F32(_med([src[i - 1, j], src[i, j - 1], src[i, j + 1]]))
                    else:
                        u[i, j] = F32(_med([src[i - 1, j], src[i, j - 1],
                                            src[i - 1, j - 1], src[i, j + 1], src[i - 1, j + 1]]))
                elif i == 0 and j == 0:
                    u[i, j] = F32((float(src[i + 1, j]) + float(src[i, j + 1])) / 2.0)
                elif i == ux - 1 and j == 0:
                    u[i, j] = F32(_med([src[i - 1, j], src[i - 1, j + 1], src[i, j + 1]]))
                elif i == 0 and j == uy - 1:
                    if j % 4 == 0:
                        u[i, j] = F32((float(src[i + 1, j]) + float(src[i, j - 1])) / 2.0)
                    else:
                        u[i, j] = F32(_med([src[i + 1, j], src[i, j - 1], src[i + 1, j - 1]]))
                elif i == ux - 1 and j == uy - 1:
                    if j % 4:
                        u[i, j] = F32((float(src[i - 1, j]) + float(src[i, j - 1])) / 2.0)
                    else:
                        u[i, j] = F32(_med([src[i - 1, j], src[i, j - 1], src[i - 1, j - 1]]))


def _f32sum(vals) -> np.float32:
    """Left-associated float32 addition chain (C float expression)."""
    s = F32(vals[0])
    for v in vals[1:]:
        s = F32(s + F32(v))
    return s


def average_umatrix(um: UMatrix) -> None:
    """One smoothing pass: neighborhood means (map.c:525-769).
    Float32 addition chains; rect divides by a double 5.0/4.0/3.0,
    hexa by float divisors — replicated."""
    u = um.uvalue
    ux, uy = um.uxdim, um.uydim
    out = u.copy()
    if um.topol == Topology.RECT:
        for j in range(uy):
            for i in range(ux):
                if 0 < i < ux - 1 and 0 < j < uy - 1:
                    out[i, j] = F32(float(_f32sum([u[i, j - 1], u[i - 1, j], u[i, j],
                                                   u[i + 1, j], u[i, j + 1]])) / 5.0)
                elif 0 < i < ux - 1 and j == 0:
                    out[i, j] = F32(float(_f32sum([u[i - 1, j], u[i, j], u[i + 1, j],
                                                   u[i, j + 1]])) / 4.0)
                elif i == 0 and 0 < j < uy - 1:
                    out[i, j] = F32(float(_f32sum([u[i, j - 1], u[i, j], u[i + 1, j],
                                                   u[i, j + 1]])) / 4.0)
                elif 0 < i < ux - 1 and j == uy - 1:
                    out[i, j] = F32(float(_f32sum([u[i, j - 1], u[i - 1, j], u[i, j],
                                                   u[i + 1, j]])) / 4.0)
                elif 0 < j < uy - 1 and i == ux - 1:
                    out[i, j] = F32(float(_f32sum([u[i, j - 1], u[i - 1, j], u[i, j],
                                                   u[i, j + 1]])) / 4.0)
        out[0, uy - 1] = F32(float(_f32sum([u[1, uy - 1], u[0, uy - 1], u[0, uy - 2]])) / 3.0)
        out[ux - 1, uy - 1] = F32(float(_f32sum([u[ux - 2, uy - 1], u[ux - 1, uy - 1], u[ux - 1, uy - 2]])) / 3.0)
        out[ux - 1, 0] = F32(float(_f32sum([u[ux - 2, 0], u[ux - 1, 0], u[ux - 1, 1]])) / 3.0)
        out[0, 0] = F32(float(_f32sum([u[1, 0], u[0, 1], u[0, 0]])) / 3.0)
    else:
        for j in range(1, uy - 1):
            for i in range(1, ux - 1):
                out[i, j] = F32(_f32sum(_hexa_neigh(u, i, j)) / F32(7.0))
        j = 0
        for i in range(1, ux - 1):
            out[i, j] = F32(_f32sum([u[i - 1, j], u[i, j], u[i + 1, j],
                                     u[i - 1, j + 1], u[i, j + 1]]) / F32(5.0))
        j = uy - 1
        for i in range(1, ux - 1):
            out[i, j] = F32(_f32sum(_order_south(u, i, j)) / F32(5.0))
        i = ux - 1
        for j in range(1, uy - 1):
            vals = _east_vals(u, i, j)
            out[i, j] = F32(_f32sum(vals) / F32(len(vals)))
        i = 0
        for j in range(1, uy - 1):
            vals = _west_vals(u, i, j)
            out[i, j] = F32(_f32sum(vals) / F32(len(vals)))
        out[0, 0] = F32(_f32sum([u[1, 0], u[0, 0], u[0, 1]]) / F32(3.0))
        out[ux - 1, 0] = F32(_f32sum([u[ux - 1, 0], u[ux - 1, 1], u[ux - 2, 0], u[ux - 2, 1]]) / F32(4.0))
        out[ux - 1, uy - 1] = F32(_f32sum([u[ux - 1, uy - 1], u[ux - 1, uy - 2], u[ux - 2, uy - 1]]) / F32(3.0))
        out[0, uy - 1] = F32(_f32sum([u[0, uy - 1], u[1, uy - 1], u[0, uy - 2]]) / F32(3.0))
    um.uvalue = out


def _hexa_neigh(u, i, j):
    """Interior 7-neighborhood in the C accumulation order
    (map.c:592-625)."""
    m = j % 4
    if m == 1:
        return [u[i, j - 1], u[i + 1, j - 1], u[i - 1, j], u[i, j], u[i + 1, j],
                u[i - 1, j + 1], u[i, j + 1]]
    if m == 2:
        return [u[i, j - 1], u[i + 1, j - 1], u[i - 1, j], u[i, j], u[i + 1, j],
                u[i, j + 1], u[i + 1, j + 1]]
    if m == 3:
        return [u[i - 1, j - 1], u[i, j - 1], u[i - 1, j], u[i, j], u[i + 1, j],
                u[i, j + 1], u[i + 1, j + 1]]
    return [u[i - 1, j - 1], u[i, j - 1], u[i - 1, j], u[i, j], u[i + 1, j],
            u[i - 1, j + 1], u[i, j + 1]]


def _order_south(u, i, j):
    m = j % 4
    if m in (1, 2):
        return [u[i, j - 1], u[i + 1, j - 1], u[i - 1, j], u[i, j], u[i + 1, j]]
    return [u[i - 1, j - 1], u[i, j - 1], u[i - 1, j], u[i, j], u[i + 1, j]]


def _east_vals(u, i, j):
    m = j % 4
    if m == 1:
        return [u[i, j - 1], u[i - 1, j], u[i, j], u[i - 1, j + 1], u[i, j + 1]]
    if m == 2:
        return [u[i, j - 1], u[i - 1, j], u[i, j], u[i, j + 1]]
    if m == 3:
        return [u[i - 1, j - 1], u[i, j - 1], u[i - 1, j], u[i, j], u[i, j + 1]]
    return [u[i - 1, j - 1], u[i, j - 1], u[i - 1, j], u[i, j], u[i - 1, j + 1], u[i, j + 1]]


def _west_vals(u, i, j):
    m = j % 4
    if m == 1:
        return [u[i, j - 1], u[i + 1, j - 1], u[i, j], u[i + 1, j], u[i, j + 1]]
    if m == 2:
        return [u[i, j - 1], u[i + 1, j - 1], u[i, j], u[i + 1, j], u[i, j + 1], u[i + 1, j + 1]]
    if m == 3:
        return [u[i, j - 1], u[i, j], u[i + 1, j], u[i, j + 1], u[i + 1, j + 1]]
    return [u[i, j - 1], u[i, j], u[i + 1, j], u[i, j + 1]]


def median_umatrix(um: UMatrix) -> None:
    """One median-filter pass (map.c:771-989 + median.c sort-medians:
    sorted value at index n//2)."""
    u = um.uvalue
    ux, uy = um.uxdim, um.uydim
    out = u.copy()

    def med(vals):
        arr = sorted(F32(v) for v in vals)
        return F32(arr[len(arr) // 2])

    if um.topol == Topology.RECT:
        for j in range(uy):
            for i in range(ux):
                if 0 < i < ux - 1 and 0 < j < uy - 1:
                    out[i, j] = med([u[i, j - 1], u[i - 1, j], u[i, j], u[i + 1, j], u[i, j + 1]])
                elif 0 < i < ux - 1 and j == 0:
                    out[i, j] = med([u[i - 1, j], u[i, j], u[i + 1, j], u[i, j + 1]])
                elif i == 0 and 0 < j < uy - 1:
                    out[i, j] = med([u[i, j - 1], u[i, j], u[i + 1, j], u[i, j + 1]])
                elif 0 < i < ux - 1 and j == uy - 1:
                    out[i, j] = med([u[i, j - 1], u[i - 1, j], u[i, j], u[i + 1, j]])
                elif 0 < j < uy - 1 and i == ux - 1:
                    # C passes u[i-1][j] twice here (map.c:810-815)
                    out[i, j] = med([u[i, j - 1], u[i - 1, j], u[i - 1, j], u[i, j], u[i, j + 1]])
        out[0, uy - 1] = med([u[1, uy - 1], u[0, uy - 1], u[0, uy - 2]])
        out[ux - 1, uy - 1] = med([u[ux - 2, uy - 1], u[ux - 1, uy - 1], u[ux - 1, uy - 2]])
        out[ux - 1, 0] = med([u[ux - 2, 0], u[ux - 1, 0], u[ux - 1, 1]])
        out[0, 0] = med([u[1, 0], u[0, 1], u[0, 0]])
    else:
        for j in range(1, uy - 1):
            for i in range(1, ux - 1):
                out[i, j] = med(_hexa_neigh(u, i, j))
        j = 0
        for i in range(1, ux - 1):
            out[i, j] = med([u[i - 1, j], u[i, j], u[i + 1, j], u[i - 1, j + 1], u[i, j + 1]])
        j = uy - 1
        for i in range(1, ux - 1):
            out[i, j] = med(_order_south(u, i, j))
        i = ux - 1
        for j in range(1, uy - 1):
            out[i, j] = med(_east_vals(u, i, j))
        i = 0
        for j in range(1, uy - 1):
            out[i, j] = med(_west_vals(u, i, j))
        out[0, 0] = med([u[1, 0], u[0, 0], u[0, 1]])
        out[ux - 1, 0] = med([u[ux - 1, 0], u[ux - 1, 1], u[ux - 2, 0], u[ux - 2, 1]])
        out[ux - 1, uy - 1] = med([u[ux - 1, uy - 1], u[ux - 1, uy - 2], u[ux - 2, uy - 1]])
        out[0, uy - 1] = med([u[0, uy - 1], u[1, uy - 1], u[0, uy - 2]])
    um.uvalue = out
