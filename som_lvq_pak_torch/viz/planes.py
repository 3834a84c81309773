"""Component-plane and trajectory EPS pictures (planes.c).

print_plane (planes.c:90-215): one gray-circle picture per codebook
component, scaled 0.05..0.95; print_trajectory (planes.c:256-400): the
BMU path of a data sequence over the unit circles.  Output text is
byte-compatible with the reference.

The port's copy of som_lvq_pak_tpu/viz/planes.py; the trajectory's
winners come from the port's copy of ops/exact.py.  Tests hold its output
to the golden `som_v_p1.ps` ... `som_v_p5.ps` byte for byte.
"""

from __future__ import annotations

from typing import List, Optional, TextIO, Tuple

import numpy as np

from ..data.dataset import Dataset, Topology
from ..data.labels import GLOBAL_LABELS, LabelTable
from ..ops import exact
from .eps import ps_string_filter

F32 = np.float32
XMSTEP = 40  # planes.c:33


def _steps(codes: Dataset) -> Tuple[int, int, int]:
    xstep = XMSTEP
    ystep = XMSTEP
    offset = 0
    if codes.topol == Topology.HEXA:
        offset = xstep // 2
        ystep = int(int(xstep) * 0.87)  # YMSTEP, planes.c:34
    return xstep, ystep, offset


def print_plane(
    codes: Dataset,
    plane: int,
    fp: TextIO,
    ps: bool = False,
    labels: Optional[LabelTable] = None,
) -> None:
    """One component plane (print_plane, planes.c:90-215).
    `plane` is 0-based here (the CLI converts from the 1-based flag)."""
    table = labels if labels is not None else GLOBAL_LABELS
    xstep, ystep, offset = _steps(codes)
    xsize = xstep * codes.xdim + offset
    ysize = ystep * codes.ydim
    w = fp.write
    if ps:
        w("%!PS-Adobe-2.0 EPSF-2.0\n")
        w("%%Title: undefined\n%%Creator: planes\n")
        w("%%Pages: 1\n%%EndComments\n")
        w("550 40 translate\n")
        w("90 rotate\n")
        w("760 %d div 510 %d div lt\n" % (xsize, ysize))
        w("   {760 %d 0 sub div} {510 %d div} ifelse\n" % (xsize, ysize))
        w("/gscale exch def\n")
        w("gscale dup scale\n")
    else:
        w("%!PS-Adobe-2.0 EPSF-2.0\n")
        w("%%Title: undefined\n%%Creator: planes\n")
        w("%%%%BoundingBox: 0 0 %d %d\n" % (xsize, ysize))
        w("%%Pages: 0\n%%EndComments\n")
    w("/fontsize %d def\n" % (xstep // 3))
    w("0 %d translate\n" % ysize)
    w("1 -1 scale\n")

    vals = codes.points[:, plane]
    minval = F32(vals.min())
    maxval = F32(vals.max())

    w("/radius %d def\n" % int(xstep / 2.2))
    w("/LN\n")
    w("{ setgray\n")
    w("newpath\n")
    w("radius 0 360 arc fill\n")
    w("} def\n")

    span = F32(maxval - minval)
    for index in range(codes.n):
        if float(span) != 0.0:
            cv = F32(0.05 + 0.9 * np.float64(F32(vals[index] - minval)) / np.float64(span))
        else:
            cv = F32(0.5)
        xp = xstep * (index % codes.xdim) + xstep // 2
        yp = ystep * (index // codes.xdim) + ystep // 2
        if (index // codes.xdim) % 2:
            xp += offset
        w("%d %d %f LN\n" % (xp, yp, cv))

    w("0 setgray\n")
    w("/Helvetica findfont fontsize scalefont setfont\n")
    w("/LP\n")
    w("{ \n")
    w("1 -1 scale dup stringwidth pop\n")
    w("-2 div 0 rmoveto show\n")
    w("1 -1 scale } def\n")

    clabels = codes.first_labels()
    for index in range(codes.n):
        xp = xstep * (index % codes.xdim) + xstep // 2
        yp = ystep * (index // codes.xdim) + ystep // 2
        if (index // codes.xdim) % 2:
            xp += offset
        if clabels[index] != 0:
            w("%d %d moveto (%s) LP\n"
              % (xp, yp, ps_string_filter(table.to_label(int(clabels[index])))))
    if ps:
        w("showpage\n")


def trajectory_indices(codes: Dataset, data: Dataset) -> List[int]:
    """BMU index per data sample, -1 for all-masked samples
    (scan_data_traj, planes.c:218-253)."""
    out = []
    for i in range(data.n):
        xm = data.mask[i] if data.mask is not None else None
        if xm is not None and xm.all():
            out.append(-1)
            continue
        wi, _ = exact.find_winner_euc(data.points[i], codes.points, xm)
        out.append(int(wi))
    return out


def print_trajectory(
    codes: Dataset,
    traj: List[int],
    fp: TextIO,
    ps: bool = False,
) -> None:
    """The BMU trajectory picture (print_trajectory, planes.c:256-400)."""
    xstep, ystep, offset = _steps(codes)
    xsize = xstep * codes.xdim + offset
    ysize = ystep * codes.ydim
    w = fp.write
    if ps:
        w("%!PS-Adobe-2.0 EPSF-2.0\n")
        w("%%Title: undefined\n%%Creator: planes\n")
        w("%%Pages: 1\n%%EndComments\n")
        w("550 40 translate\n")
        w("90 rotate\n")
        w("760 %d div 510 %d div lt\n" % (xsize, ysize))
        w("   {760 %d 0 sub div} {510 %d div} ifelse\n" % (xsize, ysize))
        w("/gscale exch def\n")
        w("gscale dup scale\n")
    else:
        w("%!PS-Adobe-2.0 EPSF-2.0\n")
        w("%%Title: undefined\n%%Creator: planes\n")
        w("%%%%BoundingBox: 0 0 %d %d\n" % (xsize, ysize))
        w("%%Pages: 0\n%%EndComments\n")
    w("0 %d translate\n" % ysize)
    w("1 -1 scale\n")
    w("1 setlinewidth\n")
    w("0.8 setgray\n")
    w("/radius %d def\n" % int(xstep / 2.2))
    w("/LN\n")
    w("{ newpath\n")
    w("radius 0 360 arc\n")
    w("stroke } def\n")
    for i in range(codes.xdim):
        for j in range(codes.ydim):
            w("%d %d LN\n" % (
                i * xstep + xstep // 2 + (offset if j % 2 else 0),
                j * ystep + ystep // 2))
    w("%d setlinewidth\n" % (xstep // 10))
    w("1 setlinejoin\n")
    w("1 setlinecap\n")
    w("0 setgray\n")
    first = True
    for bpos in traj:
        if bpos == -1:
            if not first:
                w("stroke\n")
            first = True
            continue
        x = xstep * (bpos % codes.xdim) + xstep // 2
        y = ystep * (bpos // codes.xdim) + ystep // 2
        if (bpos // codes.xdim) % 2:
            x += offset
        if first:
            first = False
            w("newpath\n")
            w("%d %d moveto\n" % (x, y))
        else:
            w("%d %d lineto\n" % (x, y))
    w("stroke\n")
    if ps:
        w("showpage\n")
