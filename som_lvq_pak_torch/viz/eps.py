"""PostScript/EPS emitters (host-side text generation).

sammon_eps replicates save_entries_in_eps (sammon.c:249-420) byte-wise:
same headers, scale selection (510/760 point targets), LN/LP marker
procs, label placement, and the row/column grid polyline walk for map
files.

The port's copy of som_lvq_pak_tpu/viz/eps.py (host text writers); tests
hold its output equal to the JAX package's and to the golden
`sammon_map_sa.ps`/`.eps` byte for byte.
"""

from __future__ import annotations

from typing import Optional, TextIO

import numpy as np

from ..data.dataset import Dataset
from ..data.labels import GLOBAL_LABELS, LabelTable

F32 = np.float32
FLT_MIN = np.float32(1.17549435e-38)
FLT_MAX = np.float32(3.4028235e38)


def ps_string_filter(text: Optional[str]) -> str:
    """Escape PS specials ( ) \\ (sammon.c:57-82)."""
    if not text:
        return ""
    out = []
    for c in text:
        if c in "()\\":
            out.append("\\")
        out.append(c)
    return "".join(out)


def sammon_eps(
    proj: Dataset,
    base_name: str,
    ps: bool,
    draw_grid: bool,
    labels: Optional[LabelTable] = None,
    fileobj: Optional[TextIO] = None,
) -> str:
    """Write `<base>_sa.eps` / `<base>_sa.ps`.  Returns the filename.

    draw_grid: connect map rows/columns with polylines (the reference
    gates this on an *uninitialized* variable for map files,
    sammon.c:431,460,478-482; we draw them for map topologies, matching
    both the code's intent and the observed behavior).
    """
    table = labels if labels is not None else GLOBAL_LABELS
    fname = "%s_sa.%s" % (base_name, "ps" if ps else "eps")

    x = proj.points[:, 0].copy()
    y = proj.points[:, 1].copy()
    xmi = F32(min(x.min(), FLT_MAX))
    xma = F32(max(x.max(), FLT_MIN))
    ymi = F32(min(y.min(), FLT_MAX))
    yma = F32(max(y.max(), FLT_MIN))

    if float(F32(xma - xmi)) * 1.5 > float(F32(yma - ymi)):
        frac = F32(510.0 / np.float64(F32(xma - xmi)))
    else:
        frac = F32(760.0 / np.float64(F32(yma - ymi)))

    x = (x - xmi).astype(F32)
    y = (y - ymi).astype(F32)

    L = []
    if ps:
        L.append("%!PS-Adobe-2.0 EPSF-2.0")
        L.append("%%Title: undefined\n%%Creator: sammon")
        L.append("%%Pages: 1\n%%EndComments")
        L.append("40 40 translate")
        L.append("/gscale %f def" % frac)
        L.append("gscale dup scale")
    else:
        L.append("%!PS-Adobe-2.0 EPSF-2.0")
        L.append("%%Title: undefined\n%%Creator: sammon")
        L.append("%%%%BoundingBox: 0 0 %f %f" % (F32(xma - xmi), F32(yma - ymi)))
        L.append("%%Pages: 0\n%%EndComments")
        L.append("/gscale %f def" % frac)
    L.append("/Helvetica findfont 12 gscale div scalefont setfont")
    L.append("/radius %f def" % F32(2.0 / np.float64(frac)))
    L.append("/LN")
    L.append("{newpath")
    L.append("radius 0 360 arc fill")
    L.append("} def")
    L.append("/LP")
    L.append("{dup stringwidth pop")
    L.append("-2 div 0 rmoveto show} def")
    L.append("%f setlinewidth" % F32(0.2 / np.float64(frac)))
    L.append("0 setgray")

    plabels = proj.first_labels()
    for i in range(proj.n):
        L.append("%f %f LN" % (x[i], y[i]))
        if plabels[i] != 0:
            L.append("%f %f moveto" % (x[i], y[i]))
            L.append("(%s) LP" % ps_string_filter(table.to_label(int(plabels[i]))))

    if draw_grid:
        xdim, ydim = proj.xdim, proj.ydim
        # rows: consecutive entries, stroke at each row end
        xc = 0
        for i in range(proj.n):
            if xc == 0:
                L.append("newpath")
                L.append("%f %f moveto" % (x[i], y[i]))
            else:
                L.append("%f %f lineto" % (x[i], y[i]))
                if xc == xdim - 1:
                    L.append("stroke")
            xc += 1
            if xc == xdim:
                xc = 0
        # columns: for each column yc, walk all entries picking xc == yc
        for yc in range(xdim):
            xc = 0
            ec = 0
            for i in range(proj.n):
                if ec == 0 and xc == yc:
                    L.append("newpath")
                    L.append("%f %f moveto" % (x[i], y[i]))
                elif xc == yc:
                    L.append("%f %f lineto" % (x[i], y[i]))
                    if ec == ydim - 1:
                        L.append("stroke")
                xc += 1
                if xc == xdim:
                    xc = 0
                    ec += 1

    if ps:
        L.append("showpage")

    text = "\n".join(L) + "\n"
    if fileobj is not None:
        fileobj.write(text)
    else:
        with open(fname, "w") as f:
            f.write(text)
    return fname


def sammon_base_name(out_code_file: str) -> str:
    """strrchr('.')-based base name (sammon.c:469-474): strip the
    extension after the LAST dot."""
    p = out_code_file.rfind(".")
    return out_code_file[:p] if p != -1 else out_code_file
