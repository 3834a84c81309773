"""EPS/PS emitter for U-matrix pictures (umat.c:344-678).

The page structure, geometry and drawing command stream replicate the
reference byte-for-byte; the PostScript *prolog* defining the drawing
operators (H/R cells, LAB/ML/LN labels, row starts XSH/XSR, NL) is our
own implementation of the same operator contract.  A custom prolog file
can be supplied (the reference's -headerfile flag / UMAT_HEADERFILE env,
umat.c:210-211) — e.g. the original header.ps for bit-parity testing.

The port's copy of som_lvq_pak_tpu/viz/umat_ps.py.  Its prolog text names
the JAX package: that line is part of the umat tool's output, which the
port writes byte for byte as the JAX CLI does.
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional, TextIO

import numpy as np

from ..data.dataset import Neighborhood, Topology
from ..data.labels import GLOBAL_LABELS, LabelTable
from ..models.umatrix import UMatrix
from .eps import ps_string_filter

# A4/A3 page sizes in points and default margins (umat.h via umat.c)
PAPERS = {"A4": (595, 841), "A3": (841, 1190)}  # umat.h:78-81
LMARGIN = RMARGIN = TMARGIN = BMARGIN = 36  # umat.h:88-91
DEFAULTFONT = "Helvetica"

# Our own prolog: same operator contract as the reference's header.ps
# (variables radius/xstep/ystep/xoff/yoff/y/wt/bt/fontname/fontsize/
# doborder; operators selfont, swapx, swapy, XSH, XSR, NL, H, R, LN,
# LAB, ML), independently written.
PROLOG = r"""%
% umat drawing operators (som_lvq_pak_tpu implementation)
100 dict begin
/yoff 0 def /xoff 0 def /xstep 0 def /ystep 0 def /y 0 def /radius 0 def
/yoffset 0 def /xoffset 0 def
/picwidth 0 def /picheight 0 def
/doborder false def
/fontname /Helvetica def
/fontsize 1.0 def
/bt 0.0 def /wt 1.0 def
/ballrad 0.2 def
/curx 0 def
% mirror the picture: negate the step and reflect the origin
/swapx { /xstep xstep neg def /xoffset picwidth xoffset sub def } def
/swapy { /ystep ystep neg def /yoffset picheight yoffset sub def } def
/selfont { fontname findfont fontsize 0 gt { fontsize radius mul }
           { radius 1.2 mul } ifelse scalefont setfont } def
% map a 0..100 color through the black/white thresholds to a gray level
/graylevel { 100 div bt sub wt bt sub div
             dup 0 lt {pop 0} if dup 1 gt {pop 1} if } def
% newline: advance to the next row
/NL { /yoff yoff ystep sub def /y y 1 add def } def
% row starts: hexa umatrix rows shift by half an xstep when y mod 4 is
% 1 or 2 (the staggered lattice); rect rows start at xoff
/XSH { /curx xoff y 4 mod dup 3 eq {pop 1} if
       xstep 2 div mul add def } def
/XSR { /curx xoff def } def
/hexpath {
  newpath
  curx yoff radius add moveto
  curx radius -0.866025 mul add yoff radius 0.5 mul add lineto
  curx radius -0.866025 mul add yoff radius -0.5 mul add lineto
  curx yoff radius sub lineto
  curx radius 0.866025 mul add yoff radius -0.5 mul add lineto
  curx radius 0.866025 mul add yoff radius 0.5 mul add lineto
  closepath } def
/sqpath {
  newpath
  curx radius sub yoff radius sub moveto
  radius 2 mul 0 rlineto 0 radius 2 mul rlineto
  radius 2 mul neg 0 rlineto closepath } def
% draw one cell filled with the given 0..100 color, advance x
/H { graylevel setgray hexpath fill
     doborder { 0 setgray hexpath stroke } if
     /curx curx xstep add def } def
/R { graylevel setgray sqpath fill
     doborder { 0 setgray sqpath stroke } if
     /curx curx xstep add def } def
% ink: black on light cells, white on dark cells
/ink { graylevel 0.5 lt { 1 } { 0 } ifelse setgray } def
% label operators advance TWO xsteps: the label stream walks the map
% grid (mxdim columns) over the (2x-1)-wide umatrix cell grid, so
% consecutive units sit two u-cells apart (reference header.ps LN/LAB/ML)
% marker ball for an unlabeled unit
/LN { ink newpath curx yoff radius ballrad mul 0 360 arc fill
      /curx curx xstep 2 mul add def } def
% single label centered on the unit: (label) color LAB
/LAB { ink curx yoff moveto
       dup stringwidth pop -2 div 0 rmoveto show
       /curx curx xstep 2 mul add def } def
% stacked labels: (l1) .. (ln) n color ML
/ML { ink /mln exch def
      0 1 mln 1 sub { /mli exch def
        curx yoff ystep 4 div mli mul sub moveto
        dup stringwidth pop -2 div 0 rmoveto show } for
      /curx curx xstep 2 mul add def } def
"""

def image_size(um: UMatrix, width: int = 0) -> dict:
    """Geometry (image_size, umat.c:460-493) — float32 like the C code."""
    F32 = np.float32
    if width <= 0:
        width = 1000
    e = {"width": float(width)}
    if um.topol == Topology.RECT:
        xstep = F32(float(width) / F32(um.uxdim))
        e["xstep"] = float(xstep)
        e["ystep"] = float(xstep)
        e["height"] = float(F32(um.uydim * xstep))
        e["x0"] = float(F32(xstep * F32(0.5)))
        e["y0"] = float(F32(xstep * F32(0.5)))
        e["radius"] = float(F32(xstep * F32(0.5)))
    elif um.topol == Topology.HEXA:
        xstep = F32(float(width) / F32(um.uxdim + 1))
        ystep = F32(xstep * np.float64(math.sqrt(3)) * 0.5)
        radius = F32(xstep / np.float64(math.sqrt(3)))
        e["xstep"] = float(xstep)
        e["ystep"] = float(ystep)
        e["radius"] = float(radius)
        e["height"] = float(F32((um.uydim - 1) * ystep + 2.0 * radius))
        e["x0"] = float(F32(xstep * F32(0.5)))
        e["y0"] = float(radius)
    else:
        raise ValueError(f"unknown topology {um.topol}")
    return e


def print_eps(
    um: UMatrix,
    fp: TextIO,
    title: str = "",
    fontname: str = DEFAULTFONT,
    fontsize: float = -1.0,
    doborder: bool = False,
    drawblocks: bool = True,
    drawlabels: bool = True,
    swapx: bool = False,
    swapy: bool = False,
    white_threshold: float = 1.0,
    black_threshold: float = 0.0,
    headerfile: Optional[str] = None,
    date: Optional[str] = None,
    labels: Optional[LabelTable] = None,
) -> None:
    """The EPS object (print_eps, umat.c:528-678)."""
    table = labels if labels is not None else GLOBAL_LABELS
    e = image_size(um)
    if um.topol == Topology.HEXA:
        start_row_s, draw_block_s = "XSH", "H"
    else:
        start_row_s, draw_block_s = "XSR", "R"

    if date is None:
        date = time.ctime() + "\n"
    if headerfile is None:
        headerfile = os.environ.get("UMAT_HEADERFILE") or None

    w = fp.write
    w("%!PS-Adobe-3.0 EPSF-3.0\n")
    w("%%%%BoundingBox: 0 0 %d %d\n" % (math.ceil(e["width"]), math.ceil(e["height"])))
    w("%%%%Title: %s\n%%%%Creator: umat V1.1\n" % ps_string_filter(title))
    w("%%%%CreationDate: %s" % ps_string_filter(date))
    w("%%Pages: 0\n")
    w("%%%%DocumentFonts: %s\n%%%%DocumentNeededFonts: %s\n" % (fontname, fontname))
    w("%%EndComments\n")

    if headerfile:
        with open(headerfile) as hf:
            w(hf.read())
    else:
        w(PROLOG)

    w("/radius %f def\n/xstep %f def\n/ystep %f def\n"
      % (np.float32(e["radius"]), np.float32(e["xstep"]), np.float32(e["ystep"])))
    w("/picwidth %f def /picheight %f def\n"
      % (np.float32(e["width"]), np.float32(e["height"])))
    w("%%%%IncludeFont: %s\n" % fontname)
    w("/fontname /%s def\n" % fontname)
    if fontsize > 0.0:
        w("/fontsize %f def\n" % np.float32(fontsize))
    w("selfont\n")
    w("/doborder %s def\n" % ("true" if doborder else "false"))
    w("/wt %f def /bt %f def\n" % (np.float32(white_threshold), np.float32(black_threshold)))
    w("/xoffset %f def /yoffset %f def\n"
      % (np.float32(e["x0"]), np.float32(np.float32(e["height"]) - np.float32(e["y0"]))))
    if swapx:
        w("swapx\n")
    if swapy:
        w("swapy\n")
    w("/y 0 def\n/xoff xoffset def\n/yoff yoffset def\n")

    def cell(v) -> int:
        # NaN-safe (a custom prolog/headerfile path could feed NaN)
        return int(100 * v) if np.isfinite(v) else 0

    u = um.uvalue
    if drawblocks:
        for y in range(um.uydim):
            w("%s " % start_row_s)
            for x in range(um.uxdim):
                w("%d %s " % (cell(u[x, y]), draw_block_s))
            w("NL\n")

    w("/y 0 def\n/xoff xoffset def\n/yoff yoffset def\n")
    if drawlabels:
        codes = um.codes
        clabels = codes.labels
        for y in range(um.mydim):
            w("%s " % start_row_s)
            for x in range(um.mxdim):
                unit = y * um.mxdim + x
                row = clabels[unit] if clabels is not None else np.zeros(1, dtype=np.int32)
                labs = [int(l) for l in row if l != 0]
                color = 100 if not drawblocks else cell(u[2 * x, 2 * y])
                if labs:
                    if len(labs) == 1:
                        w("(%s) %d LAB " % (
                            ps_string_filter(table.to_label(labs[0])), color))
                    else:
                        for lab in labs:
                            w("(%s) " % ps_string_filter(table.to_label(lab)))
                        w("%d %d ML " % (len(labs), color))
                else:
                    w("%d LN " % color)
            w("NL NL\n")
    w("end\n")
    w("% end of EPS object\n")


def print_page(
    um: UMatrix,
    fp: TextIO,
    title: str = "",
    paper: str = "A4",
    orientation: Optional[str] = None,
    notitle: bool = False,
    date: Optional[str] = None,
    **eps_kwargs,
) -> None:
    """Full PS page wrapper (print_page, umat.c:344-406)."""
    e = image_size(um)
    w_, h = e["width"], e["height"]
    if title and not notitle:
        w_ += 24
    page_w, page_h = PAPERS[paper.upper()]
    pw = page_w - LMARGIN - RMARGIN
    ph = page_h - BMARGIN - TMARGIN
    if orientation is None:
        orientation = "landscape" if um.mxdim >= um.mydim else "portrait"

    if date is None:
        date = time.ctime() + "\n"
    w = fp.write
    w("%!PS-Adobe-2.0\n%%Pages: 1\n")
    w("%%Creator: umat V1.1\n")
    w("%%%%CreationDate: %s" % ps_string_filter(date))
    if orientation == "landscape":
        w("%d %d translate 90 rotate\n" % (LMARGIN + pw, BMARGIN))
        pw, ph = ph, pw
    else:
        w("%d %d translate\n" % (LMARGIN, BMARGIN))
    scale = min(np.float32(pw) / np.float32(int(w_)), np.float32(ph) / np.float32(int(h)))
    xs = int((pw - scale * int(w_)) * 0.5)
    ys = int((ph - scale * int(h)) * 0.5)
    w("gsave %d %d translate %f dup scale\n" % (xs, ys, scale))
    if title and not notitle:
        w("gsave /Helvetica findfont 18 scalefont setfont\n")
        w("0 setgray %f %f 8 add moveto\n" % (2.0, np.float32(e["height"])))
        w("(%s - Dim: %d, Size: %d*%d units, %s neighborhood) show\n" % (
            ps_string_filter(title), um.codes.dim, um.mxdim, um.mydim,
            "gaussian" if um.codes.neigh == Neighborhood.GAUSSIAN else "bubble"))
        w("grestore\n")
    print_eps(um, fp, title=title, date=date, **eps_kwargs)
    w("grestore\nshowpage\n")
