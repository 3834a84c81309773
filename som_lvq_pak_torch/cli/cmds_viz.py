"""Visualization CLI tools: sammon, umat, planes.

Flag surfaces mirror sammon.c:424-487, umat.c:122-263 and
planes.c:414-513.

The port's copy of som_lvq_pak_tpu/cli/cmds_viz.py: host text writers on
the port's models/sammon.py, models/umatrix.py and viz/; none touches a
device."""

from __future__ import annotations

import os
import sys

from ..data.dataset import Topology
from ..data.io import write_data
from ..models.sammon import sammon
from ..models.umatrix import average_umatrix, calc_umatrix, median_umatrix
from ..utils.rng import CRandom
from ..viz.eps import sammon_base_name, sammon_eps
from ..viz.planes import print_plane, print_trajectory, trajectory_indices
from ..viz.umat_ps import print_eps, print_page
from .common import load_data
from .params import ALWAYS, OPTION, OPTION2, ArgScanner, err, ifverbose, selfuncs


# ---------------------------------------------------------------------------
# sammon  (sammon.c)
# ---------------------------------------------------------------------------

def cmd_sammon(scanner: ArgScanner, progname: str, device) -> int:
    in_code_file = scanner.get("-cin", ALWAYS)
    out_code_file = scanner.get("-cout", ALWAYS)
    length = scanner.get_int("-rlen", 1, ALWAYS)
    randomize = scanner.get_int("-rand", 0, OPTION)
    eps = scanner.get("-eps", OPTION2) is not None
    ps = scanner.get("-ps", OPTION2) is not None

    codes = load_data(in_code_file, "codes")
    rng = CRandom()
    rng.init_random(randomize)

    proj, deduped = sammon(codes, length=length, rng=rng)
    removed = codes.n - deduped.n

    if ifverbose(2):
        sys.stderr.write("Save code entries to file %s\n" % out_code_file)
    write_data(proj, out_code_file)

    # grid lines only for intact map codebooks (sammon.c:476-482)
    if proj.topol not in (Topology.RECT, Topology.HEXA):
        removed = 1
    if ps or eps:
        sammon_eps(proj, sammon_base_name(out_code_file), ps=ps,
                   draw_grid=(removed == 0))
    return 0


# ---------------------------------------------------------------------------
# umat  (umat.c)
# ---------------------------------------------------------------------------

def _guess_mode(name):
    """Output type by extension (guess_mode, umat.c:324-341)."""
    if name is None:
        return None
    _, _, ext = name.rpartition(".")
    if ext.lower() == "ps":
        return "ps"
    if ext.lower() == "eps":
        return "eps"
    return None


def cmd_umat(scanner: ArgScanner, progname: str, device) -> int:
    doborder = scanner.get("-border", OPTION2) is not None
    orientation = None
    if scanner.get("-portrait", OPTION2) is not None:
        orientation = "portrait"
    if scanner.get("-landscape", OPTION2) is not None:
        orientation = "landscape"
    mode = None
    if scanner.get("-ps", OPTION2) is not None:
        mode = "ps"
    if scanner.get("-eps", OPTION2) is not None:
        mode = "eps"
    white = scanner.get_float("-W", 1.0, OPTION)
    black = scanner.get_float("-B", 0.0, OPTION)
    out_name = scanner.get("-o", OPTION)
    if mode is None:
        mode = _guess_mode(out_name)
    fontname = scanner.get("-font", OPTION) or "Helvetica"
    fontsize = scanner.get_float("-fontsize", -1.0, OPTION)
    title = scanner.get("-title", OPTION)
    notitle = scanner.get("-notitle", OPTION2) is not None
    paper = scanner.get("-paper", OPTION) or "A4"
    if paper.upper() not in ("A4", "A3"):
        err("Unknown paper type: %s" % paper)
    average = scanner.get("-average", OPTION2) is not None
    median = scanner.get("-median", OPTION2) is not None
    drawblocks = scanner.get("-onlylabs", OPTION2) is None
    drawlabels = scanner.get("-nolabs", OPTION2) is None
    swapx = scanner.get("-swapx", OPTION2) is not None
    swapy = scanner.get("-swapy", OPTION2) is not None
    in_name = scanner.get("-cin", ALWAYS)
    headerfile = os.environ.get("UMAT_HEADERFILE")
    s = scanner.get("-headerfile", OPTION)
    if s is not None:
        headerfile = s

    try:
        codes = load_data(in_name, "codes")
        um = calc_umatrix(codes)
    except SystemExit:
        raise
    except Exception:
        err("Can't load file")
    if average:
        average_umatrix(um)
    if median:
        median_umatrix(um)
    if mode is None:
        mode = "eps"

    fp = sys.stdout if out_name is None or out_name == "-" else open(out_name, "w")
    try:
        kwargs = dict(
            title=(title if title is not None else in_name),
            fontname=fontname, fontsize=fontsize, doborder=doborder,
            drawblocks=drawblocks, drawlabels=drawlabels,
            swapx=swapx, swapy=swapy,
            white_threshold=white, black_threshold=black,
            headerfile=headerfile,
        )
        if mode == "eps":
            print_eps(um, fp, **kwargs)
        else:
            print_page(um, fp, paper=paper, orientation=orientation,
                       notitle=notitle, **kwargs)
    finally:
        if fp is not sys.stdout:
            fp.close()
    return 0


# ---------------------------------------------------------------------------
# planes  (planes.c)
# ---------------------------------------------------------------------------

def cmd_planes(scanner: ArgScanner, progname: str, device) -> int:
    selfuncs(scanner)
    in_code_file = scanner.get("-cin", ALWAYS)
    in_data_file = scanner.get("-din", OPTION)
    plane = scanner.get_int("-plane", 1, OPTION)
    scanner.get_int("-buffer", 0, OPTION)
    ps = bool(scanner.get_int("-ps", 0, OPTION))

    base_name = in_code_file
    p = base_name.rfind(".")
    if p != -1:
        base_name = base_name[:p]

    codes = load_data(in_code_file, "codes")
    if codes.topol < Topology.HEXA:
        sys.stdout.write("File %s is not a map file\n" % in_code_file)
        return 1

    data = None
    if in_data_file is not None:
        data = load_data(in_data_file, "data", skip_empty=False)
        if data.dim > codes.dim:
            err("Dimensions in data and codebook files are different")
    if plane > codes.dim:
        err("Required plane is bigger than codebook vector dimension")

    ext = "ps" if ps else "eps"
    planes = range(codes.dim) if plane == 0 else [plane - 1]
    for pl in planes:
        fname = "%s_p%d.%s" % (base_name, pl + 1, ext)
        with open(fname, "w") as fp:
            print_plane(codes, pl, fp, ps=ps)

    if data is not None:
        traj = trajectory_indices(codes, data)
        fname = "%s_tr.%s" % (base_name, ext)
        with open(fname, "w") as fp:
            print_trajectory(codes, traj, fp, ps=ps)
    return 0
