"""Reader/writer for the SOM/LVQ_PAK text data & codebook format.

Format (reference datafile.c:112-148 reader, 396-447 writer):
  * optional '#' comment lines anywhere; blank lines ignored
  * header = first non-comment line: `dim [topol [xdim ydim neigh]]`
    with topol in {data,lvq,hexa,rect}, neigh in {bubble,gaussian}
  * each entry line: `dim` float components (the masked-string, default
    'x', marks a masked component stored as 0.0), then any mix of string
    labels, `weight=N`, `fixed=x,y` (datafile.c:552-748)
  * entries whose components are ALL masked are skipped unless requested
    (skip_empty, datafile.c:676-696)

Filename conventions (reference fileio.c:57-200): '-' = stdin/stdout,
suffix .gz/.z/.Z = gzip stream, leading '|' = shell pipe.

The port's copy of the Python parser and writers of
som_lvq_pak_tpu/data/io.py (`write_data_chunks` :360-407 and the olvq1
`.lra` sidecars :410-454 included); tests hold both byte-equal on the
golden files.  The JAX package's native C++ engine (native/somvq_io.cpp,
its `_use_native` branches), which it takes when it can build it, is not
part of the port yet: every entry here is written by the Python writer.
"""

from __future__ import annotations

import gzip
import io as _io
import os
import subprocess
import sys
from typing import List, Optional, TextIO, Tuple

import numpy as np

from ..config import (
    DEFAULT_COMPRESS_COMMAND,
    DEFAULT_UNCOMPRESS_COMMAND,
    compress_command,
    masked_string,
    uncompress_command,
)
from .dataset import (
    Dataset,
    Neighborhood,
    NEIGH_IDS,
    NEIGH_NAMES,
    Topology,
    TOPOL_IDS,
    TOPOL_NAMES,
)
from .labels import GLOBAL_LABELS, LabelTable

_GZ_SUFFIXES = (".gz", ".z", ".Z")


class _ProcStream:
    """File-like wrapper over a compression subprocess stream whose
    close() also reaps the process — the Python analogue of the
    reference's pclose() on a popen'd (de)compress pipe
    (fileio.c:132-161, close_file :202-231)."""

    def __init__(self, proc: subprocess.Popen, stream: TextIO):
        self._proc = proc
        self._stream = stream

    def __getattr__(self, name):
        return getattr(self._stream, name)

    def __iter__(self):
        return iter(self._stream)

    def close(self) -> None:
        self._stream.close()
        self._proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _open_read(name: str) -> TextIO:
    if name == "-" or name is None:
        return sys.stdin
    if name.startswith("|"):
        proc = subprocess.Popen(name[1:], shell=True, stdout=subprocess.PIPE, text=True)
        return _ProcStream(proc, proc.stdout)  # type: ignore[return-value]
    if name.endswith(_GZ_SUFFIXES):
        # honor the configured decompress command (fileio.c:132-161;
        # LVQSOM_UNCOMPRESS_COMMAND, config.h:45-50).  The stock
        # `gzip -d -c %s` on a .gz file is served by Python's gzip module
        # (no subprocess); a custom command — or a .z/.Z file, which
        # Python gzip cannot read — runs through a pipe exactly like the
        # reference's popen.
        cmd = uncompress_command()
        if cmd == DEFAULT_UNCOMPRESS_COMMAND and name.endswith(".gz"):
            return _io.TextIOWrapper(gzip.open(name, "rb"))
        proc = subprocess.Popen(cmd % name, shell=True,
                                stdout=subprocess.PIPE, text=True)
        return _ProcStream(proc, proc.stdout)  # type: ignore[return-value]
    return open(name, "r")


def _open_write(name: str) -> TextIO:
    if name == "-" or name is None:
        return sys.stdout
    if name.startswith("|"):
        proc = subprocess.Popen(name[1:], shell=True, stdin=subprocess.PIPE, text=True)
        return _ProcStream(proc, proc.stdin)  # type: ignore[return-value]
    if name.endswith(_GZ_SUFFIXES):
        # honor the configured compress command (fileio.c:163-187): the
        # command receives the output filename (e.g. `gzip -9 -c >%s`)
        # and the data on its stdin.  Default command + .gz = Python gzip.
        cmd = compress_command()
        if cmd == DEFAULT_COMPRESS_COMMAND and name.endswith(".gz"):
            return _io.TextIOWrapper(gzip.open(name, "wb"))
        proc = subprocess.Popen(cmd % name, shell=True,
                                stdin=subprocess.PIPE, text=True)
        return _ProcStream(proc, proc.stdin)  # type: ignore[return-value]
    return open(name, "w")


def parse_header(line: str) -> Tuple[int, Topology, Neighborhood, int, int]:
    """Header tokens by position (datafile.c:947-1023): dim, topol at
    token 2, xdim/ydim at tokens 3/4, neigh at token 5."""
    toks = line.split()
    dim = int(toks[0])
    topol = TOPOL_IDS.get(toks[1], Topology.UNKNOWN) if len(toks) > 1 else Topology.UNKNOWN
    xdim = int(toks[2]) if len(toks) > 2 else 0
    ydim = int(toks[3]) if len(toks) > 3 else 0
    neigh = NEIGH_IDS.get(toks[4], Neighborhood.UNKNOWN) if len(toks) > 4 else Neighborhood.UNKNOWN
    return dim, topol, neigh, xdim, ydim


def read_data(
    name: str,
    labels: Optional[LabelTable] = None,
    skip_empty: bool = True,
    fileobj: Optional[TextIO] = None,
) -> Dataset:
    """Load a data/codebook file into a Dataset (reference read_entries,
    datafile.c:237-344 + load_entry :552-748). Loads everything; buffered
    streaming for huge files lives in data.streaming."""
    table = labels if labels is not None else GLOBAL_LABELS
    mstr = masked_string()

    f = fileobj if fileobj is not None else _open_read(name)
    close = fileobj is None and f is not sys.stdin
    try:
        header = None
        comments: List[str] = []
        for raw in f:
            line = raw.rstrip("\n")
            if not line.strip():
                continue
            if line.startswith("#"):
                comments.append(line)
                continue
            header = line
            break
        if header is None:
            raise ValueError(f"{name}: no header line")
        dim, topol, neigh, xdim, ydim = parse_header(header)

        pts: List[np.ndarray] = []
        masks: List[Optional[np.ndarray]] = []
        labs: List[List[int]] = []
        weights: List[float] = []
        fixeds: List[Tuple[int, int]] = []
        any_mask = False
        any_weight = False
        any_fixed = False
        max_labs = 0

        for raw in f:
            line = raw.rstrip("\n")
            if line.startswith("#"):
                continue
            toks = line.split()
            if not toks:
                continue
            if len(toks) < dim:
                raise ValueError(f"{name}: short line: {line!r}")
            vec = np.zeros(dim, dtype=np.float32)
            m: Optional[np.ndarray] = None
            nmask = 0
            for i in range(dim):
                t = toks[i]
                if t == mstr:
                    if m is None:
                        m = np.zeros(dim, dtype=np.uint8)
                    m[i] = 1
                    nmask += 1
                else:
                    vec[i] = np.float32(t)
            if nmask == dim and skip_empty:
                continue  # datafile.c:676-686
            row_labs: List[int] = []
            w = 0.0  # entries without weight= default to 0 (datafile.c:497)
            fx = (-1, -1)
            for t in toks[dim:]:
                if t.startswith("weight="):
                    # reference get_weight is atoi (datafile.c:912-915)
                    w = float(_atoi(t[7:]))
                    any_weight = True
                elif t.startswith("fixed="):
                    xs, _, ys = t[6:].partition(",")
                    fx = (_atoi(xs), _atoi(ys))
                    any_fixed = True
                else:
                    row_labs.append(table.to_index(t))
            pts.append(vec)
            masks.append(m)
            labs.append(row_labs)
            weights.append(w)
            fixeds.append(fx)
            if m is not None:
                any_mask = True
            max_labs = max(max_labs, len(row_labs))
    finally:
        if close:
            f.close()

    n = len(pts)
    points = np.stack(pts) if n else np.zeros((0, dim), dtype=np.float32)
    mask_arr = None
    if any_mask:
        mask_arr = np.zeros((n, dim), dtype=np.uint8)
        for i, m in enumerate(masks):
            if m is not None:
                mask_arr[i] = m
    lab_arr = None
    if max_labs:
        lab_arr = np.zeros((n, max_labs), dtype=np.int32)
        for i, ls in enumerate(labs):
            lab_arr[i, : len(ls)] = ls
    weight_arr = np.asarray(weights, dtype=np.float32) if any_weight else None
    fixed_arr = np.asarray(fixeds, dtype=np.int32) if any_fixed else None

    return Dataset(
        points=points,
        mask=mask_arr,
        labels=lab_arr,
        weight=weight_arr,
        fixed=fixed_arr,
        topol=topol,
        neigh=neigh,
        xdim=xdim,
        ydim=ydim,
        comments=comments,
    )


def _atoi(s: str) -> int:
    """C atoi: parse leading integer, 0 on garbage."""
    s = s.strip()
    out = ""
    for i, ch in enumerate(s):
        if ch in "+-" and i == 0 or ch.isdigit():
            out += ch
        else:
            break
    try:
        return int(out)
    except ValueError:
        return 0


def format_header(ds: Dataset) -> str:
    """write_header (datafile.c:396-415)."""
    parts = [str(ds.dim)]
    if ds.topol > Topology.DATA:
        parts.append(TOPOL_NAMES[Topology(ds.topol)])
        if ds.topol > Topology.LVQ:
            parts.append(str(ds.xdim))
            parts.append(str(ds.ydim))
            parts.append(NEIGH_NAMES[Neighborhood(ds.neigh)])
    return " ".join(parts)


def format_entry(ds: Dataset, i: int, labels: Optional[LabelTable] = None) -> str:
    """write_entry (datafile.c:420-447): '%g ' per component (masked
    string for masked), '%s ' per label — note trailing space parity."""
    table = labels if labels is not None else GLOBAL_LABELS
    mstr = masked_string()
    parts = []
    row = ds.points[i]
    m = ds.mask[i] if ds.mask is not None else None
    for d in range(ds.dim):
        if m is not None and m[d]:
            parts.append(mstr)
        else:
            parts.append("%g" % float(row[d]))
    if ds.labels is not None:
        for lab in ds.labels[i]:
            if lab == 0:
                break
            parts.append(table.to_label(int(lab)) or "")
    # weight=/fixed= tokens are not re-emitted by the reference writer
    # (write_entry only writes components + labels), so neither do we.
    return " ".join(parts) + " "


def _write_head(f, ds: Dataset, comments: Optional[str]) -> None:
    """The header line of `ds`, then `comments` (ended by a newline)."""
    f.write(format_header(ds) + "\n")
    if comments:
        f.write(comments if comments.endswith("\n") else comments + "\n")


def write_data(
    ds: Dataset,
    name: str,
    labels: Optional[LabelTable] = None,
    comments: Optional[str] = None,
    fileobj: Optional[TextIO] = None,
) -> None:
    """save_entries_wcomments (datafile.c:353-379). Byte-compatible with
    the reference writer (same %g formatting and spacing)."""
    f = fileobj if fileobj is not None else _open_write(name)
    close = fileobj is None and f is not sys.stdout
    try:
        _write_head(f, ds, comments)
        for i in range(ds.n):
            f.write(format_entry(ds, i, labels) + "\n")
    finally:
        if close:
            f.close()


def write_data_chunks(
    chunks,
    name: str,
    labels: Optional[LabelTable] = None,
    comments: Optional[str] = None,
    meta: Optional[Dataset] = None,
) -> int:
    """Incremental writer for streamed pipelines: `chunks` yields
    Datasets sharing one header; the header comes from the first chunk
    and entries append as chunks arrive — output is byte-identical to
    write_data of the concatenation, with only one chunk resident.
    `meta` supplies the header when the stream yields NO chunks (a
    zero-entry input must still produce a header-only file like the
    non-streamed writer).  Returns the number of entries written."""
    f = _open_write(name)
    close = f is not sys.stdout
    n = 0
    try:
        first = True
        for ds in chunks:
            if first:
                _write_head(f, ds, comments)
                first = False
            for i in range(ds.n):
                f.write(format_entry(ds, i, labels) + "\n")
            n += ds.n
        if first and meta is not None:
            _write_head(f, meta, comments)
    finally:
        if close:
            f.close()
    return n


# --- olvq1 learning-rate sidecar files (.lra) ---------------------------
def _alpha_basename(filename: str) -> str:
    """Replicates `strtok(basename, "."); strcat(basename, ".lra")`
    (datafile.c:1030-1045): strtok skips *leading* '.' delimiters, then
    takes up to the next '.'."""
    s = filename
    start = 0
    while start < len(s) and s[start] == ".":
        start += 1
    end = s.find(".", start)
    if end == -1:
        end = len(s)
    return s[start:end] + ".lra"


def read_alpha_file(infile: str, noc: int) -> Optional[np.ndarray]:
    """alpha_read (datafile.c:1030-1060): returns None if absent/short."""
    path = _alpha_basename(infile)
    if not os.path.exists(path):
        return None
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                vals.append(np.float32(line))
            if len(vals) >= noc:
                break
    if len(vals) < noc:
        return None
    return np.asarray(vals, dtype=np.float32)


def write_alpha_file(outfile: str, alphas: np.ndarray) -> None:
    """alpha_write (datafile.c:1062-1086): '%g\\n' per value."""
    path = _alpha_basename(outfile)
    with open(path, "w") as f:
        for a in np.asarray(alphas):
            f.write("%g\n" % float(a))


def invalidate_alpha_file(outfile: str) -> None:
    """invalidate_alphafile (datafile.c:1088-1108)."""
    path = _alpha_basename(outfile)
    if os.path.exists(path):
        os.remove(path)
