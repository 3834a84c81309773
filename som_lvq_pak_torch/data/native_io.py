"""ctypes binding to the native C++ data-file engine (native/somvq_io.cpp).

The port's copy of som_lvq_pak_tpu/data/native_io.py: the same C struct,
`available()`, `read_data_native`, `parse_text_native` and
`format_entries_native`, over the port's Dataset, label table and config.
Callers (data.io, data.streaming) take the engine when `available()` says
so and the Python parser and writer otherwise; both give the same arrays
and bytes.

The library is built from the in-repo source on first use, with
`g++ -O3 -Wall -fPIC -std=c++17 -shared -pthread` (the slab parser runs a
`std::thread` per slab above 4 MB), into the git-ignored
`som_lvq_pak_torch/_build/`, under a file name that carries a hash of the
source and the flags, and loaded from there only: `native/`'s Makefile and
its prebuilt library are never used, so the build writes nothing outside
`_build/`.  Concurrent builds (test workers, processes of one world)
each compile to a temporary name and publish with an atomic rename.  No
`g++` on the PATH (or no source): `available()` is False and callers take
Python.  A `g++` that fails raises with its error output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import List, Optional

import numpy as np

from ..config import masked_string

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "native", "somvq_io.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX = "g++"
CXXFLAGS = ["-O3", "-Wall", "-fPIC", "-std=c++17", "-shared", "-pthread"]


class _SvqData(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("dim", ctypes.c_int32),
        ("topol", ctypes.c_int32),
        ("neigh", ctypes.c_int32),
        ("xdim", ctypes.c_int32),
        ("ydim", ctypes.c_int32),
        ("points", ctypes.POINTER(ctypes.c_float)),
        ("mask", ctypes.POINTER(ctypes.c_uint8)),
        ("weight", ctypes.POINTER(ctypes.c_float)),
        ("fixedpt", ctypes.POINTER(ctypes.c_int32)),
        ("labstr", ctypes.POINTER(ctypes.c_char)),
        ("labstr_len", ctypes.c_int64),
        ("labcnt", ctypes.POINTER(ctypes.c_int32)),
        ("total_labels", ctypes.c_int64),
        ("comments", ctypes.POINTER(ctypes.c_char)),
        ("comments_len", ctypes.c_int64),
        ("error", ctypes.c_char * 256),
    ]


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join([CXX, *CXXFLAGS]).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsomvq_io_{h.hexdigest()[:16]}.so")


def build() -> Optional[str]:
    """Compile the engine unless the current source already has a library;
    returns its path, or None when there is no compiler (or no source, as
    in an installed package without the repo's native/).  A failed compile
    raises RuntimeError with the compiler's output."""
    if not os.path.exists(SOURCE):
        return None
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed ({proc.returncode}) building {SOURCE}:\n"
                               f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)  # atomic publish: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def _load():
    """The loaded engine (built on first call), or None without a compiler."""
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.svq_parse_file.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(_SvqData)
    ]
    lib.svq_parse_file.restype = ctypes.c_int
    lib.svq_parse_buffer.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(_SvqData),
    ]
    lib.svq_parse_buffer.restype = ctypes.c_int
    lib.svq_free.argtypes = [ctypes.POINTER(_SvqData)]
    lib.svq_free.restype = None
    lib.svq_format_entries.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.svq_format_entries.restype = ctypes.c_void_p
    lib.svq_free_text.argtypes = [ctypes.c_void_p]
    lib.svq_free_text.restype = None
    return lib


def available() -> bool:
    """Whether the engine is loaded (building it if need be)."""
    return _load() is not None


def _collect(d: _SvqData, labels):
    """Turn the C struct into a Dataset (intern labels on the way)."""
    from .dataset import Dataset, Neighborhood, Topology
    from .labels import GLOBAL_LABELS

    table = labels if labels is not None else GLOBAL_LABELS
    n, dim = int(d.n), int(d.dim)
    points = np.ctypeslib.as_array(d.points, shape=(n, dim)).copy() if n else \
        np.zeros((0, dim), dtype=np.float32)
    mask = None
    if d.mask:
        mask = np.ctypeslib.as_array(d.mask, shape=(n, dim)).copy()
    weight = None
    if d.weight:
        weight = np.ctypeslib.as_array(d.weight, shape=(n,)).copy()
    fixed = None
    if d.fixedpt:
        fixed = np.ctypeslib.as_array(d.fixedpt, shape=(n, 2)).copy()

    lab_arr = None
    if d.total_labels:
        labcnt = np.ctypeslib.as_array(d.labcnt, shape=(n,))
        width = int(labcnt.max()) if n else 0
        raw = ctypes.string_at(d.labstr, d.labstr_len)
        toks = raw.split(b"\0")[:-1] if d.labstr_len else []
        ids = [table.to_index(t.decode()) for t in toks]
        lab_arr = np.zeros((n, max(width, 1)), dtype=np.int32)
        k = 0
        for i in range(n):
            c = int(labcnt[i])
            lab_arr[i, :c] = ids[k : k + c]
            k += c

    comments: List[str] = []
    if d.comments_len:
        comments = ctypes.string_at(d.comments, d.comments_len).decode().split("\n")

    return Dataset(
        points=points,
        mask=mask,
        labels=lab_arr,
        weight=weight,
        fixed=fixed,
        topol=Topology(d.topol),
        neigh=Neighborhood(d.neigh),
        xdim=int(d.xdim),
        ydim=int(d.ydim),
        comments=comments,
    )


def _parsed(lib, rc: int, d: _SvqData, labels, where: str):
    """The Dataset of a parse call's struct (freed after), or its error."""
    try:
        if rc != 0:
            raise ValueError(f"{where}{d.error.decode(errors='replace')}")
        return _collect(d, labels)
    finally:
        lib.svq_free(ctypes.byref(d))


def read_data_native(name: str, labels=None, skip_empty: bool = True):
    """Parse a plain (uncompressed, file-backed) data file natively.
    Returns None if the native library is unavailable (caller falls back)."""
    lib = _load()
    if lib is None:
        return None
    d = _SvqData()
    rc = lib.svq_parse_file(
        name.encode(), masked_string().encode(), int(skip_empty), ctypes.byref(d)
    )
    return _parsed(lib, rc, d, labels, f"{name}: ")


def parse_text_native(text: str, labels=None, skip_empty: bool = True):
    """Parse an in-memory buffer (e.g. a decompressed gzip stream, a
    streamed chunk).  Returns None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    d = _SvqData()
    raw = text.encode()
    buf = ctypes.create_string_buffer(raw)  # parser tokenizes in place
    rc = lib.svq_parse_buffer(
        ctypes.cast(buf, ctypes.c_char_p), len(raw), masked_string().encode(),
        int(skip_empty), ctypes.byref(d),
    )
    return _parsed(lib, rc, d, labels, "")


def format_entries_native(ds, labels=None) -> Optional[str]:
    """Format a Dataset's entry lines natively (header/comments stay in
    Python).  Returns None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    from .labels import GLOBAL_LABELS

    table = labels if labels is not None else GLOBAL_LABELS
    n, dim = ds.n, ds.dim
    pts = np.ascontiguousarray(ds.points, dtype=np.float32)
    mask_p = None
    if ds.mask is not None:
        mask_arr = np.ascontiguousarray(ds.mask, dtype=np.uint8)
        if mask_arr.shape != pts.shape:
            raise ValueError(f"mask {mask_arr.shape} does not match points {pts.shape}")
        mask_p = mask_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    labcnt_p = None
    labstr = b""
    if ds.labels is not None:
        counts = np.zeros(n, dtype=np.int32)
        parts: List[bytes] = []
        for i in range(n):
            for lab in ds.labels[i]:
                if lab == 0:
                    break
                parts.append((table.to_label(int(lab)) or "").encode())
                counts[i] += 1
        labstr = b"\0".join(parts) + (b"\0" if parts else b"")
        labcnt_p = counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    out_len = ctypes.c_int64(0)
    p = lib.svq_format_entries(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask_p, labstr, labcnt_p, n, dim, masked_string().encode(),
        ctypes.byref(out_len),
    )
    try:
        return ctypes.string_at(p, out_len.value).decode()
    finally:
        lib.svq_free_text(p)
