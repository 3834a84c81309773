"""Shared CLI plumbing: file opening with the reference's messages and
exit codes, snapshot construction, trainer option decoding.

The port's copy of som_lvq_pak_tpu/cli/common.py (all of it), on the
port's data/, utils/snapshot.py and utils/rng.py.  None of it touches a
device.
"""

from __future__ import annotations

import sys
from typing import Optional

from ..data.dataset import Dataset, Topology
from ..data.io import read_data, write_data
from ..models.common import ALPHA_LINEAR, ALPHA_INVERSE_T
from ..utils.rng import CRandom
from ..utils.snapshot import SNAPSHOT_TYPES, Snapshot
from .params import OPTION, ArgScanner, err, ifverbose

ALPHA_TYPES = {"linear": ALPHA_LINEAR, "inverse_t": ALPHA_INVERSE_T}


def load_data(name: str, kind: str = "data", skip_empty: bool = True) -> Dataset:
    """open_entries with the reference's verbose message / error text
    (e.g. vsom.c:133-140, qerror.c:69-77)."""
    if ifverbose(2):
        sys.stderr.write(
            "%s entries are read from file %s\n"
            % ("Input" if kind == "data" else "Codebook", name)
        )
    try:
        return read_data(name, skip_empty=skip_empty)
    except (OSError, ValueError):
        if kind == "data":
            err("Can't open data file '%s'" % name)
        else:
            err("Can't open code file '%s'" % name)
        raise  # unreachable


def load_or_stream(name: str, buffer: int, kind: str = "data",
                   skip_empty: bool = True):
    """-buffer > 0 returns a bounded-memory StreamingReader (the
    reference's LOADMODE_BUFFER loader, datafile.c:237-344); otherwise
    the fully loaded Dataset.  Trainers/evaluators accept either."""
    if buffer > 0:
        from ..data.streaming import StreamingReader

        return StreamingReader(name, buffer, skip_empty=skip_empty)
    return load_data(name, kind, skip_empty=skip_empty)


def save_codes(codes: Dataset, name: str, comments: Optional[str] = None) -> None:
    if ifverbose(2):
        sys.stderr.write("Codebook entries are saved to file %s\n" % name)
    write_data(codes, name, comments=comments)


def require_map(codes: Dataset, name: str) -> None:
    """Reject non-map codebooks (vsom.c:152-156, qerror.c:90-96)."""
    if codes.topol < Topology.HEXA:
        err("File %s is not a map file" % name)


def require_same_dim(data: Dataset, codes: Dataset) -> None:
    if data.dim != codes.dim:
        err(
            "Data and codebook vectors have different dimensions (%d != %d)"
            % (data.dim, codes.dim)
        )


def get_snapshot_opts(scanner: ArgScanner, out_code_file: str, rlen: int):
    """The -snapfile/-snapinterval/-snaptype trio shared by the trainers
    (vsom.c:106-130, lvqtrain.c:124-141)."""
    snapshot_file = scanner.get("-snapfile", OPTION)
    snapshot_interval = scanner.get_int("-snapinterval", 0, OPTION)
    snap_type = scanner.get("-snaptype", OPTION) or "file"
    if snap_type not in SNAPSHOT_TYPES:
        err("Unknown snapshot type %s" % snap_type)
    if not snapshot_interval:
        return None
    if snapshot_file is None:
        snapshot_file = out_code_file
        sys.stderr.write("snapshot file not specified, using '%s'" % snapshot_file)
    return Snapshot(snapshot_file, snapshot_interval, snap_type, length=rlen)


def get_alpha_type(scanner: ArgScanner) -> str:
    s = scanner.get("-alpha_type", OPTION)
    if s is None:
        return ALPHA_LINEAR
    if s not in ALPHA_TYPES:
        err("Unknown alpha type %s" % s)
    return ALPHA_TYPES[s]


def get_rand(scanner: ArgScanner):
    """-rand handling shared by the trainers (vsom.c:94,170-172): the
    *presence* of the flag enables per-lap random sample order; its value
    seeds the LCG (0 = wall clock)."""
    rand_s = scanner.get("-rand", OPTION)
    rng = CRandom()
    rng.init_random(0 if rand_s is None else int(_atoi(rand_s)))
    return rng, rand_s is not None


def _atoi(s: str) -> int:
    from ..data.io import _atoi as a

    return a(s)
