"""CLI flag scanning with the reference's extract_parameter semantics
(lvq_pak.c:560-612) plus the shared global options (lvq_pak.c:618-661).

The reference scans argv positionally for `-flag value` pairs anywhere on
the line; ALWAYS flags are required (missing -> error + exit), OPTION
flags default, OPTION2 flags are value-less booleans.  A counter of
consumed argv slots lets programs warn about extra parameters
(parameters_left, mapinit.c:112-114).

The port's copy of som_lvq_pak_tpu/cli/params.py (all of it); `-version`
prints the port's `get_version()`, the one text that differs from the
JAX CLI's on purpose.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

ALWAYS = 1
OPTION = 0
OPTION2 = 2

# process-wide verbosity level (reference verbose(), lvq_pak.c:486-495)
_VERBOSE = 1


def verbose(level: int = -1) -> int:
    global _VERBOSE
    if level >= 0:
        _VERBOSE = level
    return _VERBOSE


def ifverbose(level: int) -> bool:
    return _VERBOSE >= level


class CliError(SystemExit):
    pass


class ArgScanner:
    """extract_parameter (lvq_pak.c:583-612): positional scan with a
    consumed-slot counter."""

    def __init__(self, argv: List[str]):
        self.argv = list(argv)
        self.no_parameters = len(self.argv)

    def get(self, param: str, when: int = OPTION) -> Optional[str]:
        argv = self.argv
        i = 0
        n = len(argv)
        while i < n and argv[i] != param:
            i += 1
        if i <= n - 1 and when == OPTION2:
            self.no_parameters -= 1
            return ""
        if i < n - 1:
            self.no_parameters -= 2
            return argv[i + 1]
        if when == ALWAYS:
            sys.stderr.write("Can't find asked option %s\n" % param)
            raise CliError(255)
        return None

    def parameters_left(self) -> int:
        return self.no_parameters

    # oatoi / oatof (lvq_pak.c:567-581)
    def get_int(self, param: str, default: int, when: int = OPTION) -> int:
        s = self.get(param, when)
        return default if s is None else _atoi(s)

    def get_float(self, param: str, default: float, when: int = OPTION) -> float:
        s = self.get(param, when)
        return default if s is None else _atof(s)


def _atoi(s: str) -> int:
    from ..data.io import _atoi as a

    return a(s)


def _atof(s: str) -> float:
    s = s.strip()
    out = ""
    seen_dot = seen_e = False
    for i, ch in enumerate(s):
        if ch in "+-" and (i == 0 or (out and out[-1] in "eE")):
            out += ch
        elif ch.isdigit():
            out += ch
        elif ch == "." and not seen_dot and not seen_e:
            out += ch
            seen_dot = True
        elif ch in "eE" and not seen_e and any(c.isdigit() for c in out):
            out += ch
            seen_e = True
        else:
            break
    try:
        return float(out)
    except ValueError:
        return 0.0


def global_options(scanner: ArgScanner) -> None:
    """Shared options + env vars (global_options, lvq_pak.c:618-661):
    -compress_cmd/-uncompress_cmd/-mask_str override the LVQSOM_* env
    vars for this process; -version prints to stderr; -v sets the
    verbosity level (default 1)."""
    s = scanner.get("-compress_cmd", OPTION)
    if s is not None:
        os.environ["LVQSOM_COMPRESS_COMMAND"] = s
    s = scanner.get("-uncompress_cmd", OPTION)
    if s is not None:
        os.environ["LVQSOM_UNCOMPRESS_COMMAND"] = s
    s = scanner.get("-mask_str", OPTION)
    if s is not None:
        os.environ["LVQSOM_MASK_STR"] = s
    if scanner.get("-version", OPTION2) is not None:
        from .. import get_version

        sys.stderr.write("Version: %s\n" % get_version())
    verbose(scanner.get_int("-v", 1, OPTION))


def selfuncs(scanner: ArgScanner) -> None:
    """-selfuncs: named function-set selector (set_vector_functions,
    datafile.c:1207-1243).  Only the "default" set is wired in the
    reference (the "fast" variants are commented out, datafile.c:1219);
    any other name warns and falls back, matching strcasecmp dispatch.
    Scanned by accuracy/balance/classify/knntest/planes/qerror/setlabel/
    vcal/vfind/visual/vsom (e.g. vsom.c:131, accuracy.c:165); lvqtrain
    and cmatr list it in their usage text but never parse it.

    Known stderr-ordering divergence: the reference emits this warning
    from set_teach_params AFTER both input files open successfully
    (e.g. qerror.c:66 vs :106), so with an unknown name plus a missing
    input file it prints nothing, while this warns up front.  The
    warning text itself is byte-identical; only timing/presence under
    error paths differs (documented rather than replicated — the golden
    pipelines never hit it)."""
    name = scanner.get("-selfuncs", OPTION)
    if name is not None and name.lower() != "default":
        sys.stderr.write("functions for '%s' not found, using defaults\n" % name)


def err(msg: str, code: int = 1) -> None:
    sys.stderr.write(msg if msg.endswith("\n") else msg + "\n")
    raise CliError(code)
