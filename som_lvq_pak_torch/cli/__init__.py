"""The `somvq-torch` multi-tool CLI: every reference program as a subcommand.

Usage:
    python -m som_lvq_pak_torch.cli <tool> [flags...]
    somvq-torch <tool> [flags...]

The reference ships ~30 single-main() programs sharing flag conventions
(lvq_pak.h:40-62); several are hard links dispatching on argv[0]
(Makefile:162-184: lvq1/lvq2/lvq3/olvq1 -> lvqtrain, propinit ->
eveninit, randinit/lininit -> mapinit).  Here every name is a subcommand
of one driver, and symlinking the driver under a tool name also works
(argv[0] dispatch, like the reference's getprogname()).

The port's copy of som_lvq_pak_tpu/cli/__init__.py: the same 31 tool names
plus `lvq_run`.  Without `-fast` a tool runs on the host and writes the
JAX CLI's bytes (it needs no GPU); with `-fast` it runs on `device`.
`main(device=)` is a Python keyword only (no flag, no environment
variable): a process always runs the `-fast` tools on "cuda", and tests
pass "cpu" for the plain versions of the kernels.  The JAX CLI's
`_enable_compile_cache` (a persistent XLA compilation cache) has no
counterpart: the port's kernels are built once into a library that every
process loads (som_lvq_pak_torch._build)."""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from .params import ArgScanner, CliError, OPTION2, global_options

# names under which argv[0] is the driver, not a tool
DRIVER_NAMES = ("__main__.py", "-m", "somvq", "somvq-torch", "python", "python3", "cli")


def _registry():
    from . import cmds_lvq as L
    from . import cmds_som as S
    from . import cmds_viz as V

    return {
        # LVQ training (multi-name dispatch like the reference hard links)
        "lvqtrain": L.cmd_lvqtrain,
        "lvq1": L.cmd_lvqtrain,
        "lvq2": L.cmd_lvqtrain,
        "lvq3": L.cmd_lvqtrain,
        "olvq1": L.cmd_lvqtrain,
        "eveninit": L.cmd_eveninit,
        "propinit": L.cmd_eveninit,
        "balance": L.cmd_balance,
        "accuracy": L.cmd_accuracy,
        "classify": L.cmd_classify,
        "knntest": L.cmd_knntest,
        "mcnemar": L.cmd_mcnemar,
        "cmatr": L.cmd_cmatr,
        "mindist": L.cmd_mindist,
        "stddev": L.cmd_stddev,
        "pick": L.cmd_pick,
        "extract": L.cmd_extract,
        "setlabel": L.cmd_setlabel,
        "showlabs": L.cmd_showlabs,
        "elimin": L.cmd_elimin,
        # SOM side
        "mapinit": S.cmd_mapinit,
        "randinit": S.cmd_mapinit,
        "lininit": S.cmd_mapinit,
        "vsom": S.cmd_vsom,
        "qerror": S.cmd_qerror,
        "vcal": S.cmd_vcal,
        "visual": S.cmd_visual,
        "vfind": S.cmd_vfind,
        # visualization
        "sammon": V.cmd_sammon,
        "umat": V.cmd_umat,
        "planes": V.cmd_planes,
    }


def tool_names() -> List[str]:
    return sorted(_registry().keys())


def main(argv: Optional[List[str]] = None, progname: Optional[str] = None,
         device="cuda") -> int:
    if argv is None:
        argv = sys.argv[1:]
    if progname is None:
        progname = os.path.basename(sys.argv[0] if sys.argv else "somvq-torch")
        if progname.endswith(".py") or progname in DRIVER_NAMES:
            progname = "somvq"

    tools = _registry()
    if progname in tools:
        tool = progname
    else:
        # lvq_run has its own driver module (it is not flag-based)
        if argv and argv[0] == "lvq_run":
            from .lvq_run import main as lvq_run_main

            return lvq_run_main(argv[1:], device=device)
        if not argv or argv[0] in ("-h", "--help", "help"):
            sys.stderr.write(
                "usage: somvq <tool> [flags...]\n\ntools:\n  "
                + "\n  ".join(tool_names() + ["lvq_run"])
                + "\n"
            )
            return 0 if argv else 1
        tool = argv[0]
        argv = argv[1:]
        if tool not in tools:
            sys.stderr.write("somvq: unknown tool '%s' (see 'somvq help')\n" % tool)
            return 1

    scanner = ArgScanner(argv)
    if tool != "mcnemar":
        global_options(scanner)
        if scanner.get("-help", OPTION2) is not None:
            # per-program usage block, byte-matching the reference's
            # printhelp() output (usage[] arrays, e.g. vsom.c:32-51)
            from .usage import usage_text

            text = usage_text(tool)
            if text is None:
                text = "%s: no usage text (see 'somvq help' for the tool list)\n" % tool
            sys.stdout.write(text)
            return 0
    try:
        return tools[tool](scanner, tool, device)
    except CliError as e:
        code = e.code if isinstance(e.code, int) else 1
        return code
    except BrokenPipeError:
        return 0


__all__ = ["main", "tool_names"]
