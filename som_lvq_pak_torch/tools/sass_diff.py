"""The instruction text of two builds of the kernel library, function by
function: whether a change to a shared body left a kernel's machine code as
it was.

    python -m som_lvq_pak_torch.tools.sass_diff LIB_A LIB_B [--kernels NAME ...]

Dumps both libraries with `cuobjdump --dump-sass` (next to nvcc), keeps each
instruction's text (no addresses, no encodings), and for every function whose
mangled name contains one of the kernel names (all functions without
--kernels) that both libraries hold, compares the two instruction lists
(anonymous namespaces, whose mangling depends on the checkout's path,
written alike).
Prints one JSON line: per function its instruction count in each library and
whether the texts are equal, and whether all of them are.  Build each tree
first (`som_lvq_pak_torch._build.build()` in each checkout); a function only
one library holds is listed under `only_a` / `only_b`.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_ANON = re.compile(r"(\d+)(?=_GLOBAL__N_)")


def unanonymize(name: str) -> str:
    """A mangled name with each anonymous namespace (whose mangling carries
    a hash of its file's path) written as `_GLOBAL__N_`, so one kernel built
    in two checkouts has one name."""
    m = _ANON.search(name)
    if not m:
        return name
    end = m.end() + int(m.group(1))
    return name[:m.start()] + "_GLOBAL__N_" + unanonymize(name[end:])


def dump_command(library: str) -> list:
    """The cuobjdump command (next to nvcc) that prints a library's SASS."""
    from .. import _build

    return [os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "--dump-sass", library]


def sass(library: str) -> dict:
    """{mangled function name: [instruction text, ...]} of a library."""
    return parse(subprocess.run(dump_command(library), capture_output=True, text=True,
                                check=True).stdout)


def parse(dump: str) -> dict:
    """`cuobjdump --dump-sass` text as {function: [instruction text, ...]}."""
    funcs, fn = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            fn = unanonymize(line.split("Function :")[1].strip())
            funcs[fn] = []
        elif fn is not None:
            m = _INSN.search(line)
            if m:
                funcs[fn].append(m.group(1))
    return funcs


def compare(a: dict, b: dict, kernels=()) -> dict:
    """Per function both dicts hold (restricted to names containing one of
    `kernels`, if any): its instruction counts and whether the texts are
    equal."""
    def keep(name):
        return not kernels or any(k in name for k in kernels)

    both = sorted(n for n in a if n in b and keep(n))
    funcs = {n: dict(a=len(a[n]), b=len(b[n]), equal=a[n] == b[n]) for n in both}
    return dict(functions=funcs, all_equal=all(f["equal"] for f in funcs.values()),
                only_a=sorted(n for n in a if n not in b and keep(n)),
                only_b=sorted(n for n in b if n not in a and keep(n)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("lib_a")
    ap.add_argument("lib_b")
    ap.add_argument("--kernels", nargs="*", default=())
    a = ap.parse_args(argv)
    print(json.dumps(compare(sass(a.lib_a), sass(a.lib_b), tuple(a.kernels))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
