"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`) into one
shared library with a plain C interface, loaded with `ctypes`.  The build
happens on first use, into `som_lvq_pak_torch/_build/` (git-ignored), and is
redone whenever a source file or the flags change (the library's file name
carries a hash of both).  A missing `nvcc` or a failed build raises: there is
no fallback.

No `--use_fast_math`: the gaussian neighbourhood needs `expf`, not
`__expf`, and IEEE division to track the reference kernels.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types; every entry returns a cudaError_t as int
_SIGNATURES = {
    # x, codes, B, N, D, val, idx, stream
    "somvq_dist_argmin": [_P, _P, _I, _I, _I, _P, _P, _P],
    "somvq_dist_argmin_t": [_P, _P, _I, _I, _I, _P, _P, _P],
    # codes, noc, D, xb, bmu, alpha, B, xn, Bn, xdim, hexa, gaussian,
    # radius, keys, val, idx, stream
    "somvq_som_fused_step": [_P, _I, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                             ctypes.c_float, _P, _P, _P, _P],
}


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode())
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsomvq_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels if the current sources have no library yet;
    returns the library's path."""
    out = library_path()
    if os.path.exists(out):
        return out
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = ([nvcc, *NVCC_FLAGS] + (["-Xptxas", "-v"] if verbose else [])
           + ["-o", tmp, *sources()])
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic publish: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.somvq_error_string.argtypes = [ctypes.c_int]
    lib.somvq_error_string.restype = ctypes.c_char_p
    return lib


def call(name: str, *args) -> None:
    """Launch C entry point `name`; raise on the cudaError_t it returns."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.somvq_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
