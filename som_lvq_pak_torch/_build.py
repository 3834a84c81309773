"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`), one
`nvcc` process per file, all started together, and the objects are linked
into one shared library with a plain C interface, loaded with `ctypes`.  The
build happens on first use, into `som_lvq_pak_torch/_build/` (git-ignored),
and is redone whenever a source or header (`csrc/*.cuh`) or the flags change
(the library's file name carries a hash of all of them).  A missing `nvcc` or
a failed build raises: there is no fallback.

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
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types; every entry returns a cudaError_t as int
_SIGNATURES = {
    # codes, N, D, Dp, hi, lo, m2, stream
    "somvq_split_codes": [_P, _I, _I, _I, _P, _P, _P, _P],
    # x, codes, B, N, D, Dp, splits, scratch, val, idx, stream
    "somvq_dist_argmin": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # x, codes, B, N, D, Dp, splits, scratch, val, idx, stream
    "somvq_dist_argmin_t": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # x, codes, B, N, D, Dp, splits, scratch, v1, i1, v2, i2, stream
    "somvq_dist_top2": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # codes, N, D, Dp, hi, lo, qhi, qlo, stream
    "somvq_split_masked_codes": [_P, _I, _I, _I, _P, _P, _P, _P, _P],
    # x, mask, codes, B, N, D, Dp, splits, scratch, val, idx, stream
    "somvq_dist_argmin_masked": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # x, mask, codes, B, N, D, Dp, splits, scratch, v1, i1, v2, i2, stream
    "somvq_dist_top2_masked": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                               _P, _P],
    # codes, codes_bf16, noc, D, xb, bmu, alpha, B, xn, Bn, xdim, hexa,
    # gaussian, radius, unit_offset, xs, keys, val, idx, rows32, stream
    "somvq_som_fused_step": [_P, _I, _I, _I, _P, _P, _P, _I, _P, _I, _I, _I,
                             _I, ctypes.c_float, _I, _P, _P, _P, _P, _P, _P],
    # the same without rows32, for D <= 128 (the Hopper walk; xs sized by
    # ops.som_step.sm90_scratch)
    "somvq_som_fused_step_sm90": [_P, _I, _I, _I, _P, _P, _P, _I, _P, _I, _I,
                                  _I, _I, ctypes.c_float, _I, _P, _P, _P, _P,
                                  _P],
    # codes, codes_bf16, noc, D, xb, bmu, alpha, B, xn, Bn, xdim, hexa,
    # gaussian, radius, chunked, wxa_bf16, batch_bf16, stagger, int8_win,
    # rows, xs, xq, q, pat, ytab, aw, keys, val, idx, rows32, stream
    "somvq_som_fused_factored": [_P, _I, _I, _I, _P, _P, _P, _I, _P, _I, _I,
                                 _I, _I, ctypes.c_float, _I, _I, _I, _I, _I,
                                 _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P],
    # K13 for D <= 128 on the Hopper walk: codes, codes_bf16, noc, D, xb,
    # bmu, alpha, B, xn, Bn, xdim, hexa, gaussian, radius, xs (sized by
    # ops.som_step.sm90_scratch without its table), pat, ytab, aw, keys, val,
    # idx, stream
    "somvq_som_fused_factored_sm90": [_P, _I, _I, _I, _P, _P, _P, _I, _P, _I, _I,
                                      _I, _I, ctypes.c_float, _P, _P, _P, _P, _P,
                                      _P, _P, _P],
    # K14's main form for D <= 128 on the Hopper walk: codes, codes_bf16, noc,
    # D, xb, bmu, alpha, B, xn, Bn, xdim, hexa, gaussian, radius, wxa_bf16,
    # batch_bf16, cluster, xs (sized by ops.som_step.sm90_scratch without its
    # table, one plane under batch_bf16), pat, ytab, aw, keys, val, idx,
    # stream
    "somvq_som_fused_chunked_sm90": [_P, _I, _I, _I, _P, _P, _P, _I, _P, _I, _I,
                                     _I, _I, ctypes.c_float, _I, _I, _I, _P, _P,
                                     _P, _P, _P, _P, _P, _P],
    # D, batch_bf16, cluster, out (int)
    "somvq_som_fused_chunked_sm90_clusters": [_I, _I, _I, _P],
    # rows, seg, B, C, noc, presorted, scratch, out, stream
    "somvq_segment_sum": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    # m, x, N, D, Dp, B, splits, out, stream
    "somvq_int8_winner_probe": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
    # m, x, N, D, B, splits, keys, out, stream
    "somvq_f32_winner_probe": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    # codes, N, D, w, T_rows, x, B, xn, Bn, bf16, scale, out, vkeys, vmax,
    # stream
    "somvq_fused_skeleton": [_P, _I, _I, _P, _I, _P, _I, _P, _I, _I,
                             ctypes.c_float, _P, _P, _P, _P],
    # codes, N, D, w, T_rows, x, B, xn, Bn, bf16, scale, out, vkeys, vmax,
    # xs, stream (D <= 128, the Hopper walk)
    "somvq_fused_skeleton_sm90": [_P, _I, _I, _P, _I, _P, _I, _P, _I, _I,
                                  ctypes.c_float, _P, _P, _P, _P, _P],
    # x, codes, B, N, D, Dp, k, splits, scratch, vo, io, stream
    "somvq_dist_topk": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # n_local, D, xb, bmu, alpha, B, xdim, hexa, gaussian, radius,
    # unit_offset, xs, acc, wsum, stream
    "somvq_som_accum": [_I, _I, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I,
                        _P, _P, _P, _P],
    # codes, n_local, D, acc, wsum, xn, Bn, xs, keys, val, idx, stream
    "somvq_som_blend_winner": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    "somvq_som_blend_winner_sm90": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    # codes, noc, D, xb, bmu, alpha, B, xdim, hexa, gaussian, radius, xs,
    # stream
    "somvq_som_update": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                         ctypes.c_float, _P, _P],
    # codes, noc, D, xb, mask, bmu, alpha, B, xdim, hexa, gaussian, radius,
    # xs (sized by ops.som_update.k6_scratch), stream
    "somvq_som_update_masked": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                ctypes.c_float, _P, _P],
    # codes, noc, D, batches, K, B, bmu0, alphas, radii, tail, xdim, hexa,
    # gaussian, rows, xs, keys, bar, bmu_out, stream
    "somvq_som_vmem_steps": [_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I,
                             _I, _I, _P, _P, _P, _P, _P],
    # the same with cluster (CTAs a tile) in place of rows: K7's walk
    "somvq_som_vmem_steps_sm90": [_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _P, _P, _P, _P, _P],
    # D, cluster, out
    "somvq_vmem_sm90_clusters": [_I, _I, _P],
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
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode())
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libsomvq_{h.hexdigest()[:16]}.so")


def _start(cmd, log: str):
    """Start `cmd` with its output into the file `log`; (cmd, Popen, log,
    start time)."""
    with open(log, "w") as f:
        p = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, text=True)
    return cmd, p, log, time.perf_counter()


def _wait(procs) -> tuple:
    """Wait for every process of `_start`; raise on the first that failed,
    after stopping the others.  Returns their output, in order, and the
    seconds each ran."""
    seconds = [None] * len(procs)
    try:
        while None in seconds:
            for j, (cmd, p, log, t0) in enumerate(procs):
                if seconds[j] is not None or p.poll() is None:
                    continue
                seconds[j] = time.perf_counter() - t0
                if p.returncode != 0:
                    with open(log) as f:
                        raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                           f"{' '.join(cmd)}\n{f.read()}")
            time.sleep(0.05)
    finally:
        for _, p, _, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for _, _, log, _ in procs:
        with open(log) as f:
            out.append(f.read())
    return "".join(out), seconds


# the build log's line for each source's compile time
_SECONDS = "nvcc seconds"


def build(verbose: bool = False) -> str:
    """Compile the kernels if the current sources have no library yet;
    returns the library's path.  The compile log, with ptxas's register and
    spill report of every kernel and each nvcc process's seconds, is kept
    beside the library (`build_log`, `compile_seconds`); `verbose` prints it
    when a build runs."""
    out = library_path()
    if os.path.exists(out):
        return out
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        flags = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v"]
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in sources()]
        log, seconds = _wait([_start(flags + ["-c", "-o", o, s], o + ".log")
                              for s, o in zip(sources(), objs)])
        log += "".join(f"{_SECONDS} {os.path.basename(s)}: {t:.1f}\n"
                       for s, t in zip(sources(), seconds))
        so = os.path.join(tmp, "lib.so")
        link, (t,) = _wait([_start([nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs],
                                   so + ".log")])
        log += link + f"{_SECONDS} link: {t:.1f}\n"
        if verbose:
            print(log)
        with open(os.path.join(tmp, "lib.log"), "w") as f:
            f.write(log)
        os.replace(os.path.join(tmp, "lib.log"), _log_path(out))
        os.replace(so, out)  # atomic publish: concurrent builds agree
    return out


def _log_path(library: str) -> str:
    return library[:-len(".so")] + ".log"


def compile_seconds(log: str = None) -> dict:
    """{source or "link": seconds} of the build that made the current
    library, from its log (`build_log()` unless given); {} if it kept none."""
    out = {}
    for line in (build_log() if log is None else log).splitlines():
        if line.startswith(_SECONDS + " "):
            name, t = line[len(_SECONDS) + 1:].rsplit(": ", 1)
            out[name] = float(t)
    return out


def build_log() -> str:
    """The compile log of the current sources' library (nvcc's output with
    `-Xptxas -v`), or "" if it has none."""
    path = _log_path(library_path())
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


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
    # rows, cluster, B, D -> K7's shared memory in bytes (a query; -1 if not
    # built)
    lib.somvq_vmem_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.somvq_vmem_smem_bytes.restype = ctypes.c_int
    return lib


def call(name: str, *args) -> None:
    """Launch C entry point `name`; raise on the cudaError_t it returns."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.somvq_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
