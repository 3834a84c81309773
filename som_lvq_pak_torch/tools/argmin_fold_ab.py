"""The A/B of K1's and K2's fold (csrc/argmin_sm90.cu) on the card, and of
K8's (the same walk with a top-2 fold), K4's (csrc/argmin_masked_sm90.cu)
and K9's (K4's walk with the top-2 fold):
the walk as it is beside copies of its source with the fold changed, each
copy built alone by nvcc into a library of its own and timed in turns in one
process.

    python -m som_lvq_pak_torch.tools.argmin_fold_ab [--iters 20]

The variants, text edits of the walk's consumer loop (`variant_sources`):

* `walk`: the source as it is;
* `no_turns`: the same fold, the two consumer warpgroups issuing their
  products without taking turns;
* `per_score`: no turns, and a compare and select per score (the running
  (max, index) updated code by code, as the mma.sync walk folds);
* `no_fold`: the fold cut to one compare a tile, wrong winners on purpose:
  the products and their feed alone.

The fold region holds K8's top-2 fold too, so `no_turns` is K8 without the
turns and `no_fold` K8's products and feed alone (`per_score` breaks K8 and
is not run for it).  K4's source has two variants (`masked_variant_sources`):
`walk` and its own `no_fold`, which cuts K9's fold with K4's (the two
kernels share the walk in that source).

Every variant but `no_fold` must return the walk's (value, index) bit for bit
(at 4096 x 65536 x 64, 777 x 3001 x 37, 1000 x 2999 x 130 and 1 x 4096 x 64;
K8's `no_turns` its pairs at the same shapes), and K9's best pair must be
K4's (value, index) bit for bit at the same shapes with a mask (p 0.1);
then each runs K1 at B 4096 and 1024 against 65,536 codes and K2 at the
eval's 1M x 65536 x 64, D 64, in the order walk, no_turns, per_score,
no_fold and back, K8 at B 1024 (walk, no_turns, no_fold and back), K4 at B
4096 and 1M with p 0.1 and K9 at B 1024 with p 0.1 (walk, no_fold,
no_fold, walk), over `iters` calls each (3 at 1M) by CUDA events, the
prologue inside every call as in the wrappers.  The copies and
their libraries go to `som_lvq_pak_torch/_build/fold_ab/` (git-ignored).
Prints one JSON line with the card's name and power limit; exits non-zero
when a variant that must match does not.  Needs nvcc and a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

from .. import _build
from ..ops.dist_argmin import k1_sm90_splits, k4_sm90_splits, split_codes_dp
from .timing import mean_ms, resolve

OUT = os.path.join(_build.BUILD_DIR, "fold_ab")
VARIANTS = ("walk", "no_turns", "per_score", "no_fold")
MATCH_CASES = ((4096, 65536, 64), (777, 3001, 37), (1000, 2999, 130), (1, 4096, 64))
TIMED_CASES = ((4096, 65536, 64, "somvq_dist_argmin"), (1024, 65536, 64, "somvq_dist_argmin"),
               (1_000_000, 65536, 64, "somvq_dist_argmin_t"))
K8_VARIANTS = ("walk", "no_turns", "no_fold")
K8_CASE = (1024, 65536, 64)
K4_CASES = ((4096, 65536, 64), (1_000_000, 65536, 64))
K9_CASE = (1024, 65536, 64)

# the walk's lines that make the warpgroups take turns
_TURNS = ("  if (wg == 1) sm90::bar_arrive(2, TURN);\n",
          "    sm90::bar_sync(2 + wg, TURN);\n",
          "    if (wg != 1 || i + 1 < nitems) sm90::bar_arrive(2 + (wg ^ 1), TURN);\n")
# the fold: from its guard to the slot's release
_FOLD_START = "    if (sl == nslab - 1) {\n"
_FOLD_END = "    __syncwarp();\n"
_PER_SCORE = """    if (sl == nslab - 1) {
      const float* m2s = reinterpret_cast<const float*>(ring + s * SLOT + 2 * KC * CHUNK_BYTES);
      const int rows = min(TN, N - n0);
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 mm = *reinterpret_cast<const float2*>(m2s + c);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int cq = c + (q & 1), h = q >> 1;
          if (cq < rows) {
            const float sc = S[4 * j + q] - 0.5f * ((q & 1) ? mm.y : mm.x);
            if (sc > best[h]) {
              best[h] = sc;
              bidx[h] = n0 + cq;
            }
          }
        }
      }
    }
"""
# (K8's, K10's and K9's lists take the score too: a product whose sums
# nothing reads is dropped by the compiler, and their walks read their list
# (K8's and K10's `list`, K9's `top2`), not best; K4's score reads both of
# its sums for the same reason)
_NO_FOLD = """    if (sl == nslab - 1 && S[0] > best[0]) {
      best[0] = S[0];
      bidx[0] = n0;
      list.s[0][0] = S[0];
    }
"""
_NO_FOLD_K4 = """    if (sl == nslab - 1 && S1[0] - 0.5f * S2[0] > best[0]) {
      best[0] = S1[0] - 0.5f * S2[0];
      bidx[0] = n0;
      top2.s[0][0] = best[0];
    }
"""


def _replace_fold(src: str, fold: str) -> str:
    a = src.index(_FOLD_START)
    b = src.index(_FOLD_END, a)
    return src[:a] + fold + src[b:]


def variant_sources(src: str) -> dict:
    """{variant: the text of argmin_sm90.cu} from the walk's source `src`;
    raises ValueError if the walk no longer has the lines edited here."""
    missing = [s for s in _TURNS + (_FOLD_START, _FOLD_END) if s not in src]
    if missing:
        raise ValueError(f"argmin_sm90.cu lacks the lines the variants edit: {missing}")
    no_turns = src
    for line in _TURNS:
        no_turns = no_turns.replace(line, "")
    return {"walk": src, "no_turns": no_turns,
            "per_score": _replace_fold(no_turns, _PER_SCORE),
            "no_fold": _replace_fold(src, _NO_FOLD)}


def masked_variant_sources(src: str) -> dict:
    """{variant: the text of argmin_masked_sm90.cu} (K4 and K9) from its
    source `src`: the walk, and `no_fold` (its folds cut to one compare a
    tile);
    raises ValueError if the walk no longer has the lines edited here."""
    if _FOLD_START not in src or _FOLD_END not in src:
        raise ValueError("argmin_masked_sm90.cu lacks the lines the variants edit")
    return {"walk": src, "no_fold": _replace_fold(src, _NO_FOLD_K4)}


_ENTRIES = {"argmin_sm90.cu": ("somvq_dist_argmin", "somvq_dist_argmin_t", "somvq_dist_top2"),
            "argmin_masked_sm90.cu": ("somvq_dist_argmin_masked", "somvq_dist_top2_masked")}


def build(out: str = OUT) -> dict:
    """Each variant's copy of csrc/ with its argmin_sm90.cu (K1, K2, K8), or
    its argmin_masked_sm90.cu (K4 and K9, under the names "k4 walk" and "k4
    no_fold"), built by one nvcc each, all started together; {variant:
    loaded library}."""
    with open(os.path.join(_build.CSRC, "argmin_sm90.cu")) as f:
        jobs = [(name, "argmin_sm90.cu", text) for name, text in variant_sources(f.read()).items()]
    with open(os.path.join(_build.CSRC, "argmin_masked_sm90.cu")) as f:
        jobs += [(f"k4 {name}", "argmin_masked_sm90.cu", text)
                 for name, text in masked_variant_sources(f.read()).items()]
    nvcc = _build._nvcc()
    procs = []
    for name, source, text in jobs:
        d = os.path.join(out, name.replace(" ", "_"))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        with open(os.path.join(d, source), "w") as f:
            f.write(text)
        procs.append(_build._start([nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
                                    os.path.join(d, "lib.so"), os.path.join(d, source)],
                                   os.path.join(d, "nvcc.log")))
    _build._wait(procs)
    libs = {}
    for name, source, _ in jobs:
        lib = ctypes.CDLL(os.path.join(out, name.replace(" ", "_"), "lib.so"))
        for entry in _ENTRIES[source]:
            fn = getattr(lib, entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _call(lib, entry: str, x: torch.Tensor, codes: torch.Tensor):
    """The wrapper's C call on `lib`: (partial distance, index), the prologue
    included."""
    (B, D), N = x.shape, codes.shape[0]
    Dp = split_codes_dp(D)
    val = torch.empty((B,), dtype=torch.float32, device=x.device)
    idx = torch.empty((B,), dtype=torch.int32, device=x.device)
    scratch = torch.empty((2 * N * Dp + -(-N // 4) * 4 + 2 * B,), dtype=torch.float32,
                          device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rc = getattr(lib, entry)(x.data_ptr(), codes.data_ptr(), B, N, D, Dp,
                             k1_sm90_splits(B, N, sms), scratch.data_ptr(), val.data_ptr(),
                             idx.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")
    return val, idx


def _call_top2(lib, x: torch.Tensor, codes: torch.Tensor):
    """K8's C call on `lib`: (v1, i1, v2, i2) partial distances, the
    prologue included."""
    (B, D), N = x.shape, codes.shape[0]
    Dp = split_codes_dp(D)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = k1_sm90_splits(B, N, sms)
    out = [torch.empty((B,), dtype=dt, device=x.device)
           for dt in (torch.float32, torch.int32, torch.float32, torch.int32)]
    scratch = torch.empty((2 * N * Dp + -(-N // 4) * 4 + 4 * splits * B,),
                          dtype=torch.float32, device=x.device)
    rc = lib.somvq_dist_top2(x.data_ptr(), codes.data_ptr(), B, N, D, Dp, splits,
                             scratch.data_ptr(), *(t.data_ptr() for t in out),
                             torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"somvq_dist_top2: CUDA error {rc}")
    return out


def _call_masked(lib, x: torch.Tensor, codes: torch.Tensor, mask: torch.Tensor):
    """K4's C call on `lib`: (partial distance, index), the prologue
    included."""
    (B, D), N = x.shape, codes.shape[0]
    Dp = split_codes_dp(D)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    val = torch.empty((B,), dtype=torch.float32, device=x.device)
    idx = torch.empty((B,), dtype=torch.int32, device=x.device)
    scratch = torch.empty((4 * N * Dp + 2 * B,), dtype=torch.float32, device=x.device)
    rc = lib.somvq_dist_argmin_masked(x.data_ptr(), mask.data_ptr(), codes.data_ptr(), B, N,
                                      D, Dp, k4_sm90_splits(B, N, sms), scratch.data_ptr(),
                                      val.data_ptr(), idx.data_ptr(),
                                      torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"somvq_dist_argmin_masked: CUDA error {rc}")
    return val, idx


def _call_top2_masked(lib, x: torch.Tensor, codes: torch.Tensor, mask: torch.Tensor):
    """K9's C call on `lib`: (v1, i1, v2, i2) partial distances, the
    prologue included."""
    (B, D), N = x.shape, codes.shape[0]
    Dp = split_codes_dp(D)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = k4_sm90_splits(B, N, sms)
    out = [torch.empty((B,), dtype=dt, device=x.device)
           for dt in (torch.float32, torch.int32, torch.float32, torch.int32)]
    scratch = torch.empty((4 * N * Dp + 4 * splits * B,), dtype=torch.float32,
                          device=x.device)
    rc = lib.somvq_dist_top2_masked(x.data_ptr(), mask.data_ptr(), codes.data_ptr(), B, N, D,
                                    Dp, splits, scratch.data_ptr(),
                                    *(t.data_ptr() for t in out),
                                    torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"somvq_dist_top2_masked: CUDA error {rc}")
    return out


def _mask(B: int, D: int, dev: torch.device) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(6)
    return (torch.rand((B, D), generator=g, device=dev) < 0.1).to(torch.uint8)


def _inputs(B: int, N: int, D: int, seed: int, dev: torch.device):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((B, D), generator=g, device=dev),
            torch.randn((N, D), generator=g, device=dev))


def run(iters: int = 20, out: str = OUT) -> dict:
    """Build the variants, hold them to the walk, time them; the record."""
    dev = resolve("cuda")
    libs = build(out)
    match = {}
    for B, N, D in MATCH_CASES:
        x, codes = _inputs(B, N, D, 3, dev)
        v0, i0 = _call(libs["walk"], "somvq_dist_argmin", x, codes)
        for name in ("no_turns", "per_score"):
            v, i = _call(libs[name], "somvq_dist_argmin", x, codes)
            match.setdefault(name, []).append(
                bool(torch.equal(v.view(torch.int32), v0.view(torch.int32))
                     and torch.equal(i, i0)))
        p0, p1 = _call_top2(libs["walk"], x, codes), _call_top2(libs["no_turns"], x, codes)
        match.setdefault("k8 no_turns", []).append(
            all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(p0, p1)))
        mask = _mask(B, D, dev)
        v4, i4 = _call_masked(libs["k4 walk"], x, codes, mask)
        v9, i9, _, _ = _call_top2_masked(libs["k4 walk"], x, codes, mask)
        match.setdefault("k9 best is k4's", []).append(
            bool(torch.equal(v9.view(torch.int32), v4.view(torch.int32)) and torch.equal(i9, i4)))
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    times = {}
    for B, N, D, entry in TIMED_CASES:
        x, codes = _inputs(B, N, D, 5, dev)
        n = 3 if B >= 100_000 else iters
        ms = {name: [] for name in VARIANTS}
        for name in order:
            ms[name].append(mean_ms(lambda: _call(libs[name], entry, x, codes), dev, n))
        times[f"{'K2' if entry.endswith('_t') else 'K1'} {B}x{N}x{D}"] = ms
        del x, codes
        torch.cuda.empty_cache()
    x, codes = _inputs(*K8_CASE, 5, dev)
    ms = {name: [] for name in K8_VARIANTS}
    for name in list(K8_VARIANTS) + list(K8_VARIANTS)[::-1]:
        ms[name].append(mean_ms(lambda: _call_top2(libs[name], x, codes), dev, iters))
    times["K8 {}x{}x{}".format(*K8_CASE)] = ms
    for B, N, D in K4_CASES:
        x, codes = _inputs(B, N, D, 5, dev)
        mask = _mask(B, D, dev)
        n = 3 if B >= 100_000 else iters
        ms = {"walk": [], "no_fold": []}
        for name in ("walk", "no_fold", "no_fold", "walk"):
            ms[name].append(mean_ms(lambda: _call_masked(libs[f"k4 {name}"], x, codes, mask),
                                    dev, n))
        times[f"K4 {B}x{N}x{D} p0.1"] = ms
        del x, codes, mask
        torch.cuda.empty_cache()
    x, codes = _inputs(*K9_CASE, 5, dev)
    mask = _mask(K9_CASE[0], K9_CASE[2], dev)
    ms = {"walk": [], "no_fold": []}
    for name in ("walk", "no_fold", "no_fold", "walk"):
        ms[name].append(mean_ms(lambda: _call_top2_masked(libs[f"k4 {name}"], x, codes, mask),
                                dev, iters))
    times["K9 {}x{}x{} p0.1".format(*K9_CASE)] = ms
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    return dict(card=card, bit_equal_to_walk=match, ms=times,
                matched=all(all(v) for v in match.values()))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    rec = run(args.iters)
    print(json.dumps(rec))
    return 0 if rec["matched"] else 1


if __name__ == "__main__":
    sys.exit(main())
