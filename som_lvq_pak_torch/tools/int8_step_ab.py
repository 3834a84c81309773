"""The int8 winner contraction inside the fused step, A/B on the card: the
counterpart of tools/int8_step_ab.py (the JAX package's only caller of
`int8_win` end to end).

    python -m som_lvq_pak_torch.tools.int8_step_ab [--xdim 256] [--batch 4096]

At the JAX tool's shape: a 256x256 hexa gaussian map (65,536 units), D 64,
B 4096, the batch-chunked step (K14) with chunk 1024 and the bf16 x-pattern,
tile 256 (one grid row); data from `default_rng(7)` centres, codes
clustered(N, 1), batches clustered(B, 2) and clustered(B, 3).

(a) Step time per chain, interleaved round by round (CUDA events over
    `time_steps` chained steps at alpha 0.02, radius 3): float32 winners
    (`f32`, K14's main form), `int8_win` (K14's walk with the winners on
    int8 mma.sync) and `stagger` (K14's walk on a persistent grid, float32
    winners), all on the tensor cores; beside them K17
    (`ops.skeleton.fused_step_skeleton`, the step's matmul-only twin at the
    same shape, float32 W and X) and attainable_pct = 100 * skeleton ms /
    step ms per chain.
(b) The quality gate: each chain trains `steps` (64) steps at alpha 0.05,
    radius 24 over clustered(B, 100 + i), from K1's prologue winners, then
    `find_qerror` over clustered(262144, 999) (K2).  `int8_win`'s qerror must
    be within 1% of float32's, and the `stagger` chain's codebook bit-equal
    to the `f32` chain's (stagger changes the schedule, not the result).

The port keeps D unpadded (no 128-lane padding), so the JAX tool's
`int8_win_k128` chain (the int8 contraction over the padded width) has no
counterpart; its `f32_dreal64` and `int8_win_dreal64` are `f32` and
`int8_win` here.  Prints one JSON line; a failed gate raises (exit
non-zero).  `device="cpu"` runs the plain versions at a small size, timed by
the host clock.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..models.som import find_qerror
from ..ops.dist_argmin import dist_argmin
from ..ops.skeleton import fused_step_skeleton
from ..ops.som_step import som_fused_train_step
from .timing import mean_ms, resolve, sync

D = 64
CHAINS = {"f32": {}, "int8_win": {"int8_win": True}, "stagger": {"stagger": True}}
QERROR_REL = 0.01


def clustered_source(dim: int = D):
    """`clustered(n, seed)` of the JAX tool: 16 centres at N(0, 4) drawn by
    default_rng(7), unit-variance noise drawn by default_rng(seed)."""
    centers = np.random.default_rng(7).normal(0, 4.0, size=(16, dim)).astype(np.float32)

    def clustered(n: int, seed: int) -> np.ndarray:
        r = np.random.default_rng(seed)
        return (centers[r.integers(0, 16, size=n)]
                + r.normal(0, 1.0, size=(n, dim)).astype(np.float32))
    return clustered


def _step_fn(xdim: int, batch: int, alpha: float, radius: float, kw: dict):
    """One K14 step of the A/B's configuration: hexa gaussian, tile = one
    grid row, chunk 1024 (the batch, if smaller), the bf16 x-pattern."""
    def step(c, bm, x, xn):
        return som_fused_train_step(c, x, bm, xn, xdim, True, alpha, radius, True,
                                    tile_n=xdim, factored=True,
                                    batch_chunk=min(1024, batch), wxa_bf16=True, **kw)
    return step


def step_times(codes, xb, xn, bmu0, xdim, dev, time_steps=20, rounds=3) -> dict:
    """(a): milliseconds per step of each chain (median over rounds of the
    mean over `time_steps` chained steps), and K17's at the same shape."""
    batch = xb.shape[0]
    per = {name: [] for name in CHAINS}
    for _ in range(rounds):
        for name, kw in CHAINS.items():
            step = _step_fn(xdim, batch, 0.02, 3.0, kw)
            state = [codes.clone(), bmu0]

            def one():
                c, bm, _ = step(state[0], state[1], xb, xn)
                state[1] = bm
            per[name].append(mean_ms(one, dev, time_steps))
    out = {f"{name}_step_ms": float(np.median(v)) for name, v in per.items()}
    g = torch.Generator(device=dev).manual_seed(5)
    w = torch.rand((xdim, batch), generator=g, device=dev) * 0.001
    x = torch.randn((batch, D), generator=g, device=dev)
    c = torch.randn(codes.shape, generator=g, device=dev)
    out["skeleton_ms"] = mean_ms(lambda: fused_step_skeleton(c, w, x, x), dev, time_steps)
    for name in CHAINS:
        out[f"{name}_attainable_pct"] = 100.0 * out["skeleton_ms"] / out[f"{name}_step_ms"]
    return out


def quality_gate(codes, clustered, xdim, batch, dev, steps=64, n_eval=262144) -> dict:
    """(b): train each chain, then its qerror per sample; the gates."""
    batches = [torch.from_numpy(clustered(batch, 100 + i)).to(dev) for i in range(steps)]
    evalx = torch.from_numpy(clustered(n_eval, 999)).to(dev)
    out, finals = {}, {}
    for name, kw in CHAINS.items():
        step = _step_fn(xdim, batch, 0.05, 24.0, kw)
        sync(dev)
        t0 = time.perf_counter()
        c = codes.clone()
        bm = dist_argmin(batches[0], c)[1]
        for i in range(steps):
            c, bm, _ = step(c, bm, batches[i], batches[(i + 1) % steps])
        sync(dev)
        out[f"{name}_train_s"] = time.perf_counter() - t0
        if not bool(torch.isfinite(c).all()):
            raise AssertionError(f"int8_step_ab: the {name} chain's codebook is not finite")
        out[f"{name}_qerror"] = find_qerror(c, evalx) / n_eval
        finals[name] = c
    q32, q8 = out["f32_qerror"], out["int8_win_qerror"]
    out["int8_rel_delta"] = abs(q8 - q32) / q32
    out["stagger_codes_equal"] = bool(torch.equal(finals["stagger"], finals["f32"]))
    if not out["int8_rel_delta"] <= QERROR_REL:
        raise AssertionError(f"int8_step_ab: int8_win qerror {q8} vs float32 {q32} "
                             f"(> {QERROR_REL:.0%})")
    if not out["stagger_codes_equal"]:
        raise AssertionError("int8_step_ab: the stagger chain's codebook differs from "
                             "the f32 chain's")
    return out


def run(xdim: int = 256, ydim: int = 256, batch: int = 4096, steps: int = 64,
        n_eval: int = 262144, time_steps: int = 20, rounds: int = 3,
        device="cuda") -> dict:
    """(a) then (b) at a xdim x ydim map; returns one record."""
    dev = resolve(device)
    clustered = clustered_source()
    codes = torch.from_numpy(clustered(xdim * ydim, 1)).to(dev)
    xb = torch.from_numpy(clustered(batch, 2)).to(dev)
    xn = torch.from_numpy(clustered(batch, 3)).to(dev)
    bmu0 = dist_argmin(xb, codes)[1]
    out = dict(device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               map=[xdim, ydim], batch=batch, dim=D, steps=steps, n_eval=n_eval)
    out.update(step_times(codes, xb, xn, bmu0, xdim, dev, time_steps, rounds))
    out.update(quality_gate(codes, clustered, xdim, batch, dev, steps, n_eval))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--xdim", type=int, default=256)
    ap.add_argument("--ydim", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--eval", type=int, default=262144)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.xdim, a.ydim, a.batch, a.steps, a.eval, device=a.device)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
