"""Does an int8 winner contraction pay on the card?  The counterpart of
tools/int8_probe.py (the JAX package's probe on the TPU).

    python -m som_lvq_pak_torch.tools.int8_probe [--n 4096] [--rows 65536]
                                                 [--dim 64] [--batch 4096]

(a) The library rates at n^3: `torch.mm` in bf16 against `torch._int_mm` in
    int8 (the JAX probe times XLA's dots here, not a kernel of its own).
(b) The winner contraction at rows x dim x batch, max over rows of m . x into
    (batch,): K15 (`ops.winner_probe.int8_winner_probe`, int8 wgmma on the
    tensor cores) against K16 (`f32_winner_probe`, split TF32 mma.sync on
    the tensor cores) on the same integer values, which must agree exactly,
    and the int8 speedup; K15's rate sits beside (a)'s int8 rate.

Inputs come from a seeded torch.Generator; times are CUDA events, the mean
of `iters` calls after a warm-up.  Prints one JSON line with the four rates;
a failed check raises (exit non-zero).  `device="cpu"` runs the plain
versions at a small size, timed by the host clock: a CPU time, no device
rate.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from ..ops.winner_probe import f32_winner_probe, int8_winner_probe
from .timing import mean_ms, resolve


def _int8(g, shape, dev):
    return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)


def library_rates(n: int = 4096, device="cuda", iters: int = 10, seed: int = 0) -> dict:
    """(a): bf16 and int8 library matmuls at n x n x n; rates in TFLOP/s and
    TOP/s (2 n^3 operations)."""
    dev = resolve(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    a16 = torch.randn((n, n), generator=g, device=dev).to(torch.bfloat16)
    b16 = torch.randn((n, n), generator=g, device=dev).to(torch.bfloat16)
    a8, b8 = _int8(g, (n, n), dev), _int8(g, (n, n), dev)
    ms16 = mean_ms(lambda: torch.mm(a16, b16), dev, iters)
    ms8 = mean_ms(lambda: torch._int_mm(a8, b8), dev, iters)
    ops = 2.0 * n ** 3
    return dict(n=n, bf16_mm_ms=ms16, int8_mm_ms=ms8, bf16_mm_tflops=ops / ms16 / 1e9,
                int8_mm_tops=ops / ms8 / 1e9, int8_over_bf16=ms16 / ms8)


def winner_rates(rows: int = 65536, dim: int = 64, batch: int = 4096, device="cuda",
                 iters: int = 10, seed: int = 1) -> dict:
    """(b): K15 and K16 on the same integer values; they must agree exactly
    (both are exact at |sum| < 2^24)."""
    dev = resolve(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    m8, x8 = _int8(g, (rows, dim), dev), _int8(g, (dim, batch), dev)
    m32, x32 = m8.to(torch.float32), x8.to(torch.float32)
    got8 = int8_winner_probe(m8, x8)
    got32 = f32_winner_probe(m32, x32)
    if not torch.equal(got8.to(torch.float32), got32):
        raise AssertionError("int8_winner_probe and f32_winner_probe disagree on "
                             "integer inputs")
    ms8 = mean_ms(lambda: int8_winner_probe(m8, x8), dev, iters)
    ms32 = mean_ms(lambda: f32_winner_probe(m32, x32), dev, iters)
    ops = 2.0 * rows * dim * batch
    return dict(shape=[rows, dim, batch], int8_winner_ms=ms8, f32_winner_ms=ms32,
                int8_winner_tops=ops / ms8 / 1e9, f32_winner_tflops=ops / ms32 / 1e9,
                int8_speedup=ms32 / ms8)


def run(n: int = 4096, rows: int = 65536, dim: int = 64, batch: int = 4096,
        device="cuda", iters: int = 10) -> dict:
    dev = resolve(device)
    out = dict(device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    out.update(library_rates(n, dev, iters))
    out.update(winner_rates(rows, dim, batch, dev, iters))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--rows", type=int, default=65536)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.n, a.rows, a.dim, a.batch, a.device, a.iters)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
