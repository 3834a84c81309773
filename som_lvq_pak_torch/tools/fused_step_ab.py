"""The tensor-core fused steps on one step body (csrc/fused_step_tc.cuh):
K3, K13 and K14's main form, and the winner walks K4 (masked,
csrc/argmin_masked_sm90.cu), K8 (csrc/argmin_sm90.cu) and K10
(csrc/dist_topk.cu, at k 2 and 8), timed side by side on one tree, with a
digest of every output so that two trees can be held bit for bit against
each other.

    python -m som_lvq_pak_torch.tools.fused_step_ab [--iters 10] [--device cuda]

For each case (map, topology, neighbourhood, B, D, radius): K3
(`som_fused_train_step(factored=False)`) and, where the case names it, K13
(`som_fused_factored_step`) and, where B is also a multiple of 128, K14's
main form (`som_fused_factored_chunked_step`, "k14") and its bf16-batch form
(`batch_bf16=True`, "k14_bf16") on the same inputs, made on the device from
seed 4 (codes, both batches and the per-sample alphas from `randn`/`rand`,
the BMUs from `dist_argmin_plain`, seven samples without one).  For each
kernel: the mean milliseconds per step over `iters` steps after a warm-up
(CUDA events), and the SHA-256 of its updated codebook, winners and values
from one step on fresh inputs.  For each winner case (B, N, D): K4
(`dist_argmin` with a mask, p 0.1 and every 97th row masked), K8
(`dist_top2`) and K10 (`dist_topk` at k 2 and 8) on inputs from seed 5,
their ms and the SHA-256 of their values and indices.  Run it in two checkouts in one call
(parent, change, change, parent) and compare: equal digests mean the same
floats.  Prints one JSON line.  `device="cpu"` runs the plain versions,
timed by the host clock (a CPU time, never a device number).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import torch

from ..ops.dist_argmin import dist_argmin, dist_argmin_plain
from ..ops.dist_top2 import dist_top2
from ..ops.dist_topk import dist_topk
from ..ops.som_step import (som_fused_factored_chunked_step, som_fused_factored_step,
                            som_fused_train_step)
from .timing import mean_ms, resolve

# (xdim, ydim, hexa, gaussian, B, D, radius, K13 too): the 1M cell's step,
# K13's main-path shapes, and K3's D 5, ragged D 37 and D 200 cases; K14 runs
# where K13 does and B is a multiple of 128 (its batch chunk)
CASES = ((256, 256, True, True, 4096, 64, 64.0, False),
         (128, 128, True, True, 1024, 64, 32.0, True),
         (64, 64, True, True, 512, 64, 16.0, True),
         (256, 256, True, True, 1024, 64, 64.0, True),
         (64, 64, True, False, 4096, 64, 16.0, True),
         (12, 8, True, False, 1000, 5, 3.0, True),
         (10, 6, True, True, 100, 37, 3.0, True),
         (16, 16, False, True, 256, 200, 4.0, True))


# (B, N, D) of the winner walks: the LVQ step, the masked 1M cell's step,
# the sharded lvq3 rank's step, the masked LVQ cell's step, a ragged D 37 and
# D 130 (64-feature slabs)
WINNER_CASES = ((1024, 65536, 64), (4096, 65536, 64), (512, 32768, 64), (1024, 4096, 64),
                (777, 3001, 37), (1000, 2999, 130))


def _k3(*a):
    return som_fused_train_step(*a, factored=False)


def _k14_bf16(*a):
    return som_fused_factored_chunked_step(*a, batch_bf16=True)


def kernels(B, k13) -> tuple:
    """The (name, step) pairs a case runs."""
    out = (("k3", _k3),)
    if k13:
        out += (("k13", som_fused_factored_step),)
    if k13 and B % 128 == 0:
        out += (("k14", som_fused_factored_chunked_step), ("k14_bf16", _k14_bf16))
    return out


def _digest(ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def run_case(xdim, ydim, hexa, gaussian, B, D, radius, k13, dev, iters=10) -> dict:
    """One case: ms and digest for each of `kernels(B, k13)`."""
    g = torch.Generator(device=dev).manual_seed(4)
    codes = torch.randn((xdim * ydim, D), generator=g, device=dev)
    xb = torch.randn((B, D), generator=g, device=dev)
    xn = torch.randn((B, D), generator=g, device=dev)
    bmu = dist_argmin_plain(xb, codes)[1]
    bmu[:7] = -1
    alpha = 0.02 + 0.06 * torch.rand((B,), generator=g, device=dev)
    out = dict(case=f"{xdim}x{ydim} {'hexa' if hexa else 'rect'} "
                    f"{'gaussian' if gaussian else 'bubble'} B {B} D {D}")
    for name, fn in kernels(B, k13):
        args = (xb, bmu, xn, xdim, hexa, alpha, radius, gaussian)
        out[f"{name}_digest"] = _digest(fn(codes.clone(), *args))
        work = codes.clone()
        out[f"{name}_ms"] = mean_ms(lambda: fn(work, *args), dev, iters)
    return out


def run_winners(B, N, D, dev, iters=10) -> dict:
    """One winner case: ms and digest of K4, K8 and K10 at k 2 and 8."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((B, D), generator=g, device=dev)
    codes = torch.randn((N, D), generator=g, device=dev)
    mask = (torch.rand((B, D), generator=g, device=dev) < 0.1).to(torch.uint8)
    mask[::97] = 1
    out = dict(case=f"B {B} N {N} D {D}")
    for name, fn in (("k4", lambda: dist_argmin(x, codes, mask)),
                     ("k8", lambda: dist_top2(x, codes)),
                     ("k10_k2", lambda: dist_topk(x, codes, 2)),
                     ("k10_k8", lambda: dist_topk(x, codes, 8))):
        out[f"{name}_digest"] = _digest(fn())
        out[f"{name}_ms"] = mean_ms(fn, dev, iters)
    return out


def run(iters: int = 10, device="cuda") -> dict:
    dev = resolve(device)
    return dict(device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                cases=[run_case(*c, dev=dev, iters=iters) for c in CASES],
                winners=[run_winners(*c, dev=dev, iters=iters) for c in WINNER_CASES])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    print(json.dumps(run(a.iters, a.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
