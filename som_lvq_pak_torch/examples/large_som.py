"""BASELINE.json config 4: a large SOM (default 128x128 units) trained on
synthetic 100k x 64-dim data with a quantization-error curve and a Sammon
projection of the trained codebook.  The port's counterpart of
examples/large_som.py: the same defaults, data, schedule and JSON summary.

The reference tops out at 12x8 maps trained one sample at a time
(som_rout.c:556-671); this drives the production path instead: the
minibatch SOMTrainer (models/trainer.py: the fused step the trainer picks
with `fused_step_choice`, K13 at 128x128 and B 1024), `find_qerror` on K2,
and `sammon_fast`, all on the card.  `device="cpu"` runs the plain PyTorch
versions; without a GPU the default "cuda" raises.

Run:
    python -m som_lvq_pak_torch.examples.large_som                   # full size
    python -m som_lvq_pak_torch.examples.large_som --n 2000 --map 16 \\
        --batch 256 --device cpu                                     # CPU smoke

Prints a JSON summary: qerror after each training phase (the curve must
be decreasing), wall time, and the Sammon mapping error of a codebook
subsample.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from ..data.dataset import Dataset, Neighborhood, Topology
from ..models.sammon import mapping_error, sammon_fast
from ..models.som import find_qerror, randinit
from ..models.trainer import SOMTrainer
from ..ops import exact
from ..utils.rng import CRandom


def synthetic_data(n: int, dim: int, n_clusters: int = 64, seed: int = 7):
    """Gaussian cluster mixture: enough structure that a trained map has
    visibly lower qerror than an untrained one (examples/large_som.py's
    draws, value for value)."""
    r = np.random.RandomState(seed)
    centers = r.uniform(-4.0, 4.0, size=(n_clusters, dim)).astype(np.float32)
    asg = r.randint(0, n_clusters, size=n)
    pts = centers[asg] + r.normal(0, 0.5, size=(n, dim)).astype(np.float32)
    return pts.astype(np.float32)


def run_large_som(n: int, dim: int, side: int, batch: int, rlen: int = 0,
                  sammon_sub: int = 512, device="cuda") -> dict:
    """Train the map and return the summary dict (importable for tests)."""
    data = Dataset(synthetic_data(n, dim))
    rng = CRandom()
    rng.init_random(123)
    codes = randinit(data, topol=Topology.HEXA, neigh=Neighborhood.GAUSSIAN,
                     xdim=side, ydim=side, rng=rng)
    if codes.n != side * side:
        raise AssertionError(f"map of {codes.n} units, asked for {side} x {side}")

    rlen = rlen or 20 * n
    curve = [find_qerror(codes, data, mode="fast", device=device) / data.n]
    t0 = time.perf_counter()
    # two-phase schedule, scaled from the reference somexample
    # (Makefile:195-205): coarse wide-radius ordering then fine-tuning;
    # find_qerror returns a host float, so each reading ends on the device
    tr = SOMTrainer(codes, batch_size=batch, device=device)
    codes = tr.fit(data, rlen=rlen, alpha=0.05, radius=side / 2.0)
    curve.append(find_qerror(codes, data, mode="fast", device=device) / data.n)
    tr = SOMTrainer(codes, batch_size=batch, device=device)
    codes = tr.fit(data, rlen=rlen, alpha=0.02, radius=3.0)
    curve.append(find_qerror(codes, data, mode="fast", device=device) / data.n)
    wall = time.perf_counter() - t0

    # Sammon projection of a codebook subsample (the full-map pairwise
    # table is O(noc^2); project a spread subsample like a user would)
    sub = Dataset(codes.points[:: max(1, codes.n // sammon_sub)].copy())
    proj, deduped = sammon_fast(sub, length=100, seed=1, device=device)
    dmat = exact.pairwise_dist_euc(deduped.points, deduped.points, None, None)

    return {
        "n": n, "dim": dim, "map": [side, side], "rlen_per_phase": rlen,
        "qerror_curve": [round(float(q), 4) for q in curve],
        "train_wall_s": round(wall, 2),
        "samples_per_s": round(2 * rlen / wall),
        "sammon_points": deduped.n,
        "sammon_requested": sub.n,
        "sammon_mapping_error": round(float(mapping_error(proj, dmat)), 6),
    }


def check_summary(summary: dict) -> None:
    """Quality gates (importable by tests): training must not just nudge
    qerror down but meaningfully order the map, and the codebook must not
    collapse to a handful of distinct vectors.  Raises AssertionError."""
    curve = summary["qerror_curve"]
    if not curve[-1] < curve[0]:
        raise AssertionError("training must reduce quantization error")
    if not curve[-1] < 0.7 * curve[0]:
        raise AssertionError(
            f"qerror must drop by >30% (got {curve[0]:.4f} -> {curve[-1]:.4f})")
    # codebook collapse check: the Sammon subsample must stay diverse
    # after remove_identicals (a collapsed map dedupes to a few points)
    if not summary["sammon_points"] >= summary["sammon_requested"] // 4:
        raise AssertionError(
            f"codebook collapse: only {summary['sammon_points']} unique points "
            f"of {summary['sammon_requested']} sampled")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m som_lvq_pak_torch.examples.large_som")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--map", type=int, default=128, help="map side (map x map units)")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--rlen", type=int, default=0,
                    help="samples per phase (default 20 laps over the data)")
    ap.add_argument("--sammon-sub", type=int, default=512,
                    help="codebook subsample for the Sammon projection")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the kernels) or "cpu" (their plain versions)')
    args = ap.parse_args(argv)

    summary = run_large_som(args.n, args.dim, args.map, args.batch,
                            args.rlen, args.sammon_sub, device=args.device)
    print(json.dumps(summary))
    check_summary(summary)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
