"""BASELINE config 5, single-device portion: train a SOM on 1 M vectors
streamed from disk through the buffered input pipeline.  The port's
counterpart of examples/streaming_som.py: the same defaults, file bytes,
schedule and JSON summary.

The reference handles files bigger than RAM with LOADMODE_BUFFER
(datafile.c:237-344): refill a linked-list buffer inside next_entry,
rewind per lap.  Here the same contract is data.streaming.StreamingReader
(a background prefetch thread parsing each chunk with the native C++
engine, data.native_io) feeding SOMTrainer, which copies each chunk to
the card and runs the fused training step the trainer picks there.
`device="cpu"` runs the plain PyTorch versions; without a GPU the default
"cuda" raises.

Run:
    python -m som_lvq_pak_torch.examples.streaming_som        # 1M x 64, 128x128 map
    python -m som_lvq_pak_torch.examples.streaming_som --n 50000 --map 32 \\
        --device cpu                                          # CPU smoke

Prints a JSON summary: end-to-end samples/s (parse + H2D + train), the
qerror before/after on a held-out subsample, and wall times.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from ..data.dataset import Neighborhood, Topology
from ..data.streaming import StreamingReader
from ..models.som import find_qerror, randinit
from ..models.trainer import SOMTrainer
from ..utils.rng import CRandom


def generate_file(path: str, n: int, dim: int, n_clusters: int = 64,
                  seed: int = 7, chunk: int = 50_000) -> float:
    """Write an n x dim data file in the package text format (the same
    bytes as examples/streaming_som.py:generate_file for the same
    arguments); returns the seconds it took."""
    t0 = time.perf_counter()
    r = np.random.RandomState(seed)
    centers = r.uniform(-4.0, 4.0, size=(n_clusters, dim)).astype(np.float32)
    with open(path, "w") as f:
        f.write(f"{dim}\n")
        done = 0
        while done < n:
            m = min(chunk, n - done)
            asg = r.randint(0, n_clusters, size=m)
            pts = centers[asg] + r.normal(0, 0.5, size=(m, dim)).astype(np.float32)
            np.savetxt(f, pts, fmt="%.4f")
            done += m
    return time.perf_counter() - t0


def head_codebook(path: str, side: int, buffer: int = 16384):
    """The file's first `buffer`-row chunk and the example's initial
    codebook: randinit (CRandom(123)) of a side x side hexa gaussian map in
    that chunk's min/max box.  Returns (head, codes)."""
    head = next(iter(StreamingReader(path, buffer=buffer).chunks(laps=1)))
    rng = CRandom()
    rng.init_random(123)
    codes = randinit(head, topol=Topology.HEXA, neigh=Neighborhood.GAUSSIAN,
                     xdim=side, ydim=side, rng=rng)
    return head, codes


def fit_stream(tr: SOMTrainer, path: str, rlen: int, buffer: int = 16384):
    """`tr.fit` over `rlen` samples of `path` streamed in `buffer`-row
    chunks, at the example's schedule (alpha 0.05, radius half the map's
    side); returns the trained host codebook."""
    return tr.fit(StreamingReader(path, buffer=buffer).chunks(laps=None),
                  rlen=rlen, alpha=0.05, radius=tr.meta.xdim / 2.0)


def run_streaming_som(path: str, n: int, dim: int, side: int, batch: int,
                      buffer: int = 16384, laps: int = 0, device="cuda") -> dict:
    """Stream `path` (written by `generate_file` first if it is missing)
    through one SOMTrainer.fit of max(1, laps) laps; returns the summary
    dict (importable for tests)."""
    gen_s = 0.0
    if not os.path.exists(path):
        gen_s = generate_file(path, n, dim)

    # init from the first buffer's worth of data (enough for min/max box)
    head, codes = head_codebook(path, side, buffer)
    q0 = find_qerror(codes, head, mode="fast", device=device) / head.n

    rlen = n * max(1, laps)
    tr = SOMTrainer(codes, batch_size=batch, device=device)
    t0 = time.perf_counter()
    codes = fit_stream(tr, path, rlen, buffer)
    wall = time.perf_counter() - t0  # fit returns a host codebook: the card is done
    q1 = find_qerror(codes, head, mode="fast", device=device) / head.n

    return {
        "n": n, "dim": dim, "map": [side, side], "rlen": rlen,
        "file_mb": round(os.path.getsize(path) / 1e6, 1),
        "gen_wall_s": round(gen_s, 1),
        "train_wall_s": round(wall, 2),
        "samples_per_s": round(rlen / wall),
        "qerror_subsample": [round(float(q0), 4), round(float(q1), 4)],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m som_lvq_pak_torch.examples.streaming_som")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--map", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--buffer", type=int, default=16384)
    ap.add_argument("--laps", type=int, default=1)
    ap.add_argument("--file", default="")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the kernels) or "cpu" (their plain versions)')
    args = ap.parse_args(argv)

    path = args.file or os.path.join(tempfile.gettempdir(),
                                     f"stream_som_{args.n}x{args.dim}.dat")
    summary = run_streaming_som(path, args.n, args.dim, args.map, args.batch,
                                args.buffer, args.laps, device=args.device)
    print(json.dumps(summary))
    if not summary["qerror_subsample"][1] < summary["qerror_subsample"][0]:
        raise AssertionError("streamed training must reduce quantization error")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
