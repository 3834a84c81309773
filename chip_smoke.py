#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (som_lvq_pak_torch).

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero without them.  Phases, each
printing one JSON line:

1. env      torch/CUDA/nvcc versions, card name and power limit;
2. build    compiles som_lvq_pak_torch/csrc/*.cu for sm_90a (timed);
3. kernels  each CUDA kernel against its plain PyTorch version on the card
            (winners equal except at near-ties, values/codebooks to 1e-4),
            with kernel and plain times from CUDA events;
4. e2e_128x128_100k  SOMTrainer.fit on a stream, then find_qerror(fast),
            through the kernels (launch counters must move) and through the
            plain versions; qerror within 1% of the plain run and 2% of the
            JAX package's anchor;
5. e2e_256x256_1M    the 1M x 64 run of bench.py:run_e2e_1m_65k, qerror
            within 2% of the JAX package's anchor.

Then one line with every kernel's record, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failure ends the run non-zero first.

Nothing here imports jax.  The host types (Dataset, Topology, CRandom) are
the ones the port shares with the JAX package's jax-free data and utils
modules, reached through the port.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

# quality anchors of the JAX package on these runs (BENCH_r05.json)
ANCHOR_128 = 7.7118
ANCHOR_1M = 7.754


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean milliseconds per call of fn() by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_winners(name, x, codes, ik, ip, rel=1e-5):
    """Kernel and plain winners must agree except where the two candidate
    rows' distances differ by less than `rel` (relative, in float64)."""
    import torch

    bad = (ik.long() != ip.long()).nonzero()[:, 0]
    if bad.numel():
        xb = x[bad].double()
        da = ((xb - codes[ik[bad].long()].double()) ** 2).sum(-1)
        db = ((xb - codes[ip[bad].long()].double()) ** 2).sum(-1)
        gap = (da - db).abs() / torch.clamp(torch.maximum(da, db), min=1e-30)
        worst = float(gap.max())
        if worst >= rel:
            raise AssertionError(f"{name}: {bad.numel()} winners differ, "
                                 f"largest relative gap {worst:.3g} >= {rel}")
    return int(bad.numel())


def phase_distance(name, kernel, plain, B, N, D, seed, dup=False, iters=10):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, D), generator=g, device="cuda")
    if dup:  # every row three times: the lowest index must win exact ties
        base = torch.randn((N // 3, D), generator=g, device="cuda")
        codes = torch.cat([base, base, base]).contiguous()
    else:
        codes = torch.randn((N, D), generator=g, device="cuda")
    vk, ik = kernel(x, codes)
    vp, ip = plain(x, codes)
    torch.cuda.synchronize()
    if dup and int(ik.max()) >= N // 3:
        raise AssertionError(f"{name}: a duplicate row beat its first copy")
    n_diff = check_winners(name, x, codes, ik, ip)
    if not torch.allclose(vk, vp, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"{name}: values differ by {float((vk - vp).abs().max())}")
    rec = dict(kernel=name, shape=[B, N, D], dup=dup, winners_differ=n_diff,
               max_abs_err=float((vk - vp).abs().max()),
               ms=cuda_ms(lambda: kernel(x, codes), iters),
               plain_ms=cuda_ms(lambda: plain(x, codes), iters))
    emit("kernels", **rec)
    return rec


def phase_step(kernel, plain, xdim, ydim, hexa, gaussian, B, D, radius, seed):
    import torch

    from som_lvq_pak_torch.ops.dist_argmin import dist_argmin_plain

    noc = xdim * ydim
    g = torch.Generator(device="cuda").manual_seed(seed)
    codes = torch.randn((noc, D), generator=g, device="cuda")
    xb = torch.randn((B, D), generator=g, device="cuda")
    xn = torch.randn((B, D), generator=g, device="cuda")
    bmu = dist_argmin_plain(xb, codes)[1]
    bmu[:7] = -1  # samples without a BMU teach nothing
    alpha = 0.02 + 0.06 * torch.rand((B,), generator=g, device="cuda")
    ck, ik, vk = kernel(codes.clone(), xb, bmu, xn, xdim, hexa, alpha, radius, gaussian)
    cp, ip, vp = plain(codes.clone(), xb, bmu, xn, xdim, hexa, alpha, radius, gaussian)
    torch.cuda.synchronize()
    name = f"som_fused_train_step {xdim}x{ydim} {'hexa' if hexa else 'rect'} " \
           f"{'gaussian' if gaussian else 'bubble'}"
    if not torch.allclose(ck, cp, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"{name}: codebooks differ by {float((ck - cp).abs().max())}")
    n_diff = check_winners(name, xn, ck, ik, ip)
    if not torch.allclose(vk, vp, rtol=1e-4, atol=1e-3):
        raise AssertionError(f"{name}: winner values differ by {float((vk - vp).abs().max())}")
    work = codes.clone()
    rec = dict(kernel=name, shape=[noc, B, D], radius=radius, winners_differ=n_diff,
               max_abs_err=float((ck - cp).abs().max()),
               ms=cuda_ms(lambda: kernel(work, xb, bmu, xn, xdim, hexa, alpha, radius, gaussian)),
               plain_ms=cuda_ms(lambda: plain(work, xb, bmu, xn, xdim, hexa, alpha, radius, gaussian)))
    emit("kernels", **rec)
    return rec


def blob_data(seed: int, n: int, n_centres: int):
    """bench.py's e2e data: gaussian clusters around N(0, 4) centres."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 4.0, size=(n_centres, 64)).astype(np.float32)
    return (centres[rng.integers(0, n_centres, size=n)]
            + rng.normal(0, 1.0, size=(n, 64)).astype(np.float32))


def stream(X, chunk: int, total: int):
    from som_lvq_pak_torch.models.som import Dataset

    sent, n = 0, X.shape[0]
    while sent < total:
        lo = sent % n
        hi = min(lo + chunk, n)
        yield Dataset(points=X[lo:hi])
        sent += hi - lo


@contextlib.contextmanager
def plain_kernels():
    """Route the trainer and the qerror through the plain versions (for the
    reference run on the card); restores the kernels on exit."""
    from som_lvq_pak_torch.models import som, trainer
    from som_lvq_pak_torch.ops import dist_argmin as da
    from som_lvq_pak_torch.ops import som_step

    saved = (trainer.dist_argmin, trainer.som_fused_train_step, som.dist_argmin_t)
    trainer.dist_argmin = da.dist_argmin_plain
    trainer.som_fused_train_step = som_step.som_fused_train_step_plain
    som.dist_argmin_t = da.dist_argmin_t_plain
    try:
        yield
    finally:
        trainer.dist_argmin, trainer.som_fused_train_step, som.dist_argmin_t = saved


def e2e(X, map_dim, bs, radius, chunk):
    """One streamed lap of SOMTrainer.fit, then find_qerror(fast) on a
    device-resident copy; returns (per-sample qerror, train_s, eval_s)."""
    import torch

    from som_lvq_pak_torch.models.som import (CRandom, Dataset, Neighborhood,
                                              Topology, find_qerror, randinit)
    from som_lvq_pak_torch.models.trainer import SOMTrainer

    n = X.shape[0]
    crng = CRandom()
    crng.init_random(123)
    codes = randinit(Dataset(points=X), topol=Topology.HEXA,
                     neigh=Neighborhood.GAUSSIAN, xdim=map_dim, ydim=map_dim,
                     rng=crng)
    X_dev = torch.from_numpy(X).to("cuda")
    warm = SOMTrainer(codes, batch_size=bs, device="cuda")
    find_qerror(warm.fit(stream(X, chunk, 2 * bs), rlen=2 * bs, alpha=0.05,
                         radius=radius, allow_short_stream=True), X_dev)
    torch.cuda.synchronize()

    tr = SOMTrainer(codes, batch_size=bs, device="cuda")
    t0 = time.perf_counter()
    out = tr.fit(stream(X, chunk, n), rlen=n, alpha=0.05, radius=radius,
                 allow_short_stream=True)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q = find_qerror(out, X_dev) / n
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    if not np.isfinite(out.points).all() or out.points.shape != (map_dim * map_dim, 64):
        raise AssertionError("trained codebook is not finite or has the wrong shape")
    return q, train_s, eval_s


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "kernels need a CUDA device", file=sys.stderr)
        return 1
    from som_lvq_pak_torch import _build
    from som_lvq_pak_torch.ops.dist_argmin import (dist_argmin, dist_argmin_plain,
                                                   dist_argmin_t, dist_argmin_t_plain)
    from som_lvq_pak_torch.ops.distance import fp32_matmul
    from som_lvq_pak_torch.ops.som_step import (som_fused_train_step,
                                                som_fused_train_step_plain)

    fp32_matmul()  # plain references in full float32 (no TF32)
    smi = nvidia_smi_line()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    emit("env", torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
         card=smi, python=sys.version.split()[0])

    t0 = time.perf_counter()
    _build.build(verbose=True)  # ptxas register/shared-memory report on stdout
    _build.library()
    emit("build", seconds=time.perf_counter() - t0, library=_build.library_path())

    recs = {}
    for name, k, p in (("dist_argmin", dist_argmin, dist_argmin_plain),
                       ("dist_argmin_t", dist_argmin_t, dist_argmin_t_plain)):
        rs = [phase_distance(name, k, p, 4096, 65536, 64, seed=1),
              phase_distance(name, k, p, 1000, 999, 5, seed=2),
              phase_distance(name, k, p, 1000, 999, 5, seed=3, dup=True)]
        if name == "dist_argmin_t":  # the 1M eval's single launch
            rs.insert(0, phase_distance(name, k, p, 1_000_000, 65536, 64,
                                        seed=5, iters=3))
        # the record at the main path's shape: the 1M run's prologue (K1)
        # and its evaluation (K2)
        recs[name] = dict(rs[0], max_abs_err=max(r["max_abs_err"] for r in rs))
    steps = [phase_step(som_fused_train_step, som_fused_train_step_plain,
                        *case, seed=4)
             for case in ((128, 128, True, True, 1024, 64, 32.0),
                          (256, 256, True, True, 4096, 64, 64.0),
                          (12, 8, False, False, 1024, 64, 3.0))]
    recs["som_fused_train_step"] = dict(
        steps[1], max_abs_err=max(r["max_abs_err"] for r in steps))

    # ---- e2e 128x128, 100k x 64 (bench.py:run_e2e_config4) ---------------
    X = blob_data(42, 100_000, 4)
    counted = (dist_argmin, dist_argmin_t, som_fused_train_step)
    for fn in counted:
        fn.launches = 0
    q, train_s, eval_s = e2e(X, 128, 1024, 32, 8192)
    launches = {fn.__name__: fn.launches for fn in counted}
    # e2e() runs a 2-batch warm-up fit + eval before the timed run; the
    # counts cover both, all of them through the main path's entry points
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    with plain_kernels():
        q_plain, train_plain_s, eval_plain_s = e2e(X, 128, 1024, 32, 8192)
    if {fn.__name__: fn.launches for fn in counted} != launches:
        raise AssertionError("the plain run launched a kernel")
    if abs(q - q_plain) > 0.01 * q_plain:
        raise AssertionError(f"e2e 128: qerror {q} vs plain {q_plain} (> 1%)")
    if abs(q - ANCHOR_128) > 0.02 * ANCHOR_128:
        raise AssertionError(f"e2e 128: qerror {q} vs JAX anchor {ANCHOR_128} (> 2%)")
    emit("e2e_128x128_100k", card=smi, qerror_per_sample=q, train_s=train_s,
         qerror_eval_s=eval_s, plain_qerror_per_sample=q_plain,
         plain_train_s=train_plain_s, plain_qerror_eval_s=eval_plain_s,
         launches=launches)

    # ---- e2e 256x256, 1M x 64 (bench.py:run_e2e_1m_65k) ------------------
    X = blob_data(7, 1_000_000, 16)
    q, train_s, eval_s = e2e(X, 256, 4096, 64, 16384)
    if abs(q - ANCHOR_1M) > 0.02 * ANCHOR_1M:
        raise AssertionError(f"e2e 1M: qerror {q} vs JAX anchor {ANCHOR_1M} (> 2%)")
    emit("e2e_256x256_1M", card=smi, qerror_per_sample=q, train_s=train_s,
         qerror_eval_s=eval_s)

    sources = {"dist_argmin": ("som_lvq_pak_torch/csrc/dist_argmin.cu",
                               "som_lvq_pak_tpu/ops/pallas_distance.py:60"),
               "dist_argmin_t": ("som_lvq_pak_torch/csrc/dist_argmin.cu",
                                 "som_lvq_pak_tpu/ops/pallas_distance.py:426"),
               "som_fused_train_step": ("som_lvq_pak_torch/csrc/som_fused_step.cu",
                                        "som_lvq_pak_tpu/ops/pallas_som.py:580")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": recs[name]["max_abs_err"], "ms": recs[name]["ms"],
         "plain_ms": recs[name]["plain_ms"], "shape": recs[name]["shape"]}
        for name in sources]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
