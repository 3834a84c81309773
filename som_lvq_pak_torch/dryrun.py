"""Driver entry points of the port: the counterpart of __graft_entry__.py,
and the worker of the two-host run (tests/multihost_worker.py's
counterpart).

entry(device)              the flagship step (models.fast.som_batch_step:
                           K1 winners, then the K5 neighbourhood update) and
                           its inputs, for a one-device check.
dryrun_multichip(n, device)  a world of n ranks (parallel.mesh.spawn, the
                           (data, model) factoring of make_mesh) that runs
                           every sharded path at small shapes, in the JAX
                           dryrun's order, with its checks and tolerances.
multihost_worker(datafile, outdir, device)
                           one rank of a world of several hosts started by
                           torchrun: each host streams its own rows of
                           `datafile`, the ranks assemble the global batch
                           and run the sharded steps, a streamed train with
                           a mid-run checkpoint resume, and the fused steps.

    python -m som_lvq_pak_torch.dryrun [N] [--device cpu]
    torchrun --nnodes 2 --nproc-per-node 2 --node-rank H \\
        --master-addr ADDR --master-port PORT \\
        -m som_lvq_pak_torch.dryrun multihost DATAFILE OUTDIR [--device cpu]

Inputs come from NumPy seeds (the JAX functions draw from jax.random, so
the two packages' dryruns see different numbers); the checks are the JAX
ones.  Every check raises AssertionError when it fails.  Each rank of a
world reports the launch counts of the kernels the dryrun runs (0 on the
CPU, where the wrappers run their plain versions).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .models.fast import lvq23_batch_step, som_batch_step, unit_coords
from .ops.dist_argmin import dist_argmin
from .ops.distance import fp32_matmul
from .ops.som_step import som_fused_train_step
from .parallel.mesh import _factor, initialize_distributed, make_mesh, spawn
from .parallel.sharded import (ClassBlockedOLVQ1, make_dim_sharded_winner,
                               make_mixed_fused_som_train_step, make_ring_winner,
                               make_sharded_fused_som_train_step,
                               make_sharded_lvq_train_step,
                               make_sharded_olvq1_train_step,
                               make_sharded_som_train_step)
from .utils.checkpoint import Checkpointer, TrainState

DP = 128  # the JAX fused sections pad D to 128 lanes; the port keeps it


def _counted():
    """The kernel wrappers the dryrun and the two-host worker run."""
    from .ops.dist_top2 import dist_top2
    from .ops.dist_topk import dist_topk
    from .ops.segment_sum import segment_sum
    from .ops.som_accum import som_neighborhood_accumulate
    from .ops.som_blend import som_blend_winner
    from .ops.som_step import som_fused_factored_step
    from .ops.som_update import som_neighborhood_update_idx

    return (dist_argmin, som_fused_train_step, som_fused_factored_step,
            som_neighborhood_update_idx, dist_top2, dist_topk,
            som_neighborhood_accumulate, som_blend_winner, segment_sum)


def _zero_launches():
    for fn in _counted():
        fn.launches = 0


def _launches():
    return {fn.__name__: fn.launches for fn in _counted()}


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol, err_msg=what)


def _equal(got, want, what):
    if not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError(f"{what}: not equal")


def _padded(a, device):
    """`a` (n, D) with its rows zero-padded to DP columns, on `device`."""
    out = torch.zeros((a.shape[0], DP), dtype=torch.float32, device=device)
    out[:, :a.shape[1]] = a
    return out


# -- entry -------------------------------------------------------------------

def _batch_step(codes, xb, alpha, radius):
    return som_batch_step(codes.clone(), xb, 32, True, alpha, radius, gaussian=False)


def entry(device="cuda"):
    """(fn, args): fn(*args) is one som_batch_step (32x16 hexa bubble map,
    B 256, D 64, alpha 0.05, radius 3) on `device`; it leaves its inputs as
    they are and returns the new codebook."""
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.normal(size=(32 * 16, 64)).astype(np.float32))
    xb = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32))
    return _batch_step, (codes.to(device), xb.to(device), 0.05, 3.0)


# -- dryrun_multichip ------------------------------------------------------------

def _qerror(M, xb):
    """Sum over the batch of the distance to the nearest code (float32)."""
    d = ((M * M).sum(1)[None, :] - 2.0 * xb @ M.T + (xb * xb).sum(1)[:, None])
    return float(torch.sqrt(torch.clamp(d.min(1).values, min=0.0)).sum())


def dryrun_rank(mesh, ckdir: str):
    """Every section of the JAX dryrun on this rank of the world, in its
    order; `ckdir` is a directory every rank can read, for the checkpoint.
    Returns the summary's numbers and this rank's launch counts."""
    _zero_launches()
    fp32_matmul()
    dev = mesh.device
    dd, S = mesh.shape["data"], mesh.shape["model"]
    D = 16
    xdim, ydim = S * 4, 4  # codebook rows divide the model axis
    noc = xdim * ydim
    B = dd * 8
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.normal(size=(noc, D)).astype(np.float32)).to(dev)
    xb = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(dev)
    coords = unit_coords(xdim, ydim, True, device=dev)

    # the two-pass step, and again with each rank's winner search in four
    # pieces whose gathers overlap the next piece's search
    step = make_sharded_som_train_step(mesh, gaussian=False)
    out = step(codes, xb, coords, 0.05, 3.0)
    if out.shape != (noc, D) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"two-pass step: shape {tuple(out.shape)} or not finite")
    lapped = make_sharded_som_train_step(mesh, gaussian=False, overlap_chunks=4)
    _close(lapped(codes, xb, coords, 0.05, 3.0), out, 1e-6, "overlap_chunks=4")

    # sharded olvq1: codebook over model, batch over data, alphas replicated
    clabels = torch.from_numpy(rng.integers(1, 4, size=noc).astype(np.int32)).to(dev)
    xlabels = torch.from_numpy(rng.integers(1, 4, size=B).astype(np.int32)).to(dev)
    alphas = torch.full((noc,), 0.3, dtype=torch.float32, device=dev)
    lstep = make_sharded_olvq1_train_step(mesh)
    oc, oa = lstep(codes, clabels, alphas, xb, xlabels)
    if oc.shape != (noc, D) or oa.shape != (noc,):
        raise AssertionError(f"olvq1 step: shapes {tuple(oc.shape)}, {tuple(oa.shape)}")

    # the feature-sharded winner (D over model, the codebook in 8-row
    # chunks), and the ring winner equal to it
    _, widx = make_dim_sharded_winner(mesh, chunk=8)(xb, codes)
    if widx.shape != (B,):
        raise AssertionError(f"dim-sharded winner: shape {tuple(widx.shape)}")
    _, ridx = make_ring_winner(mesh)(xb, codes)
    _equal(ridx, widx, "ring != dim-sharded")

    # the gaussian two-pass step (the JAX dryrun's TP + Pallas composition:
    # K1 per shard on the card)
    out_g = make_sharded_som_train_step(mesh, gaussian=True)(codes, xb, coords, 0.05, 3.0)
    if not bool(torch.isfinite(out_g).all()):
        raise AssertionError("gaussian two-pass step: not finite")

    # the fused update + winner step on one device, D padded to 128
    cp, xp = _padded(codes, dev), _padded(xb, dev)
    _, bmu0 = dist_argmin(xp, cp)
    c2, bmu1, _ = som_fused_train_step(cp.clone(), xp, bmu0, xp, xdim, True, 0.05,
                                       3.0, gaussian=True)
    if not bool(torch.isfinite(c2).all()):
        raise AssertionError("fused step: not finite")

    # K sharded steps with decaying (alpha, radius) against the one-device
    # som_batch_step, and the qerror falling
    K = 8

    def schedule(t):
        return 0.05 * (K - t) / K, 1.0 + 2.0 * (K - t) / K

    q_start = _qerror(codes, xb)
    cur, oracle = codes, codes.clone()
    for t in range(K):
        a, r = schedule(t)
        cur = step(cur, xb, coords, a, r)
        som_batch_step(oracle, xb, xdim, True, a, r, gaussian=False)
    _close(cur, oracle, 1e-4, f"{K}-step sharded train vs som_batch_step")
    q_end = _qerror(cur, xb)
    if not q_end < q_start:
        raise AssertionError(f"qerror did not fall: {q_start} -> {q_end}")

    # checkpoint under the mesh: rank 0 saves the half-way codebook, every
    # rank restores it and finishes; equal to the uninterrupted run
    half = codes
    for t in range(K // 2):
        half = step(half, xb, coords, *schedule(t))
    if mesh.rank == 0:
        Checkpointer(ckdir).save(TrainState(codes=_np(half), step=K // 2))
    dist.barrier()
    st = Checkpointer(ckdir).load()
    if st is None or st.step != K // 2:
        raise AssertionError("mesh checkpoint: restore failed")
    resumed = torch.from_numpy(st.codes).to(dev)
    for t in range(K // 2, K):
        resumed = step(resumed, xb, coords, *schedule(t))
    _close(resumed, cur, 1e-6, "resumed vs uninterrupted")

    # the fused TP step on a model-only mesh: one pass per shard (K3 with
    # the shard's unit offset) and the gather-min winner; equal to K3 on
    # the whole codebook
    n = dd * S
    mesh_tp = make_mesh(n, data=1, model=n)
    c_tp, bmu_tp = make_sharded_fused_som_train_step(mesh_tp, True, xdim, True)(
        cp, xp, bmu0, xp, 0.05, 3.0)
    c_1d, bmu_1d, _ = som_fused_train_step(cp.clone(), xp, bmu0, xp, xdim, True, 0.05,
                                           3.0, gaussian=True, factored=False)
    _close(c_tp, c_1d, 1e-5, "fused TP step vs one device")
    _equal(bmu_tp, bmu_1d, "fused TP step winners")

    # the mixed data x model fused step: accumulate (K11), sum over data,
    # blend and winners (K12), gather-min over model
    c_mx, bmu_mx = make_mixed_fused_som_train_step(mesh, True, xdim, True)(
        cp, xp, bmu0, xp, 0.05, 3.0)
    _close(c_mx, c_1d, 1e-4, "mixed fused step vs one device")
    _equal(bmu_mx, bmu_1d, "mixed fused step winners")

    # sharded lvq3 (K10 at k 2 per shard) against the batched step
    out3 = make_sharded_lvq_train_step(mesh, algorithm="lvq3")(codes, clabels, xb,
                                                               xlabels, 0.05)
    ref3 = lvq23_batch_step(codes.clone(), clabels, xb, xlabels, 0.05, 0.3,
                            epsilon=0.1, lvq3=True)
    _close(out3, ref3, 1e-5, "sharded lvq3 vs batched")

    # ClassBlockedOLVQ1: equal to the unblocked sharded olvq1 up to its
    # row permutation
    ep = ClassBlockedOLVQ1(mesh, codes, clabels)
    ep.step(xb, xlabels).step(xb, xlabels)
    ref_c, ref_a = codes, alphas
    for _ in range(2):
        ref_c, ref_a = lstep(ref_c, clabels, ref_a, xb, xlabels)
    _close(ep.codes(), ref_c, 1e-5, "ClassBlockedOLVQ1 vs sharded olvq1")
    dist.barrier()
    return dict(data=dd, model=S, noc=noc, D=D, B=B, K=K, q_start=q_start,
                q_end=q_end, backend=mesh.backend, device=str(dev),
                launches=_launches())


def summary(r) -> str:
    """The dryrun's one summary line from a rank's result."""
    return (f"dryrun_multichip OK ({r['backend']}, {r['device']}): mesh "
            f"data={r['data']} x model={r['model']}; SOM step (codes "
            f"{r['noc']}x{r['D']} TP, batch {r['B']} DP) with overlap_chunks 1 "
            f"and 4, olvq1 step, tiled dim-sharded winner (D/{r['model']} per "
            f"rank), ring-pass winner, the gaussian two-pass step, the fused "
            f"update+winner step, a {r['K']}-step sharded train (qerror "
            f"{r['q_start']:.2f} -> {r['q_end']:.2f}, == one-device "
            f"som_batch_step), mesh checkpoint save/restore+resume, the fused TP "
            f"step (== one-device K3), the MIXED data x model fused step "
            f"(accumulate + sum over data + blend + gather-min over model, == "
            f"one-device K3 on the full {r['data']}x{r['model']} mesh), the "
            f"sharded lvq3 step (== batched step), and ClassBlockedOLVQ1 (== "
            f"unblocked olvq1 up to permutation) all executed")


def dryrun_multichip(n_devices: int, device="cuda", timeout_s: float = 300.0):
    """dryrun_rank on every rank of a world of `n_devices` processes on
    `device` (make_mesh's factoring; on "cuda" the backend rule picks NCCL
    with a card per rank, else gloo on cuda:0); prints the summary line and
    returns each rank's result."""
    data, model = _factor(n_devices)
    with tempfile.TemporaryDirectory(prefix="somvq_dryrun_") as ckdir:
        ranks = spawn(dryrun_rank, data, model, device, ckdir, timeout_s=timeout_s)
    print(summary(ranks[0]), flush=True)
    return ranks


# -- the two-host worker -------------------------------------------------------

N_MULTIHOST = 16 * 4  # the worker's 16x4 hexa map


def multihost_worker(datafile: str, outdir: str, device="cuda"):
    """One rank of a world of several hosts whose ranks torchrun started
    (initialize_distributed() from the environment).  Host h of H streams
    rows h, h + H, ... of `datafile` (StreamingReader shard=(h, H)) and its
    ranks take data row h of a (H, world / H) mesh; Mesh.global_batch
    builds the global batch.  Runs on it one sharded SOM step and one
    olvq1 step, a 6-step streamed train whose half-way codebook rank 0
    writes to `outdir`/mh_ck and every rank resumes from (bit-equal to the
    uninterrupted run), the fused TP step on a (1, world) mesh and the
    mixed step on the main mesh (each held to K3 on one device).  Rank 0
    writes the arrays to `outdir`/result.npz; returns them."""
    from .data.labels import LabelTable
    from .data.streaming import StreamingReader

    backend, dev = initialize_distributed(device=device)
    fp32_matmul()
    _zero_launches()
    world, rank = dist.get_world_size(), dist.get_rank()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    hosts, host = world // local_world, rank // local_world
    mesh = make_mesh(world, data=hosts, model=world // hosts)
    if mesh.coords["data"] != host:
        raise AssertionError(f"rank {rank} on data row {mesh.coords['data']}, host {host}")

    # this host's rows of the shared file; the labels interned in one order
    # on every host
    table = LabelTable()
    for lab in ("L1", "L2", "L3"):
        table.to_index(lab)
    chunks = list(StreamingReader(datafile, buffer=16, labels=table,
                                  shard=(host, hosts)).chunks(laps=1))
    local = np.concatenate([c.points for c in chunks])
    local_labels = np.concatenate([c.first_labels() for c in chunks]).astype(np.int32)
    D = local.shape[1]
    rs = np.random.RandomState(5)
    codes_np = rs.randn(N_MULTIHOST, D).astype(np.float32)
    clabels_np = (np.arange(N_MULTIHOST) % 3 + 1).astype(np.int32)
    codes = torch.from_numpy(codes_np).to(dev)
    clabels = torch.from_numpy(clabels_np).to(dev)
    coords = unit_coords(16, 4, True, device=dev)

    def global_batch(a):
        return mesh.global_batch(torch.from_numpy(np.ascontiguousarray(a)).to(dev))

    xs, xl = global_batch(local), global_batch(local_labels)
    som_step = make_sharded_som_train_step(mesh, gaussian=False)
    som = som_step(codes, xs, coords, 0.05, 3.0)
    lvq_codes, lvq_alphas = make_sharded_olvq1_train_step(mesh)(
        codes, clabels, torch.full((N_MULTIHOST,), 0.3, device=dev), xs, xl)

    # a streamed train: each step a fresh global batch (this host's rows
    # rotated), resumed half-way from the checkpoint rank 0 wrote
    K = 6

    def advance(state, t0, t1):
        for t in range(t0, t1):
            state = som_step(state, global_batch(np.roll(local, t * 7, axis=0)), coords,
                             0.05 * (K - t) / K, 1.0 + 2.0 * (K - t) / K)
        return state

    full = advance(codes, 0, K)
    ckdir = os.path.join(outdir, "mh_ck")
    half = advance(codes, 0, K // 2)
    if rank == 0:
        Checkpointer(ckdir).save(TrainState(codes=_np(half), step=K // 2))
    dist.barrier()
    st = Checkpointer(ckdir).load()
    if st is None or st.step != K // 2:
        raise AssertionError("all-restore failed")
    resumed = advance(torch.from_numpy(st.codes).to(dev), K // 2, K)
    _equal(resumed, full, "resumed vs uninterrupted streamed train")

    # the fused TP step on a model-only mesh over every host, then the mixed
    # step on the main mesh, each against K3 on one device (D padded to 128)
    cp, xp = _padded(codes, dev), _padded(xs, dev)
    _, bmu0 = dist_argmin(xp, cp)
    c_1d, bmu_1d, _ = som_fused_train_step(cp.clone(), xp, bmu0, xp, 16, True, 0.05,
                                           3.0, gaussian=True, factored=False)
    mesh_tp = make_mesh(world, data=1, model=world)
    c_tp, bmu_tp = make_sharded_fused_som_train_step(mesh_tp, True, 16, True)(
        cp, xp, bmu0, xp, 0.05, 3.0)
    _close(c_tp, c_1d, 1e-5, "fused TP step vs one device")
    _equal(bmu_tp, bmu_1d, "fused TP winners under several hosts")
    xs_p = global_batch(np.pad(local, ((0, 0), (0, DP - D))))
    c_mx, bmu_mx = make_mixed_fused_som_train_step(mesh, True, 16, True)(
        cp, xs_p, bmu0, xs_p, 0.05, 3.0)
    _close(c_mx, c_1d, 1e-4, "mixed fused step vs one device")
    _equal(bmu_mx, bmu_1d, "mixed fused winners under several hosts")

    out = dict(som=som, lvq_codes=lvq_codes, lvq_alphas=lvq_alphas, xb=xs, xl=xl,
               codes=codes, clabels=clabels, multi_full=full, multi_resumed=resumed,
               c_tp=c_tp, bmu_tp=bmu_tp, c_mx=c_mx, bmu_mx=bmu_mx, c_1d=c_1d,
               bmu_1d=bmu_1d, bmu0=bmu0)
    out = {k: _np(v) for k, v in out.items()}
    if rank == 0:
        np.savez(os.path.join(outdir, "result.npz"), **out)
    print(json.dumps({"multihost_rank": rank, "host": host, "hosts": hosts,
                      "backend": backend, "device": str(dev), "layout": mesh.shape,
                      "launches": _launches()}), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return out


def main(argv) -> int:
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if argv[:1] == ["multihost"] and len(argv) == 3:
        multihost_worker(argv[1], argv[2], device)
        return 0
    if len(argv) > 1 or (argv and not argv[0].isdigit()):
        print(__doc__.split("\n\n")[2], file=sys.stderr)
        return 2
    fn, args = entry(device)
    out = fn(*args)
    print(f"entry OK: som_batch_step -> codes {tuple(out.shape)} on {out.device}")
    dryrun_multichip(int(argv[0]) if argv else 4, device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
