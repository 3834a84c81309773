"""The port's world of several hosts on the CPU, against the JAX package.

The backend rule (`parallel.mesh.backend_rule`) case by case, and
`initialize_distributed()` started from torchrun's environment; the
asynchronous `Mesh.all_gather` against the synchronous one; and the
counterpart of tests/test_multihost.py: two "hosts" of two ranks each,
four processes of `python -m som_lvq_pak_torch.dryrun multihost` with the
environment torchrun gives its workers (an env:// rendezvous on 127.0.0.1
at a free port, gloo), each host streaming its own half of one labelled
file.  Their results are held against the JAX single-process oracle on the
batch they assembled, at the JAX test's tolerances (1e-5, the alphas
1e-6), the fused TP step against the JAX fused kernel (interpret mode) at
1e-5 with its winners equal, and the mixed step against the worker's
one-device K3 at 1e-4, as tests/multihost_worker.py holds them.

This module imports no jax at its top: a `spawn` child imports it for its
worker function (`_gathers`)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from som_lvq_pak_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120.0


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- the backend rule --------------------------------------------------------

@pytest.mark.parametrize("case,want", [
    # (device, world, local world, local rank, cards) -> (backend, card)
    (("cuda", 4, 4, 3, 4), ("nccl", 3)),     # one host, a card per rank
    (("cuda", 8, 8, 5, 4), ("gloo", 0)),     # one host, more ranks than cards
    (("cuda", 16, 8, 3, 8), ("nccl", 3)),    # two hosts of 8 ranks, 8 cards each
    (("cpu", 8, 4, 1, 0), ("gloo", None)),   # the CPU
])
def test_backend_rule(case, want):
    assert pmesh.backend_rule(*case) == want


def test_backend_rule_raises_for_a_host_short_of_cards():
    """Two hosts of 4 ranks with 2 cards each: gloo on one host would hang
    the first collective against NCCL on the other, so it raises."""
    with pytest.raises(RuntimeError, match="4 ranks on this host of a 8-rank"):
        pmesh.backend_rule("cuda", 8, 4, 1, 2)


def test_initialize_distributed_from_the_environment(monkeypatch):
    """No arguments: env:// and WORLD_SIZE, RANK from the environment; a
    one-rank gloo world on the CPU, kept when called again."""
    monkeypatch.setattr(pmesh, "_device", None)
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                     WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    try:
        assert pmesh.initialize_distributed(device="cpu") == ("gloo", torch.device("cpu"))
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        monkeypatch.delenv("WORLD_SIZE")
        monkeypatch.delenv("RANK")
        assert pmesh.initialize_distributed(device="cpu") == ("gloo", torch.device("cpu"))
        assert pmesh.make_mesh().device == torch.device("cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("local_world,cards", [(8, 8), (4, 2)])
def test_initialize_distributed_several_hosts(monkeypatch, local_world, cards):
    """Rank 11 of a 16-rank world, local rank 3 of `local_world`, on a host
    showing `cards` cards (torch.cuda and init_process_group stood in for):
    NCCL on cuda:3 with 8 cards; with 2 cards it raises before joining."""
    monkeypatch.setattr(pmesh, "_device", None)
    for k, v in dict(WORLD_SIZE="16", RANK="11", LOCAL_RANK="3",
                     LOCAL_WORLD_SIZE=str(local_world)).items():
        monkeypatch.setenv(k, v)
    joined = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: joined.setdefault("card", d))
    monkeypatch.setattr(dist, "is_initialized", lambda: "backend" in joined)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: joined.update(backend=backend, **kw))
    monkeypatch.setattr(dist, "get_backend", lambda *a: joined["backend"])
    if cards < local_world:
        with pytest.raises(RuntimeError, match="2 cards"):
            pmesh.initialize_distributed()
        assert not joined
        return
    assert pmesh.initialize_distributed() == ("nccl", torch.device("cuda", 3))
    assert joined["card"] == torch.device("cuda", 3)
    assert (joined["init_method"], joined["world_size"], joined["rank"]) == ("env://", 16, 11)


# -- the asynchronous gather ----------------------------------------------------

def _gathers(mesh):
    """A `spawn` worker: each rank's own rows gathered over both axes, once
    synchronously and once issued together asynchronously and waited on in
    turn (two in flight on `model`)."""
    torch.manual_seed(mesh.rank)
    t = torch.randn(5, 3)
    i = torch.arange(4, dtype=torch.int32) + 10 * mesh.rank
    sync = [mesh.all_gather(t, "model"), mesh.all_gather(i, "model"),
            mesh.all_gather(t, "data")]
    pending = [mesh.all_gather(t, "model", async_op=True),
               mesh.all_gather(i, "model", async_op=True),
               mesh.all_gather(t, "data", async_op=True)]
    return sync, [p.wait() for p in pending], mesh.global_batch(i)


def test_async_all_gather_equals_the_synchronous_one():
    ranks = pmesh.spawn(_gathers, 2, 2, "cpu", timeout_s=TIMEOUT_S)
    for r, (sync, lapped, batch) in enumerate(ranks):
        for a, b in zip(sync, lapped):
            np.testing.assert_array_equal(a, b)
        assert sync[0].shape == (2, 5, 3) and sync[1].dtype == np.int32
        m, d = r % 2, r // 2
        np.testing.assert_array_equal(sync[1][:, 0], [10 * (2 * d + k) for k in range(2)])
        # global_batch: the data column's rows in data order
        np.testing.assert_array_equal(batch, np.concatenate(
            [np.arange(4) + 10 * (2 * k + m) for k in range(2)]))


# -- two hosts of two ranks --------------------------------------------------------

@pytest.fixture(scope="module")
def two_hosts(tmp_path_factory):
    """The shared 128 x 12 labelled file of tests/test_multihost.py and the
    four ranks' results (rank 0's arrays, every rank's printed record)."""
    tmp = tmp_path_factory.mktemp("multihost")
    rng = np.random.RandomState(11)
    n, dim = 128, 12
    pts = rng.randn(n, dim).astype(np.float32)
    labs = rng.randint(1, 4, n)
    datafile = tmp / "mh.dat"
    with open(datafile, "w") as f:
        f.write(f"{dim}\n")
        for row, lab in zip(pts, labs):
            f.write(" ".join(f"{v:.6f}" for v in row) + f" L{lab}\n")
    port = str(_free_port())
    procs = []
    for rank in range(4):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   WORLD_SIZE="4", RANK=str(rank), LOCAL_RANK=str(rank % 2),
                   LOCAL_WORLD_SIZE="2", OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "som_lvq_pak_torch.dryrun", "multihost",
             str(datafile), str(tmp), "--device", "cpu"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    recs = [json.loads(line) for out in outs for line in out.splitlines()
            if line.startswith('{"multihost_rank"')]
    return dict(np.load(tmp / "result.npz")), recs, pts, tmp


def test_two_hosts_world_layout(two_hosts):
    """Each rank joined by the environment alone: gloo, hosts 0 and 1 on
    data rows 0 and 1 of a (2, 2) mesh."""
    _, recs, _, _ = two_hosts
    assert sorted(r["multihost_rank"] for r in recs) == [0, 1, 2, 3]
    for r in recs:
        assert (r["backend"], r["device"], r["hosts"]) == ("gloo", "cpu", 2)
        assert r["layout"] == {"data": 2, "model": 2}
        assert r["host"] == r["multihost_rank"] // 2


def test_two_hosts_interleave_the_file(two_hosts):
    data, _, pts, _ = two_hosts
    assert data["xb"].shape[0] == pts.shape[0]
    # host 0 streamed rows 0, 2, ..., host 1 rows 1, 3, ...: in data order
    np.testing.assert_allclose(data["xb"][:64], pts[0::2], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(data["xb"][64:], pts[1::2], rtol=1e-5, atol=1e-5)


def test_two_hosts_som_and_olvq1_steps_match_jax(two_hosts):
    import jax.numpy as jnp

    from som_lvq_pak_tpu.models.fast import olvq1_batch_step, som_batch_step, unit_coords

    data, _, _, _ = two_hosts
    ref = som_batch_step(jnp.asarray(data["codes"]), jnp.asarray(data["xb"]),
                         unit_coords(16, 4, hexa=True), 0.05, 3.0, gaussian=False,
                         use_pallas=False)
    np.testing.assert_allclose(data["som"], np.asarray(ref), rtol=1e-5, atol=1e-5)
    ref_codes, ref_a = olvq1_batch_step(
        jnp.asarray(data["codes"]), jnp.asarray(data["clabels"]),
        jnp.full((data["codes"].shape[0],), 0.3, dtype=jnp.float32),
        jnp.asarray(data["xb"]), jnp.asarray(data["xl"]), use_pallas=False)
    np.testing.assert_allclose(data["lvq_codes"], np.asarray(ref_codes), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(data["lvq_alphas"], np.asarray(ref_a), rtol=1e-6,
                               atol=1e-6)


def test_two_hosts_resume_equals_the_uninterrupted_run(two_hosts):
    """Rank 0 wrote the half-way checkpoint, every rank restored it: the
    resumed run is the uninterrupted one bit for bit, and it trained."""
    data, _, _, tmp = two_hosts
    assert os.path.isdir(tmp / "mh_ck")
    np.testing.assert_array_equal(data["multi_resumed"], data["multi_full"])
    np.testing.assert_allclose(data["multi_resumed"], data["multi_full"], rtol=1e-6,
                               atol=1e-6)
    assert not np.allclose(data["multi_full"], data["codes"])


def test_two_hosts_fused_steps(two_hosts):
    """The fused TP step on the (1, 4) mesh against the JAX fused kernel
    (interpret mode) and the worker's one-device K3 at 1e-5, winners equal;
    the mixed step on the (2, 2) mesh against the one-device K3 at 1e-4,
    winners equal."""
    import jax.numpy as jnp

    from som_lvq_pak_tpu.ops.pallas_som import som_fused_train_step

    data, _, _, _ = two_hosts
    cp = np.pad(data["codes"], ((0, 0), (0, 128 - data["codes"].shape[1])))
    xp = np.pad(data["xb"], ((0, 0), (0, 128 - data["xb"].shape[1])))
    jc, jb, _ = som_fused_train_step(
        jnp.asarray(cp), jnp.asarray(xp), jnp.asarray(data["bmu0"]), jnp.asarray(xp),
        16, True, jnp.float32(0.05), jnp.float32(3.0), gaussian=True, tile_n=8,
        factored=False, interpret=True)
    np.testing.assert_allclose(data["c_tp"], np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(data["bmu_tp"], np.asarray(jb))
    np.testing.assert_allclose(data["c_tp"], data["c_1d"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(data["bmu_tp"], data["bmu_1d"])
    np.testing.assert_allclose(data["c_mx"], data["c_1d"], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(data["bmu_mx"], data["bmu_1d"])
