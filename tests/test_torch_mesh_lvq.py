"""The port's mesh slice against the JAX package, LVQ side.

Plain K10 (`dist_topk`) against the JAX kernel in interpret mode; the
sharded lvq1/lvq2/lvq3 and olvq1 steps, ClassBlockedOLVQ1, the ring and the
feature-sharded winner searches, and LVQTrainer/OLVQ1Trainer(mesh=...) on a
stream, in one gloo world of four CPU processes (data 2, model 2;
parallel.mesh.spawn with a time limit) against the JAX builders and
trainers on the 8-device virtual CPU mesh, fed the same numpy-seeded inputs
(label ids given as numbers, the same in both packages).  Each case is its
own test.

Tolerances: winners and top-k indices equal (the inputs hold no near-ties
but exact ones); values and one step's codes and alphas to 1e-5; trained
codebooks on the same stream to 1e-4; every rank returns the same whole
arrays, exactly."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from som_lvq_pak_tpu.data.dataset import Dataset as JDataset
from som_lvq_pak_tpu.data.dataset import Topology
from som_lvq_pak_tpu.models.trainer import LVQTrainer as JLVQTrainer
from som_lvq_pak_tpu.models.trainer import OLVQ1Trainer as JOLVQ1Trainer
from som_lvq_pak_tpu.ops import pallas_distance as jpd
from som_lvq_pak_tpu.parallel import sharded as jsh
from som_lvq_pak_tpu.parallel.mesh import make_mesh as jmake_mesh
from som_lvq_pak_torch.convert import class_blocked_state
from som_lvq_pak_torch.data.dataset import Dataset as PDataset
from som_lvq_pak_torch.models.trainer import LVQTrainer, OLVQ1Trainer
from som_lvq_pak_torch.ops.dist_topk import dist_topk
from som_lvq_pak_torch.parallel import sharded
from som_lvq_pak_torch.parallel.mesh import call_each, class_blocked_order, spawn

T = torch.from_numpy
SH = "som_lvq_pak_torch.parallel.sharded:"
TRM = "som_lvq_pak_torch.models.trainer:"
NOC, D, B, CLASSES = 40, 8, 64, 4
TIMEOUT_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run torch on one CPU thread in this module, as the port's other
    test modules do (see tests/test_torch_trainer.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _labelled(n, seed):
    """n samples around CLASSES centres, label id = centre + 1."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 1.5, size=(CLASSES, D)).astype(np.float32)
    c = rng.integers(0, CLASSES, size=n)
    x = centres[c] + rng.normal(0, 1.0, size=(n, D)).astype(np.float32)
    return x, (c + 1).astype(np.int32)


def _codebook(cls):
    x, lab = _labelled(NOC, 21)
    return cls(points=x, labels=lab[:, None], topol=Topology.LVQ)


def _chunks(cls, n=1024, chunk=256):
    x, lab = _labelled(n, 22)
    return [cls(points=x[lo:lo + chunk], labels=lab[lo:lo + chunk, None])
            for lo in range(0, n, chunk)]


def _jmesh(data, model):
    return jmake_mesh(data * model, data=data, model=model)


def _put(mesh, a, *spec):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, JP(*spec)))


# -- plain K10 against the JAX kernel ------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 5, 16])
def test_dist_topk_plain_matches_jax(k):
    """Every code twice (exact ties: the copies lowest index first); values
    to 1e-5, indices equal."""
    rng = np.random.default_rng(30 + k)
    base = rng.normal(size=(20, D)).astype(np.float32)
    codes = np.concatenate([base, base])
    x = rng.normal(size=(48, D)).astype(np.float32)
    val, idx = dist_topk(T(x), T(codes), k)
    jval, jidx = jpd.dist_topk(jnp.asarray(x), jnp.asarray(codes), k,
                               tile_b=16, tile_n=128, interpret=True)
    assert val.shape == (48, k) and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=1e-5, atol=1e-5)
    if k >= 2:
        np.testing.assert_array_equal(idx.numpy()[:, 1], idx.numpy()[:, 0] + 20)


def test_dist_topk_rejects_k_out_of_range():
    x, c = torch.randn(5, 3), torch.randn(20, 3)
    for k in (0, 17):
        with pytest.raises(ValueError, match="out of range"):
            dist_topk(x, c, k)
        with pytest.raises(ValueError, match="out of range"):
            jpd.dist_topk(jnp.asarray(x.numpy()), jnp.asarray(c.numpy()), k)
    with pytest.raises(ValueError, match="codes"):
        dist_topk(x, c[:3], 4)


# -- errors ----------------------------------------------------------------------

def _fake_mesh(data, model):
    """Rank 0's view of a data x model mesh, without a world (for the
    checks that raise before any collective)."""
    def block(n):
        return -(-n // model)

    return types.SimpleNamespace(shape={"data": data, "model": model},
                                 coords={"data": 0, "model": 0}, rank=0,
                                 device=torch.device("cpu"), block=block,
                                 rows=lambda n: slice(0, min(n, block(n))),
                                 batch_rows=lambda b: slice(0, b // data))


def test_lvq23_needs_two_rows_per_shard():
    """3 codes over 2 model shards leave the second with one row: lvq2/lvq3
    raise in both packages, lvq1 does not."""
    for algorithm in ("lvq2", "lvq3"):
        with pytest.raises(ValueError, match=">= 2 codebook rows"):
            sharded.check_lvq_mesh(_fake_mesh(1, 2), 3, algorithm)
        jstep = jsh.make_sharded_lvq_train_step(_jmesh(1, 2), algorithm)
        with pytest.raises(ValueError, match=">= 2 codebook rows"):
            jstep(jnp.zeros((3, D)), jnp.zeros((3,), jnp.int32),
                  jnp.zeros((B, D)), jnp.zeros((B,), jnp.int32), jnp.float32(0.1))
    sharded.check_lvq_mesh(_fake_mesh(1, 2), 3, "lvq1")
    with pytest.raises(ValueError, match="unknown algorithm"):
        sharded.make_sharded_lvq_train_step(_fake_mesh(1, 2), "lvq4")


def test_mesh_trainers_reject_masked_batches_and_uneven_batches():
    x, lab = _labelled(256, 23)
    mask = np.zeros_like(x, dtype=np.uint8)
    mask[5, 2] = 1
    data = [PDataset(points=x, labels=lab[:, None], mask=mask)]
    for tr in (LVQTrainer(_codebook(PDataset), "lvq1", batch_size=B,
                          mesh=_fake_mesh(2, 1), device="cpu"),
               OLVQ1Trainer(_codebook(PDataset), batch_size=B, mesh=_fake_mesh(2, 1),
                            device="cpu")):
        kw = {} if isinstance(tr, OLVQ1Trainer) else dict(alpha=0.05)
        with pytest.raises(ValueError, match="masked batches"):
            tr.fit(data, rlen=256, **kw)
    with pytest.raises(ValueError, match="does not split"):
        LVQTrainer(_codebook(PDataset), batch_size=B, mesh=_fake_mesh(3, 1),
                   device="cpu")


@pytest.mark.parametrize("trainer", ["SOMTrainer", "LVQTrainer", "OLVQ1Trainer"])
def test_mesh_trainers_reject_a_device_the_mesh_is_not_on(trainer):
    """A mesh on the CPU with the default device="cuda" raises, so a trainer
    never runs on the CPU unless the caller asks for it; device="cpu" takes
    the mesh, and "cuda" names any card of a mesh on a card."""
    from som_lvq_pak_torch.models import trainer as tm
    codes = _codebook(PDataset)
    if trainer == "SOMTrainer":
        codes = PDataset(points=codes.points, topol=Topology.HEXA, xdim=8, ydim=5)
    cls = getattr(tm, trainer)
    with pytest.raises(ValueError, match="disagrees with the mesh's device"):
        cls(codes, batch_size=B, mesh=_fake_mesh(2, 1))
    assert cls(codes, batch_size=B, mesh=_fake_mesh(2, 1), device="cpu").device.type == "cpu"
    on_card = _fake_mesh(2, 1)
    on_card.device = torch.device("cuda", 1)
    assert cls(codes, batch_size=B, mesh=on_card).device == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="disagrees with the mesh's device"):
        cls(codes, batch_size=B, mesh=on_card, device="cuda:0")


# -- the sharded steps and trainers in a (data 2, model 2) world ----------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every (2, 2) case of this module in one world; {name: (port result,
    JAX result)}."""
    jm = _jmesh(2, 2)
    codes, clab = _labelled(NOC, 24)
    xb, xlab = _labelled(B, 25)
    ref, calls = {}, []

    def add(name, target, kw, then, jax_result):
        calls.append((target, (), kw, then))
        ref[name] = jax_result

    for algorithm in ("lvq1", "lvq2", "lvq3"):
        jstep = jsh.make_sharded_lvq_train_step(jm, algorithm, winlen=0.3,
                                                epsilon=0.1)
        add(algorithm, SH + "make_sharded_lvq_train_step",
            dict(algorithm=algorithm, winlen=0.3, epsilon=0.1),
            (None, (codes, clab, xb, xlab, 0.05), {}),
            jstep(_put(jm, codes, "model", None), jnp.asarray(clab),
                  _put(jm, xb, "data", None), _put(jm, xlab, "data"),
                  jnp.float32(0.05)))
    alphas = np.linspace(0.05, 0.3, NOC).astype(np.float32)
    jstep = jsh.make_sharded_olvq1_train_step(jm, clip=0.3)
    add("olvq1", SH + "make_sharded_olvq1_train_step", dict(clip=0.3),
        (None, (codes, clab, alphas, xb, xlab), {}),
        jstep(_put(jm, codes, "model", None), jnp.asarray(clab),
              jnp.asarray(alphas), _put(jm, xb, "data", None),
              _put(jm, xlab, "data")))
    # class-blocked olvq1: two steps; and one step in JAX, carried across
    # (convert.class_blocked_state), then one in the port
    x2, l2 = _labelled(B, 26)
    jcb = jsh.ClassBlockedOLVQ1(jm, codes, clab, clip=0.3)
    jcb.step(jnp.asarray(xb), jnp.asarray(xlab))
    carried = class_blocked_state(jcb)
    jcb.step(jnp.asarray(x2), jnp.asarray(l2))
    two = [("step", (xb, xlab), {}), ("step", (x2, l2), {})]
    blocked = dict(codes=codes, code_labels=clab, clip=0.3)
    add("blocked_codes", SH + "ClassBlockedOLVQ1", blocked, two + [("codes", (), {})],
        np.asarray(jcb.codes()))
    add("blocked_alphas", SH + "ClassBlockedOLVQ1", blocked,
        two + [("alphas", (), {})], np.asarray(jcb.alphas()))
    add("blocked_carried", SH + "ClassBlockedOLVQ1", dict(carried, clip=0.3),
        [("step", (x2, l2), {}), ("codes", (), {})], np.asarray(jcb.codes()))
    add("blocked_shards", SH + "ClassBlockedOLVQ1", blocked,
        ("shards_per_class", (), {}), jcb.shards_per_class())
    # ring and feature-sharded winners
    xr = _labelled(4 * 16, 27)[0]
    add("ring", SH + "make_ring_winner", {}, (None, (xr, codes), {}),
        jsh.make_ring_winner(jm)(jnp.asarray(xr), jnp.asarray(codes)))
    add("dim", SH + "make_dim_sharded_winner", dict(chunk=16),
        (None, (xb, codes), {}),
        jsh.make_dim_sharded_winner(jm, chunk=16)(jnp.asarray(xb),
                                                  jnp.asarray(codes)))
    # the trainers on a stream
    rlen = B * 12
    for name, jtr, cls, kw, fit in (
            ("trainer_lvq1", JLVQTrainer, "LVQTrainer", dict(algorithm="lvq1"),
             dict(alpha=0.05)),
            ("trainer_lvq3", JLVQTrainer, "LVQTrainer",
             dict(algorithm="lvq3", winlen=0.3, epsilon=0.1), dict(alpha=0.05)),
            ("trainer_olvq1", JOLVQ1Trainer, "OLVQ1Trainer", dict(alpha=0.3), {})):
        jt = jtr(_codebook(JDataset), batch_size=B, mesh=jm, use_pallas=False, **kw)
        add(name, TRM + cls, dict(codes=_codebook(PDataset), batch_size=B,
                                  device="cpu", **kw),
            ("fit", (), dict(data=_chunks(PDataset), rlen=rlen, **fit)),
            jt.fit(_chunks(JDataset), rlen=rlen, **fit).points)
    # resume from a checkpoint a JAX mesh olvq1 run wrote at step 6 of 12
    d = str(tmp_path_factory.mktemp("jax_mesh_olvq1"))
    jt = JOLVQ1Trainer(_codebook(JDataset), batch_size=B, mesh=jm, alpha=0.3,
                       use_pallas=False, checkpoint_dir=d, checkpoint_interval=6)
    full = jt.fit(_chunks(JDataset), rlen=rlen).points
    os.remove(os.path.join(d, "step_12.npz"))
    add("trainer_resume", TRM + "OLVQ1Trainer",
        dict(codes=_codebook(PDataset), batch_size=B, alpha=0.3, device="cpu",
             checkpoint_dir=d),
        ("fit", (), dict(data=_chunks(PDataset), rlen=rlen)), full)
    ranks = spawn(call_each, 2, 2, "cpu", calls, timeout_s=TIMEOUT_S)
    out = {}
    for i, name in enumerate(ref):
        got = [r[i].points if isinstance(r[i], PDataset) else r[i] for r in ranks]
        for other in got[1:]:
            if isinstance(got[0], dict):
                assert other == got[0]
            else:
                for u, v in zip(got[0] if isinstance(got[0], tuple) else (got[0],),
                                other if isinstance(other, tuple) else (other,)):
                    np.testing.assert_array_equal(u, v)
        out[name] = (got[0], ref[name])
    return out


@pytest.mark.parametrize("algorithm", ["lvq1", "lvq2", "lvq3"])
def test_sharded_lvq_step_matches_jax(world, algorithm):
    got, ref = world[algorithm]
    assert not np.array_equal(got, _labelled(NOC, 24)[0])
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_sharded_olvq1_step_matches_jax(world):
    (c, a), (jc, ja) = world["olvq1"]
    np.testing.assert_allclose(c, np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a, np.asarray(ja), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["blocked_codes", "blocked_alphas",
                                  "blocked_carried"])
def test_class_blocked_olvq1_matches_jax(world, case):
    got, ref = world[case]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_class_blocked_layout_matches_jax(world):
    got, ref = world["blocked_shards"]
    assert got == ref
    clab = _labelled(NOC, 24)[1]
    jcb_order = np.argsort(clab, kind="stable")
    np.testing.assert_array_equal(class_blocked_order(clab), jcb_order)


@pytest.mark.parametrize("case", ["ring", "dim"])
def test_ring_and_dim_sharded_winners_match_jax(world, case):
    (v, i), (jv, ji) = world[case]
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("case", ["trainer_lvq1", "trainer_lvq3", "trainer_olvq1"])
def test_mesh_trainer_on_stream_matches_jax(world, case):
    got, ref = world[case]
    assert not np.array_equal(got, _codebook(PDataset).points)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_mesh_trainer_resumes_jax_mesh_checkpoint(world):
    got, ref = world["trainer_resume"]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)

