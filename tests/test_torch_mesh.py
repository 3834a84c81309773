"""The port's mesh slice against the JAX package, SOM side.

Plain K11 (`som_neighborhood_accumulate`), K12 (`som_blend_winner`) and K3
with a unit offset against the JAX kernels in interpret mode; the sharded
SOM steps (two-pass, pure-TP fused, mixed fused) and SOMTrainer(mesh=...)
in gloo worlds of CPU processes (parallel.mesh.spawn, one process per mesh
position, a `file://` rendezvous, a time limit on every world) against the
JAX builders and trainer on the 8-device virtual CPU mesh, fed the same
numpy-seeded inputs.  One world per mesh layout serves every case of this
module (module-scoped fixtures); each case is its own test.

Tolerances: one step's codes to 1e-5 (the packages sum in different
orders), its winners equal; the two-pass step with overlap_chunks against
the JAX one and against one chunk to 1e-6 (the JAX test's rule), under a
mask equal to one chunk; trained codebooks on the same stream to 1e-4;
the mesh trainers against the port's single-device trainer on the same
Dataset (same batches) to 1e-5; overlap_segments=2 exactly equal to 1; every
rank of a world returns the same whole arrays, exactly."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from som_lvq_pak_tpu.data.dataset import Dataset as JDataset
from som_lvq_pak_tpu.data.dataset import Neighborhood, Topology
from som_lvq_pak_tpu.models.fast import unit_coords as junit_coords
from som_lvq_pak_tpu.models.trainer import SOMTrainer as JSOMTrainer
from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_tpu.parallel import sharded as jsh
from som_lvq_pak_tpu.parallel.mesh import make_mesh as jmake_mesh
from som_lvq_pak_torch.data.dataset import Dataset as PDataset
from som_lvq_pak_torch.models.trainer import SOMTrainer
from som_lvq_pak_torch.ops.som_accum import som_neighborhood_accumulate
from som_lvq_pak_torch.ops.som_blend import som_blend_winner
from som_lvq_pak_torch.ops.som_step import som_fused_train_step
from som_lvq_pak_torch.parallel import sharded
from som_lvq_pak_torch.parallel.mesh import call_each, spawn

T = torch.from_numpy
SH = "som_lvq_pak_torch.parallel.sharded:"
TR = "som_lvq_pak_torch.models.trainer:SOMTrainer"
XDIM, YDIM, D, B = 16, 8, 128, 64  # D lane-padded, as the JAX kernels want
N = XDIM * YDIM
TIMEOUT_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run torch on one CPU thread in this module, as the port's other
    test modules do (see tests/test_torch_trainer.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    codes, xb, xn = f(N, D), f(B, D), f(B, D)
    bmu = rng.integers(0, N, size=B).astype(np.int32)
    mask = (rng.random((B, D)) < 0.2).astype(np.uint8)
    mask[::9] = 1
    weights = rng.integers(0, 4, size=B).astype(np.float32)
    fixed = np.where(rng.random(B) < 0.2, rng.integers(0, N, size=B), -1).astype(np.int32)
    return codes, xb, xn, bmu, mask, weights, fixed


def _blobs(n=1024, seed=3):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 4.0, size=(4, D)).astype(np.float32)
    return (centres[rng.integers(0, 4, size=n)]
            + rng.normal(0, 1.0, size=(n, D)).astype(np.float32))


def _chunks(X, cls, chunk=256, mask=None):
    return [cls(points=X[lo:lo + chunk],
                mask=None if mask is None or not mask[lo:lo + chunk].any()
                else mask[lo:lo + chunk])
            for lo in range(0, X.shape[0], chunk)]


def _codebook(cls, seed=4):
    rng = np.random.default_rng(seed)
    return cls(points=rng.normal(0, 2.0, size=(N, D)).astype(np.float32),
               topol=Topology.HEXA, neigh=Neighborhood.GAUSSIAN, xdim=XDIM,
               ydim=YDIM)


COORDS = np.asarray(junit_coords(XDIM, YDIM, True))


def _val(r):
    """A world's result as arrays: a Dataset's points, a tuple's arrays."""
    return r.points if isinstance(r, PDataset) else r


def _world(data, model, calls):
    """Run `calls` (parallel.mesh.call_each) in a data x model gloo world on
    the CPU; every rank must return the same results (rank 0's are
    returned)."""
    ranks = spawn(call_each, data, model, "cpu", calls, timeout_s=TIMEOUT_S)
    for other in ranks[1:]:
        for a, b in zip(ranks[0], other):
            a, b = _val(a), _val(b)
            for u, v in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(u, v)
    return [_val(r) for r in ranks[0]]


def _jmesh(data, model):
    return jmake_mesh(data * model, data=data, model=model)


def _put(mesh, a, *spec):
    return jax.device_put(jnp.asarray(a), NamedSharding(mesh, JP(*spec)))


# -- the plain kernels against the JAX kernels (interpret mode) ---------------

@pytest.mark.parametrize("gaussian,hexa,per_sample", [(True, True, False),
                                                      (False, False, True)])
def test_accumulate_plain_matches_jax(gaussian, hexa, per_sample):
    """Plain K11 at a shard of 32 rows with global unit offset 64 (bmu
    global, a few samples without one) against som_neighborhood_accumulate;
    to 1e-5."""
    _, xb, _, bmu, _, _, _ = _inputs(1)
    bmu[:3] = -1
    Dp = 128  # the JAX kernel wants lane-padded rows
    xp = np.zeros((B, Dp), np.float32)
    xp[:, :D] = xb
    alpha = np.linspace(0.01, 0.08, B).astype(np.float32) if per_sample else 0.05
    acc, wsum = som_neighborhood_accumulate(T(xb), T(bmu), 32, XDIM, hexa,
                                            alpha if not per_sample else T(alpha),
                                            3.0, gaussian, unit_offset=64)
    jacc, jw = jps.som_neighborhood_accumulate(
        jnp.asarray(xp), jnp.asarray(bmu), 32, XDIM, hexa, jnp.asarray(alpha),
        jnp.float32(3.0), gaussian=gaussian, tile_n=16, unit_offset=64,
        interpret=True)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc)[:, :D], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(wsum.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-5)
    assert wsum.shape == (32, 1)


def test_blend_winner_plain_matches_jax():
    """Plain K12 against som_blend_winner: the blended shard to 1e-5, the
    max-score winners (local rows) equal, -2 score to 1e-4.  On a shard with
    every row twice (exact ties) the JAX kernel picks the first copy; the
    plain version's matmul may round a copy's score differently (BLAS tiles
    rows unevenly), so there it must pick the same pair."""
    codes, _, xn, _, _, _, _ = _inputs(2)
    rng = np.random.default_rng(12)
    base = codes[:16]
    acc = rng.normal(size=(32, D)).astype(np.float32)
    wsum = rng.uniform(0, 2, size=(32, 1)).astype(np.float32)
    pad = lambda a: np.pad(a, ((0, 0), (0, 128 - D)))  # noqa: E731
    for dup, shard in ((False, codes[:32]), (True, np.concatenate([base, base]))):
        a2, w2 = acc, wsum
        if dup:  # the same blend for both copies
            a2, w2 = np.concatenate([acc[:16]] * 2), np.concatenate([wsum[:16]] * 2)
        c, val, idx = som_blend_winner(T(shard.copy()), T(a2), T(w2), T(xn))
        jc, jv, ji = jps.som_blend_winner(
            jnp.asarray(pad(shard)), jnp.asarray(pad(a2)), jnp.asarray(w2),
            jnp.asarray(pad(xn)), tile_n=16, d_real=D, interpret=True)
        ji = np.asarray(ji)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc)[:, :D], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(val.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)
        if dup:
            assert int(ji.max()) < 16  # the first copy of each tied pair
            np.testing.assert_array_equal(idx.numpy() % 16, ji)
        else:
            np.testing.assert_array_equal(idx.numpy(), ji)


def test_fused_step_unit_offset_matches_jax():
    """The port's plain K3 on the rows 64..127 of a map with unit_offset 64
    against som_fused_train_step(unit_offset=64): codes to 1e-5, winners
    equal (local rows in both packages)."""
    codes, xb, xn, bmu, _, _, _ = _inputs(3)
    shard = codes[64:].copy()
    c, idx, val = som_fused_train_step(T(shard.copy()), T(xb), T(bmu), T(xn), XDIM, True,
                                       0.05, 3.0, gaussian=True, unit_offset=64)
    jc, jidx, jval = jps.som_fused_train_step(
        jnp.asarray(shard), jnp.asarray(xb), jnp.asarray(bmu), jnp.asarray(xn),
        XDIM, True, jnp.float32(0.05), jnp.float32(3.0), gaussian=True,
        tile_n=16, factored=False, unit_offset=64, interpret=True)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=1e-4, atol=1e-4)
    # offset 0 is the unsharded kernel
    c0, i0, _ = som_fused_train_step(T(codes.copy()), T(xb), T(bmu), T(xn), XDIM,
                                     True, 0.05, 3.0, gaussian=True, factored=False)
    np.testing.assert_allclose(c0.numpy()[64:], c.numpy(), rtol=1e-5, atol=1e-5)


# -- the errors the JAX builders raise ------------------------------------------

def _fake_mesh(data, model):
    return types.SimpleNamespace(shape={"data": data, "model": model},
                                 coords={"data": 0, "model": 0})


def test_fused_tp_step_rejects_a_data_axis():
    with pytest.raises(ValueError, match="data-axis size 1"):
        sharded.make_sharded_fused_som_train_step(_fake_mesh(2, 1), True, XDIM, True)
    with pytest.raises(ValueError, match="data-axis size 1"):
        jsh.make_sharded_fused_som_train_step(_jmesh(2, 1), gaussian=True, xdim=XDIM,
                                              hexa=True)


def test_mixed_step_rejects_shard_heights_not_multiple_of_8():
    """A 12-row shard raises before any collective, in both packages."""
    step = sharded.make_mixed_fused_som_train_step(_fake_mesh(1, 2), True, XDIM,
                                                   True)
    codes, xb, xn, bmu, _, _, _ = _inputs(5)
    with pytest.raises(ValueError, match="multiple of 8"):
        step.local(T(codes[:12].copy()), T(xb), T(bmu), T(xn), 0.05, 3.0, 0)
    jm = _jmesh(1, 2)
    jstep = jsh.make_mixed_fused_som_train_step(jm, gaussian=True, xdim=XDIM,
                                                hexa=True, tile_n=16,
                                                use_pallas=False)
    with pytest.raises(ValueError, match="multiple of 8"):
        jstep(_put(jm, codes[:24], "model", None), jnp.asarray(xb),
              jnp.asarray(bmu), jnp.asarray(xn), jnp.float32(0.05),
              jnp.float32(3.0))


# -- the sharded steps in a (data 2, model 2) world ----------------------------

@pytest.fixture(scope="module")
def world22(tmp_path_factory):
    """Every (2, 2) case of this module in one world: port results (rank 0's,
    after checking every rank agrees) beside the JAX package's."""
    codes, xb, xn, bmu, mask, weights, fixed = _inputs(7)
    alphas = np.linspace(0.01, 0.08, B).astype(np.float32)
    X = _blobs()
    jm = _jmesh(2, 2)
    ref, calls = {}, []

    def add(name, target, kw, then, jax_result):
        calls.append((target, (), kw, then))
        ref[name] = jax_result

    # two-pass step: plain gaussian; masked, weighted and fixed bubble;
    # masked gaussian
    jstep = jsh.make_sharded_som_train_step(jm, gaussian=True)
    add("two_pass", SH + "make_sharded_som_train_step", dict(gaussian=True),
        (None, (codes, xb, COORDS, 0.05, 3.0), {}),
        jstep(*jsh.shard_arrays(jm, jnp.asarray(codes), jnp.asarray(xb),
                                jnp.asarray(COORDS)),
              jnp.float32(0.05), jnp.float32(3.0)))
    jstep = jsh.make_sharded_som_train_step(jm, gaussian=False, masked=True,
                                            weighted=True, fixed=True)
    add("two_pass_mwf", SH + "make_sharded_som_train_step",
        dict(gaussian=False, masked=True, weighted=True, fixed=True),
        (None, (codes, xb, COORDS, 0.05, 3.0, mask, weights, fixed), {}),
        jstep(*jsh.shard_arrays(jm, jnp.asarray(codes), jnp.asarray(xb),
                                jnp.asarray(COORDS)),
              jnp.float32(0.05), jnp.float32(3.0), _put(jm, mask, "data", None), _put(jm, weights, "data"),
              _put(jm, fixed, "data")))
    jstep = jsh.make_sharded_som_train_step(jm, gaussian=True, masked=True)
    add("two_pass_masked", SH + "make_sharded_som_train_step",
        dict(gaussian=True, masked=True),
        (None, (codes, xb, COORDS, 0.05, 3.0, mask), {}),
        jstep(*jsh.shard_arrays(jm, jnp.asarray(codes), jnp.asarray(xb),
                                jnp.asarray(COORDS)),
              jnp.float32(0.05), jnp.float32(3.0), _put(jm, mask, "data", None)))
    # overlap_chunks on the JAX test's inputs (tests/test_sharded.py:
    # test_overlap_chunked_step_matches_unchunked: B 64, 16x8 hexa, D 16,
    # gaussian), the JAX builder on the 8-device mesh; the port at 1, 4 and
    # more chunks than a rank's 32 batch rows; and under a mask, where the
    # option is ignored
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    ocodes = np.asarray(jax.random.normal(k1, (N, 16), dtype=jnp.float32))
    oxb = np.asarray(jax.random.normal(k2, (B, 16), dtype=jnp.float32) * 2)
    j8 = jmake_mesh(8)
    jstep = jsh.make_sharded_som_train_step(j8, gaussian=True, overlap_chunks=4)
    jlapped = jstep(*jsh.shard_arrays(j8, jnp.asarray(ocodes), jnp.asarray(oxb),
                                      jnp.asarray(COORDS)),
                    jnp.float32(0.05), jnp.float32(3.0))
    for chunks in (1, 4, 1000):
        add(f"overlap{chunks}", SH + "make_sharded_som_train_step",
            dict(gaussian=True, overlap_chunks=chunks),
            (None, (ocodes, oxb, COORDS, 0.05, 3.0), {}), jlapped)
    add("two_pass_masked_overlap4", SH + "make_sharded_som_train_step",
        dict(gaussian=True, masked=True, overlap_chunks=4),
        (None, (codes, xb, COORDS, 0.05, 3.0, mask), {}), None)
    # mixed fused step: scalar alpha gaussian (one segment and two), and
    # per-sample alpha bubble
    for name, gaussian, alpha, segs in (("mixed", True, 0.05, 1),
                                        ("mixed_lapped", True, 0.05, 2),
                                        ("mixed_bubble", False, alphas, 1)):
        jstep = jsh.make_mixed_fused_som_train_step(
            jm, gaussian=gaussian, xdim=XDIM, hexa=True, tile_n=16,
            overlap_segments=segs)
        add(name, SH + "make_mixed_fused_som_train_step",
            dict(gaussian=gaussian, xdim=XDIM, hexa=True, overlap_segments=segs),
            (None, (codes, xb, bmu, xn, alpha, 3.0), {}),
            jstep(_put(jm, codes, "model", None), _put(jm, xb, "data", None),
                  _put(jm, bmu, "data"), _put(jm, xn, "data", None),
                  jnp.asarray(alpha), jnp.float32(3.0)))
    # the trainer on a stream (the two-pass path in both packages)
    jt = JSOMTrainer(_codebook(JDataset), batch_size=B, mesh=jm, use_pallas=False)
    fit = dict(rlen=B * 12, alpha=0.05, radius=4.0)
    add("trainer_stream", TR, dict(codes=_codebook(PDataset), batch_size=B,
                                   device="cpu"),
        ("fit", (), dict(data=_chunks(X, PDataset), **fit)),
        jt.fit(_chunks(X, JDataset), **fit).points)
    # the trainer on a Dataset (the mixed fused path) against the port's
    # single-device trainer (K3 per step) on the same batches
    ds_fit = dict(rlen=B * 8, alpha=0.05, radius=4.0)
    add("trainer_mixed", TR, dict(codes=_codebook(PDataset), batch_size=B,
                                  device="cpu", seed=5),
        ("fit", (), dict(data=PDataset(points=X), **ds_fit)),
        SOMTrainer(_codebook(PDataset), batch_size=B, device="cpu", seed=5,
                   vmem_steps=False).fit(PDataset(points=X), **ds_fit).points)
    # resume from a checkpoint a JAX mesh run wrote at step 6 of 12
    d = str(tmp_path_factory.mktemp("jax_mesh_ckpt"))
    jt = JSOMTrainer(_codebook(JDataset), batch_size=B, mesh=jm, use_pallas=False,
                     checkpoint_dir=d, checkpoint_interval=6)
    full = jt.fit(_chunks(X, JDataset), **fit).points
    os.remove(os.path.join(d, f"step_{12}.npz"))
    add("trainer_resume", TR, dict(codes=_codebook(PDataset), batch_size=B,
                                   device="cpu", checkpoint_dir=d),
        ("fit", (), dict(data=_chunks(X, PDataset), **fit)), full)
    return {name: (got, ref[name])
            for name, got in zip(ref, _world(2, 2, calls))}


@pytest.mark.parametrize("case", ["two_pass", "two_pass_mwf", "two_pass_masked"])
def test_two_pass_step_matches_jax(world22, case):
    got, ref = world22[case]
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_overlap_chunks_matches_jax(world22):
    """overlap_chunks=4 against the JAX builder with overlap_chunks=4 on the
    8-device mesh, at the JAX test's rule (1e-6)."""
    got, ref = world22["overlap4"]
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["overlap4", "overlap1000"])
def test_overlap_chunks_equal_to_one_chunk(world22, case):
    """4 chunks, and more chunks than the rank's 32 batch rows (clamped to
    one row each), against overlap_chunks=1 at the JAX test's rule (1e-6):
    the winners do not depend on the chunk, so the step is the same."""
    got, _ = world22[case]
    one, _ = world22["overlap1"]
    np.testing.assert_allclose(got, one, rtol=1e-6, atol=1e-6)


def test_overlap_chunks_ignored_under_a_mask(world22):
    """Under a mask the option is ignored, as in the JAX step: the masked
    step with overlap_chunks=4 equals it with 1, exactly."""
    got, _ = world22["two_pass_masked_overlap4"]
    one, _ = world22["two_pass_masked"]
    np.testing.assert_array_equal(got, one)


@pytest.mark.parametrize("case", ["mixed", "mixed_bubble"])
def test_mixed_fused_step_matches_jax(world22, case):
    (c, b), (jc, jb) = world22[case]
    np.testing.assert_allclose(c, np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(b, np.asarray(jb))


def test_mixed_overlap_segments_exactly_equal(world22):
    (c1, b1), _ = world22["mixed"]
    (c2, b2), _ = world22["mixed_lapped"]
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(b1, b2)


def test_mesh_trainer_on_stream_matches_jax(world22):
    got, ref = world22["trainer_stream"]
    assert not np.array_equal(got, _codebook(PDataset).points)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_mesh_trainer_mixed_path_matches_single_device(world22):
    got, ref = world22["trainer_mixed"]
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_mesh_trainer_resumes_jax_mesh_checkpoint(world22):
    got, ref = world22["trainer_resume"]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


# -- the pure-TP and data-only layouts -----------------------------------------

@pytest.fixture(scope="module")
def world12():
    """(data 1, model 2): three chained fused TP steps, each fed the JAX
    chain's state at that step; the trainer's TP path on a Dataset against
    the port's single-device trainer (same batches)."""
    codes, xb, xn, bmu, _, _, _ = _inputs(9)
    jm = _jmesh(1, 2)
    jstep = jsh.make_sharded_fused_som_train_step(jm, gaussian=True, xdim=XDIM,
                                                  hexa=True, tile_n=16)
    calls, ref = [], []
    c, b, x0, x1 = codes, bmu, xb, xn
    for t in range(3):
        a, r = 0.05 - 0.01 * t, 3.0 - 0.5 * t
        calls.append((SH + "make_sharded_fused_som_train_step", (),
                      dict(gaussian=True, xdim=XDIM, hexa=True),
                      (None, (c, x0, b, x1, a, r), {})))
        jc, jb = jstep(_put(jm, c, "model", None), jnp.asarray(x0),
                       jnp.asarray(b), jnp.asarray(x1), jnp.float32(a),
                       jnp.float32(r))
        c, b = np.asarray(jc), np.asarray(jb)
        ref.append((c, b))
        x0, x1 = x1, x0
    X = _blobs(seed=8)
    fit = dict(rlen=B * 8, alpha=0.05, radius=4.0)
    calls.append((TR, (), dict(codes=_codebook(PDataset), batch_size=B,
                               device="cpu", seed=2),
                  ("fit", (), dict(data=PDataset(points=X), **fit))))
    single = SOMTrainer(_codebook(PDataset), batch_size=B, device="cpu", seed=2,
                        vmem_steps=False).fit(PDataset(points=X), **fit).points
    got = _world(1, 2, calls)
    return got[:3], ref, got[3], single


@pytest.mark.parametrize("t", [0, 1, 2])
def test_fused_tp_step_matches_jax(world12, t):
    got, ref, _, _ = world12
    np.testing.assert_allclose(got[t][0], ref[t][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[t][1], ref[t][1])


def test_fused_tp_trainer_path_matches_single_device(world12):
    _, _, got, single = world12
    assert not np.array_equal(got, _codebook(PDataset).points)
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-5)


def test_masked_stream_trainer_on_data_mesh_matches_jax():
    """(data 2, model 1), a stream whose chunks 1 and 3 carry missing
    components (the masked two-pass step, K4 on the card) against the JAX
    mesh trainer on the same stream; to 1e-4."""
    X = _blobs(seed=10)
    rng = np.random.default_rng(11)
    mask = (rng.random(X.shape) < 0.15).astype(np.uint8)
    mask[::41] = 1
    mask[:256] = 0
    mask[512:768] = 0
    X = np.where(mask != 0, np.float32(0), X)
    fit = dict(rlen=B * 12, alpha=0.05, radius=4.0)
    ref = JSOMTrainer(_codebook(JDataset), batch_size=B, mesh=_jmesh(2, 1),
                      use_pallas=False).fit(_chunks(X, JDataset, mask=mask),
                                            **fit).points
    got, = _world(2, 1, [(TR, (), dict(codes=_codebook(PDataset), batch_size=B,
                                        device="cpu"),
                          ("fit", (), dict(data=_chunks(X, PDataset, mask=mask),
                                           **fit)))])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
