"""The port's grouped training path against the JAX package: K7's plain
version (`som_vmem_train_steps`, K chained plain K3 steps) against the JAX
package's `som_vmem_train_steps` in interpret mode, and `SOMTrainer.fit` at
the default vmem_steps=None (GK = 32 batches per launch) against the JAX
package's default trainer: chaining across groups, dirty groups, interval
checkpoints at group boundaries, resume, and the choice of path.

Tolerances: one K7 call, codebooks allclose 1e-5 and winners equal except
at near-ties (float32 sums of a few hundred terms, summed in different
orders by the two packages); trained codebooks 2e-2 and quality 2% against
the JAX package, where near-tie winner flips compound over batches, as in
tests/test_torch_trainer.py; the port's grouped and per-step paths, whose
arithmetic is the same, 1e-5."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.data.dataset import Dataset, Neighborhood, Topology
from som_lvq_pak_tpu.data.labels import GLOBAL_LABELS as JAX_LABELS
from som_lvq_pak_tpu.models import som as jsom
from som_lvq_pak_tpu.models.trainer import SOMTrainer as JaxSOMTrainer
from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_tpu.utils.rng import CRandom
from som_lvq_pak_torch.convert import as_port_dataset
from som_lvq_pak_torch.data.dataset import Dataset as PDataset
from som_lvq_pak_torch.models import trainer as ptrainer
from som_lvq_pak_torch.models.trainer import SOMTrainer, use_grouped_steps
from som_lvq_pak_torch.ops.som_vmem import som_vmem_train_steps

TOL = 1e-5
T = torch.from_numpy


def P(ds):
    """A JAX package Dataset carried to the port (labels by name)."""
    return as_port_dataset(ds, source_labels=JAX_LABELS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run torch on one CPU thread in this module (the gaussian step's first
    parallel exp on a multi-core CPU host can come back up to 1.5e-4 off in
    one thread's share; see tests/test_torch_trainer.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(n, dim=8, seed=3):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 4.0, size=(4, dim)).astype(np.float32)
    return (centres[rng.integers(0, 4, size=n)]
            + rng.normal(0, 1.0, size=(n, dim)).astype(np.float32))


def _init(X, xdim, ydim, topol, neigh, seed=123):
    return jsom.randinit(Dataset(points=X), topol, neigh, xdim, ydim, CRandom(seed))


def _stream(X, chunk=256, cls=Dataset, **extras):
    """Chunks as the JAX package's Datasets, or the port's (cls=PDataset);
    `extras` are per-chunk dicts of mask/weight/fixed arrays by chunk index."""
    for k, lo in enumerate(range(0, X.shape[0], chunk)):
        kw = {name: a[k][lo:lo + chunk] for name, a in extras.items() if k in a}
        yield cls(points=X[lo:lo + chunk], **kw)


def _q(codes, X):
    """The JAX package's per-sample fast qerror of either package's codebook."""
    jcodes = Dataset(points=codes.points, topol=Topology(int(codes.topol)),
                     neigh=Neighborhood(int(codes.neigh)), xdim=codes.xdim,
                     ydim=codes.ydim)
    return jsom.find_qerror(jcodes, Dataset(points=X), mode="fast") / X.shape[0]


def _assert_winners_agree(x, codes, i_port, i_ref):
    bad = np.nonzero(np.asarray(i_port) != np.asarray(i_ref))[0]
    if bad.size:
        x64 = np.asarray(x, np.float64)[bad]
        c64 = np.asarray(codes, np.float64)
        da = ((x64 - c64[np.asarray(i_port)[bad]]) ** 2).sum(-1)
        db = ((x64 - c64[np.asarray(i_ref)[bad]]) ** 2).sum(-1)
        gap = np.abs(da - db) / np.maximum(np.maximum(da, db), 1e-30)
        assert gap.max() < TOL, (bad, gap)


# -- K7's plain version against the JAX kernel -----------------------------

@pytest.mark.parametrize("per_sample_alpha", [False, True])
@pytest.mark.parametrize("chained", [False, True])
@pytest.mark.parametrize("xdim,ydim,hexa,gaussian", [(8, 6, True, True),
                                                     (8, 8, False, False)])
def test_vmem_steps_match_jax(xdim, ydim, hexa, gaussian, chained,
                              per_sample_alpha):
    """K = 5 steps of B = 64 at D = 7.  The JAX kernel takes D padded to
    128 with zero columns; the first D columns are compared.  Alphas stay
    small enough that no unit's weight mass passes 1, so bubble units never
    saturate to equal rows (whose ties float rounding would decide)."""
    K, B, D = 5, 64, 7
    noc = xdim * ydim
    rng = np.random.default_rng(noc + 2 * chained + per_sample_alpha)
    codes = rng.normal(size=(noc, D)).astype(np.float32)
    xs = rng.normal(size=(K, B, D)).astype(np.float32)
    nf = rng.normal(size=(B, D)).astype(np.float32) if chained else None
    d0 = ((xs[0][:, None, :] - codes[None]) ** 2).sum(-1)
    bmu0 = np.argmin(d0, axis=1).astype(np.int32)
    alphas = (rng.uniform(0.001, 0.012, size=(K, B)) if per_sample_alpha
              else np.linspace(0.012, 0.004, K)).astype(np.float32)
    radii = np.linspace(3.0, 1.5, K).astype(np.float32)

    c = T(codes.copy())
    out, bmu = som_vmem_train_steps(c, T(xs), T(bmu0), T(alphas), T(radii), xdim,
                                    hexa, gaussian,
                                    next_first=None if nf is None else T(nf))
    assert out.data_ptr() == c.data_ptr() and bmu.dtype == torch.int32

    def pad(a):
        return jnp.zeros(a.shape[:-1] + (128,), jnp.float32).at[..., :D].set(a)

    ref, jbmu = jps.som_vmem_train_steps(
        pad(codes), pad(xs), jnp.asarray(bmu0), jnp.asarray(alphas),
        jnp.asarray(radii), xdim, hexa, gaussian=gaussian,
        next_first=None if nf is None else pad(nf))
    ref = np.asarray(ref)
    np.testing.assert_array_equal(ref[:, D:], 0.0)
    np.testing.assert_allclose(out.numpy(), ref[:, :D], rtol=TOL, atol=TOL)
    assert not np.allclose(out.numpy(), codes, atol=1e-3)  # the steps did something
    _assert_winners_agree(xs[-1] if nf is None else nf, out.numpy(), bmu.numpy(),
                          np.asarray(jbmu))


# -- SOMTrainer's grouped path ----------------------------------------------

MAPS = [(8, 6, Topology.HEXA, Neighborhood.GAUSSIAN, 4.0, True),
        (8, 8, Topology.RECT, Neighborhood.BUBBLE, 3.0, False)]


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(a[1].shape[0])  # K of the group
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("xdim,ydim,topol,neigh,radius,same_codes", MAPS)
def test_grouped_fit_matches_jax_default(xdim, ydim, topol, neigh, radius,
                                         same_codes, monkeypatch):
    """40 batches of 64 from a stream: one full group of 32 and one of 8 in
    both packages, at both packages' default vmem_steps=None.  A bubble map
    is compared on quality only (tests/test_torch_trainer.py:MAPS)."""
    X = _blobs(40 * 64)
    init = _init(X, xdim, ydim, topol, neigh)
    kw = dict(rlen=40 * 64, alpha=0.05, radius=radius)
    jcalls = _count_calls(monkeypatch, jps, "som_vmem_train_steps")
    pcalls = _count_calls(monkeypatch, ptrainer, "som_vmem_train_steps")
    ref = JaxSOMTrainer(init, batch_size=64, use_pallas=True).fit(_stream(X), **kw)
    out = SOMTrainer(P(init), batch_size=64, device="cpu").fit(
        _stream(X, cls=PDataset), **kw)
    assert jcalls == pcalls == [32, 8]
    if same_codes:
        np.testing.assert_allclose(out.points, ref.points, rtol=2e-2, atol=2e-2)
    q_ref = _q(ref, X)
    assert abs(_q(out, X) - q_ref) < 0.02 * q_ref
    assert q_ref < 0.8 * _q(init, X)


def test_grouped_fit_matches_stepwise():
    """The port's grouped path against its own per-step path on a Dataset
    (per-lap shuffle, 40 batches of 64 over 3+ laps): the same arithmetic,
    so to 1e-5 (the port's copy of
    tests/test_trainer_quality.py:test_vmem_grouped_trainer_matches_stepwise)."""
    X = _blobs(700)
    init = P(_init(X, 8, 6, Topology.HEXA, Neighborhood.GAUSSIAN))
    kw = dict(rlen=40 * 64, alpha=0.05, radius=4.0)
    tk = dict(batch_size=64, seed=9, device="cpu")
    out_v = SOMTrainer(init, vmem_steps=None, **tk).fit(PDataset(points=X), **kw)
    out_s = SOMTrainer(init, vmem_steps=False, **tk).fit(PDataset(points=X), **kw)
    np.testing.assert_allclose(out_v.points, out_s.points, rtol=1e-5, atol=1e-5)


def test_dirty_and_clean_groups_match_jax(monkeypatch):
    """80 batches of 32 in chunks of 256 (8 batches), weight= tokens on
    every chunk: group 0 is clean, group 1 holds a masked chunk and a chunk
    with fixed= samples, group 2 (16 batches) is clean.  The dirty group
    runs every batch through the two-kernel step, and the clean group after
    it finds its winners again."""
    X = _blobs(80 * 32)
    rng = np.random.default_rng(8)
    mask = (rng.random(X.shape) < 0.15).astype(np.uint8)
    mask[::53] = 1
    X = np.where(mask != 0, 0.0, X).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, size=X.shape[0]).astype(np.float32)
    fixed = np.full((X.shape[0], 2), -1, np.int32)
    fixed[6 * 256::7] = (3, 2)
    extras = dict(mask={5: mask}, weight={k: weight for k in range(10)},
                  fixed={6: fixed})
    init = _init(X, 6, 6, Topology.HEXA, Neighborhood.GAUSSIAN, seed=9)
    kw = dict(rlen=80 * 32, alpha=0.05, radius=3.0, use_weights=True,
              use_fixed=True)
    jcalls = _count_calls(monkeypatch, jps, "som_vmem_train_steps")
    pcalls = _count_calls(monkeypatch, ptrainer, "som_vmem_train_steps")
    ref = JaxSOMTrainer(init, batch_size=32, use_pallas=True).fit(
        _stream(X, **extras), **kw)
    out = SOMTrainer(P(init), batch_size=32, device="cpu").fit(
        _stream(X, cls=PDataset, **extras), **kw)
    assert jcalls == pcalls == [32, 16]  # groups 0 and 2
    np.testing.assert_allclose(out.points, ref.points, rtol=2e-2, atol=2e-2)


def test_interval_checkpoints_match_jax(tmp_path):
    """63 batches at interval 10: both packages save at the group boundary
    after batch 32 and at 63 (tests/test_trainer.py:239-252)."""
    X = _blobs(63 * 16)
    init = _init(X, 6, 4, Topology.HEXA, Neighborhood.BUBBLE, seed=3)
    kw = dict(rlen=63 * 16, alpha=0.05, radius=4.0)
    jt = JaxSOMTrainer(init, batch_size=16, checkpoint_dir=str(tmp_path / "j"),
                       checkpoint_interval=10, use_pallas=True)
    pt = SOMTrainer(P(init), batch_size=16, checkpoint_dir=str(tmp_path / "p"),
                    checkpoint_interval=10, device="cpu")
    jt.ckpt.keep = pt.ckpt.keep = 0
    jt.fit(_stream(X), **kw)
    pt.fit(_stream(X, cls=PDataset), **kw)
    assert pt.ckpt.steps() == jt.ckpt.steps() == [32, 63]


def test_resume_jax_checkpoint_on_grouped_path(tmp_path):
    """A checkpoint the JAX package's grouped run wrote at batch 32 resumes
    in the port's grouped path (the remaining 8 batches as one group)."""
    X = _blobs(40 * 64)
    init = _init(X, 8, 6, Topology.HEXA, Neighborhood.GAUSSIAN)
    kw = dict(rlen=40 * 64, alpha=0.05, radius=4.0)
    d = str(tmp_path / "ckj")
    full = JaxSOMTrainer(init, batch_size=64, checkpoint_dir=d, checkpoint_interval=10,
                         use_pallas=True).fit(_stream(X), **kw)
    tr = SOMTrainer(P(init), batch_size=64, checkpoint_dir=d, device="cpu")
    assert tr.ckpt.steps() == [32, 40]
    os.remove(os.path.join(d, "step_40.npz"))
    resumed = tr.fit(_stream(X, cls=PDataset), **kw)
    np.testing.assert_allclose(resumed.points, full.points, rtol=2e-2, atol=2e-2)
    assert tr.ckpt.latest_step() == 40


@pytest.mark.parametrize("case,grouped", [
    ("stream", True), ("dataset", True), ("dataset_fixed_unused", True),
    ("vmem_steps_false", False), ("masked_dataset", False),
    ("dataset_fixed", False)])
def test_path_choice_matches_jax(case, grouped, monkeypatch):
    """At small sizes the packages take the grouped path for the same
    configurations (counted on the JAX side by patching its kernel)."""
    X = _blobs(256, dim=5)
    init = _init(X, 4, 3, Topology.HEXA, Neighborhood.GAUSSIAN)
    fixed = np.full((256, 2), -1, np.int32)
    fixed[::9] = (1, 1)
    mask = np.zeros(X.shape, np.uint8)
    mask[::4, 1] = 1
    extras = {"dataset_fixed": dict(fixed=fixed), "dataset_fixed_unused": dict(fixed=fixed),
              "masked_dataset": dict(mask=mask)}.get(case, {})
    kw = dict(rlen=256, alpha=0.05, radius=2.0, use_fixed=case == "dataset_fixed")
    tk = dict(batch_size=32, vmem_steps=False if case == "vmem_steps_false" else None)

    def data(cls):
        return _stream(X, cls=cls) if case == "stream" else cls(points=X, **extras)

    jcalls = _count_calls(monkeypatch, jps, "som_vmem_train_steps")
    pcalls = _count_calls(monkeypatch, ptrainer, "som_vmem_train_steps")
    JaxSOMTrainer(init, use_pallas=True, **tk).fit(data(Dataset), **kw)
    SOMTrainer(P(init), device="cpu", **tk).fit(data(PDataset), **kw)
    assert jcalls == pcalls == ([8] if grouped else [])


def test_path_choice_at_large_sizes():
    """The predicate at the sizes the chip runs: the TPU's sizes decide, as
    written in the JAX package (Dp = 128-multiple of D)."""
    stream = iter(())
    assert use_grouped_steps(64 * 64, 64, 512, stream)            # 64x64, B 512
    assert use_grouped_steps(64 * 64, 128, 512, stream)           # 2 MB codebook
    assert not use_grouped_steps(128 * 128, 64, 512, stream)      # 8 MB codebook
    assert not use_grouped_steps(256 * 256, 64, 4096, stream)
    assert use_grouped_steps(64 * 64, 64, 1024, stream)
    assert not use_grouped_steps(64 * 64, 64, 2048, stream)       # working set > 14 MB
    assert use_grouped_steps(12 * 8, 5, 128, stream)              # somexample
    assert not use_grouped_steps(64 * 64, 64, 512, stream, vmem_steps=False)
    ds = PDataset(points=np.zeros((4, 64), np.float32),
                  fixed=np.full((4, 2), -1, np.int32))
    assert use_grouped_steps(64 * 64, 64, 512, ds)
    assert not use_grouped_steps(64 * 64, 64, 512, ds, use_fixed=True)
    masked = PDataset(points=np.zeros((4, 64), np.float32),
                      mask=np.ones((4, 64), np.uint8))
    assert not use_grouped_steps(64 * 64, 64, 512, masked)
