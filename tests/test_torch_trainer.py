"""The port's main path, SOMTrainer.fit then find_qerror(mode="fast"),
against the JAX package's SOMTrainer (fused Pallas path, interpret mode on
the CPU) on the same seeded data.

Tolerances follow tests/test_trainer.py: winner flips at near-ties compound
over batches, so trained codebooks agree to 2e-2 and quality to 2%; the
Dataset form shuffles with a different generator (jax.random vs
torch.Generator), so there only quality is compared, to 5%."""

import os
import types

import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.data.dataset import Dataset, Neighborhood, Topology
from som_lvq_pak_tpu.data.labels import GLOBAL_LABELS as JAX_LABELS
from som_lvq_pak_tpu.models import som as jsom
from som_lvq_pak_tpu.models.trainer import SOMTrainer as JaxSOMTrainer
from som_lvq_pak_tpu.utils.rng import CRandom
from som_lvq_pak_torch.convert import as_port_dataset
from som_lvq_pak_torch.data.dataset import Dataset as PDataset
from som_lvq_pak_torch.models import som
from som_lvq_pak_torch.models.trainer import SOMTrainer

B = 128


def P(ds):
    """A JAX package Dataset carried to the port (labels by name)."""
    return as_port_dataset(ds, source_labels=JAX_LABELS)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run torch on one CPU thread in this module.  On a multi-core x86
    host, the first vectorized transcendental (exp, sin, ...) that torch
    spreads over several OpenMP threads in a process came back up to
    1.5e-4 relative off in one worker thread's share, in about 0.5% of
    processes; the port's plain SOM step makes such a call (the gaussian
    neighbourhood), and 1e-4 is far outside these tests' tolerances."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blobs(n=1024, dim=8, seed=3):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 4.0, size=(4, dim)).astype(np.float32)
    return (centres[rng.integers(0, 4, size=n)]
            + rng.normal(0, 1.0, size=(n, dim)).astype(np.float32))


def _stream(X, chunk=256, cls=Dataset):
    """Chunks as the JAX package's Datasets, or the port's (cls=PDataset)."""
    for lo in range(0, X.shape[0], chunk):
        yield cls(points=X[lo:lo + chunk])


def _init(X, xdim, ydim, topol, neigh):
    """A JAX package codebook; P(...) carries it to the port."""
    return jsom.randinit(Dataset(points=X), topol, neigh, xdim, ydim, CRandom(123))


def _jax_q(codes, X):
    """The JAX package's per-sample fast qerror of either package's codebook."""
    jcodes = Dataset(points=codes.points, topol=Topology(int(codes.topol)),
                     neigh=Neighborhood(int(codes.neigh)), xdim=codes.xdim,
                     ydim=codes.ydim)
    return jsom.find_qerror(jcodes, Dataset(points=X), mode="fast") / X.shape[0]


# 8x6 hexa takes the JAX package's plain fused kernel (48 rows pad to a
# 32-row tile); 8x8 its separable ("factored") kernel.  A bubble map is
# compared on quality only: units with the same neighbour set saturate to
# the same weighted mean, so their rows are equal in exact arithmetic and
# float rounding alone (which differs between the packages' matmuls)
# decides those winner ties, and the maps drift apart.
MAPS = [(8, 6, Topology.HEXA, Neighborhood.GAUSSIAN, 4.0, True),
        (8, 8, Topology.RECT, Neighborhood.GAUSSIAN, 3.0, True),
        (8, 8, Topology.RECT, Neighborhood.BUBBLE, 3.0, False)]


@pytest.mark.parametrize("xdim,ydim,topol,neigh,radius,same_codes", MAPS)
def test_stream_fit_and_qerror_match_jax(xdim, ydim, topol, neigh, radius,
                                         same_codes):
    X = _blobs()
    init = _init(X, xdim, ydim, topol, neigh)
    ref = JaxSOMTrainer(init, batch_size=B, use_pallas=True, vmem_steps=False
                        ).fit(_stream(X), rlen=1024, alpha=0.05, radius=radius)
    out = SOMTrainer(P(init), batch_size=B, device="cpu", vmem_steps=False).fit(
        _stream(X, cls=PDataset), rlen=1024, alpha=0.05, radius=radius)
    assert out.points.shape == init.points.shape
    assert (out.topol, out.neigh, out.xdim, out.ydim) == (topol, neigh, xdim, ydim)
    if same_codes:
        np.testing.assert_allclose(out.points, ref.points, rtol=2e-2, atol=2e-2)
    q_ref = _jax_q(ref, X)
    assert abs(_jax_q(out, X) - q_ref) < 0.02 * q_ref
    assert q_ref < 0.8 * _jax_q(init, X)  # training did something

    # the fast qerror itself, on one codebook, host or tensor arguments
    want = jsom.find_qerror(ref, Dataset(points=X), mode="fast")
    for codes, data in ((P(ref), PDataset(points=X)),
                        (torch.tensor(ref.points), torch.from_numpy(X))):
        got = som.find_qerror(codes, data, device="cpu")
        assert abs(got - want) <= 1e-4 * want, (got, want)


def test_dataset_fit_quality_matches_jax():
    X = _blobs(n=600)
    init = _init(X, 8, 6, Topology.HEXA, Neighborhood.GAUSSIAN)
    kw = dict(rlen=1536, alpha=0.05, radius=4.0)  # 2.5 laps of 600
    ref = JaxSOMTrainer(init, batch_size=B, use_pallas=True, vmem_steps=False,
                        seed=1).fit(Dataset(points=X), **kw)
    out = SOMTrainer(P(init), batch_size=B, seed=1, device="cpu",
                     vmem_steps=False).fit(PDataset(points=X), **kw)
    q_ref = _jax_q(ref, X)
    assert abs(_jax_q(out, X) - q_ref) < 0.05 * q_ref


def test_dataset_shuffle_depends_on_seed():
    """Each lap's order derives from (seed, lap): another seed, another
    order.  (The CPU generator keeps only the low 32 bits of its seed, and
    seed and lap once shared one 64-bit seed, so every seed shuffled alike.)"""
    X = _blobs(n=300)
    init = P(_init(X, 6, 4, Topology.HEXA, Neighborhood.GAUSSIAN))
    perms = [SOMTrainer(init, seed=s, device="cpu")._lap_perm(0, 300) for s in (1, 2)]
    assert not np.array_equal(*perms)
    assert np.array_equal(perms[0], SOMTrainer(init, seed=1, device="cpu")._lap_perm(0, 300))
    kw = dict(rlen=B * 4, alpha=0.05, radius=3.0)
    outs = [SOMTrainer(init, batch_size=B, seed=s, device="cpu", vmem_steps=False).fit(
        PDataset(points=X), **kw).points for s in (1, 2)]
    assert not np.array_equal(*outs)


def _drop_after(ckpt, step):
    assert step in ckpt.steps(), ckpt.steps()
    for s in ckpt.steps():
        if s > step:
            os.remove(os.path.join(ckpt.directory, f"step_{s}.npz"))


@pytest.mark.parametrize("form", ["dataset", "stream"])
def test_resume_from_own_checkpoint(form, tmp_path):
    X = _blobs()
    init = _init(X, 8, 6, Topology.HEXA, Neighborhood.GAUSSIAN)

    def data():
        return (PDataset(points=X[:600]) if form == "dataset"
                else _stream(X, 200, cls=PDataset))

    kw = dict(rlen=B * 8, alpha=0.05, radius=4.0)
    d = str(tmp_path / "ck")
    tk = dict(batch_size=B, seed=5, device="cpu", vmem_steps=False)
    full = SOMTrainer(P(init), checkpoint_dir=d, checkpoint_interval=3,
                      **tk).fit(data(), **kw)
    tr = SOMTrainer(P(init), checkpoint_dir=d, **tk)
    _drop_after(tr.ckpt, 3)
    resumed = tr.fit(data(), **kw)
    np.testing.assert_allclose(resumed.points, full.points, rtol=1e-6, atol=1e-6)


def test_interval_checkpoints_fire_on_elapsed_batches(tmp_path):
    X = _blobs()
    init = _init(X, 8, 6, Topology.HEXA, Neighborhood.GAUSSIAN)
    tr = SOMTrainer(P(init), batch_size=B, checkpoint_dir=str(tmp_path / "ck"),
                    checkpoint_interval=3, device="cpu", vmem_steps=False)
    tr.ckpt.keep = 0
    tr.fit(_stream(X, cls=PDataset), rlen=B * 8, alpha=0.05, radius=4.0)
    assert tr.ckpt.steps() == [3, 6, 8]
    st = tr.ckpt.load(3)
    assert st.codes.shape == init.points.shape and st.codes.dtype == np.float32
    assert st.extra == {"alpha": 0.05, "radius": 4.0}


def test_resume_from_jax_checkpoint(tmp_path):
    """A checkpoint the JAX trainer wrote resumes in the port's stream form
    (same Checkpointer files; the JAX prng_key is not needed there)."""
    X = _blobs()
    init = _init(X, 8, 6, Topology.HEXA, Neighborhood.GAUSSIAN)
    kw = dict(rlen=1024, alpha=0.05, radius=4.0)
    d = str(tmp_path / "ckj")
    full = JaxSOMTrainer(init, batch_size=B, checkpoint_dir=d, checkpoint_interval=2,
                         use_pallas=True, vmem_steps=False).fit(_stream(X), **kw)
    tr = SOMTrainer(P(init), batch_size=B, checkpoint_dir=d, device="cpu",
                    vmem_steps=False)
    _drop_after(tr.ckpt, 4)
    assert tr.ckpt.load().prng_key is not None
    resumed = tr.fit(_stream(X, cls=PDataset), **kw)
    np.testing.assert_allclose(resumed.points, full.points, rtol=2e-2, atol=2e-2)
    assert tr.ckpt.latest_step() == 8


def test_unported_inputs_raise_and_short_streams():
    """bf16 streaming now runs (a float32 codebook out, qerror within 0.5%
    of the float32-streamed run, the JAX gate); a batch that does not split
    over a mesh's data axis still raises; masked data (as a Dataset and
    inside a stream), weight= and fixed= tokens and the masked qerror run;
    short streams raise unless allowed."""
    X = _blobs(n=512)
    init = P(_init(X, 6, 4, Topology.HEXA, Neighborhood.BUBBLE))
    mask = np.zeros_like(X, dtype=np.uint8)
    mask[:, 1] = 1
    kw = dict(rlen=512, alpha=0.05, radius=3.0)
    with pytest.raises(ValueError, match="does not split"):
        SOMTrainer(init, batch_size=63, mesh=types.SimpleNamespace(
            shape={"data": 2, "model": 1}), device="cpu")
    q = {}
    for bf16 in (False, True):
        out = SOMTrainer(init, batch_size=B, stream_bf16=bf16, device="cpu").fit(
            _stream(X, cls=PDataset), **kw)
        assert out.points.dtype == np.float32 and np.isfinite(out.points).all()
        q[bf16] = _jax_q(out, X)
    assert abs(q[True] - q[False]) < 0.005 * q[False], q
    out = SOMTrainer(init, batch_size=B, device="cpu").fit(
        PDataset(points=X, mask=mask), **kw)
    # component 1 is masked in every sample: no unit's component 1 moves
    np.testing.assert_array_equal(out.points[:, 1], init.points[:, 1])

    def masked_stream():
        yield PDataset(points=X[:256])
        yield PDataset(points=X[256:], mask=mask[256:])

    out = SOMTrainer(init, batch_size=B, device="cpu").fit(masked_stream(), **kw)
    assert np.isfinite(out.points).all()
    assert not np.array_equal(out.points[:, 1], init.points[:, 1])
    weight = np.full((512,), 2.0, np.float32)
    fixed = np.full((512, 2), -1, np.int32)
    fixed[::5] = (3, 2)
    for flag in ("use_weights", "use_fixed"):
        out = SOMTrainer(init, batch_size=B, device="cpu").fit(
            PDataset(points=X, weight=weight, fixed=fixed), **kw, **{flag: True})
        assert np.isfinite(out.points).all()
    q = som.find_qerror(init, PDataset(points=X, mask=mask), device="cpu")
    assert np.isfinite(q) and q > 0
    with pytest.raises(RuntimeError, match="stream exhausted"):
        SOMTrainer(init, batch_size=B, device="cpu").fit(
            _stream(X, cls=PDataset), rlen=4096, alpha=0.05, radius=3.0)
    out = SOMTrainer(init, batch_size=B, device="cpu").fit(
        _stream(X, cls=PDataset), rlen=4096, alpha=0.05, radius=3.0,
        allow_short_stream=True)
    assert np.isfinite(out.points).all()
