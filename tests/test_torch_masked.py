"""The port's masked, weighted and fixed-point paths against the JAX package:
the masked winner search (K4's plain version), the two-kernel step's
neighbourhood update (K5/K6's plain version), `som_batch_step`,
SOMTrainer.fit with masks, `weight=` and `fixed=` tokens, and the masked
fast qerror.  The JAX side runs its Pallas kernels in interpret mode.

Tolerances: winners equal except at near-ties, where the two candidates'
float64 distances over the kept components differ by less than 1e-5
relative (the packages sum in different orders, so float32 rounding may
flip such a tie); values and codebooks of one step allclose at 1e-5
(float32 sums of at most a few hundred terms); trained codebooks at 2e-2
and quality at 5% where batches shuffle differently, as in
tests/test_torch_trainer.py."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.data import read_data
from som_lvq_pak_tpu.data.dataset import Dataset, Neighborhood, Topology
from som_lvq_pak_tpu.data.labels import GLOBAL_LABELS as JAX_LABELS
from som_lvq_pak_tpu.models import fast as jfast
from som_lvq_pak_tpu.models import som as jsom
from som_lvq_pak_tpu.models.trainer import SOMTrainer as JaxSOMTrainer
from som_lvq_pak_tpu.ops import pallas_distance as jpd
from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_tpu.utils.rng import CRandom
from som_lvq_pak_torch.convert import as_port_dataset
from som_lvq_pak_torch.data.dataset import Dataset as PDataset
from som_lvq_pak_torch.models import fast, som
from som_lvq_pak_torch.models.trainer import SOMTrainer
from som_lvq_pak_torch.ops.dist_argmin import dist_argmin
from som_lvq_pak_torch.ops.distance import find_winners
from som_lvq_pak_torch.ops.som_update import som_neighborhood_update_idx

TOL = 1e-5
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
T = torch.from_numpy


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


def _mask(rng, shape, p=0.2, full_every=7):
    """Components masked with probability p, and every full_every-th row
    masked entirely."""
    m = (rng.random(shape) < p).astype(np.uint8)
    m[::full_every] = 1
    return m


def assert_masked_winners_agree(x, codes, mask, i_port, i_ref):
    i_port = np.asarray(i_port, np.int64)
    i_ref = np.asarray(i_ref, np.int64)
    bad = np.nonzero(i_port != i_ref)[0]
    if bad.size:
        keep = (mask[bad] == 0).astype(np.float64)
        x64 = np.asarray(x, np.float64)[bad]
        c64 = np.asarray(codes, np.float64)
        da = (((x64 - c64[i_port[bad]]) ** 2) * keep).sum(-1)
        db = (((x64 - c64[i_ref[bad]]) ** 2) * keep).sum(-1)
        gap = np.abs(da - db) / np.maximum(np.maximum(da, db), 1e-30)
        assert gap.max() < TOL, (bad, gap)


@pytest.mark.parametrize("B,N,D,dup", [(37, 53, 5, False), (200, 130, 64, False),
                                       (70, 99, 5, True), (129, 300, 64, True)])
def test_masked_dist_argmin_matches_jax(B, N, D, dup):
    rng = np.random.default_rng(B + N)
    x = rng.normal(size=(B, D)).astype(np.float32)
    if dup:  # every row three times: the lowest index must win
        base = rng.normal(size=(N // 3, D)).astype(np.float32)
        codes = np.concatenate([base, base, base])
    else:
        codes = rng.normal(size=(N, D)).astype(np.float32)
    mask = _mask(rng, (B, D))
    v, i = dist_argmin(T(x), T(codes), mask=T(mask))
    jv, ji = jpd.dist_argmin(jnp.asarray(x), jnp.asarray(codes),
                             mask=jnp.asarray(mask))
    assert i.dtype == torch.int32 and v.dtype == torch.float32
    assert_masked_winners_agree(x, codes, mask, i.numpy(), ji)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)
    full = mask.all(axis=1)
    assert full.any()
    assert (i.numpy()[full] == 0).all() and (v.numpy()[full] == 0).all()
    if dup:
        assert int(i.max()) < N // 3
    # and the plain expanded-form reference of ops.distance
    wi, wv = find_winners(T(x), T(codes), T(mask))
    assert_masked_winners_agree(x, codes, mask, i.numpy(), wi.numpy())
    np.testing.assert_allclose(v.numpy(), wv.numpy(), rtol=TOL, atol=TOL)


def _update_inputs(xdim, ydim, D, B, seed, masked):
    rng = np.random.default_rng(seed)
    noc = xdim * ydim
    codes = rng.normal(size=(noc, D)).astype(np.float32)
    xb = rng.normal(size=(B, D)).astype(np.float32)
    bmu = rng.integers(0, noc, size=B).astype(np.int32)
    bmu[:3] = -1  # samples without a BMU teach nothing
    alpha = rng.uniform(0.0, 0.1, size=B).astype(np.float32)
    mask = _mask(rng, (B, D)) if masked else None
    return codes, xb, bmu, alpha, mask


@pytest.mark.parametrize("tiles", [None, (16, 32)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("xdim,ydim,hexa,gaussian,radius", [
    (9, 7, True, True, 2.5),     # ragged: 63 rows
    (10, 8, True, False, 3.0),   # hexa bubble: exact-boundary pairs at r=3
    (12, 8, False, False, 3.0),
    (8, 6, False, True, 3.0),
])
def test_update_matches_jax(xdim, ydim, hexa, gaussian, radius, masked, tiles):
    """tiles (16, 32) makes the JAX kernel accumulate over several batch
    tiles and code tiles."""
    D, B = 5, 48
    codes, xb, bmu, alpha, mask = _update_inputs(xdim, ydim, D, B,
                                                 seed=xdim * ydim, masked=masked)
    c = T(codes.copy())
    out = som_neighborhood_update_idx(c, T(xb), T(bmu), xdim, hexa, T(alpha),
                                      radius, gaussian,
                                      mask=None if mask is None else T(mask))
    assert out.data_ptr() == c.data_ptr()  # updated in place
    kw = {} if tiles is None else dict(tile_b=tiles[0], tile_n=tiles[1])
    ref = jps.som_neighborhood_update_idx(
        jnp.asarray(codes), jnp.asarray(xb), jnp.asarray(bmu), xdim, hexa,
        jnp.asarray(alpha), radius, gaussian=gaussian,
        mask=None if mask is None else jnp.asarray(mask), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    if masked:  # a component masked in every sample stays exactly as it was
        mask[:, 2] = 1
        c = T(codes.copy())
        som_neighborhood_update_idx(c, T(xb), T(bmu), xdim, hexa, T(alpha),
                                    radius, gaussian, mask=T(mask))
        np.testing.assert_array_equal(c.numpy()[:, 2], codes[:, 2])


@pytest.mark.parametrize("masked", [False, True])
def test_update_exact_bubble_boundary(masked):
    """dx = 1.5, dy = 3 sqrt(0.75), r = 3: d2 = r^2 exactly, so the unit is
    inside the bubble (the exact-f32 grid algebra decides it)."""
    xdim, ydim, D = 8, 6, 3
    codes = np.zeros((xdim * ydim, D), np.float32)
    xb = np.ones((1, D), np.float32)
    bmu = np.array([2], np.int32)               # column 2, row 0
    mask = np.array([[0, 1, 0]], np.uint8) if masked else None
    c = T(codes.copy())
    som_neighborhood_update_idx(c, T(xb), T(bmu), xdim, True, 0.5, 3.0, False,
                                mask=None if mask is None else T(mask))
    inside = 3 * xdim + 3                        # row 3 (odd): x = 3.5
    want = np.full(D, 0.5, np.float32)
    if masked:
        want[1] = 0.0
    np.testing.assert_array_equal(c.numpy()[inside], want)
    ref = jps.som_neighborhood_update_idx(
        jnp.asarray(codes), jnp.asarray(xb), jnp.asarray(bmu), xdim, True,
        0.5, 3.0, gaussian=False, mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_array_equal(c.numpy(), np.asarray(ref))


@pytest.mark.parametrize("extras", ["none", "mask+weights+fixed"])
def test_som_batch_step_matches_jax(extras):
    """The golden masked/weighted fixture (6x5 hexa gaussian), with a few
    fixed= samples added."""
    data = read_data(os.path.join(GOLDEN, "wmask.dat"))
    codes = read_data(os.path.join(GOLDEN, "wmask_r.cod"))
    X = data.points
    kw, jkw = {}, {}
    if extras != "none":
        fixed = np.full((data.n,), -1, np.int32)
        fixed[[1, 17, 40]] = [0, 29, 12]
        mk, wt = data.mask, data.weight
        assert mk is not None and wt is not None and (wt != 0).any()
        kw = dict(mask=T(mk), weights=T(wt), fixed_bmu=T(fixed))
        jkw = dict(mask=jnp.asarray(mk), weights=jnp.asarray(wt),
                   fixed_bmu=jnp.asarray(fixed))
    c = T(codes.points.copy())
    out = fast.som_batch_step(c, T(X), 6, True, 0.05, 2.0, True, **kw)
    assert out.data_ptr() == c.data_ptr()
    ref = jfast.som_batch_step(
        jnp.asarray(codes.points), jnp.asarray(X), jfast.unit_coords(6, 5, True),
        0.05, 2.0, gaussian=True, use_pallas=True, xdim=6, hexa=True, **jkw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def _blobs(n=1024, dim=8, seed=3):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 4.0, size=(4, dim)).astype(np.float32)
    return (centres[rng.integers(0, 4, size=n)]
            + rng.normal(0, 1.0, size=(n, dim)).astype(np.float32))


def _masked_stream(X, mask, masked_chunks, chunk=128, cls=Dataset):
    """Chunks as the JAX package's Datasets, or the port's (cls=PDataset)."""
    for k, lo in enumerate(range(0, X.shape[0], chunk)):
        sl = slice(lo, lo + chunk)
        yield cls(points=np.where(mask[sl] != 0, 0.0, X[sl]),
                  mask=mask[sl] if k in masked_chunks else None)


def _stream_case():
    X = _blobs()
    rng = np.random.default_rng(4)
    mask = (rng.random(X.shape) < 0.1).astype(np.uint8)
    mask[:, 2] = 1          # component 2 masked everywhere it is masked
    mask[::97] = 1          # and a few rows with nothing left
    init = jsom.randinit(Dataset(points=X), Topology.HEXA, Neighborhood.GAUSSIAN,
                         6, 6, CRandom(9))
    return X, mask, init


def test_stream_fit_masked_chunks_match_jax():
    """Masked chunks inside a clean stream (mirrors
    tests/test_trainer.py:333-357): chunk 2 masked, chunks 5 and 6 masked,
    the rest clean, so the fused step, the two-kernel step and the winner
    re-seed all run in both packages on the same batches."""
    X, mask, init = _stream_case()
    kw = dict(rlen=1024, alpha=0.05, radius=3.0)
    chunks = {1, 4, 5}
    ref = JaxSOMTrainer(init, batch_size=128, use_pallas=True, vmem_steps=False
                        ).fit(_masked_stream(X, mask, chunks), **kw)
    out = SOMTrainer(P(init), batch_size=128, device="cpu", vmem_steps=False).fit(
        _masked_stream(X, mask, chunks, cls=PDataset), **kw)
    np.testing.assert_allclose(out.points, ref.points, rtol=2e-2, atol=2e-2)


def test_resume_masked_run_from_jax_checkpoint(tmp_path):
    """A checkpoint the JAX trainer wrote during a masked stream run resumes
    in the port (the masked chunks before and after the resume point both
    train)."""
    X, mask, init = _stream_case()
    kw = dict(rlen=1024, alpha=0.05, radius=3.0)
    chunks = {1, 5}
    d = str(tmp_path / "ckj")
    full = JaxSOMTrainer(init, batch_size=128, checkpoint_dir=d,
                         checkpoint_interval=2, use_pallas=True,
                         vmem_steps=False).fit(_masked_stream(X, mask, chunks), **kw)
    tr = SOMTrainer(P(init), batch_size=128, checkpoint_dir=d, device="cpu",
                    vmem_steps=False)
    for s in tr.ckpt.steps():
        if s > 4:
            os.remove(os.path.join(tr.ckpt.directory, f"step_{s}.npz"))
    assert tr.ckpt.latest_step() == 4
    resumed = tr.fit(_masked_stream(X, mask, chunks, cls=PDataset), **kw)
    np.testing.assert_allclose(resumed.points, full.points, rtol=2e-2, atol=2e-2)
    assert tr.ckpt.latest_step() == 8


def _q(codes, data):
    """The JAX package's per-sample fast qerror of either package's codebook."""
    jcodes = Dataset(points=codes.points, topol=Topology(int(codes.topol)),
                     neigh=Neighborhood(int(codes.neigh)), xdim=codes.xdim,
                     ydim=codes.ydim)
    return jsom.find_qerror(jcodes, data, mode="fast") / data.n


def test_dataset_fit_masked_weighted_quality_matches_jax():
    """The golden masked/weighted fixture as a Dataset with use_weights:
    every batch takes the two-kernel step in both packages; the shuffles
    differ (jax.random vs torch.Generator), so quality is compared."""
    data = read_data(os.path.join(GOLDEN, "wmask.dat"))
    codes = read_data(os.path.join(GOLDEN, "wmask_r.cod"))
    kw = dict(rlen=600, alpha=0.05, radius=4.0, use_weights=True)
    ref = JaxSOMTrainer(codes, batch_size=16, use_pallas=True, vmem_steps=False,
                        seed=3).fit(data, **kw)
    out = SOMTrainer(P(codes), batch_size=16, seed=3, device="cpu",
                     vmem_steps=False).fit(P(data), **kw)
    assert np.isfinite(out.points).all()
    q_ref = _q(ref, data)
    assert abs(_q(out, data) - q_ref) < 0.05 * q_ref


def test_dataset_fit_fixed_quality_matches_jax():
    """The golden fixed-point fixture (4x3 rect bubble) with use_fixed: the
    fused step with fixed= winners in both packages, compared on quality."""
    data = read_data(os.path.join(GOLDEN, "fix.dat"))
    codes = read_data(os.path.join(GOLDEN, "fix_r.cod"))
    assert data.fixed is not None and (data.fixed >= 0).any()
    kw = dict(rlen=800, alpha=0.1, radius=2.0, use_fixed=True)
    ref = JaxSOMTrainer(codes, batch_size=16, use_pallas=True, vmem_steps=False,
                        seed=2).fit(data, **kw)
    out = SOMTrainer(P(codes), batch_size=16, seed=2, device="cpu",
                     vmem_steps=False).fit(P(data), **kw)
    q_ref = _q(ref, data)
    assert abs(_q(out, data) - q_ref) < 0.05 * q_ref


def test_masked_find_qerror_matches_jax():
    X, mask, init = _stream_case()
    X = np.where(mask != 0, 0.0, X).astype(np.float32)
    data = Dataset(points=X, mask=mask)
    want = jsom.find_qerror(init, data, mode="fast")
    for got in (som.find_qerror(P(init), P(data), device="cpu"),
                som.find_qerror(T(init.points.copy()), T(X), mask=T(mask))):
        assert abs(got - want) <= 1e-4 * want, (got, want)
    with pytest.raises(ValueError, match="mask"):
        som.find_qerror(P(init), P(data), mask=T(mask), device="cpu")
