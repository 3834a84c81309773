"""The port's separable fused SOM step (K13's and K14's plain versions, which
the CPU runs), its bf16 codebook, the trainer's kernel choice, `bf16=` and
`stream_bf16=`, and the streamed fast qerror, against the JAX package (its
Pallas kernels in interpret mode).

Tolerances: codebooks within 1e-5 and values within 1e-4 (float32 sums of a
few hundred terms in another order), winners equal except at near-ties
(`assert_winners_agree`: the two candidates' float64 distances within 1e-5
relative).  A bf16 codebook is held to one bf16 ulp (2^-7 relative) plus
1e-5 per entry, where the two packages' float32 blends round to different
sides.
Trained codebooks agree to 2e-2 and quality to 2%, as in
test_torch_trainer.py: near-tie winner flips compound over batches."""

import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.data.dataset import Dataset, Neighborhood, Topology
from som_lvq_pak_tpu.data.labels import GLOBAL_LABELS as JAX_LABELS
from som_lvq_pak_tpu.data.streaming import StreamingReader as JStreamingReader
from som_lvq_pak_tpu.models import som as jsom
from som_lvq_pak_tpu.models.trainer import SOMTrainer as JaxSOMTrainer
from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_tpu.utils.rng import CRandom
from som_lvq_pak_torch.convert import as_port_dataset
from som_lvq_pak_torch.data.dataset import Dataset as PDataset
from som_lvq_pak_torch.data.labels import LabelTable
from som_lvq_pak_torch.data.streaming import StreamingReader
from som_lvq_pak_torch.models import som
from som_lvq_pak_torch.models.trainer import SOMTrainer, fused_step_choice
from som_lvq_pak_torch.ops import som_step
from som_lvq_pak_torch.ops.som_step import (factored_geometry_ok,
                                            som_fused_factored_chunked_step,
                                            som_fused_factored_step,
                                            som_fused_train_step)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run torch on one CPU thread in this module: the first vectorized
    transcendental torch spreads over several OpenMP threads came back up
    to 1.5e-4 relative off in one thread's share in about 0.5% of processes
    (ROADMAP Queue C), and the gaussian step makes such a call."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad128(a):
    """Lane-pad features to 128 for the JAX kernels only."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(np.pad(a, ((0, 0), (0, -a.shape[1] % 128))))


def _bf16_64(a):
    """`a` rounded to bf16 (nearest even), as float64."""
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16).double().numpy()


def _dists(x, codes, bf16_score=False):
    """(B', noc) float64 distances the fused steps' winners rank by: ||x -
    m||^2, or under batch_bf16 ||x'||^2 - 2 x'.m' + ||m||^2 with x' and m'
    rounded to bf16 and the norm from the float32 rows."""
    c64 = np.asarray(codes, np.float64)
    xr = _bf16_64(x) if bf16_score else np.asarray(x, np.float64)
    cr = _bf16_64(codes) if bf16_score else c64
    return ((xr * xr).sum(1)[:, None] - 2.0 * xr @ cr.T
            + (c64 * c64).sum(1)[None, :])


def assert_winners_agree(x, codes, i_port, i_ref, tol=TOL, bf16_score=False):
    i_port = np.asarray(i_port, np.int64)
    i_ref = np.asarray(i_ref, np.int64)
    bad = np.nonzero(i_port != i_ref)[0]
    if bad.size:
        d = _dists(np.asarray(x)[bad], codes, bf16_score)
        rows = np.arange(bad.size)
        da, db = d[rows, i_port[bad]], d[rows, i_ref[bad]]
        gap = np.abs(da - db) / np.maximum(np.maximum(da, db), 1e-30)
        assert gap.max() < tol, (bad, gap)
    return bad.size


def assert_own_scoring(x, codes, idx, val, bf16_score=False):
    """A step's winners and values against the float64 scoring of its own
    updated rows `codes`: winners equal except near-ties (TOL), values
    (||m||^2 - 2 x.m, the distance without ||x||^2) within 1e-4."""
    d = _dists(x, codes, bf16_score)
    assert_winners_agree(x, codes, idx, d.argmin(1), bf16_score=bf16_score)
    xr = _bf16_64(x) if bf16_score else np.asarray(x, np.float64)
    want = d[np.arange(d.shape[0]), np.asarray(idx, np.int64)] - (xr * xr).sum(1)
    np.testing.assert_allclose(val, want, rtol=1e-4, atol=1e-4)


def _inputs(noc, D, B, Bn, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return (f(noc, D), f(B, D), rng.integers(0, noc, size=B).astype(np.int32),
            f(Bn, D), rng.uniform(0.0, 0.1, size=B).astype(np.float32))


def _port(codes, xb, bmu, xn, xdim, hexa, alpha, radius, gaussian, **kw):
    c = torch.from_numpy(codes.copy())
    out, i, v = som_fused_train_step(
        c, torch.from_numpy(xb), torch.from_numpy(bmu), torch.from_numpy(xn),
        xdim, hexa, torch.from_numpy(alpha), radius, gaussian, **kw)
    assert out.data_ptr() == c.data_ptr()  # updated in place
    return out.numpy(), i.numpy(), v.numpy()


def _jax(codes, xb, bmu, xn, xdim, hexa, alpha, radius, gaussian, **kw):
    jc, ji, jv = jps.som_fused_train_step(
        _pad128(codes), _pad128(xb), jnp.asarray(bmu), _pad128(xn), xdim, hexa,
        jnp.asarray(alpha), radius, gaussian=gaussian, **kw)
    return np.asarray(jc)[:, :codes.shape[1]], np.asarray(ji), np.asarray(jv)


# (xdim, ydim, hexa, tile_n): hexa one grid row per tile (both parities in
# the TPU scratch), two rows per tile, and a rect map of three rows per tile
GEOMETRIES = [(16, 8, True, 16), (16, 8, True, 32), (16, 12, False, 48)]


@pytest.mark.parametrize("gaussian", [True, False])
@pytest.mark.parametrize("xdim,ydim,hexa,tile_n", GEOMETRIES)
def test_factored_step_matches_jax(xdim, ydim, hexa, tile_n, gaussian):
    """Plain K13 (taken by factored=True) against `_som_fused_factored_kernel`."""
    assert factored_geometry_ok(xdim * ydim, xdim, tile_n, hexa)
    args = _inputs(xdim * ydim, 64, 64, 64, seed=tile_n + gaussian)
    codes, xb, bmu, xn, alpha = args
    kw = dict(tile_n=tile_n, factored=True)
    c, i, v = _port(codes, xb, bmu, xn, xdim, hexa, alpha, 3.0, gaussian, **kw)
    jc, ji, jv = _jax(codes, xb, bmu, xn, xdim, hexa, alpha, 3.0, gaussian, **kw)
    np.testing.assert_allclose(c, jc, rtol=TOL, atol=TOL)
    assert_winners_agree(xn, c, i, ji)
    np.testing.assert_allclose(v, jv, rtol=1e-4, atol=1e-4)
    assert_own_scoring(xn, c, i, v)
    # factored=None takes the same kernel where the geometry allows it
    c2, i2, v2 = _port(codes, xb, bmu, xn, xdim, hexa, alpha, 3.0, gaussian,
                       tile_n=tile_n)
    np.testing.assert_array_equal(c2, c)
    np.testing.assert_array_equal(i2, i)


def test_factored_step_exact_bubble_boundary():
    """dx = 1.5, dy = 3 sqrt(0.75), r = 3: d2 = r^2 exactly, so the unit is
    inside the bubble through the separable algebra too (dx^2 + dy^2 with
    dy^2 = 9 * 0.75)."""
    xdim, ydim, D = 8, 6, 3
    codes = np.zeros((xdim * ydim, D), np.float32)
    xb = np.ones((1, D), np.float32)
    bmu = np.array([2], np.int32)                # column 2, row 0
    alpha = np.array([0.5], np.float32)
    assert factored_geometry_ok(xdim * ydim, xdim, 48, True)
    c, _, _ = _port(codes, xb, bmu, xb, xdim, True, alpha, 3.0, False)
    inside = 3 * xdim + 3                        # row 3 (odd): x = 3.5
    np.testing.assert_array_equal(c[inside], np.full(D, 0.5, np.float32))
    jc, _, _ = _jax(codes, xb, bmu, xb, xdim, True, alpha, 3.0, False,
                    factored=True)
    np.testing.assert_array_equal(c, jc)


FLAGS = [dict(), dict(wxa_bf16=True), dict(batch_bf16=True),
         dict(wxa_bf16=True, batch_bf16=True)]


@pytest.mark.parametrize("gaussian", [True, False])
@pytest.mark.parametrize("flags", FLAGS, ids=["f32", "wxa_bf16", "batch_bf16",
                                              "both"])
def test_chunked_step_matches_jax(flags, gaussian):
    """Plain K14 against `_som_fused_factored_chunked_kernel` with
    batch_chunk=128 under the same flags (a bubble map keeps an f32
    x-pattern in both).  Each bf16 option moves the result off the float32
    step by far more than the tolerance, so the roundings are the ones
    compared.  Under batch_bf16 the winners score the updated rows rounded
    to bf16, and so does the check (`_dists`): winners agree to 1e-5.  Where
    the two packages' float32 rows (equal to 1e-5) round to different bf16
    neighbours, a value moves by the sample's component times one bf16 ulp
    of the entry, so values agree to 5e-3; each package's winners and values
    against the scoring of its own rows to 1e-4."""
    xdim, ydim, hexa = 16, 8, True
    codes, xb, bmu, xn, alpha = _inputs(xdim * ydim, 64, 256, 256, seed=7)
    kw = dict(tile_n=32, batch_chunk=128, **flags)
    c, i, v = _port(codes, xb, bmu, xn, xdim, hexa, alpha, 3.0, gaussian, **kw)
    jc, ji, jv = _jax(codes, xb, bmu, xn, xdim, hexa, alpha, 3.0, gaussian, **kw)
    np.testing.assert_allclose(c, jc, rtol=TOL, atol=TOL)
    bb = bool(flags.get("batch_bf16"))
    assert_winners_agree(xn, c, i, ji, bf16_score=bb)
    np.testing.assert_allclose(v, jv, rtol=0.0 if bb else 1e-4,
                               atol=5e-3 if bb else 1e-4)
    assert_own_scoring(xn, c, i, v, bb)
    assert_own_scoring(xn, jc, ji, jv, bb)
    f32, _, v32 = _port(codes, xb, bmu, xn, xdim, hexa, alpha, 3.0, gaussian,
                        tile_n=32, factored=True)
    moved = max(np.abs(c - f32).max(), np.abs(v - v32).max())
    if flags.get("batch_bf16") or (flags.get("wxa_bf16") and gaussian):
        assert moved > 1e-3, moved
    else:
        assert moved < 1e-5, moved


def _bf16_ulp_close(got, want):
    """bf16 codebooks from float32 blends equal to TOL: each entry within
    one bf16 ulp (<= 2^-7 relative) plus TOL (near 0 the float32 difference
    itself shows), at most 1% of the entries differing."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    assert (diff <= 2.0 ** -7 * np.abs(want) + TOL).all(), diff.max()
    assert (diff > 0).mean() <= 0.01, (diff > 0).mean()


@pytest.mark.parametrize("kernel", ["plain", "factored"])
def test_bf16_codebook_step_matches_jax(kernel):
    """A bf16 codebook through K3's and K13's plain versions against the JAX
    kernels given bf16 `codes`: rows read upcast, blended in float32, stored
    rounded; the winners taken against the float32 blended rows."""
    xdim, ydim = 16, 8
    codes, xb, bmu, xn, alpha = _inputs(xdim * ydim, 64, 64, 64, seed=11)
    codes = codes.astype(jnp.bfloat16).astype(np.float32)  # exact in bf16
    kw = dict(tile_n=32, factored=kernel == "factored")
    c = torch.from_numpy(codes).to(torch.bfloat16)
    out, i, v = som_fused_train_step(
        c, torch.from_numpy(xb), torch.from_numpy(bmu), torch.from_numpy(xn),
        xdim, True, torch.from_numpy(alpha), 3.0, True, **kw)
    assert out.dtype == torch.bfloat16 and out.data_ptr() == c.data_ptr()
    jc, ji, jv = jps.som_fused_train_step(
        _pad128(codes).astype(jnp.bfloat16), _pad128(xb), jnp.asarray(bmu),
        _pad128(xn), xdim, True, jnp.asarray(alpha), 3.0, gaussian=True, **kw)
    assert jc.dtype == jnp.bfloat16
    got = out.to(torch.float32).numpy()
    _bf16_ulp_close(got, np.asarray(jc.astype(jnp.float32))[:, :64])
    assert_winners_agree(xn, got, i.numpy(), np.asarray(ji), tol=1e-2)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)


def test_routing_follows_the_jax_wrapper():
    """factored=None needs the geometry and no unit_offset; factored with a
    unit_offset raises, as does a bad geometry or batch chunk; any chunk or
    bf16 option takes the batch-chunked kernel."""
    codes, xb, bmu, xn, alpha = _inputs(128, 8, 128, 128, seed=3)
    T = torch.from_numpy
    args = (T(xb), T(bmu), T(xn), 16, True, T(alpha), 3.0, True)
    step = lambda **kw: som_fused_train_step(T(codes.copy()), *args, **kw)  # noqa: E731
    auto = step()[0]
    np.testing.assert_array_equal(
        auto, som_fused_factored_step(T(codes.copy()), *args)[0])
    k3 = step(unit_offset=0)[0]  # a shard at offset 0 stays on K3
    np.testing.assert_array_equal(k3, step(factored=False)[0])
    assert not torch.equal(auto, k3)  # another kernel, another rounding
    np.testing.assert_allclose(auto, k3, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(
        step(batch_chunk=128)[0],
        som_fused_factored_chunked_step(T(codes.copy()), *args, 128)[0])
    with pytest.raises(ValueError, match="unit_offset"):
        step(factored=True, unit_offset=0)
    with pytest.raises(ValueError, match="separable path"):
        step(factored=True, tile_n=24)
    with pytest.raises(ValueError, match="batch_chunk"):
        step(batch_chunk=64)
    # a geometry the separable kernels reject takes K3 under factored=None
    c6, xb6, bmu6, xn6, a6 = _inputs(60, 8, 16, 16, seed=4)
    out = som_fused_train_step(T(c6.copy()), T(xb6), T(bmu6), T(xn6), 10, True,
                               T(a6), 3.0, True)[0]
    want = som_step.som_fused_train_step_plain(T(c6.copy()), T(xb6), T(bmu6),
                                               T(xn6), 10, True, T(a6), 3.0, True)[0]
    np.testing.assert_array_equal(out, want)


def _jax_choice(noc, xdim, hexa, gaussian, B, dim):
    """The JAX trainer's fused-step choice (trainer.py:545-583), from the JAX
    package's own sizing functions."""
    dp = -(-dim // 128) * 128
    tn_fact = jps.pick_fused_tile_n(noc, B, dp, xdim=xdim, factored=True)
    factored = jps._factored_geometry_ok(noc, xdim, tn_fact, hexa)
    tile_n = tn_fact if factored else jps.pick_fused_tile_n(noc, B, dp)
    batch_chunk, chunk_bf16 = None, {}
    if factored and B >= 4096 and B % 1024 == 0:
        tn_big = jps.pick_fused_tile_n(noc, 1024, dp, xdim=xdim, factored=True)
        if jps._factored_geometry_ok(noc, xdim, tn_big, hexa):
            for wxa_b, bat_b in ((gaussian, False), (gaussian, True)):
                if jps.chunked_step_vmem_bytes(tn_big, B, 1024, dp, xdim, hexa,
                                               wxa_bf16=wxa_b,
                                               batch_bf16=bat_b) <= (14 << 20):
                    tile_n, batch_chunk = tn_big, 1024
                    chunk_bf16 = dict(wxa_bf16=wxa_b, batch_bf16=bat_b)
                    break
    return (factored, tile_n, batch_chunk, chunk_bf16.get("wxa_bf16", False),
            chunk_bf16.get("batch_bf16", False))


MAP_CASES = [(128, 128, True, True), (256, 256, True, True), (64, 64, True, False),
             (64, 64, True, True), (64, 64, False, True), (32, 32, True, True),
             (64, 32, True, True), (16, 8, True, True), (16, 8, True, False),
             (8, 6, True, True), (10, 8, False, True), (12, 8, False, False),
             (48, 48, True, True), (24, 16, False, True)]


@pytest.mark.parametrize("dim", [64, 8, 200])
@pytest.mark.parametrize("xdim,ydim,hexa,gaussian", MAP_CASES)
def test_fused_step_choice_equals_jax(xdim, ydim, hexa, gaussian, dim):
    for B in (128, 512, 1024, 2048, 3072, 4096, 5000, 8192, 16384):
        got = fused_step_choice(xdim * ydim, xdim, hexa, gaussian, B, dim)
        assert got == _jax_choice(xdim * ydim, xdim, hexa, gaussian, B, dim), B


@pytest.mark.parametrize("xdim,ydim,hexa,gaussian,B,want", [
    (128, 128, True, True, 1024, (True, 512, None, False, False)),
    (256, 256, True, True, 1024, (True, 512, None, False, False)),
    (256, 256, True, True, 512, (True, 1024, None, False, False)),
    (128, 128, True, True, 2048, (True, 256, None, False, False)),
    (64, 64, True, False, 4096, (True, 64, None, False, False)),
    (64, 64, True, True, 4096, (True, 512, 1024, True, True)),
    (64, 64, False, True, 4096, (True, 512, 1024, True, True)),
    (32, 32, True, True, 4096, (True, 512, 1024, True, True)),
    (64, 32, True, True, 4096, (True, 512, 1024, True, True)),
    (256, 256, True, True, 4096, (False, 128, None, False, False)),
    (128, 128, True, True, 8192, (False, 32, None, False, False)),
    (64, 64, True, True, 8192, (False, 32, None, False, False)),
    (256, 256, True, True, 8192, (False, 32, None, False, False)),
    (64, 64, True, True, 512, (True, 1024, None, False, False)),
])
def test_fused_step_choice_table(xdim, ydim, hexa, gaussian, B, want):
    """The kernel each configuration of the port's cells takes (D 64)."""
    assert fused_step_choice(xdim * ydim, xdim, hexa, gaussian, B, 64) == want


def _blobs(n, dim=8, seed=3):
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 4.0, size=(4, dim)).astype(np.float32)
    return (centres[rng.integers(0, 4, size=n)]
            + rng.normal(0, 1.0, size=(n, dim)).astype(np.float32))


def _stream(X, chunk, cls):
    for lo in range(0, X.shape[0], chunk):
        yield cls(points=X[lo:lo + chunk])


def _jax_q(codes, X):
    jcodes = Dataset(points=codes.points, topol=Topology(int(codes.topol)),
                     neigh=Neighborhood(int(codes.neigh)), xdim=codes.xdim,
                     ydim=codes.ydim)
    return jsom.find_qerror(jcodes, Dataset(points=X), mode="fast") / X.shape[0]


@pytest.mark.parametrize("case", ["factored", "chunked", "bf16", "stream_bf16"])
def test_trainer_matches_jax(case):
    """SOMTrainer.fit on one chunk stream in both packages, on a 16x8 hexa
    gaussian map: B 128 takes the separable kernel; B 4096 (three steps) the
    batch-chunked one with a bf16 x-pattern; bf16=True the separable kernel
    on a bf16 codebook; stream_bf16=True bf16 batches.  Both return float32
    codebooks."""
    xdim, ydim = 16, 8
    bs, n = (4096, 3 * 4096) if case == "chunked" else (128, 1024)
    want = {"chunked": (True, 128, 1024, True, False)}.get(
        case, (True, 128, None, False, False))
    assert fused_step_choice(xdim * ydim, xdim, True, True, bs, 8) == want
    assert _jax_choice(xdim * ydim, xdim, True, True, bs, 8) == want
    X = _blobs(n)
    init = jsom.randinit(Dataset(points=X), Topology.HEXA, Neighborhood.GAUSSIAN,
                         xdim, ydim, CRandom(123))
    kw = dict(bf16=case == "bf16", stream_bf16=case == "stream_bf16")
    fit = dict(rlen=n, alpha=0.05, radius=4.0)
    ref = JaxSOMTrainer(init, batch_size=bs, use_pallas=True, vmem_steps=False,
                        **kw).fit(_stream(X, 512, Dataset), **fit)
    out = SOMTrainer(as_port_dataset(init, source_labels=JAX_LABELS),
                     batch_size=bs, device="cpu", vmem_steps=False, **kw).fit(
        _stream(X, 512, PDataset), **fit)
    assert out.points.dtype == np.float32 and ref.points.dtype == np.float32
    tol = 5e-2 if case == "bf16" else 2e-2  # bf16 ulp at |m| ~ 8: 3e-2
    np.testing.assert_allclose(out.points, ref.points, rtol=tol, atol=tol)
    q_ref = _jax_q(ref, X)
    assert abs(_jax_q(out, X) - q_ref) < 0.02 * q_ref
    assert q_ref < 0.8 * _jax_q(init, X)


def test_trainer_bf16_quality_and_paths():
    """bf16=True against the float32 run on a Dataset (the JAX gate: qerror
    under 1.1x), with a masked stream batch (its two-kernel step on a
    float32 copy) and interval checkpoints written as float32; on a masked
    Dataset it trains in float32, exactly as bf16=False."""
    X = _blobs(1024)
    init = as_port_dataset(jsom.randinit(
        Dataset(points=X), Topology.HEXA, Neighborhood.GAUSSIAN, 8, 8,
        CRandom(7)), source_labels=JAX_LABELS)
    fit = dict(rlen=2048, alpha=0.05, radius=4.0)
    tk = dict(batch_size=128, seed=5, device="cpu")
    q = {b: _jax_q(SOMTrainer(init, bf16=b, **tk).fit(PDataset(points=X), **fit), X)
         for b in (False, True)}
    assert q[True] < 1.1 * q[False], q
    mask = np.zeros_like(X, dtype=np.uint8)
    mask[512:, 2] = 1

    def stream():
        yield PDataset(points=X[:512])
        yield PDataset(points=X[512:], mask=mask[512:])

    with tempfile.TemporaryDirectory() as d:
        tr = SOMTrainer(init, bf16=True, checkpoint_dir=d, checkpoint_interval=3,
                        **tk)
        out = tr.fit(stream(), rlen=1024, alpha=0.05, radius=4.0)
        assert tr.ckpt.load(3).codes.dtype == np.float32
    assert out.points.dtype == np.float32 and np.isfinite(out.points).all()
    masked = PDataset(points=X, mask=mask)
    a, b = (SOMTrainer(init, bf16=bf, **tk).fit(masked, **fit).points
            for bf in (False, True))
    np.testing.assert_array_equal(a, b)


def _write_data(path, X, mask=None):
    with open(path, "w") as f:
        f.write(f"{X.shape[1]}\n")
        for r, row in enumerate(X):
            f.write(" ".join("x" if mask is not None and mask[r, k] else f"{v:.6f}"
                             for k, v in enumerate(row)) + "\n")


@pytest.mark.parametrize("masked", [False, True])
def test_find_qerror_on_a_stream_matches_jax(masked, tmp_path):
    """find_qerror(mode="fast") on a StreamingReader: one device total over
    the chunks, against the JAX streamed value (rel 1e-5)."""
    rng = np.random.default_rng(9)
    X = _blobs(300, dim=5, seed=9)
    mask = None
    if masked:
        mask = (rng.random(X.shape) < 0.2).astype(np.uint8)
        mask[::17] = 1  # fully masked rows add 0
    path = str(tmp_path / "d.dat")
    _write_data(path, X, mask)
    codes = jsom.randinit(Dataset(points=X), Topology.HEXA, Neighborhood.GAUSSIAN,
                          6, 4, CRandom(5))
    want = jsom.find_qerror(codes, JStreamingReader(path, buffer=64), mode="fast")
    pc = as_port_dataset(codes, source_labels=JAX_LABELS)
    reader = StreamingReader(path, buffer=64, labels=LabelTable())
    for c in (pc, torch.from_numpy(np.asarray(codes.points, np.float32))):
        got = som.find_qerror(c, reader, device="cpu")
        assert abs(got - want) <= 1e-5 * want, (got, want)
    with pytest.raises(ValueError, match="mask"):
        som.find_qerror(pc, reader, mask=torch.zeros((1, 5)), device="cpu")
