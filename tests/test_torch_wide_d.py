"""The SOM step kernels past 256 features (their feature passes): the plain
versions of K3, K5, K6, K7, K11 then K12, K13, K14's main form and K17
against the JAX package's Pallas kernels in interpret mode at D 300 and 512
(small maps: 8x8 or 16x8, B 256, or 64 for K7), a CPU `SOMTrainer.fit` at
D 300 against the JAX trainer on quality, and the pass plan the kernels and
their wrappers share (pass widths, the split layout, scratch sizes) at
every D from 1 to 1024.

The JAX kernels pad D to a multiple of 128 (zero columns, compared on the
first D).  Inputs come from NumPy seeds.  Tolerances are those of the D <=
256 tests of the same function: codebooks and accumulators to 1e-5
(tests/test_torch_ops.py, test_torch_masked.py, test_torch_vmem.py,
test_torch_mesh.py), the separable steps' values to 1e-4 and, under
batch_bf16, to 5e-3 (test_torch_factored.py), K17's vmax to 1e-5 relative
(test_torch_probes.py); winners equal except at near-ties (float64
distances within 1e-5 relative); the trainer's codebook to 2e-2 and its
qerror within 2% (test_torch_factored.py's trainer test)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bench
from som_lvq_pak_tpu.data.dataset import Dataset, Neighborhood, Topology
from som_lvq_pak_tpu.data.labels import GLOBAL_LABELS as JAX_LABELS
from som_lvq_pak_tpu.models import som as jsom
from som_lvq_pak_tpu.models.trainer import SOMTrainer as JaxSOMTrainer
from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_tpu.utils.rng import CRandom
from som_lvq_pak_torch.convert import as_port_dataset
from som_lvq_pak_torch.data.dataset import Dataset as PDataset
from som_lvq_pak_torch.models.trainer import SOMTrainer, fused_step_choice
from som_lvq_pak_torch.ops import som_step
from som_lvq_pak_torch.ops.skeleton import fused_step_skeleton
from som_lvq_pak_torch.ops.som_accum import som_neighborhood_accumulate
from som_lvq_pak_torch.ops.som_blend import som_blend_winner
from som_lvq_pak_torch.ops.som_step import (PASS_D, feature_passes, som_fused_train_step,
                                            split_scratch_floats, split_width)
from som_lvq_pak_torch.ops.som_update import som_neighborhood_update_idx
from som_lvq_pak_torch.ops.som_vmem import som_vmem_train_steps
from som_lvq_pak_torch.ops.tf32x3 import split_batches_plain, tf32_split

TOL = 1e-5
WIDE = (300, 512)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread in this module, as tests/test_torch_ops.py
    runs it (a first-parallel-transcendental fault of torch on the CPU host:
    the gaussian neighbourhood's exp came back up to 1.5e-4 off in one
    worker thread's share)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad128(a):
    """Features zero-padded to a multiple of 128 for the JAX kernels only."""
    a = np.asarray(a, np.float32)
    pad = [(0, 0)] * (a.ndim - 1) + [(0, -a.shape[-1] % 128)]
    return jnp.asarray(np.pad(a, pad))


def _winners_agree(x, codes, i_port, i_ref, rel=TOL):
    """Equal winners, or a near-tie: the two rows' float64 distances within
    `rel` relative."""
    i_port, i_ref = np.asarray(i_port, np.int64), np.asarray(i_ref, np.int64)
    bad = np.nonzero(i_port != i_ref)[0]
    if bad.size:
        x64, c64 = np.asarray(x, np.float64)[bad], np.asarray(codes, np.float64)
        da = ((x64 - c64[i_port[bad]]) ** 2).sum(-1)
        db = ((x64 - c64[i_ref[bad]]) ** 2).sum(-1)
        gap = np.abs(da - db) / np.maximum(np.maximum(da, db), 1e-30)
        assert gap.max() < rel, (bad, gap)


def _step_inputs(noc, D, B, seed, no_bmu=True):
    rng = np.random.default_rng(seed)
    codes = rng.normal(size=(noc, D)).astype(np.float32)
    xb = rng.normal(size=(B, D)).astype(np.float32)
    xn = rng.normal(size=(B, D)).astype(np.float32)
    bmu = rng.integers(0, noc, size=B).astype(np.int32)
    if no_bmu:
        bmu[:3] = -1  # samples without a BMU teach nothing
    alpha = rng.uniform(0.0, 0.1, size=B).astype(np.float32)
    return codes, xb, xn, bmu, alpha


def _port_step(codes, xb, bmu, xn, xdim, hexa, alpha, radius, gaussian, **kw):
    c = T(codes.copy())
    out, i, v = som_fused_train_step(c, T(xb), T(bmu), T(xn), xdim, hexa, T(alpha),
                                     radius, gaussian, **kw)
    assert out.data_ptr() == c.data_ptr()  # updated in place
    return out.numpy(), i.numpy(), v.numpy()


def _jax_step(codes, xb, bmu, xn, xdim, hexa, alpha, radius, gaussian, **kw):
    jc, ji, jv = jps.som_fused_train_step(
        _pad128(codes), _pad128(xb), jnp.asarray(bmu), _pad128(xn), xdim, hexa,
        jnp.asarray(alpha), radius, gaussian=gaussian, **kw)
    return np.asarray(jc)[:, :codes.shape[1]], np.asarray(ji), np.asarray(jv)


# -- the plain kernels against the JAX kernels (interpret mode) ---------------

@pytest.mark.parametrize("D", WIDE)
@pytest.mark.parametrize("hexa,gaussian", [(True, True), (False, False)])
def test_k3_plain_matches_jax_wide(D, hexa, gaussian):
    """Plain K3 (factored=False) against `_som_fused_step_kernel`, 8x8 map,
    B 256, a few samples without a BMU."""
    args = _step_inputs(64, D, 256, seed=D + hexa)
    codes, xb, xn, bmu, alpha = args
    c, i, v = _port_step(codes, xb, bmu, xn, 8, hexa, alpha, 3.0, gaussian, factored=False)
    jc, ji, jv = _jax_step(codes, xb, bmu, xn, 8, hexa, alpha, 3.0, gaussian, factored=False)
    np.testing.assert_allclose(c, jc, rtol=TOL, atol=TOL)
    _winners_agree(xn, c, i, ji)
    np.testing.assert_allclose(v, jv, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("D", WIDE)
@pytest.mark.parametrize("gaussian", [True, False])
def test_k13_plain_matches_jax_wide(D, gaussian):
    """Plain K13 (factored=True) against `_som_fused_factored_kernel`, 8x8
    hexa map in tiles of two grid rows, B 256; that kernel takes no bmu < 0
    (the JAX trainer never gives it one)."""
    assert som_step.factored_geometry_ok(64, 8, 16, True)
    codes, xb, xn, bmu, alpha = _step_inputs(64, D, 256, seed=2 * D + gaussian,
                                             no_bmu=False)
    kw = dict(tile_n=16, factored=True)
    c, i, v = _port_step(codes, xb, bmu, xn, 8, True, alpha, 3.0, gaussian, **kw)
    jc, ji, jv = _jax_step(codes, xb, bmu, xn, 8, True, alpha, 3.0, gaussian, **kw)
    np.testing.assert_allclose(c, jc, rtol=TOL, atol=TOL)
    _winners_agree(xn, c, i, ji)
    np.testing.assert_allclose(v, jv, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("D", WIDE)
@pytest.mark.parametrize("batch_bf16", [False, True], ids=["f32", "batch_bf16"])
def test_k14_plain_matches_jax_wide(D, batch_bf16):
    """Plain K14's main form against `_som_fused_factored_chunked_kernel`
    (16x8 hexa gaussian, tile 32, B 256 in chunks of 128), float32 batches
    and bf16 ones.  Under batch_bf16 the winners score bf16-rounded rows, so
    a near-tie is judged on those rows' distances."""
    codes, xb, xn, bmu, alpha = _step_inputs(128, D, 256, seed=3 * D + batch_bf16,
                                             no_bmu=False)
    kw = dict(tile_n=32, batch_chunk=128, batch_bf16=batch_bf16)
    c, i, v = _port_step(codes, xb, bmu, xn, 16, True, alpha, 3.0, True, **kw)
    jc, ji, jv = _jax_step(codes, xb, bmu, xn, 16, True, alpha, 3.0, True, **kw)
    np.testing.assert_allclose(c, jc, rtol=TOL, atol=TOL)
    if batch_bf16:
        bf = lambda a: T(a).to(torch.bfloat16).float().numpy()  # noqa: E731
        _winners_agree(bf(xn), bf(c), i, ji)
    else:
        _winners_agree(xn, c, i, ji)
    np.testing.assert_allclose(v, jv, rtol=0.0 if batch_bf16 else 1e-4,
                               atol=5e-3 if batch_bf16 else 1e-4)


@pytest.mark.parametrize("D", WIDE)
@pytest.mark.parametrize("masked", [False, True], ids=["K5", "K6"])
def test_update_plain_matches_jax_wide(D, masked):
    """Plain K5 (and K6 with a mask, a tenth of the components masked)
    against `som_neighborhood_update_idx`, 8x8 hexa gaussian, B 256."""
    codes, xb, _, bmu, alpha = _step_inputs(64, D, 256, seed=4 * D + masked)
    mask = None
    if masked:
        mask = (np.random.default_rng(D).uniform(size=xb.shape) < 0.1).astype(np.uint8)
    c = T(codes.copy())
    out = som_neighborhood_update_idx(c, T(xb), T(bmu), 8, True, T(alpha), 3.0, True,
                                      mask=None if mask is None else T(mask))
    assert out.data_ptr() == c.data_ptr()
    ref = jps.som_neighborhood_update_idx(
        jnp.asarray(codes), jnp.asarray(xb), jnp.asarray(bmu), 8, True,
        jnp.asarray(alpha), 3.0, gaussian=True,
        mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("D", WIDE)
def test_k7_plain_matches_jax_wide(D):
    """Plain K7 against `som_vmem_train_steps`: K = 3 steps of B 64 on an
    8x8 hexa gaussian map, next_first given, small alphas (no unit's weight
    mass reaches 1), a decaying radius."""
    K, B = 3, 64
    rng = np.random.default_rng(D)
    codes = rng.normal(size=(64, D)).astype(np.float32)
    xs = rng.normal(size=(K, B, D)).astype(np.float32)
    nf = rng.normal(size=(B, D)).astype(np.float32)
    bmu0 = np.argmin(((xs[0][:, None, :] - codes[None]) ** 2).sum(-1), 1).astype(np.int32)
    alphas = rng.uniform(0.001, 0.012, size=(K, B)).astype(np.float32)
    radii = np.linspace(3.0, 1.5, K).astype(np.float32)
    c = T(codes.copy())
    out, bmu = som_vmem_train_steps(c, T(xs), T(bmu0), T(alphas), T(radii), 8, True, True,
                                    next_first=T(nf))
    ref, jbmu = jps.som_vmem_train_steps(
        _pad128(codes), _pad128(xs), jnp.asarray(bmu0), jnp.asarray(alphas),
        jnp.asarray(radii), 8, True, gaussian=True, next_first=_pad128(nf))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref[:, :D], rtol=TOL, atol=TOL)
    assert not np.allclose(out.numpy(), codes, atol=1e-3)  # the steps did something
    _winners_agree(nf, out.numpy(), bmu.numpy(), np.asarray(jbmu))


@pytest.mark.parametrize("D", WIDE)
def test_k11_then_k12_plain_matches_jax_wide(D):
    """Plain K11 on a 32-row shard at global unit offset 32 of an 8x8 map,
    then plain K12 on its accumulators, against `som_neighborhood_accumulate`
    then `som_blend_winner` (each package blending its own sums): the
    accumulators and the blended shard to 1e-5, winners equal but at
    near-ties, values to 1e-4."""
    codes, xb, xn, bmu, alpha = _step_inputs(64, D, 256, seed=5 * D)
    shard = codes[32:]
    acc, wsum = som_neighborhood_accumulate(T(xb), T(bmu), 32, 8, True, T(alpha), 3.0,
                                            True, unit_offset=32)
    jacc, jw = jps.som_neighborhood_accumulate(
        _pad128(xb), jnp.asarray(bmu), 32, 8, True, jnp.asarray(alpha), jnp.float32(3.0),
        gaussian=True, tile_n=16, unit_offset=32, interpret=True)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc)[:, :D], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(wsum.numpy(), np.asarray(jw), rtol=TOL, atol=TOL)
    c, val, idx = som_blend_winner(T(shard.copy()), acc, wsum, T(xn))
    jc, jv, ji = jps.som_blend_winner(_pad128(shard), jacc, jw, _pad128(xn), tile_n=16,
                                      d_real=D, interpret=True)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc)[:, :D], rtol=TOL, atol=TOL)
    _winners_agree(xn, c.numpy(), idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(val.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)


def _bench_skeleton(codes, w, x, tile_n, batch_chunk, d_real):
    """bench.py:_skeleton_kernel through prep_skeleton's pallas_call
    (bench.py:556-581) in interpret mode, as tests/test_torch_probes.py
    calls it: codes (N, DP), w (tile_n, B), x (B, DP) as both X and X'."""
    N, DP = codes.shape
    B = x.shape[0]
    return pl.pallas_call(
        functools.partial(bench._skeleton_kernel, tile_n=tile_n,
                          batch_chunk=batch_chunk, d_real=d_real),
        grid=(N // tile_n,),
        in_specs=[pl.BlockSpec((tile_n, B), lambda i: (0, 0)),
                  pl.BlockSpec((B, DP), lambda i: (0, 0)),
                  pl.BlockSpec((B, DP), lambda i: (0, 0)),
                  pl.BlockSpec((tile_n, DP), lambda i: (i, 0))],
        out_specs=[pl.BlockSpec((tile_n, DP), lambda i: (i, 0)),
                   pl.BlockSpec((1, B), lambda i: (0, 0))],
        out_shape=[jax.ShapeDtypeStruct((N, DP), jnp.float32),
                   jax.ShapeDtypeStruct((1, B), jnp.float32)],
        interpret=True,
    )(w, x, x, codes)


@pytest.mark.parametrize("D", WIDE)
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_k17_plain_matches_bench_kernel_wide(D, bf16):
    """K17's plain version against bench.py's skeleton (two 256-row tiles,
    B 256 in one chunk), W uniform * 0.001 and X normal as prep_skeleton
    makes them: at the bench's scale 1e-30 the rows come back as the codes,
    vmax within 1e-5 relative."""
    N, Tr, B = 512, 256, 256
    rng = np.random.default_rng(D + bf16)
    codes = rng.normal(size=(N, D)).astype(np.float32)
    w = (rng.uniform(size=(Tr, B)) * 0.001).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    j_out, j_vmax = _bench_skeleton(_pad128(codes), jnp.asarray(w).astype(jdt),
                                    _pad128(x).astype(jdt), Tr, 256, D)
    tdt = torch.bfloat16 if bf16 else torch.float32
    tx = T(x).to(tdt)
    out, vmax = fused_step_skeleton(T(codes), T(w).to(tdt), tx, tx)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out)[:, :D])
    np.testing.assert_allclose(vmax.numpy(), np.asarray(j_vmax)[0], rtol=1e-5, atol=0)


# -- the trainer -----------------------------------------------------------------

def test_trainer_matches_jax_d300():
    """SOMTrainer.fit at D 300 on an 8x8 hexa gaussian map in both packages,
    one chunk stream, B 128: the separable kernel in both (the JAX trainer's
    choice, D padded to 384 there); codebooks within 2e-2, qerror within 2%,
    and well under the random initial codebook's."""
    D, bs, n = 300, 128, 1024
    assert fused_step_choice(64, 8, True, True, bs, D) == (True, 64, None, False, False)
    rng = np.random.default_rng(300)
    centres = rng.normal(0, 4.0, size=(4, D)).astype(np.float32)
    X = centres[rng.integers(0, 4, size=n)] + rng.normal(size=(n, D)).astype(np.float32)
    init = jsom.randinit(Dataset(points=X), Topology.HEXA, Neighborhood.GAUSSIAN, 8, 8,
                         CRandom(123))
    fit = dict(rlen=n, alpha=0.05, radius=4.0)

    def stream(cls):
        for lo in range(0, n, 512):
            yield cls(points=X[lo:lo + 512])

    ref = JaxSOMTrainer(init, batch_size=bs, use_pallas=True, vmem_steps=False).fit(
        stream(Dataset), **fit)
    out = SOMTrainer(as_port_dataset(init, source_labels=JAX_LABELS), batch_size=bs,
                     device="cpu", vmem_steps=False).fit(stream(PDataset), **fit)
    np.testing.assert_allclose(out.points, ref.points, rtol=2e-2, atol=2e-2)

    def q(codes):
        jc = Dataset(points=codes.points, topol=Topology(int(codes.topol)),
                     neigh=Neighborhood(int(codes.neigh)), xdim=codes.xdim,
                     ydim=codes.ydim)
        return jsom.find_qerror(jc, Dataset(points=X), mode="fast") / n

    q_ref = q(ref)
    assert abs(q(out) - q_ref) < 0.02 * q_ref
    assert q_ref < 0.8 * q(init)


# -- the pass plan -----------------------------------------------------------------

@pytest.mark.parametrize("lo", range(1, 1025, 128))
def test_pass_plan(lo):
    """feature_passes(D): one pass of the smallest DP = 8 x 2^k covering D up
    to PASS_D (256), past it ceil(D / 256) passes of 256, the last the only
    one with padding; split_width and the split scratch follow it, and a
    bf16 codebook gets its float32 rows copy (rows32) only past 256 (D in
    lo..lo + 127).  K7's shared memory at every D is the C layout's own count
    (somvq_vmem_smem_bytes), held on the card by chip_smoke.py's phase 3w."""
    for D in range(lo, lo + 128):
        _check_pass_plan(D)


def _check_pass_plan(D):
    n, dp = feature_passes(D)
    assert dp % 8 == 0 and dp <= PASS_D and (dp // 8) & (dp // 8 - 1) == 0
    assert n * dp >= D and (n - 1) * dp < D
    if D <= PASS_D:
        assert n == 1 and (dp == 8 or dp // 2 < D)
    else:
        assert dp == PASS_D and n == -(-D // 256)
    assert split_width(D) == n * dp
    for B, Bn, planes in ((100, 77, 2), (256, 0, 2), (0, 999, 1)):
        rows = -(-B // 64) * 64 + -(-Bn // 64) * 64
        assert split_scratch_floats(B, Bn, D, planes) == planes * rows * n * dp
    rows32 = som_step._rows32(torch.empty((4, D), dtype=torch.bfloat16))
    assert (rows32 is not None) == (D > PASS_D)
    if rows32 is not None:
        assert rows32.shape == (4, D) and rows32.dtype == torch.float32
    assert som_step._rows32(torch.empty((4, D))) is None
    if D == 1024:
        with pytest.raises(ValueError):
            feature_passes(0)


@pytest.mark.parametrize("D,planes", [(5, 2), (256, 2), (300, 2), (512, 1), (1000, 2)])
def test_split_layout_is_slab_by_slab(D, planes):
    """split_batches_plain (csrc/fused_step_tc.cuh:split_batches_kernel's
    layout): each batch's slabs of DP features in turn, each slab's planes
    (TF32 hi, lo; or one bf16 plane) as (rows, DP), zeros past D and the
    batch; slab s holds features s DP.. of the whole-row split."""
    B, Bn = 100, 77
    rng = np.random.default_rng(D)
    xb = T(rng.normal(size=(B, D)).astype(np.float32))
    xn = T(rng.normal(size=(Bn, D)).astype(np.float32))
    n, dp = feature_passes(D)
    flat = split_batches_plain(xb, xn, dp, planes)
    assert flat.numel() == split_scratch_floats(B, Bn, D, planes)
    o = 0
    for x, rows in ((xb, 128), (xn, 128)):
        full = torch.zeros((rows, n * dp))
        full[:x.shape[0], :D] = x
        want = ([full.to(torch.bfloat16).float()] if planes == 1 else list(tf32_split(full)))
        for s in range(n):
            for p in range(planes):
                got = flat[o:o + rows * dp].reshape(rows, dp)
                assert torch.equal(got, want[p][:, s * dp:(s + 1) * dp])
                o += rows * dp
    assert o == flat.numel()
