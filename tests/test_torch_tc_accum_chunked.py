"""The numeric design of K11 (the mixed mesh step's accumulators) and K14's
main form (the batch-chunked separable step) on the tensor cores, on the CPU
(the kernels run only on a card): `ops.tf32x3`'s emulations of their routes
against the JAX package's kernels in interpret mode and the port's plain
versions.

K11 is K3's update half: W.X by split-TF32 products summed per 32-sample
chunk into float32 totals, the weight mass a float32 sum of W.  Its
accumulators are held to the JAX kernel and the plain K11 at
tests/test_torch_mesh.py's 1e-5 (features lane-padded to 128 for JAX only),
and blended they give K3's emulated rows bit for bit.  K14's main form is
K13's body with the bf16 x-pattern and, under batch_bf16, one TF32 product
per contraction on bf16 operands (exact: a bf16 value is exact in TF32 and a
product of two is exact in float32); it is held to the JAX 8c kernel and the
plain K14 at tests/test_torch_factored.py:test_chunked_step_matches_jax's
tolerances: codebooks within 1e-5, winners to the 1e-5 gap of the distance
each side ranks by, values within 1e-4 (5e-3 under batch_bf16, where float32
rows equal to 1e-5 may round to different bf16 neighbours), and each side's
winners and values against the scoring of its own rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_torch.ops.som_accum import som_neighborhood_accumulate_plain
from som_lvq_pak_torch.ops.som_step import (guarded_blend,
                                            som_fused_factored_chunked_step_plain)
from som_lvq_pak_torch.ops.tf32x3 import (som_fused_factored_chunked_step_tc,
                                          som_fused_train_step_tf32x3,
                                          som_neighborhood_accumulate_tf32x3,
                                          tf32_mm)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread, as tests/test_torch_tf32x3.py runs the gaussian
    step (a first-parallel-transcendental fault of torch on the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad128(a):
    """Lane-pad features to 128 for the JAX kernels only."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(np.pad(a, ((0, 0), (0, -a.shape[1] % 128))))


def T(a):
    return torch.from_numpy(np.asarray(a))


# -- K11 ------------------------------------------------------------------

XDIM, YDIM = 16, 12         # 192 units
N_LOCAL, OFFSET = 48, 64    # a shard of three grid rows, from unit 64
D, B = 20, 100              # three whole 32-sample chunks and a partial one


def _accum_inputs(seed):
    rng = np.random.default_rng(seed)
    codes = rng.normal(size=(XDIM * YDIM, D)).astype(np.float32)
    xb = rng.normal(size=(B, D)).astype(np.float32)
    xn = rng.normal(size=(64, D)).astype(np.float32)
    bmu = rng.integers(0, XDIM * YDIM, size=B).astype(np.int32)
    bmu[:3] = -1  # samples without a BMU teach nothing
    alpha = rng.uniform(0.01, 0.08, size=B).astype(np.float32)
    return codes, xb, xn, bmu, alpha


ACCUM_CASES = [(hexa, gaussian, per_sample) for hexa in (True, False)
               for gaussian in (True, False) for per_sample in (True, False)]


@pytest.mark.parametrize("hexa,gaussian,per_sample", ACCUM_CASES)
def test_accumulate_tf32x3_matches_jax_and_plain(hexa, gaussian, per_sample):
    """K11's route on a shard at unit offset 64 against the JAX
    som_neighborhood_accumulate (interpret mode) and the plain K11, to 1e-5;
    a unit of the shard takes weight."""
    codes, xb, xn, bmu, alpha = _accum_inputs(7 * hexa + 3 * gaussian + per_sample)
    a = alpha if per_sample else np.float32(0.05)
    radius = 3.0
    acc, wsum = som_neighborhood_accumulate_tf32x3(
        T(xb), T(bmu), N_LOCAL, XDIM, hexa, T(a), radius, gaussian, unit_offset=OFFSET)
    jacc, jw = jps.som_neighborhood_accumulate(
        _pad128(xb), jnp.asarray(bmu), N_LOCAL, XDIM, hexa, jnp.asarray(a),
        jnp.float32(radius), gaussian=gaussian, tile_n=16, unit_offset=OFFSET,
        interpret=True)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc)[:, :D], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(wsum.numpy(), np.asarray(jw), rtol=TOL, atol=TOL)
    pacc, pw = som_neighborhood_accumulate_plain(
        T(xb), T(bmu), N_LOCAL, XDIM, hexa, T(a), radius, gaussian, unit_offset=OFFSET)
    np.testing.assert_allclose(acc.numpy(), pacc.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(wsum.numpy(), pw.numpy(), rtol=TOL, atol=TOL)
    assert wsum.shape == (N_LOCAL, 1) and float(wsum.max()) > 0


@pytest.mark.parametrize("offset", [0, OFFSET])
@pytest.mark.parametrize("hexa,gaussian", [(True, True), (False, False)])
def test_accumulate_tf32x3_blends_to_k3_bitwise(hexa, gaussian, offset):
    """K11 then K12's guarded blend on a shard gives K3's rows bit for bit,
    as on the card: K11's sums of a row are K3's (the same W at the same
    global unit, the same chunk sums)."""
    codes, xb, xn, bmu, alpha = _accum_inputs(11 + offset)
    shard = codes[offset:offset + N_LOCAL]
    acc, wsum = som_neighborhood_accumulate_tf32x3(
        T(xb), T(bmu), N_LOCAL, XDIM, hexa, T(alpha), 3.0, gaussian, unit_offset=offset)
    blended = guarded_blend(T(shard), acc, wsum).numpy()
    k3, _, _ = som_fused_train_step_tf32x3(T(shard), T(xb), T(bmu), T(xn), XDIM, hexa,
                                           T(alpha), 3.0, gaussian, unit_offset=offset)
    np.testing.assert_array_equal(blended.view(np.int32), k3.numpy().view(np.int32))
    assert not np.array_equal(blended, shard)  # the shard moved


# -- K14's main form --------------------------------------------------------

def _bf16_64(a):
    """`a` rounded to bf16 (nearest even), as float64."""
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16).double().numpy()


def _dists(x, codes, bf16_score=False):
    """(B', noc) float64 distances the steps' winners rank by: ||x - m||^2,
    or under batch_bf16 ||x'||^2 - 2 x'.m' + ||m||^2 with x' and m' rounded
    to bf16 and the norm from the float32 rows."""
    c64 = np.asarray(codes, np.float64)
    xr = _bf16_64(x) if bf16_score else np.asarray(x, np.float64)
    cr = _bf16_64(codes) if bf16_score else c64
    return (xr * xr).sum(1)[:, None] - 2.0 * xr @ cr.T + (c64 * c64).sum(1)[None, :]


def assert_winners_agree(x, codes, i_got, i_want, bf16_score=False):
    i_got, i_want = np.asarray(i_got, np.int64), np.asarray(i_want, np.int64)
    bad = np.nonzero(i_got != i_want)[0]
    if bad.size:
        d = _dists(np.asarray(x)[bad], codes, bf16_score)
        rows = np.arange(bad.size)
        da, db = d[rows, i_got[bad]], d[rows, i_want[bad]]
        gap = np.abs(da - db) / np.maximum(np.maximum(da, db), 1e-30)
        assert gap.max() < TOL, (bad, gap)


def assert_own_scoring(x, codes, idx, val, bf16_score=False):
    """Winners and values against the float64 scoring of the step's own
    rows: winners to the 1e-5 gap, values within 1e-4."""
    d = _dists(x, codes, bf16_score)
    assert_winners_agree(x, codes, idx, d.argmin(1), bf16_score)
    xr = _bf16_64(x) if bf16_score else np.asarray(x, np.float64)
    want = d[np.arange(d.shape[0]), np.asarray(idx, np.int64)] - (xr * xr).sum(1)
    np.testing.assert_allclose(val, want, rtol=1e-4, atol=1e-4)


FLAGS = [dict(), dict(wxa_bf16=True), dict(batch_bf16=True),
         dict(wxa_bf16=True, batch_bf16=True)]


@pytest.mark.parametrize("gaussian", [True, False])
@pytest.mark.parametrize("flags", FLAGS, ids=["f32", "wxa_bf16", "batch_bf16", "both"])
def test_chunked_step_tc_matches_jax_and_plain(flags, gaussian):
    """K14's route against `_som_fused_factored_chunked_kernel` (batch_chunk
    128, tile 32, interpret mode) and the plain K14 under the same flags, at
    test_chunked_step_matches_jax's shapes and tolerances; a bubble map
    keeps a float32 x-pattern in all three."""
    xdim, ydim, hexa = 16, 8, True
    rng = np.random.default_rng(7)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    codes, xb = f(xdim * ydim, 64), f(256, 64)
    bmu = rng.integers(0, xdim * ydim, size=256).astype(np.int32)
    xn, alpha = f(256, 64), rng.uniform(0.0, 0.1, size=256).astype(np.float32)
    c, i, v = (t.numpy() for t in som_fused_factored_chunked_step_tc(
        T(codes), T(xb), T(bmu), T(xn), xdim, hexa, T(alpha), 3.0, gaussian, **flags))
    jc, ji, jv = jps.som_fused_train_step(
        _pad128(codes), _pad128(xb), jnp.asarray(bmu), _pad128(xn), xdim, hexa,
        jnp.asarray(alpha), 3.0, gaussian=gaussian, tile_n=32, batch_chunk=128, **flags)
    pc, pi, pv = (t.numpy() for t in som_fused_factored_chunked_step_plain(
        T(codes.copy()), T(xb), T(bmu), T(xn), xdim, hexa, T(alpha), 3.0, gaussian,
        batch_chunk=128, **flags))
    bb = bool(flags.get("batch_bf16"))
    for rc, ri, rv in ((np.asarray(jc)[:, :64], np.asarray(ji), np.asarray(jv)),
                       (pc, pi, pv)):
        np.testing.assert_allclose(c, rc, rtol=TOL, atol=TOL)
        assert_winners_agree(xn, c, i, ri, bf16_score=bb)
        np.testing.assert_allclose(v, rv, rtol=0.0 if bb else 1e-4,
                                   atol=5e-3 if bb else 1e-4)
    assert_own_scoring(xn, c, i, v, bb)


def test_chunked_step_tc_bf16_codebook_and_bubble_boundary():
    """A bf16 codebook is read upcast and blended in float32 (the rows the
    winners take); the exact bubble boundary (dx = 1.5, dy^2 = 9 * 0.75,
    r = 3) holds under batch_bf16: W = 2^-8 and x = 1 are exact in bf16, so
    128 such samples make the unit exactly 0.5, as the plain K14 does."""
    xdim, ydim, Dd, Bb = 8, 6, 64, 128
    codes = np.zeros((xdim * ydim, Dd), np.float32)
    xb = np.ones((Bb, Dd), np.float32)
    bmu = np.full(Bb, 2, np.int32)
    alpha = np.full(Bb, 2.0 ** -8, np.float32)
    c, _, _ = som_fused_factored_chunked_step_tc(T(codes), T(xb), T(bmu), T(xb), xdim,
                                                 True, T(alpha), 3.0, False,
                                                 batch_bf16=True)
    np.testing.assert_array_equal(c.numpy()[3 * xdim + 3], np.full(Dd, 0.5, np.float32))
    pc, _, _ = som_fused_factored_chunked_step_plain(
        T(codes.copy()), T(xb), T(bmu), T(xb), xdim, True, T(alpha), 3.0, False,
        batch_chunk=128, batch_bf16=True)
    np.testing.assert_array_equal(c.numpy(), pc.numpy())
    rng = np.random.default_rng(3)
    c16 = T(rng.normal(size=(xdim * ydim, Dd)).astype(np.float32)).to(torch.bfloat16)
    xr = T(rng.normal(size=(Bb, Dd)).astype(np.float32))
    args = (T(bmu), xr, xdim, True, T(alpha * 8), 3.0, True)
    got = som_fused_factored_chunked_step_tc(c16, xr, *args, wxa_bf16=True, batch_bf16=True)
    want = som_fused_factored_chunked_step_tc(c16.float(), xr, *args, wxa_bf16=True,
                                              batch_bf16=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@settings(max_examples=200, deadline=None)
@given(st.lists(st.floats(width=32, min_value=-2.0 ** 60, max_value=2.0 ** 60)
                .filter(lambda v: v == 0 or abs(v) >= 2.0 ** -60), min_size=2, max_size=48))
def test_bf16_w_times_bf16_x_one_tf32_product_is_exact(values):
    """A bf16-rounded W times a bf16 x in one TF32 product (K14's route under
    batch_bf16) equals the float64 product: every pair of the values, as
    W (a column) times x (a row), through `tf32_mm` with one term per entry
    (magnitudes in [2^-60, 2^60], where float32 neither overflows nor goes
    subnormal)."""
    half = len(values) // 2
    w = torch.tensor(values[:half], dtype=torch.float32)
    x = torch.tensor(values[half:], dtype=torch.float32)
    w16, x16 = (t.to(torch.bfloat16).to(torch.float32) for t in (w, x))
    got = tf32_mm(w16[:, None], x16[None, :])
    assert torch.equal(got.double(), w16.double()[:, None] * x16.double()[None, :])
