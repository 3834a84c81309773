"""The numeric design of the split-TF32 kernels K1, K2, K3, K4, K6 and K13 on
the CPU
(the kernels run only on a card): `ops.tf32x3`'s emulation of the split and
of the kernels' contractions, against float64, the port's plain versions and
the JAX package's kernels in interpret mode; and the identity K1 rests on:
the distance form's plain version equals the max-score form's bit for bit.

Tolerances are chip_smoke.py's K3 gates: codebooks allclose at 1e-4,
winner values at (rtol 1e-4, atol 1e-3), winners equal except where the
two candidates' float64 distances differ by less than 1e-5 relative; K2's
values at 1e-4, its winners to the same 1e-5 gap; K1's the same.  K6's
masked update at tests/test_torch_masked.py's update tolerance, 1e-5 (float32
sums of at most a few hundred terms).  K4's masked winners at K1's gates
over the unmasked components; K13's step at chip_smoke.py's K13 gates:
codebooks within 1e-5, values within 1e-4, winners to the 1e-5 gap.  The
products' bound is
(2^-20 + (K + 2) 2^-24) (|a| @ |b|): four terms of at most 2^-22 |a b| each
from the split, and the float32 sums of K terms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.ops import pallas_distance as jpd
from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_torch.ops.dist_argmin import (dist_argmin_masked_plain,
                                               dist_argmin_plain, dist_argmin_t_plain)
from som_lvq_pak_torch.ops.som_step import (som_fused_factored_step_plain,
                                            som_fused_train_step_plain)
from som_lvq_pak_torch.ops.som_update import som_neighborhood_update_idx_plain
from som_lvq_pak_torch.ops.tf32x3 import (dist_argmin_masked_tf32x3,
                                          dist_argmin_t_tf32x3, dist_argmin_tf32x3,
                                          som_fused_factored_step_tf32x3,
                                          som_fused_train_step_tf32x3,
                                          som_update_masked_tf32x3, tf32_mm,
                                          tf32_round, tf32_split, tf32x3_mm)

GAP = 1e-5
CODES_TOL = 1e-4
VAL_TOL = (1e-4, 1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread, as tests/test_torch_ops.py runs the gaussian
    step (a first-parallel-transcendental fault of torch on the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad128(a):
    """Lane-pad features to 128 for the JAX kernels only."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(np.pad(a, ((0, 0), (0, -a.shape[1] % 128))))


def _tf32_reference(a: np.ndarray) -> np.ndarray:
    """TF32 rounding in float64 arithmetic: the nearest multiple of the
    value's 2^(e - 11) (10 mantissa bits after the leading one), ties away
    from zero."""
    a64 = a.astype(np.float64)
    _, e = np.frexp(a64)  # |a| in [2^(e-1), 2^e)
    ulp = np.ldexp(1.0, e - 11)
    return (np.sign(a64) * np.floor(np.abs(a64) / ulp + 0.5) * ulp).astype(np.float32)


def assert_gap(x, codes, i_got, i_want, rel=GAP):
    """Winners equal except where the two rows' float64 distances differ by
    less than `rel` relative."""
    i_got, i_want = np.asarray(i_got, np.int64), np.asarray(i_want, np.int64)
    bad = np.nonzero(i_got != i_want)[0]
    if bad.size:
        x64 = np.asarray(x, np.float64)[bad]
        c64 = np.asarray(codes, np.float64)
        da = ((x64 - c64[i_got[bad]]) ** 2).sum(-1)
        db = ((x64 - c64[i_want[bad]]) ** 2).sum(-1)
        gap = np.abs(da - db) / np.maximum(np.maximum(da, db), 1e-30)
        assert gap.max() < rel, (bad, gap)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tf32_round_matches_rounding_to_ten_bits(seed):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=4096) * np.exp2(rng.integers(-20, 20, size=4096))).astype(np.float32)
    got = tf32_round(torch.from_numpy(a)).numpy()
    assert not (got.view(np.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(got, _tf32_reference(a))
    rel = np.abs(got.astype(np.float64) - a) / np.abs(a)
    assert rel.max() <= 2.0 ** -11


def test_tf32_round_ties_away_from_zero():
    a = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11,
                  1 + 2.0 ** -11 - 2.0 ** -23, 0.0], np.float32)
    want = np.array([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1 + 2.0 ** -9, 1.0, 0.0],
                    np.float32)
    np.testing.assert_array_equal(tf32_round(torch.from_numpy(a)).numpy(), want)
    hi, lo = tf32_split(torch.from_numpy(a))
    np.testing.assert_array_equal((hi + lo).numpy()[:3], a[:3])  # 12 bits each


@pytest.mark.parametrize("M,K,N,scale", [(64, 64, 64, 1.0), (37, 5, 53, 1.0),
                                         (128, 256, 96, 1e3), (256, 64, 512, 1e-3)])
def test_tf32x3_within_float32_bound_one_pass_not(M, K, N, scale):
    rng = np.random.default_rng(M + K + N)
    a = (scale * rng.normal(size=(M, K))).astype(np.float32)
    b = rng.normal(size=(K, N)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    bound = (2.0 ** -20 + (K + 2) * 2.0 ** -24) * (np.abs(a).astype(np.float64)
                                                     @ np.abs(b).astype(np.float64))
    got = tf32x3_mm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (np.abs(got - want) <= bound).all()
    one = tf32_mm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (np.abs(one - want) > bound).any()  # why the kernels split
    assert np.abs(one - want).max() > 30 * np.abs(got - want).max()


def _step_inputs(xdim, ydim, D, B, Bn, seed):
    rng = np.random.default_rng(seed)
    noc = xdim * ydim
    codes = rng.normal(size=(noc, D)).astype(np.float32)
    xb = rng.normal(size=(B, D)).astype(np.float32)
    xn = rng.normal(size=(Bn, D)).astype(np.float32)
    bmu = rng.integers(0, noc, size=B).astype(np.int32)
    bmu[:3] = -1  # samples without a BMU teach nothing
    alpha = rng.uniform(0.02, 0.08, size=B).astype(np.float32)
    return codes, xb, xn, bmu, alpha


STEP_CASES = [(12, 8, False, False, 5, 3.0), (12, 8, True, True, 64, 3.0),
              (32, 32, True, True, 5, 8.0), (32, 32, False, False, 64, 8.0)]


def _tf32x3_step(codes, xb, xn, bmu, alpha, xdim, hexa, radius, gaussian):
    c, i, v = som_fused_train_step_tf32x3(
        torch.from_numpy(codes), torch.from_numpy(xb), torch.from_numpy(bmu),
        torch.from_numpy(xn), xdim, hexa, torch.from_numpy(alpha), radius, gaussian)
    return c.numpy(), i.numpy(), v.numpy()


def _assert_k3_gates(xn, c, i, v, c_ref, i_ref, v_ref):
    np.testing.assert_allclose(c, c_ref, rtol=CODES_TOL, atol=CODES_TOL)
    assert_gap(xn, c, i, i_ref)
    np.testing.assert_allclose(v, v_ref, rtol=VAL_TOL[0], atol=VAL_TOL[1])


@pytest.mark.parametrize("xdim,ydim,hexa,gaussian,D,radius", STEP_CASES)
def test_fused_step_tf32x3_meets_k3_gates_against_plain(xdim, ydim, hexa, gaussian, D,
                                                       radius):
    codes, xb, xn, bmu, alpha = _step_inputs(xdim, ydim, D, 256, 200, seed=xdim + D)
    c, i, v = _tf32x3_step(codes, xb, xn, bmu, alpha, xdim, hexa, radius, gaussian)
    pc, pi, pv = som_fused_train_step_plain(
        torch.from_numpy(codes.copy()), torch.from_numpy(xb), torch.from_numpy(bmu),
        torch.from_numpy(xn), xdim, hexa, torch.from_numpy(alpha), radius, gaussian)
    _assert_k3_gates(xn, c, i, v, pc.numpy(), pi.numpy(), pv.numpy())


@pytest.mark.parametrize("xdim,ydim,hexa,gaussian,D,radius", STEP_CASES)
def test_fused_step_tf32x3_meets_k3_gates_against_jax(xdim, ydim, hexa, gaussian, D,
                                                     radius):
    codes, xb, xn, bmu, alpha = _step_inputs(xdim, ydim, D, 48, 40, seed=xdim * D)
    c, i, v = _tf32x3_step(codes, xb, xn, bmu, alpha, xdim, hexa, radius, gaussian)
    jc, ji, jv = jps.som_fused_train_step(
        _pad128(codes), _pad128(xb), jnp.asarray(bmu), _pad128(xn), xdim, hexa,
        jnp.asarray(alpha), radius, gaussian=gaussian, factored=False)
    _assert_k3_gates(xn, c, i, v, np.asarray(jc)[:, :D], np.asarray(ji), np.asarray(jv))


@pytest.mark.parametrize("B,N,D,dup", [(37, 53, 5, False), (200, 130, 64, False),
                                       (70, 99, 5, True), (129, 300, 64, True),
                                       (64, 1000, 100, False), (300, 64, 37, False)])
def test_dist_argmin_t_tf32x3_agrees_with_jax(B, N, D, dup):
    rng = np.random.default_rng(B * N + D)
    x = rng.normal(size=(B, D)).astype(np.float32)
    if dup:  # every row three times: the lowest index must win
        base = rng.normal(size=(N // 3, D)).astype(np.float32)
        codes = np.concatenate([base, base, base])
    else:
        codes = rng.normal(size=(N, D)).astype(np.float32)
    v, i = dist_argmin_t_tf32x3(torch.from_numpy(x), torch.from_numpy(codes))
    jv, ji = jpd.dist_argmin_t(_pad128(x), _pad128(codes))
    assert_gap(x, codes, i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)
    pv, pi = dist_argmin_t_plain(torch.from_numpy(x), torch.from_numpy(codes))
    assert_gap(x, codes, i.numpy(), pi.numpy())
    if dup:
        assert int(i.max()) < N // 3


def _winner_case(B, N, D, seed, dup):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D)).astype(np.float32)
    if dup:  # every row three times, and some samples on a code exactly
        base = rng.normal(size=(N // 3, D)).astype(np.float32)
        codes = np.concatenate([base, base, base])
        x[:5] = base[rng.integers(0, N // 3, size=5)]
    else:
        codes = rng.normal(size=(N, D)).astype(np.float32)
    return x, codes


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("B,N,D,dup", [(512, 4096, 64, False), (300, 999, 5, False),
                                       (256, 2048, 37, False), (300, 999, 5, True),
                                       (129, 300, 64, True)])
def test_distance_form_plain_equals_max_score_form_bitwise(B, N, D, dup, seed):
    """-2 fl(x.m - ||m||^2 / 2) = fl(||m||^2 - 2 x.m): halving and doubling
    are exact, so the plain K1 and K2 return the same values and winners bit
    for bit; the kernels share one body on this identity."""
    x, codes = _winner_case(B, N, D, seed, dup)
    v1, i1 = dist_argmin_plain(torch.from_numpy(x), torch.from_numpy(codes))
    v2, i2 = dist_argmin_t_plain(torch.from_numpy(x), torch.from_numpy(codes))
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_array_equal(v1.numpy().view(np.int32), v2.numpy().view(np.int32))
    if dup:
        assert int(i1.max()) < N // 3


@pytest.mark.parametrize("B,N,D,dup", [(37, 53, 5, False), (200, 130, 64, False),
                                       (70, 99, 5, True), (129, 300, 64, True),
                                       (64, 1000, 100, False), (300, 64, 37, False)])
def test_dist_argmin_tf32x3_agrees_with_jax(B, N, D, dup):
    """K1's split-TF32 scoring against the JAX distance-form kernel, and bit
    for bit against K2's split-TF32 scoring."""
    rng = np.random.default_rng(B * N + D + 1)
    x = rng.normal(size=(B, D)).astype(np.float32)
    if dup:  # every row three times: the lowest index must win
        base = rng.normal(size=(N // 3, D)).astype(np.float32)
        codes = np.concatenate([base, base, base])
    else:
        codes = rng.normal(size=(N, D)).astype(np.float32)
    v, i = dist_argmin_tf32x3(torch.from_numpy(x), torch.from_numpy(codes))
    jv, ji = jpd.dist_argmin(_pad128(x), _pad128(codes))
    assert_gap(x, codes, i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)
    pv, pi = dist_argmin_plain(torch.from_numpy(x), torch.from_numpy(codes))
    assert_gap(x, codes, i.numpy(), pi.numpy())
    tv, ti = dist_argmin_t_tf32x3(torch.from_numpy(x), torch.from_numpy(codes))
    np.testing.assert_array_equal(i.numpy(), ti.numpy())
    np.testing.assert_array_equal(v.numpy().view(np.int32), tv.numpy().view(np.int32))
    if dup:
        assert int(i.max()) < N // 3


UPDATE_TOL = 1e-5


def _update_inputs(xdim, ydim, D, B, seed):
    """tests/test_torch_masked.py's update inputs with a mask: components
    masked with probability 0.2, every 7th sample masked entirely."""
    rng = np.random.default_rng(seed)
    noc = xdim * ydim
    codes = rng.normal(size=(noc, D)).astype(np.float32)
    xb = rng.normal(size=(B, D)).astype(np.float32)
    bmu = rng.integers(0, noc, size=B).astype(np.int32)
    bmu[:3] = -1  # samples without a BMU teach nothing
    alpha = rng.uniform(0.0, 0.1, size=B).astype(np.float32)
    mask = (rng.random((B, D)) < 0.2).astype(np.uint8)
    mask[::7] = 1
    return codes, xb, bmu, alpha, mask


def _k6_tf32x3(codes, xb, bmu, mask, xdim, hexa, alpha, radius, gaussian):
    return som_update_masked_tf32x3(
        torch.from_numpy(codes), torch.from_numpy(xb), torch.from_numpy(bmu),
        torch.from_numpy(mask), xdim, hexa, torch.from_numpy(alpha), radius,
        gaussian).numpy()


@pytest.mark.parametrize("tiles", [None, (16, 32)])
@pytest.mark.parametrize("xdim,ydim,hexa,gaussian,radius", [
    (9, 7, True, True, 2.5),     # ragged: 63 rows
    (10, 8, True, False, 3.0),   # hexa bubble: exact-boundary pairs at r=3
    (12, 8, False, False, 3.0),
    (8, 6, False, True, 3.0),
])
def test_masked_update_tf32x3_matches_jax(xdim, ydim, hexa, gaussian, radius, tiles):
    """K6's numeric design (W.(X o K) by three TF32 products, W.K by two,
    sums per 32-sample chunk) against the JAX masked update, at
    test_update_matches_jax's shapes (B 48: a whole chunk and a partial one)
    and tolerance; a component masked in every sample stays exactly as it
    was."""
    D, B = 5, 48
    codes, xb, bmu, alpha, mask = _update_inputs(xdim, ydim, D, B, seed=xdim * ydim)
    got = _k6_tf32x3(codes, xb, bmu, mask, xdim, hexa, alpha, radius, gaussian)
    kw = {} if tiles is None else dict(tile_b=tiles[0], tile_n=tiles[1])
    ref = jps.som_neighborhood_update_idx(
        jnp.asarray(codes), jnp.asarray(xb), jnp.asarray(bmu), xdim, hexa,
        jnp.asarray(alpha), radius, gaussian=gaussian, mask=jnp.asarray(mask), **kw)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=UPDATE_TOL, atol=UPDATE_TOL)
    mask[:, 2] = 1
    got = _k6_tf32x3(codes, xb, bmu, mask, xdim, hexa, alpha, radius, gaussian)
    np.testing.assert_array_equal(got[:, 2], codes[:, 2])


@pytest.mark.parametrize("xdim,ydim,hexa,gaussian,D,B,radius", [
    (12, 8, True, True, 64, 200, 3.0), (32, 32, False, False, 37, 300, 8.0),
    (16, 16, True, False, 200, 96, 4.0)])
def test_masked_update_tf32x3_matches_plain(xdim, ydim, hexa, gaussian, D, B, radius):
    """At K6's main-path width (D 64), a ragged D and D > 128 (two feature
    slabs on the card), against the plain float32 update at 1e-5."""
    codes, xb, bmu, alpha, mask = _update_inputs(xdim, ydim, D, B, seed=D + B)
    got = _k6_tf32x3(codes, xb, bmu, mask, xdim, hexa, alpha, radius, gaussian)
    want = som_neighborhood_update_idx_plain(
        torch.from_numpy(codes.copy()), torch.from_numpy(xb), torch.from_numpy(bmu),
        xdim, hexa, torch.from_numpy(alpha), radius, gaussian,
        mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=UPDATE_TOL, atol=UPDATE_TOL)


def test_masked_update_tf32x3_exact_bubble_boundary():
    """dx = 1.5, dy = 3 sqrt(0.75), r = 3: d2 = r^2 exactly, so the unit is
    inside the bubble; W = 0.5 and K are exact in TF32, so the split sums
    give the JAX kernel's codebook bit for bit, the masked component kept."""
    xdim, ydim, D = 8, 6, 3
    codes = np.zeros((xdim * ydim, D), np.float32)
    xb = np.ones((1, D), np.float32)
    bmu = np.array([2], np.int32)               # column 2, row 0
    mask = np.array([[0, 1, 0]], np.uint8)
    got = _k6_tf32x3(codes, xb, bmu, mask, xdim, True, np.array([0.5], np.float32),
                     3.0, False)
    np.testing.assert_array_equal(got[3 * xdim + 3], [0.5, 0.0, 0.5])
    ref = jps.som_neighborhood_update_idx(
        jnp.asarray(codes), jnp.asarray(xb), jnp.asarray(bmu), xdim, True, 0.5, 3.0,
        gaussian=False, mask=jnp.asarray(mask))
    np.testing.assert_array_equal(got, np.asarray(ref))


def assert_masked_gap(x, codes, mask, i_got, i_want, rel=GAP):
    """Winners equal except where the two rows' float64 distances over the
    sample's unmasked components differ by less than `rel` relative."""
    i_got, i_want = np.asarray(i_got, np.int64), np.asarray(i_want, np.int64)
    bad = np.nonzero(i_got != i_want)[0]
    if bad.size:
        keep = (mask[bad] == 0).astype(np.float64)
        x64 = np.asarray(x, np.float64)[bad]
        c64 = np.asarray(codes, np.float64)
        da = (((x64 - c64[i_got[bad]]) ** 2) * keep).sum(-1)
        db = (((x64 - c64[i_want[bad]]) ** 2) * keep).sum(-1)
        gap = np.abs(da - db) / np.maximum(np.maximum(da, db), 1e-30)
        assert gap.max() < rel, (bad, gap)


@pytest.mark.parametrize("B,N,D,dup", [(37, 53, 5, False), (200, 130, 64, False),
                                       (70, 99, 5, True), (129, 300, 64, True),
                                       (64, 300, 130, False), (300, 64, 37, False)])
def test_dist_argmin_masked_tf32x3_agrees_with_jax_and_plain(B, N, D, dup):
    """K4's numeric design ((x keep).m by three TF32 products, keep.(m o m)
    by two) against the JAX masked kernel and the plain K4, at D 5, D 64, a
    ragged D and D 130 (three 64-feature slabs on the card): winners to the
    1e-5 gap over the unmasked components, values within 1e-4; every fully
    masked row (every 7th) gets index 0 and value 0; with every row three
    times the first copy wins."""
    rng = np.random.default_rng(B * N + D + 2)
    x = rng.normal(size=(B, D)).astype(np.float32)
    if dup:
        base = rng.normal(size=(N // 3, D)).astype(np.float32)
        codes = np.concatenate([base, base, base])
    else:
        codes = rng.normal(size=(N, D)).astype(np.float32)
    mask = (rng.random((B, D)) < 0.2).astype(np.uint8)
    mask[::7] = 1
    v, i = dist_argmin_masked_tf32x3(torch.from_numpy(x), torch.from_numpy(codes),
                                     torch.from_numpy(mask))
    jv, ji = jpd.dist_argmin(jnp.asarray(x), jnp.asarray(codes), mask=jnp.asarray(mask))
    assert_masked_gap(x, codes, mask, i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)
    pv, pi = dist_argmin_masked_plain(torch.from_numpy(x), torch.from_numpy(codes),
                                      torch.from_numpy(mask))
    assert_masked_gap(x, codes, mask, i.numpy(), pi.numpy())
    np.testing.assert_allclose(v.numpy(), pv.numpy(), rtol=1e-4, atol=1e-4)
    full = mask.all(axis=1)
    assert full.any()
    assert (i.numpy()[full] == 0).all() and (v.numpy()[full] == 0).all()
    if dup:
        assert int(i.max()) < N // 3


def test_dist_argmin_masked_tf32x3_unmasked_equals_k1_design():
    """With nothing masked, keep.(m o m) is ||m||^2 up to its split's
    remainder: K4's design gives K1's winners except at near-ties and its
    values within 1e-4."""
    x, codes = _winner_case(300, 999, 64, 3, False)
    mask = np.zeros(x.shape, np.uint8)
    v, i = dist_argmin_masked_tf32x3(torch.from_numpy(x), torch.from_numpy(codes),
                                     torch.from_numpy(mask))
    v1, i1 = dist_argmin_tf32x3(torch.from_numpy(x), torch.from_numpy(codes))
    assert_gap(x, codes, i.numpy(), i1.numpy())
    np.testing.assert_allclose(v.numpy(), v1.numpy(), rtol=1e-4, atol=1e-4)


K13_TOL = 1e-5


def _k13_inputs(noc, D, B, Bn, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    bmu = rng.integers(0, noc, size=B).astype(np.int32)
    return f(noc, D), f(B, D), bmu, f(Bn, D), rng.uniform(0.0, 0.1, size=B).astype(np.float32)


def _k13_design(codes, xb, bmu, xn, xdim, hexa, alpha, radius, gaussian):
    c, i, v = som_fused_factored_step_tf32x3(
        torch.from_numpy(codes), torch.from_numpy(xb), torch.from_numpy(bmu),
        torch.from_numpy(xn), xdim, hexa, torch.from_numpy(alpha), radius, gaussian)
    return c.numpy(), i.numpy(), v.numpy()


# (xdim, ydim, hexa, tile_n, D, B): one grid row per JAX tile, two rows, a
# rect map of three rows per tile, D 5, a batch over two update chunks with
# a partial one
K13_CASES = [(16, 8, True, 16, 64, 64), (16, 8, True, 32, 5, 100),
             (16, 12, False, 48, 64, 64), (8, 6, True, 48, 37, 70)]


@pytest.mark.parametrize("gaussian", [True, False])
@pytest.mark.parametrize("xdim,ydim,hexa,tile_n,D,B", K13_CASES)
def test_factored_step_tf32x3_meets_k13_gates(xdim, ydim, hexa, tile_n, D, B, gaussian):
    """K13's numeric design (the separable W, W.X per 32-sample chunk by
    three TF32 products, the winners' scores by three) against the JAX
    separable kernel in interpret mode and the plain K13: codebooks within
    1e-5, winners to the 1e-5 gap, values within 1e-4."""
    noc = xdim * ydim
    codes, xb, bmu, xn, alpha = _k13_inputs(noc, D, B, 48, seed=noc + D + gaussian)
    bmu[:3] = -1  # samples without a BMU teach nothing
    c, i, v = _k13_design(codes, xb, bmu, xn, xdim, hexa, alpha, 3.0, gaussian)
    pc, pi, pv = som_fused_factored_step_plain(
        torch.from_numpy(codes.copy()), torch.from_numpy(xb), torch.from_numpy(bmu),
        torch.from_numpy(xn), xdim, hexa, torch.from_numpy(alpha), 3.0, gaussian)
    np.testing.assert_allclose(c, pc.numpy(), rtol=K13_TOL, atol=K13_TOL)
    assert_gap(xn, c, i, pi.numpy())
    np.testing.assert_allclose(v, pv.numpy(), rtol=1e-4, atol=1e-4)
    jbmu = np.where(bmu < 0, 0, bmu).astype(np.int32)  # the TPU kernels take
    jalpha = np.where(bmu < 0, 0.0, alpha).astype(np.float32)  # no bmu < 0
    jc, ji, jv = jps.som_fused_train_step(
        _pad128(codes), _pad128(xb), jnp.asarray(jbmu), _pad128(xn), xdim, hexa,
        jnp.asarray(jalpha), 3.0, gaussian=gaussian, tile_n=tile_n, factored=True)
    np.testing.assert_allclose(c, np.asarray(jc)[:, :D], rtol=K13_TOL, atol=K13_TOL)
    assert_gap(xn, c, i, np.asarray(ji))
    np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-4, atol=1e-4)


def test_factored_step_tf32x3_exact_bubble_boundary_and_ties():
    """The exact bubble boundary (d2 = r^2 through dx = 1.5, dy^2 = 9 *
    0.75): W = 0.5 and x = 1 are exact in TF32, so the unit becomes 0.5
    exactly, bit-equal to the JAX kernel.  Every code three times at alpha 0:
    the rows do not move and the first copy wins each exact tie."""
    xdim, ydim, D = 8, 6, 3
    codes = np.zeros((xdim * ydim, D), np.float32)
    xb = np.ones((1, D), np.float32)
    bmu = np.array([2], np.int32)
    c, _, _ = _k13_design(codes, xb, bmu, xb, xdim, True, np.array([0.5], np.float32),
                          3.0, False)
    np.testing.assert_array_equal(c[3 * xdim + 3], np.full(D, 0.5, np.float32))
    jc, _, _ = jps.som_fused_train_step(
        _pad128(codes), _pad128(xb), jnp.asarray(bmu), _pad128(xb), xdim, True,
        jnp.asarray([0.5], jnp.float32), 3.0, gaussian=False, factored=True)
    np.testing.assert_array_equal(c, np.asarray(jc)[:, :D])
    rng = np.random.default_rng(5)
    base = rng.normal(size=(16, 64)).astype(np.float32)
    codes = np.concatenate([base, base, base])        # 48 rows: 8 x 6
    xb = rng.normal(size=(64, 64)).astype(np.float32)
    xn = base[rng.integers(0, 16, size=40)] + 0.01 * rng.normal(size=(40, 64)).astype(np.float32)
    bmu = rng.integers(0, 48, size=64).astype(np.int32)
    c, i, _ = _k13_design(codes, xb, bmu, xn.astype(np.float32), xdim, True,
                          np.zeros(64, np.float32), 3.0, True)
    np.testing.assert_array_equal(c, codes)
    assert int(i.max()) < 16


def test_factored_step_tf32x3_bf16_codebook_matches_jax():
    """A bf16 codebook through K13's design: rows read upcast, blended in
    float32 (the winners' rows), stored rounded to nearest even; against the
    JAX separable kernel given bf16 codes, to one bf16 ulp, winners to a
    1e-2 gap and values within 1e-4, as test_torch_factored.py holds the
    plain K13."""
    xdim, ydim = 16, 8
    codes, xb, bmu, xn, alpha = _k13_inputs(xdim * ydim, 64, 64, 64, seed=11)
    codes = codes.astype(jnp.bfloat16).astype(np.float32)  # exact in bf16
    c, i, v = som_fused_factored_step_tf32x3(
        torch.from_numpy(codes).to(torch.bfloat16), torch.from_numpy(xb),
        torch.from_numpy(bmu), torch.from_numpy(xn), xdim, True,
        torch.from_numpy(alpha), 3.0, True)
    got = c.to(torch.bfloat16).to(torch.float32).numpy()
    jc, ji, jv = jps.som_fused_train_step(
        _pad128(codes).astype(jnp.bfloat16), _pad128(xb), jnp.asarray(bmu),
        _pad128(xn), xdim, True, jnp.asarray(alpha), 3.0, gaussian=True, tile_n=32,
        factored=True)
    want = np.asarray(jc.astype(jnp.float32))[:, :64]
    diff = np.abs(got - want)
    assert (diff <= 2.0 ** -7 * np.abs(want) + K13_TOL).all(), diff.max()
    assert (diff > 0).mean() <= 0.01
    assert_gap(xn, got, i.numpy(), np.asarray(ji), rel=1e-2)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)
