"""The numeric design of the split-TF32 kernels K2 and K3 on the CPU (the
kernels run only on a card): `ops.tf32x3`'s emulation of the split and of
the two fused contractions, against float64, the port's plain versions and
the JAX package's kernels in interpret mode.

Tolerances are chip_smoke.py's K3 gates: codebooks allclose at 1e-4,
winner values at (rtol 1e-4, atol 1e-3), winners equal except where the
two candidates' float64 distances differ by less than 1e-5 relative; K2's
values at 1e-4, its winners to the same 1e-5 gap.  The products' bound is
(2^-20 + (K + 2) 2^-24) (|a| @ |b|): four terms of at most 2^-22 |a b| each
from the split, and the float32 sums of K terms."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.ops import pallas_distance as jpd
from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_torch.ops.dist_argmin import dist_argmin_t_plain
from som_lvq_pak_torch.ops.som_step import som_fused_train_step_plain
from som_lvq_pak_torch.ops.tf32x3 import (dist_argmin_t_tf32x3,
                                          som_fused_train_step_tf32x3, tf32_mm,
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
