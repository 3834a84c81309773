"""The numeric design of K17 (`fused_step_skeleton`) and K16
(`f32_winner_probe`) on the tensor cores, on the CPU (the kernels run only on
a card): `ops.tf32x3`'s emulations of their routes against the JAX package's
kernels in interpret mode, the port's plain versions and float64.

K17's route: W.X per 32-sample chunk, each chunk's sums added into float32
totals in batch order, then the rows' scores against x'; float32 operands as
split TF32 (three products), bf16 operands as one TF32 product, a bf16 value
being exact in TF32.  Tolerances are the plain version's against
bench.py's `_skeleton_kernel` (tests/test_torch_probes.py): out within 1e-5
and vmax within 1e-5 relative.

K16's route: K2's split-TF32 body without the norm.  On the probe's integer
inputs (|v| <= 127) it is exact, so it equals the plain version and
tools/int8_probe.py's `kern32` bit for bit; on normal floats it is held
within PROBE_REL (chip_smoke.py's PROBE_F32_REL) of the float64 maximum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl

from som_lvq_pak_torch.ops.skeleton import fused_step_skeleton_plain
from som_lvq_pak_torch.ops.tf32x3 import (f32_winner_probe_tf32x3,
                                          fused_step_skeleton_tf32x3, tf32_round,
                                          tf32_split)
from som_lvq_pak_torch.ops.winner_probe import f32_winner_probe_plain
from test_torch_probes import _bench_skeleton, _int64_max, _probe_kernels

TOL = 1e-5
PROBE_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread, as tests/test_torch_tf32x3.py runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _skeleton_inputs(seed, N, T, B, D, Bn=None, bf16=False):
    """prep_skeleton's inputs: codes normal, W uniform * 0.001, X normal
    (bf16 W and X for the bf16 twin); x' = X unless Bn is given."""
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    dt = torch.bfloat16 if bf16 else torch.float32
    w = torch.from_numpy((rng.uniform(size=(T, B)) * 0.001).astype(np.float32)).to(dt)
    x = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(dt)
    xn = x if Bn is None else torch.from_numpy(
        rng.normal(size=(Bn, D)).astype(np.float32)).to(dt)
    return codes, w, x, xn


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("shape", [(1024, 256, 512, 64, 256), (512, 256, 384, 37, 128)],
                         ids=["4x256_B512_D64", "2x256_B384_D37"])
def test_skeleton_route_matches_bench_kernel(shape, bf16):
    """K17's route against bench.py's `_skeleton_kernel` through its own
    pallas_call in interpret mode (batch chunks of BC, features lane-padded
    to 128), at the bench's scale 1e-30: the rows come back as the codes and
    vmax within 1e-5 relative."""
    N, T, B, D, BC = shape
    codes, w, x, _ = _skeleton_inputs(11 + D + bf16, N, T, B, D, bf16=bf16)
    pad = lambda a: np.pad(a, ((0, 0), (0, 128 - D)))  # noqa: E731
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jx = jnp.asarray(pad(x.float().numpy())).astype(jdt)
    j_out, j_vmax = _bench_skeleton(jnp.asarray(pad(codes.numpy())),
                                    jnp.asarray(w.float().numpy()).astype(jdt), jx, T, BC, D)
    out, vmax = fused_step_skeleton_tf32x3(codes, w, x, x)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out)[:, :D])
    np.testing.assert_allclose(vmax.numpy(), np.asarray(j_vmax)[0], rtol=TOL, atol=0)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("shape", [(300, 7, 70, 5, 33), (512, 256, 1000, 130, 257)],
                         ids=["ragged_D5", "B1000_D130"])
def test_skeleton_route_matches_plain(shape, bf16):
    """K17's route against the plain version at scale 1 (the accumulation
    shows) and at 1e-30, with an x' of its own: out within 1e-5; vmax within
    1e-5 relative of the plain scoring of the route's own rows (bf16: two
    rows equal to 1e-6 may round to neighbouring bf16 values) and, at 1e-30
    (out = codes on both sides) or in float32, of the plain run's."""
    N, T, B, D, Bn = shape
    codes, w, x, xn = _skeleton_inputs(N + D + bf16, N, T, B, D, Bn, bf16)
    for scale in (1.0, 1e-30):
        out, vmax = fused_step_skeleton_tf32x3(codes, w, x, xn, scale)
        op, vp = fused_step_skeleton_plain(codes, w, x, xn, scale)
        np.testing.assert_allclose(out.numpy(), op.numpy(), rtol=TOL, atol=TOL)
        v_own = fused_step_skeleton_plain(out, w, x, xn, 0.0)[1]
        np.testing.assert_allclose(vmax.numpy(), v_own.numpy(), rtol=TOL, atol=0)
        if scale < 1.0 or not bf16:
            np.testing.assert_allclose(vmax.numpy(), vp.numpy(), rtol=TOL, atol=0)


def test_skeleton_route_accumulates_within_the_split_bound():
    """At scale 1 the route's W.X per row sits within split TF32's bound of
    the float64 product: (2^-20 + (K + 2) 2^-24) (|W| @ |X|) with K the
    32-sample chunk, plus the float32 chunk sums over the batch."""
    N, T, B, D = 256, 64, 640, 16
    codes, w, x, xn = _skeleton_inputs(3, N, T, B, D, 40)
    out, _ = fused_step_skeleton_tf32x3(torch.zeros_like(codes), w, x, xn, 1.0)
    w64, x64 = w.double().numpy(), x.double().numpy()
    exact = (w64 @ x64)[np.arange(N) % T]
    mag = (np.abs(w64) @ np.abs(x64))[np.arange(N) % T]
    bound = (2.0 ** -20 + (32 + 2 + B // 32) * 2.0 ** -24) * mag
    assert (np.abs(out.double().numpy() - exact) <= bound).all()


@settings(max_examples=200, deadline=None)
@given(st.lists(st.floats(width=32, min_value=-2.0 ** 60, max_value=2.0 ** 60)
                .filter(lambda v: v == 0 or abs(v) >= 2.0 ** -60), min_size=2, max_size=64))
def test_bf16_values_are_exact_in_tf32(values):
    """Every bf16 value is its own TF32 rounding (8 significant bits within
    TF32's 11), so the split's lo is zero and the one-pass bf16 route takes
    each product exactly: a product of two bf16 values is exact in float32
    (magnitudes in [2^-60, 2^60], where float32 neither overflows nor goes
    subnormal)."""
    b = torch.tensor(values, dtype=torch.float32).to(torch.bfloat16).to(torch.float32)
    hi, lo = tf32_split(b)
    assert torch.equal(tf32_round(b), b) and torch.equal(hi, b)
    assert not bool(lo.any())
    prod = (b[:-1] * b[1:]).double()
    assert torch.equal(prod, b[:-1].double() * b[1:].double())


@pytest.mark.parametrize("shape,dup", [((999, 5, 1000), False), ((300, 64, 257), False),
                                       ((1000, 5, 999), True)])
def test_probe_route_bit_equal_on_integers(shape, dup):
    """K16's route on the probe's integer values, bit for bit equal to the
    plain version and to the NumPy int64 maximum (the shapes of
    test_probe_plain_versions_match_int64, with every row twice too)."""
    N, D, B = shape
    rng = np.random.default_rng(N + D + 1)
    m = rng.integers(-127, 128, size=(N // 2 if dup else N, D)).astype(np.float32)
    if dup:
        m = np.concatenate([m, m])
    x = rng.integers(-127, 128, size=(D, B)).astype(np.float32)
    got = f32_winner_probe_tf32x3(torch.from_numpy(m), torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _int64_max(m, x).astype(np.float32))
    assert torch.equal(got, f32_winner_probe_plain(torch.from_numpy(m), torch.from_numpy(x)))


def test_probe_route_bit_equal_to_kern32(monkeypatch):
    """K16's route against tools/int8_probe.py's `kern32` in interpret mode
    on its grid (256-row tiles, the (1, B) maximum carried across steps),
    bit for bit: three tiles of 64-wide rows against B 384, every row twice."""
    _, kern32 = _probe_kernels(monkeypatch)
    rng = np.random.default_rng(17)
    half = rng.integers(-127, 128, size=(384, 64)).astype(np.float32)
    m = np.concatenate([half, half])
    x = rng.integers(-127, 128, size=(64, 384)).astype(np.float32)
    want = np.asarray(pl.pallas_call(
        kern32, grid=(m.shape[0] // 256,),
        in_specs=[pl.BlockSpec((256, 64), lambda i: (i, 0)),
                  pl.BlockSpec((64, 384), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, 384), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, 384), jnp.float32),
        interpret=True)(jnp.asarray(m), jnp.asarray(x)))[0]
    got = f32_winner_probe_tf32x3(torch.from_numpy(m), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(4096, 64, 512), (999, 130, 300)],
                         ids=["4096x64x512", "999x130x300"])
def test_probe_route_within_gap_on_normal_floats(shape):
    """K16's route on normal floats: within PROBE_REL relative of the
    float64 maximum (the plain version rounds it to float32 once)."""
    N, D, B = shape
    rng = np.random.default_rng(D)
    m = rng.normal(size=(N, D)).astype(np.float32)
    x = rng.normal(size=(D, B)).astype(np.float32)
    got = f32_winner_probe_tf32x3(torch.from_numpy(m), torch.from_numpy(x)).double().numpy()
    want = (m.astype(np.float64) @ x.astype(np.float64)).max(0)
    assert (np.abs(got - want) <= PROBE_REL * np.abs(want)).all()
    plain = f32_winner_probe_plain(torch.from_numpy(m), torch.from_numpy(x)).double().numpy()
    assert (np.abs(got - plain) <= PROBE_REL * np.abs(plain)).all()
