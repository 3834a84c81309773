"""The numeric design of K9 (the masked lvq2.1/lvq3 winner pair) and K5 (the
unmasked update of the two-kernel step) on the tensor cores, on the CPU (the
kernels run only on a card): `ops.tf32x3`'s emulations of their routes
against the JAX package's kernels in interpret mode and the port's plain
versions.

K9 runs K4's masked walk with K10's top-2 fold: its emulation
(`dist_top2_masked_tf32x3`) scores as K4's (`dist_argmin_masked_tf32x3`), so
its first pair is K4's bit for bit.  It is held to the JAX `dist_top2` with
a mask and to the plain K9 at tests/test_torch_lvq.py's tolerances: winners
equal except where the two candidates' float64 distances over the kept
components differ by less than 1e-5 relative, values within 1e-5; with every
code two or three times each pair is a code and its copy; a fully masked row
gets (0, 0, 0, 1).  K5 runs K3's update half with the blend: its emulation
(`som_update_tf32x3`, K11's emulation then the guarded blend) is held to the
JAX `som_neighborhood_update_idx` and the plain K5 at
tests/test_torch_masked.py's update tolerance, 1e-5 (float32 sums of at most
a few hundred terms), and is K3's emulation's codebook on the same winners
bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.ops import pallas_distance as jpd
from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_torch.ops.dist_top2 import dist_top2_plain
from som_lvq_pak_torch.ops.som_update import som_neighborhood_update_idx_plain
from som_lvq_pak_torch.ops.tf32x3 import (dist_argmin_masked_tf32x3,
                                          dist_top2_masked_tf32x3,
                                          som_fused_train_step_tf32x3,
                                          som_update_tf32x3)

TOL = 1e-5
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread, as tests/test_torch_tf32x3.py runs the gaussian
    update (a first-parallel-transcendental fault of torch on the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- K9 -------------------------------------------------------------------

def _mask(rng, shape, p=0.2, full_every=7):
    """tests/test_torch_lvq.py's mask: components masked with probability
    p, every full_every-th row masked entirely."""
    m = (rng.random(shape) < p).astype(np.uint8)
    m[::full_every] = 1
    return m


def _top2m_case(B, N, D, copies, seed):
    """x (B, D), codes (N, D) (with copies > 1 every code `copies` times,
    N // copies rows stacked) and a mask."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D)).astype(np.float32)
    if copies > 1:
        base = rng.normal(size=(N // copies, D)).astype(np.float32)
        codes = np.concatenate([base] * copies)
    else:
        codes = rng.normal(size=(N, D)).astype(np.float32)
    return x, codes, _mask(rng, (B, D))


def assert_masked_gap(x, codes, mask, i_got, i_want, rel=TOL):
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


def _assert_pairs(got, mask, N, copies):
    """Distinct codes, ordered values; fully masked rows (0, 0, 0, 1); with
    every code `copies` times, each other row's pair is a first copy and its
    next copy."""
    assert [t.dtype for t in got] == [torch.float32, torch.int32] * 2
    assert (got[1] != got[3]).all() and (got[2] >= got[0]).all()
    full = mask.all(axis=1)
    assert full.any()
    for k, want in enumerate((0, 0, 0, 1)):
        assert (got[k].numpy()[full] == want).all()
    if copies > 1:
        n, i1, i2 = N // copies, got[1].numpy()[~full], got[3].numpy()[~full]
        assert i1.max() < n and (i2 == i1 + n).all()


@pytest.mark.parametrize("B,N,D,dup", [(37, 53, 5, False), (70, 600, 37, False),
                                       (70, 99, 5, True), (129, 130, 37, True),
                                       (20, 2, 5, False)])
def test_dist_top2_masked_tf32x3_matches_jax(B, N, D, dup):
    """test_dist_top2_plain_matches_jax's masked shapes (N not a multiple of
    the JAX tiles, D 5 and 37, every code three times, two codes) against
    the JAX `dist_top2` with a mask in interpret mode: winners to the 1e-5
    gap over the kept components, values within 1e-5; on exact ties the
    JAX indices exactly."""
    x, codes, mask = _top2m_case(B, N, D, 3 if dup else 1, seed=B * N + D)
    got = dist_top2_masked_tf32x3(T(x), T(codes), T(mask))
    ref = jpd.dist_top2(jnp.asarray(x), jnp.asarray(codes), mask=jnp.asarray(mask))
    for k in (1, 3):
        assert_masked_gap(x, codes, mask, got[k].numpy(), np.asarray(ref[k]))
    for k in (0, 2):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=TOL, atol=TOL)
    _assert_pairs(got, mask, N, 3 if dup else 1)
    if dup:
        for k in (1, 3):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("B,N,D,copies", [(300, 999, 5, 1), (256, 777, 37, 1),
                                          (128, 1000, 64, 1), (100, 301, 130, 1),
                                          (300, 998, 5, 2), (128, 1000, 64, 2)])
def test_dist_top2_masked_tf32x3_matches_plain(B, N, D, copies):
    """Against the plain K9 at D 5, a ragged D 37, D 64 and D 130 (K4's
    64-feature slabs on the card), and every code twice: there each pair is
    a code and its copy, the plain version's indices exactly."""
    x, codes, mask = _top2m_case(B, N, D, copies, seed=3 * B + N + D)
    got = dist_top2_masked_tf32x3(T(x), T(codes), T(mask))
    ref = dist_top2_plain(T(x), T(codes), T(mask))
    for k in (1, 3):
        assert_masked_gap(x, codes, mask, got[k].numpy(), ref[k].numpy())
    for k in (0, 2):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=TOL, atol=TOL)
    _assert_pairs(got, mask, N, copies)
    if copies > 1:
        for k in (1, 3):
            np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy())


@pytest.mark.parametrize("B,N,D,copies", [(37, 53, 5, 1), (70, 600, 37, 1),
                                          (200, 130, 64, 1), (90, 300, 130, 1),
                                          (70, 99, 5, 3), (129, 130, 37, 2),
                                          (20, 2, 5, 1)])
def test_dist_top2_masked_tf32x3_first_pair_is_k4s(B, N, D, copies):
    """K9's first pair is K4's (value, index) bit for bit: both walk the
    same scores, so a top-2 fold that loses the best pair shows here."""
    x, codes, mask = _top2m_case(B, N, D, copies, seed=B * N + D + 5)
    got = dist_top2_masked_tf32x3(T(x), T(codes), T(mask))
    v, i = dist_argmin_masked_tf32x3(T(x), T(codes), T(mask))
    np.testing.assert_array_equal(got[1].numpy(), i.numpy())
    np.testing.assert_array_equal(got[0].numpy().view(np.int32), v.numpy().view(np.int32))
    _assert_pairs(got, mask, N, copies)


def test_dist_top2_masked_tf32x3_every_row_masked():
    """Every component of every sample masked: each sample scores 0 against
    every code and gets (0, 0, 0, 1), as the plain version and the JAX
    kernel."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(40, 9)).astype(np.float32)
    codes = rng.normal(size=(70, 9)).astype(np.float32)
    mask = np.ones(x.shape, np.uint8)
    got = dist_top2_masked_tf32x3(T(x), T(codes), T(mask))
    ref = jpd.dist_top2(jnp.asarray(x), jnp.asarray(codes), mask=jnp.asarray(mask))
    plain = dist_top2_plain(T(x), T(codes), T(mask))
    for k, want in enumerate((0, 0, 0, 1)):
        assert (got[k].numpy() == want).all()
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
        np.testing.assert_array_equal(got[k].numpy(), plain[k].numpy())


# -- K5 -------------------------------------------------------------------

def _update_inputs(xdim, ydim, D, B, seed):
    """tests/test_torch_masked.py's update inputs: three samples without a
    BMU, per-sample alphas in [0, 0.1)."""
    rng = np.random.default_rng(seed)
    noc = xdim * ydim
    codes = rng.normal(size=(noc, D)).astype(np.float32)
    xb = rng.normal(size=(B, D)).astype(np.float32)
    bmu = rng.integers(0, noc, size=B).astype(np.int32)
    bmu[:3] = -1  # samples without a BMU teach nothing
    alpha = rng.uniform(0.0, 0.1, size=B).astype(np.float32)
    return codes, xb, bmu, alpha


def _k5_tf32x3(codes, xb, bmu, xdim, hexa, alpha, radius, gaussian):
    c = T(codes.copy())
    out = som_update_tf32x3(c, T(xb), T(bmu), xdim, hexa,
                            T(alpha) if isinstance(alpha, np.ndarray) else alpha,
                            radius, gaussian)
    np.testing.assert_array_equal(c.numpy(), codes)  # the input is not changed
    assert out.dtype == torch.float32
    return out.numpy()


@pytest.mark.parametrize("tiles", [None, (16, 32)])
@pytest.mark.parametrize("xdim,ydim,hexa,gaussian,radius", [
    (9, 7, True, True, 2.5),     # ragged: 63 rows
    (10, 8, True, False, 3.0),   # hexa bubble: exact-boundary pairs at r=3
    (12, 8, False, False, 3.0),
    (8, 6, False, True, 3.0),
])
def test_update_tf32x3_matches_jax(xdim, ydim, hexa, gaussian, radius, tiles):
    """K5's numeric design (K3's update half: W.X by three TF32 products
    summed per 32-sample chunk, then the blend) against the JAX update at
    test_update_matches_jax's shapes (B 48: a whole chunk and a partial
    one) and tolerance; tiles (16, 32) makes the JAX kernel accumulate over
    several batch tiles and code tiles."""
    D, B = 5, 48
    codes, xb, bmu, alpha = _update_inputs(xdim, ydim, D, B, seed=xdim * ydim)
    got = _k5_tf32x3(codes, xb, bmu, xdim, hexa, alpha, radius, gaussian)
    kw = {} if tiles is None else dict(tile_b=tiles[0], tile_n=tiles[1])
    ref = jps.som_neighborhood_update_idx(
        jnp.asarray(codes), jnp.asarray(xb), jnp.asarray(bmu), xdim, hexa,
        jnp.asarray(alpha), radius, gaussian=gaussian, **kw)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=TOL, atol=TOL)
    assert not np.allclose(got, codes, atol=1e-3)  # the update did something


@pytest.mark.parametrize("xdim,ydim,hexa,gaussian,D,B,radius", [
    (12, 8, True, False, 5, 1000, 3.0), (10, 6, True, True, 37, 100, 3.0),
    (16, 16, True, True, 64, 300, 4.0), (16, 16, False, True, 200, 256, 4.0)])
def test_update_tf32x3_matches_plain(xdim, ydim, hexa, gaussian, D, B, radius):
    """At D 5, a ragged D 37 on a ragged map, K5's main-path width D 64 and
    D 200 (past 128: K3's 64-row CTAs on the card), against the plain
    float32 update at 1e-5."""
    codes, xb, bmu, alpha = _update_inputs(xdim, ydim, D, B, seed=D + B)
    got = _k5_tf32x3(codes, xb, bmu, xdim, hexa, alpha, radius, gaussian)
    want = som_neighborhood_update_idx_plain(
        T(codes.copy()), T(xb), T(bmu), xdim, hexa, T(alpha), radius,
        gaussian).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("xdim,ydim,hexa,gaussian", [
    (9, 7, True, True), (10, 8, True, False), (12, 8, False, False),
    (8, 6, False, True)])
def test_update_tf32x3_equals_k3_rows(xdim, ydim, hexa, gaussian, per_sample):
    """K5 is K3's update half with K3's blend: on the same winners its
    codebook is K3's emulation's bit for bit (any next batch), with samples
    without a BMU and a scalar or per-sample alpha; B 100 is three whole
    32-sample chunks and a partial one."""
    D, B = 37, 100
    codes, xb, bmu, alpha = _update_inputs(xdim, ydim, D, B, seed=5 * xdim + ydim)
    a = alpha if per_sample else 0.04
    got = _k5_tf32x3(codes, xb, bmu, xdim, hexa, a, 3.0, gaussian)
    xn = np.random.default_rng(1).normal(size=(17, D)).astype(np.float32)
    k3, _, _ = som_fused_train_step_tf32x3(T(codes), T(xb), T(bmu), T(xn), xdim, hexa,
                                           T(alpha) if per_sample else a, 3.0,
                                           gaussian)
    np.testing.assert_array_equal(got.view(np.int32), k3.numpy().view(np.int32))


def test_update_tf32x3_exact_bubble_boundary():
    """dx = 1.5, dy = 3 sqrt(0.75), r = 3: d2 = r^2 exactly, so the unit is
    inside the bubble; W = 0.5 is exact in TF32, so the split sums give the
    JAX kernel's codebook bit for bit."""
    xdim, ydim, D = 8, 6, 3
    codes = np.zeros((xdim * ydim, D), np.float32)
    xb = np.ones((1, D), np.float32)
    bmu = np.array([2], np.int32)               # column 2, row 0
    got = _k5_tf32x3(codes, xb, bmu, xdim, True, 0.5, 3.0, False)
    np.testing.assert_array_equal(got[3 * xdim + 3], [0.5, 0.5, 0.5])
    ref = jps.som_neighborhood_update_idx(
        jnp.asarray(codes), jnp.asarray(xb), jnp.asarray(bmu), xdim, True, 0.5, 3.0,
        gaussian=False)
    np.testing.assert_array_equal(got, np.asarray(ref))


# -- the A/B tool's winner digests ----------------------------------------

@pytest.mark.parametrize("B,N,D", [(50, 99, 37), (130, 70, 130)])
def test_fused_step_ab_winner_digests_repeat_on_the_cpu(B, N, D):
    """`tools.fused_step_ab`'s winner cases on the CPU (the plain K4, K9, K8
    and K10): K4, K9, K8 and K10 at k 1, 2, 5, 8 and 16 are timed and
    digested, and a second run on the same seed gives the same digests, so
    equal digests across trees mean equal floats."""
    from som_lvq_pak_torch.tools import fused_step_ab

    one, two = (fused_step_ab.run_winners(B, N, D, torch.device("cpu"), iters=1)
                for _ in range(2))
    names = ("k4", "k9", "k8", "k10_k1", "k10_k2", "k10_k5", "k10_k8", "k10_k16")
    assert sorted(k[:-len("_digest")] for k in one if k.endswith("_digest")) == sorted(names)
    for name in names:
        assert len(one[f"{name}_digest"]) == 64 and one[f"{name}_ms"] > 0
        assert one[f"{name}_digest"] == two[f"{name}_digest"]
