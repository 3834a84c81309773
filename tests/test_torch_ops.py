"""The port's winner search and fused SOM step (plain PyTorch versions, which
the CPU runs) against the JAX package's Pallas kernels in interpret mode.

Tolerances: winners equal except at near-ties, where the two candidates'
float64 distances differ by less than 1e-5 relative (the two packages sum
in different orders, so float32 rounding may flip such a tie); values and
codebooks allclose at 1e-5 (float32 sums of at most a few hundred terms)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.ops import pallas_distance as jpd
from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_torch.ops.dist_argmin import dist_argmin, dist_argmin_t
from som_lvq_pak_torch.ops.distance import find_winners
from som_lvq_pak_torch.ops.som_step import som_fused_train_step

TOL = 1e-5


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


def _pad128(a):
    """Lane-pad features to 128 for the JAX kernels only."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(np.pad(a, ((0, 0), (0, -a.shape[1] % 128))))


def assert_winners_agree(x, codes, i_port, i_ref):
    i_port = np.asarray(i_port, np.int64)
    i_ref = np.asarray(i_ref, np.int64)
    bad = np.nonzero(i_port != i_ref)[0]
    if bad.size:
        x64 = np.asarray(x, np.float64)[bad]
        c64 = np.asarray(codes, np.float64)
        da = ((x64 - c64[i_port[bad]]) ** 2).sum(-1)
        db = ((x64 - c64[i_ref[bad]]) ** 2).sum(-1)
        gap = np.abs(da - db) / np.maximum(np.maximum(da, db), 1e-30)
        assert gap.max() < TOL, (bad, gap)
    return bad.size


def _case(B, N, D, seed, dup):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D)).astype(np.float32)
    if dup:  # every row three times: the lowest index must win
        base = rng.normal(size=(N // 3, D)).astype(np.float32)
        codes = np.concatenate([base, base, base])
    else:
        codes = rng.normal(size=(N, D)).astype(np.float32)
    return x, codes


@pytest.mark.parametrize("B,N,D,dup", [(37, 53, 5, False), (200, 130, 64, False),
                                       (70, 99, 5, True), (129, 300, 64, True)])
@pytest.mark.parametrize("form", ["classic", "max_score"])
def test_dist_argmin_matches_jax(B, N, D, dup, form):
    x, codes = _case(B, N, D, seed=B + N, dup=dup)
    port, ref = ((dist_argmin, jpd.dist_argmin) if form == "classic"
                 else (dist_argmin_t, jpd.dist_argmin_t))
    v, i = port(torch.from_numpy(x), torch.from_numpy(codes))
    jv, ji = ref(_pad128(x), _pad128(codes))
    assert i.dtype == torch.int32 and v.dtype == torch.float32
    assert_winners_agree(x, codes, i.numpy(), ji)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)
    if dup:
        assert int(i.max()) < N // 3
    # and against the plain expanded-form reference of ops.distance
    wi, wv = find_winners(torch.from_numpy(x), torch.from_numpy(codes))
    assert_winners_agree(x, codes, i.numpy(), wi.numpy())


def _step_inputs(xdim, ydim, D, B, Bn, seed):
    rng = np.random.default_rng(seed)
    noc = xdim * ydim
    codes = rng.normal(size=(noc, D)).astype(np.float32)
    xb = rng.normal(size=(B, D)).astype(np.float32)
    xn = rng.normal(size=(Bn, D)).astype(np.float32)
    bmu = rng.integers(0, noc, size=B).astype(np.int32)
    bmu[:3] = -1  # samples without a BMU teach nothing
    alpha = rng.uniform(0.0, 0.1, size=B).astype(np.float32)
    return codes, xb, xn, bmu, alpha


def _port_step(codes, xb, bmu, xn, xdim, hexa, alpha, radius, gaussian):
    """K3's plain version (factored=False: the geometries below that the
    separable kernels accept would otherwise take K13)."""
    c = torch.from_numpy(codes.copy())
    out, i, v = som_fused_train_step(c, torch.from_numpy(xb), torch.from_numpy(bmu),
                                     torch.from_numpy(xn), xdim, hexa,
                                     torch.from_numpy(alpha), radius, gaussian,
                                     factored=False)
    assert out.data_ptr() == c.data_ptr()  # updated in place
    return out.numpy(), i.numpy(), v.numpy()


@pytest.mark.parametrize("xdim,ydim,hexa,gaussian,radius", [
    (10, 6, True, True, 3.0),    # ragged: 60 rows is no multiple of a tile
    (10, 8, True, False, 3.0),   # hexa bubble: exact-boundary pairs at r=3
    (12, 8, False, False, 3.0),
    (9, 7, False, True, 2.5),
])
def test_fused_step_matches_jax_plain_kernel(xdim, ydim, hexa, gaussian, radius):
    D = 5
    codes, xb, xn, bmu, alpha = _step_inputs(xdim, ydim, D, 48, 40, seed=xdim * ydim)
    c, i, v = _port_step(codes, xb, bmu, xn, xdim, hexa, alpha, radius, gaussian)
    jc, ji, jv = jps.som_fused_train_step(
        _pad128(codes), _pad128(xb), jnp.asarray(bmu), _pad128(xn), xdim, hexa,
        jnp.asarray(alpha), radius, gaussian=gaussian, factored=False)
    np.testing.assert_allclose(c, np.asarray(jc)[:, :D], rtol=TOL, atol=TOL)
    assert_winners_agree(xn, c, i, ji)
    np.testing.assert_allclose(v, np.asarray(jv), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("gaussian", [True, False])
@pytest.mark.parametrize("tile_n", [16, 32])
def test_fused_step_matches_jax_factored_kernel(gaussian, tile_n):
    """The separable TPU kernel computes the same step (16x8 hexa map; tile
    16 is one grid row per tile, tile 32 two).  That kernel takes no
    bmu < 0 (the JAX trainer never gives it one), so those samples carry
    alpha 0 here instead."""
    xdim, ydim, D = 16, 8, 64
    assert jps._factored_geometry_ok(xdim * ydim, xdim, tile_n, True)
    codes, xb, xn, bmu, alpha = _step_inputs(xdim, ydim, D, 64, 64, seed=tile_n)
    alpha[bmu < 0] = 0.0
    bmu[bmu < 0] = 5
    c, i, v = _port_step(codes, xb, bmu, xn, xdim, True, alpha, 3.0, gaussian)
    jc, ji, _ = jps.som_fused_train_step(
        _pad128(codes), _pad128(xb), jnp.asarray(bmu), _pad128(xn), xdim, True,
        jnp.asarray(alpha), 3.0, gaussian=gaussian, tile_n=tile_n,
        factored=True)
    np.testing.assert_allclose(c, np.asarray(jc)[:, :D], rtol=TOL, atol=TOL)
    assert_winners_agree(xn, c, i, ji)


def test_fused_step_exact_bubble_boundary():
    """dx = 1.5, dy = 3 sqrt(0.75), r = 3: d2 = r^2 exactly, so the unit is
    inside the bubble (the exact-f32 grid algebra decides it)."""
    xdim, ydim, D = 8, 6, 3
    noc = xdim * ydim
    codes = np.zeros((noc, D), np.float32)
    xb = np.ones((1, D), np.float32)
    bmu = np.array([2], np.int32)               # column 2, row 0
    c, _, _ = _port_step(codes, xb, bmu, xb, xdim, True,
                         np.array([0.5], np.float32), 3.0, False)
    inside = 3 * xdim + 3                        # row 3 (odd): x = 3.5
    np.testing.assert_array_equal(c[inside], np.full(D, 0.5, np.float32))
    jc, _, _ = jps.som_fused_train_step(
        _pad128(codes), _pad128(xb), jnp.asarray(bmu), _pad128(xb), xdim, True,
        jnp.float32(0.5), 3.0, gaussian=False, factored=False)
    np.testing.assert_array_equal(c, np.asarray(jc)[:, :D])
