"""The numeric design of K8 (the lvq2.1/lvq3 winner pair) and K7 (K training
steps per launch) on the tensor cores, on the CPU (the kernels run only on a
card): `ops.tf32x3`'s emulations of their routes against the JAX package's
kernels in interpret mode and the port's plain versions.

K8 runs K1's split-TF32 body with a top-2 fold: its emulation
(`dist_top2_tf32x3`) scores as K1's (`dist_argmin_tf32x3`) and its first pair
is K1's bit for bit.  It is held to the JAX `dist_top2` and the plain K8 at
tests/test_torch_lvq.py's tolerances: winners equal except where the two
candidates' float64 distances differ by less than 1e-5 relative, values
within 1e-5; exact ties (every code two or three times) resolve to the same
indices.  K7 runs K3's step body on the resident codebook: its emulation
(`som_vmem_train_steps_tf32x3`) is K chained K3 emulations, held to the JAX
`som_vmem_train_steps` and the plain K7 at tests/test_torch_vmem.py's: one
launch's codebooks within 1e-5, winners to the 1e-5 gap."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.ops import pallas_distance as jpd
from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_torch.ops.dist_top2 import dist_top2_plain
from som_lvq_pak_torch.ops.som_vmem import som_vmem_train_steps_plain
from som_lvq_pak_torch.ops.tf32x3 import (dist_argmin_tf32x3, dist_top2_tf32x3,
                                          som_fused_train_step_tf32x3,
                                          som_vmem_train_steps_tf32x3)

TOL = 1e-5
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread, as tests/test_torch_tf32x3.py runs the gaussian
    step (a first-parallel-transcendental fault of torch on the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_gap(x, codes, i_got, i_want, rel=TOL):
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


# -- K8 -------------------------------------------------------------------

def _top2_case(B, N, D, copies, seed):
    """x (B, D) and codes (N, D); with copies > 1 every code `copies` times
    (N // copies rows, stacked)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D)).astype(np.float32)
    if copies > 1:
        base = rng.normal(size=(N // copies, D)).astype(np.float32)
        codes = np.concatenate([base] * copies)
    else:
        codes = rng.normal(size=(N, D)).astype(np.float32)
    return x, codes


def _assert_copies(got, N, copies):
    """Every code `copies` times: the best is a first copy, the second its
    next copy."""
    n = N // copies
    i1, i2 = got[1].numpy(), got[3].numpy()
    assert i1.max() < n and (i2 == i1 + n).all()


@pytest.mark.parametrize("B,N,D,copies", [(37, 53, 5, 1), (70, 600, 37, 1),
                                          (200, 130, 64, 1), (90, 300, 130, 1),
                                          (70, 99, 5, 3), (129, 130, 37, 2),
                                          (20, 2, 5, 1)])
def test_dist_top2_tf32x3_first_pair_is_k1s(B, N, D, copies):
    """K8's first pair is K1's (val, idx) bit for bit: both score the same
    floats, so a top-2 fold that loses the best pair shows here."""
    x, codes = _top2_case(B, N, D, copies, seed=B * N + D)
    got = dist_top2_tf32x3(T(x), T(codes))
    v, i = dist_argmin_tf32x3(T(x), T(codes))
    assert [t.dtype for t in got] == [torch.float32, torch.int32] * 2
    np.testing.assert_array_equal(got[1].numpy(), i.numpy())
    np.testing.assert_array_equal(got[0].numpy().view(np.int32), v.numpy().view(np.int32))
    assert (got[1] != got[3]).all()
    assert (got[2] >= got[0]).all()
    if copies > 1:
        _assert_copies(got, N, copies)


@pytest.mark.parametrize("B,N,D,dup", [(37, 53, 5, False), (70, 600, 37, False),
                                       (70, 99, 5, True), (129, 130, 37, True),
                                       (20, 2, 5, False)])
def test_dist_top2_tf32x3_matches_jax(B, N, D, dup):
    """tests/test_torch_lvq.py's K8 shapes (N not a multiple of the JAX
    tiles, D 5 and 37, every code three times, two codes) against the JAX
    `dist_top2` in interpret mode."""
    x, codes = _top2_case(B, N, D, 3 if dup else 1, seed=B * N + D + 1)
    got = dist_top2_tf32x3(T(x), T(codes))
    ref = jpd.dist_top2(jnp.asarray(x), jnp.asarray(codes))
    for k in (1, 3):
        assert_gap(x, codes, got[k].numpy(), np.asarray(ref[k]))
    for k in (0, 2):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=TOL, atol=TOL)
    if dup:
        _assert_copies(got, N, 3)
        for k in (1, 3):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("B,N,D,copies", [(300, 999, 5, 1), (256, 777, 37, 1),
                                          (128, 1000, 64, 1), (100, 301, 130, 1),
                                          (300, 998, 5, 2), (128, 1000, 64, 2)])
def test_dist_top2_tf32x3_matches_plain(B, N, D, copies):
    """Against the plain K8 at D 5, a ragged D 37, D 64 and D 130 (K8's
    64-feature slabs), and every code twice: there each pair is a code and
    its copy, the plain version's indices exactly."""
    x, codes = _top2_case(B, N, D, copies, seed=3 * B + N + D)
    got = dist_top2_tf32x3(T(x), T(codes))
    ref = dist_top2_plain(T(x), T(codes))
    for k in (1, 3):
        assert_gap(x, codes, got[k].numpy(), ref[k].numpy())
    for k in (0, 2):
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=TOL, atol=TOL)
    if copies > 1:
        _assert_copies(got, N, copies)
        for k in (1, 3):
            np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy())


# -- K7 -------------------------------------------------------------------

VMEM_CASES = [(xdim, ydim, hexa, gaussian, chained, per_sample)
              for xdim, ydim, hexa in ((8, 6, True), (8, 8, False))
              for gaussian in (True, False)
              for chained in (False, True)
              for per_sample in (False, True)]


def _vmem_inputs(noc, K, B, D, chained, per_sample, seed):
    """tests/test_torch_vmem.py's group: codes, K batches, next_first (or
    None), the first batch's winners, alphas small enough that no bubble
    unit's weight mass passes 1, a decaying radius."""
    rng = np.random.default_rng(seed)
    codes = rng.normal(size=(noc, D)).astype(np.float32)
    xs = rng.normal(size=(K, B, D)).astype(np.float32)
    nf = rng.normal(size=(B, D)).astype(np.float32) if chained else None
    d0 = ((xs[0][:, None, :] - codes[None]) ** 2).sum(-1)
    bmu0 = np.argmin(d0, axis=1).astype(np.int32)
    alphas = (rng.uniform(0.001, 0.012, size=(K, B)) if per_sample
              else np.linspace(0.012, 0.004, K)).astype(np.float32)
    radii = np.linspace(3.0, 1.5, K).astype(np.float32)
    return codes, xs, nf, bmu0, alphas, radii


def _vmem_tf32x3(codes, xs, nf, bmu0, alphas, radii, xdim, hexa, gaussian):
    c = T(codes.copy())
    out, bmu = som_vmem_train_steps_tf32x3(c, T(xs), T(bmu0), T(alphas), T(radii),
                                           xdim, hexa, gaussian,
                                           next_first=None if nf is None else T(nf))
    np.testing.assert_array_equal(c.numpy(), codes)  # the input is not changed
    assert bmu.dtype == torch.int32
    return out.numpy(), bmu.numpy()


@pytest.mark.parametrize("xdim,ydim,hexa,gaussian,chained,per_sample", VMEM_CASES)
def test_vmem_steps_tf32x3_matches_jax(xdim, ydim, hexa, gaussian, chained,
                                       per_sample):
    """tests/test_torch_vmem.py's K = 5 steps of B = 64 at D = 7 against the
    JAX kernel (D padded to 128 for JAX only), hexa and rect maps, gaussian
    and bubble, scalar and per-sample alphas, with and without next_first."""
    K, B, D = 5, 64, 7
    noc = xdim * ydim
    codes, xs, nf, bmu0, alphas, radii = _vmem_inputs(
        noc, K, B, D, chained, per_sample, seed=noc + 2 * chained + per_sample)
    out, bmu = _vmem_tf32x3(codes, xs, nf, bmu0, alphas, radii, xdim, hexa, gaussian)

    def pad(a):
        return jnp.zeros(a.shape[:-1] + (128,), jnp.float32).at[..., :D].set(a)

    ref, jbmu = jps.som_vmem_train_steps(
        pad(codes), pad(xs), jnp.asarray(bmu0), jnp.asarray(alphas),
        jnp.asarray(radii), xdim, hexa, gaussian=gaussian,
        next_first=None if nf is None else pad(nf))
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref[:, :D], rtol=TOL, atol=TOL)
    assert not np.allclose(out, codes, atol=1e-3)  # the steps did something
    assert_gap(xs[-1] if nf is None else nf, out, bmu, np.asarray(jbmu))


@pytest.mark.parametrize("xdim,ydim,hexa,gaussian,chained,per_sample", VMEM_CASES)
def test_vmem_steps_tf32x3_matches_plain(xdim, ydim, hexa, gaussian, chained,
                                         per_sample):
    """Against the plain K7 (K chained plain K3 steps) at a ragged group: K =
    9 steps of B = 100 (three whole 32-sample chunks and a partial one) at
    D = 37; the emulation is K chained K3 emulations, step for step."""
    K, B, D = 9, 100, 37
    noc = xdim * ydim
    codes, xs, nf, bmu0, alphas, radii = _vmem_inputs(
        noc, K, B, D, chained, per_sample, seed=7 * noc + 2 * chained + per_sample)
    out, bmu = _vmem_tf32x3(codes, xs, nf, bmu0, alphas, radii, xdim, hexa, gaussian)
    ref, pbmu = som_vmem_train_steps_plain(T(codes.copy()), T(xs), T(bmu0), T(alphas),
                                           T(radii), xdim, hexa, gaussian,
                                           next_first=None if nf is None else T(nf))
    np.testing.assert_allclose(out, ref.numpy(), rtol=TOL, atol=TOL)
    assert_gap(xs[-1] if nf is None else nf, out, bmu, pbmu.numpy())
    # the chain, step for step: K3's emulation K times
    c, b = T(codes), T(bmu0)
    for t in range(K):
        xn = T(xs[t + 1]) if t + 1 < K else (T(xs[-1]) if nf is None else T(nf))
        c, b, _ = som_fused_train_step_tf32x3(c, T(xs[t]), b, xn, xdim, hexa,
                                              T(alphas[t]) if per_sample
                                              else float(alphas[t]),
                                              float(radii[t]), gaussian)
    np.testing.assert_array_equal(out.view(np.int32), c.numpy().view(np.int32))
    np.testing.assert_array_equal(bmu, b.numpy())
