"""The LVQ steps' fixed-order segment sum (`ops.segment_sum`) on the CPU: the
plain version (index_add_) bit-equal to `jax.ops.segment_sum` and
`np.add.at`, the kernel's order (a stable sort of the ids, then each run
walked in sample order from 0.0) bit-equal to them too, and the LVQ steps
that take their updates from it.  The kernel itself runs on a card only
(chip_smoke.py holds it bit-equal to np.add.at there).

All comparisons are bit for bit: every path adds each segment's rows in
ascending sample order, starting from 0.0, in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_torch.models.fast import olvq1_batch_step
from som_lvq_pak_torch.ops.segment_sum import segment_sum, segment_sum_plain


def _case(kind, B, D, noc, seed):
    """Rows of mixed scale and segment ids: `spread` draws ids uniformly
    over half the segments (the rest empty), `hot` puts most rows in one
    segment, `few` uses three segments of a thousand."""
    rng = np.random.default_rng(seed)
    shape = (B,) if D is None else (B, D)
    rows = (rng.normal(size=shape) * np.exp2(rng.integers(-30, 30, size=shape)))
    rows = rows.astype(np.float32)
    rows[rng.random(shape) < 0.05] = -0.0
    if kind == "spread":
        seg = rng.integers(0, noc // 2, size=B) * 2
    elif kind == "hot":
        seg = np.where(rng.random(B) < 0.9, min(7, noc - 1), rng.integers(0, noc, size=B))
    else:
        seg = rng.choice(np.array([1, noc // 2, noc - 1]), size=B)
    return rows, seg.astype(np.int64)


def _numpy(rows, seg, noc):
    out = np.zeros((noc,) + rows.shape[1:], np.float32)
    np.add.at(out, seg, rows)
    return out


def _kernel_order(rows, seg, noc):
    """The kernel's order on the host: a stable sort of the ids, then each
    segment's run summed in sorted (sample) order from 0.0 in float32."""
    perm = np.argsort(seg, kind="stable")
    sid = seg[perm]
    flat = rows.reshape(rows.shape[0], -1)
    out = np.zeros((noc, flat.shape[1]), np.float32)
    for n in np.unique(sid):
        lo, hi = np.searchsorted(sid, n, "left"), np.searchsorted(sid, n, "right")
        run = np.concatenate([np.zeros((1, flat.shape[1]), np.float32),
                              flat[perm[lo:hi]]])
        out[n] = np.cumsum(run, axis=0, dtype=np.float32)[-1]  # one add at a time
    return out.reshape((noc,) + rows.shape[1:])


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("kind", ["spread", "hot", "few"])
@pytest.mark.parametrize("B,D,noc", [(4096, 16, 64), (1024, 64, 4096), (777, None, 300),
                                     (300, 5, 2)])
def test_segment_sum_plain_bit_equal_to_jax_and_numpy(kind, B, D, noc):
    rows, seg = _case(kind, B, D, noc, seed=B + noc)
    got = segment_sum_plain(torch.from_numpy(rows), torch.from_numpy(seg), noc).numpy()
    want = _numpy(rows, seg, noc)
    jax_out = np.asarray(jax.ops.segment_sum(jnp.asarray(rows), jnp.asarray(seg),
                                             num_segments=noc))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(jax_out), _bits(want))
    # the wrapper takes the plain version on a CPU tensor, int32 ids too
    wrapped = segment_sum(torch.from_numpy(rows), torch.from_numpy(seg.astype(np.int32)),
                          noc).numpy()
    np.testing.assert_array_equal(_bits(wrapped), _bits(want))


@pytest.mark.parametrize("kind", ["spread", "hot", "few"])
@pytest.mark.parametrize("B,D,noc", [(2048, 8, 128), (500, None, 50)])
def test_kernel_order_bit_equal_to_numpy(kind, B, D, noc):
    """The order the kernel sums in (sorted runs, each from 0.0 in sample
    order) gives np.add.at's floats bit for bit, empty segments 0 and -0
    rows adding to +0."""
    rows, seg = _case(kind, B, D, noc, seed=3 * B + noc)
    np.testing.assert_array_equal(_bits(_kernel_order(rows, seg, noc)),
                                  _bits(_numpy(rows, seg, noc)))


def test_a_different_order_differs():
    """The test data can tell orders apart: the same rows summed in reverse
    sample order give other floats."""
    rows, seg = _case("hot", 4096, 16, 64, seed=9)
    fwd = _numpy(rows, seg, 64)
    rev = _numpy(rows[::-1].copy(), seg[::-1].copy(), 64)
    assert (_bits(fwd) != _bits(rev)).any()


def test_segment_sum_checks_its_arguments():
    rows = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        segment_sum(rows, torch.zeros(5, dtype=torch.int64), 2)
    with pytest.raises(TypeError):
        segment_sum(rows.double(), torch.zeros(4, dtype=torch.int64), 2)
    with pytest.raises(TypeError):
        segment_sum(rows, torch.zeros(4), 2)
    with pytest.raises(ValueError):
        segment_sum(rows, torch.zeros(4, dtype=torch.int64), 0)


@pytest.mark.parametrize("masked", [False, True])
def test_olvq1_step_sums_equal_three_separate_segment_sums(masked):
    """olvq1's update and its two hit counts share one segment sum as the
    columns of one array: the codebook and the alphas equal those of three
    separate sums (the JAX step's form) bit for bit."""
    rng = np.random.default_rng(4)
    noc, B, D = 40, 256, 7
    codes = rng.normal(size=(noc, D)).astype(np.float32)
    labels = rng.integers(0, 3, size=noc).astype(np.int32)
    alphas = rng.uniform(0.01, 0.3, size=noc).astype(np.float32)
    xb = rng.normal(size=(B, D)).astype(np.float32)
    xl = rng.integers(0, 3, size=B).astype(np.int32)
    mask = (rng.random((B, D)) < 0.2).astype(np.uint8) if masked else None
    T = torch.from_numpy
    got, got_a = olvq1_batch_step(T(codes.copy()), T(labels), T(alphas), T(xb), T(xl),
                                  mask=None if mask is None else T(mask))
    # the same step with three separate sums
    from som_lvq_pak_torch.ops.dist_argmin import dist_argmin

    _, bmu = dist_argmin(T(xb), T(codes), mask=None if mask is None else T(mask))
    bmu = bmu.long()
    c, a = T(codes), T(alphas)
    correct = T(labels)[bmu] == T(xl)
    sa = a[bmu]
    delta = torch.where(correct, sa, -sa)[:, None] * (T(xb) - c[bmu])
    if mask is not None:
        delta = torch.where(T(mask) != 0, 0.0, delta)
    upd = segment_sum_plain(delta, bmu, noc)
    nc = segment_sum_plain(correct.float(), bmu, noc)
    nw = segment_sum_plain((~correct).float(), bmu, noc)
    new_a = a / (1.0 + nc * a)
    denom = 1.0 - nw * new_a
    ok = denom > 1e-6
    clip = torch.tensor(0.3)
    grown = torch.where(ok, new_a / torch.where(ok, denom, 1.0), clip)
    new_a = torch.where(nw > 0, torch.minimum(grown, clip), new_a)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits((c + upd).numpy()))
    np.testing.assert_array_equal(_bits(got_a.numpy()), _bits(new_a.numpy()))
