"""K9 on K4's Hopper walk (csrc/argmin_masked_sm90.cu's masked_top2_sm90_kernel)
and K6 on K3's (csrc/som_update_masked_sm90.cu), the parts the CPU reaches.

K9: a NumPy re-enactment of its fold, K8's top-2 fold on K4's 64-code tiles
and `k4_sm90_spans`, over the scores of K4's two sums, bit-equal to
`dist_top2_masked_tf32x3` on codebooks full of exact ties, with fully masked
rows: the fold keeps the lexicographically smallest (value, index) pairs of
the same floats, so nothing may differ.

K6: its prologue's plain version (`split_k6_plain`: X o K split into TF32 hi
and lo and K, transposed, and K3's per-sample table) bit for bit against
`tf32_split` and `split_sm90_plain`'s table; an emulation of its walk (W from
the prologue's table by the closed form, per feature slab of
`ops.som_update.k6_slabs`, per 32-sample chunk, the five products' sums in
their order) bit-equal to `som_update_masked_tf32x3` and within 1e-5 (the
masked update's tolerance, tests/test_torch_masked.py) of the JAX
`som_neighborhood_update_idx(mask=...)` and of the plain K6; the slabs cover
every feature once.  The A/B tool's update cases run on the CPU and repeat.
Inputs from NumPy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_torch.ops import dist_argmin as da
from som_lvq_pak_torch.ops.distance import keep_of
from som_lvq_pak_torch.ops.som_step import guarded_blend, neighborhood_w
from som_lvq_pak_torch.ops.som_update import (k6_scratch, k6_slabs,
                                              som_neighborhood_update_idx_plain)
from som_lvq_pak_torch.ops.tf32x3 import (CHUNK, dist_top2_masked_tf32x3,
                                          som_update_masked_tf32x3, split_k6_plain,
                                          split_sm90_plain, tf32_split, tf32x3_mm)
from test_torch_argmin_sm90_masked import _bits, _clamped, _tie_codebook, _top2_fold

UPDATE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread in this module, as tests/test_torch_ops.py
    runs the gaussian step: the first vectorized exp that torch spreads over
    several threads in a process came back up to 1.5e-4 off in one thread's
    share, in about 0.5% of processes, and the walk emulation holds two exp
    passes bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- K9: K8's top-2 fold on K4's walk -----------------------------------------

@pytest.mark.parametrize("N,dup,pattern,splits,D", [
    (2, 1, "tile", 1, 5), (100, 2, "tile", 1, 37), (100, 2, "repeat", 2, 37),
    (333, 3, "tile", 3, 64), (333, 3, "repeat", 1, 5), (1000, 1, "tile", 3, 37),
    (1000, 2, "repeat", 4, 130), (65, 1, "tile", 2, 37), (640, 2, "tile", 5, 64),
    (1000, 1, "lane", 3, 37), (700, 1, "lane", 2, 130), (384, 3, "repeat", 3, 64),
    (129, 1, "tile", 2, 5)])
def test_k9_top2_fold_reenacted_matches_tf32x3(N, dup, pattern, splits, D):
    """K9's fold over K4's scores (x keep).m - keep.(m o m) / 2, tile by
    64-code tile of each split of `k4_sm90_spans` and lane by lane, merged
    by split in split order: bit-equal to the emulation's two first minima,
    its best pair K4's; a fully masked row gets (0, 0), (0, 1)."""
    rng = np.random.default_rng(N + 13 * dup + splits + D)
    B = 160
    codes = _tie_codebook(N, D, dup, pattern, seed=N + dup + D + 1)
    x = rng.normal(size=(B, D)).astype(np.float32)
    x[3] = codes[min(5, N - 1)]  # a sample on a code: its copies tie at the top
    mask = (rng.uniform(size=(B, D)) < 0.3).astype(np.uint8)
    mask[3] = 0
    mask[::7] = 1  # fully masked rows: score 0 everywhere
    xt, ct, mt = torch.from_numpy(x), torch.from_numpy(codes), torch.from_numpy(mask)
    keep = keep_of(mt)
    xk = xt * keep
    qhi, qlo = tf32_split(ct * ct)
    sc = (tf32x3_mm(xk, ct.T) - 0.5 * (keep @ qlo.T + keep @ qhi.T)).numpy()
    v, ix = _top2_fold(sc, da.k4_sm90_spans(N, splits), N, tile=da.K4_TILE)
    d1, i1, d2, i2 = dist_top2_masked_tf32x3(xt, ct, mt)
    x2 = (xk * xk).sum(-1)
    assert np.array_equal(_bits(_clamped(v[:, 0], x2)), _bits(d1))
    assert np.array_equal(_bits(_clamped(v[:, 1], x2)), _bits(d2))
    assert np.array_equal(ix[:, 0], i1.numpy()) and np.array_equal(ix[:, 1], i2.numpy())
    full = mask.all(1)
    assert full.any()
    assert (ix[full, 0] == 0).all() and (ix[full, 1] == 1).all()
    assert (v[full] == 0).all()
    if dup > 1 and N % dup == 0:  # exact ties went to the lower copy
        assert (ix[:, 0] != ix[:, 1]).all()


# -- K6: the prologue ------------------------------------------------------------

def _update_inputs(xdim, ydim, D, B, seed):
    """Components masked with probability 0.2, every 7th sample masked
    entirely, a few samples without a BMU."""
    rng = np.random.default_rng(seed)
    noc = xdim * ydim
    codes = rng.normal(size=(noc, D)).astype(np.float32)
    xb = rng.normal(size=(B, D)).astype(np.float32)
    bmu = rng.integers(0, noc, size=B).astype(np.int32)
    bmu[:3] = -1
    bmu[B // 2] = -1
    alpha = rng.uniform(0.0, 0.1, size=B).astype(np.float32)
    mask = (rng.random((B, D)) < 0.2).astype(np.uint8)
    mask[::7] = 1
    return codes, xb, bmu, alpha, mask


@pytest.mark.parametrize("B,D,hexa", [(100, 37, True), (64, 5, False), (200, 64, True),
                                      (33, 130, False), (96, 300, True)])
def test_k6_prologue_planes_and_table(B, D, hexa):
    """The prologue's scratch (k6_scratch's size): X o K transposed (Dp, Bp)
    split into hi and lo by tf32_split, then K transposed as exact 1.0 and
    0.0, zeros past B and D (a masked component +0 whatever x holds); then
    K3's per-sample table as split_sm90_plain makes it for K3."""
    xdim = 9
    _, xb, bmu, alpha, mask = _update_inputs(xdim, 7, D, B, seed=B + D)
    xb[1, 0] = -3.0
    mask[1, 0] = 1  # a masked negative component: +0, not -0
    xt, mt = torch.from_numpy(xb), torch.from_numpy(mask)
    bt, at = torch.from_numpy(bmu), torch.from_numpy(alpha)
    flat = split_k6_plain(xt, mt, bt, at, xdim, hexa)
    Dp, Bp = da.split_codes_dp(D), -(-B // 64) * 64
    assert flat.numel() == k6_scratch(B, D, "cpu").numel() == 3 * Dp * Bp + 4 * Bp
    hi, lo, kk = flat[:3 * Dp * Bp].view(3, Dp, Bp)
    on = torch.from_numpy(mask == 0)
    want_hi, want_lo = tf32_split(torch.where(on, xt, 0.0).T.contiguous())
    assert torch.equal(hi[:D, :B].view(torch.int32), want_hi.view(torch.int32))
    assert torch.equal(lo[:D, :B].view(torch.int32), want_lo.view(torch.int32))
    assert torch.equal(kk[:D, :B], on.T.to(torch.float32))
    for plane in (hi, lo, kk):
        assert not plane[D:].any() and not plane[:, B:].any()
    assert int(hi[0, 1].view(torch.int32)) == 0
    k3 = split_sm90_plain(xt, xt, Dp, bmu=bt, alpha=at, xdim=xdim, hexa=hexa)
    assert torch.equal(flat[3 * Dp * Bp:].view(torch.int32), k3[-4 * Bp:].view(torch.int32))


def test_k6_slabs_cover_every_feature_once():
    """gridDim.y's slabs (k6_slabs): 32 features up to D 32, else 64, as
    many as the prologue's Dp rows hold, contiguous from 0 to D, each
    non-empty, every feature once."""
    for D in range(1, 1100):
        slabs = k6_slabs(D)
        F = 32 if D <= 32 else 64
        assert len(slabs) * F == da.split_codes_dp(D)
        assert slabs[0][0] == 0 and slabs[-1][1] == D
        for (lo, hi), (nxt, _) in zip(slabs, slabs[1:] + [(D, None)]):
            assert lo % F == 0 and lo < hi <= lo + F and hi == nxt


# -- K6: the walk -----------------------------------------------------------------

def _table_w(table, noc, xdim, hexa, radius, gaussian):
    """(noc, Bp) W as the walk builds it from the prologue's
    table: the unit's grid x and row against the BMU's, d2 = dx^2 + dy^2
    (dy^2 * 0.75 on a hexa map), bubble alpha inside r^2, gaussian alpha
    exp(-d2 / (2 r r)); the table's zeros (bmu < 0) give alpha 0."""
    u = torch.arange(noc)
    row = u // xdim
    lx = (u % xdim).to(torch.float32)
    if hexa:
        lx = lx + 0.5 * (row % 2).to(torch.float32)
    fur = row.to(torch.float32)
    dx = lx[:, None] - table[None, :, 0]
    rd = fur[:, None] - table[None, :, 1]
    d2 = dx * dx + ((rd * rd) * 0.75 if hexa else rd * rd)
    a = table[None, :, 2]
    r = torch.tensor(radius, dtype=torch.float32)
    if gaussian:
        return a * torch.exp(-d2 / (2.0 * r * r))
    return torch.where(d2 <= r * r, a, torch.zeros_like(a))


def _k6_walk(codes, xb, bmu, mask, xdim, hexa, alpha, radius, gaussian):
    """K6's walk on its prologue's scratch: for each slab of k6_slabs, for
    each 32-sample chunk in batch order, the chunk's W split into hi and lo
    (the A fragments), acc += (X o K lo.W hi + hi.W lo) + hi.W hi and mass
    += K.W lo + K.W hi over the slab's planes; then the guarded blend of the
    slab's columns."""
    noc, (B, D) = codes.shape[0], xb.shape
    Dp, Bp = da.split_codes_dp(D), -(-B // 64) * 64
    flat = split_k6_plain(xb, mask, bmu, alpha, xdim, hexa)
    planes = flat[:3 * Dp * Bp].view(3, Dp, Bp)
    w = _table_w(flat[3 * Dp * Bp:].view(Bp, 4), noc, xdim, hexa, radius, gaussian)[:, :B]
    whi, wlo = tf32_split(w.contiguous())
    out = codes.clone()
    for lo, hi in k6_slabs(D):
        xhi, xlo, kk = (planes[p, lo:hi, :B].T.contiguous() for p in range(3))
        acc = torch.zeros((noc, hi - lo), dtype=torch.float32)
        mass = torch.zeros_like(acc)
        for s in range(0, B, CHUNK):
            c = slice(s, s + CHUNK)
            acc += (wlo[:, c] @ xhi[c] + whi[:, c] @ xlo[c]) + whi[:, c] @ xhi[c]
            mass += wlo[:, c] @ kk[c] + whi[:, c] @ kk[c]
        out[:, lo:hi] = guarded_blend(codes[:, lo:hi], acc, mass)
    return out, w


@pytest.mark.parametrize("D", [5, 37, 64, 200, 300])
@pytest.mark.parametrize("xdim,ydim,hexa,gaussian,radius", [
    (9, 7, True, True, 2.5),     # ragged: 63 rows
    (10, 8, True, False, 3.0),   # hexa bubble: exact-boundary pairs at r = 3
    (12, 8, False, False, 3.0),
    (8, 6, False, True, 3.0),
])
def test_k6_walk_emulation(xdim, ydim, hexa, gaussian, radius, D):
    """The walk's W from the table is neighborhood_w's bit for bit; its
    codebook is som_update_masked_tf32x3's bit for bit, within 1e-5 of the
    JAX masked update (interpret mode) and of the plain K6; a component
    masked in every sample stays as it was."""
    B = 80  # two whole chunks and a partial one
    codes, xb, bmu, alpha, mask = _update_inputs(xdim, ydim, D, B, seed=xdim * ydim + D)
    mask[:, 2] = 1
    ct, xt, bt, at, mt = (torch.from_numpy(a) for a in (codes, xb, bmu, alpha, mask))
    got, w = _k6_walk(ct, xt, bt, mt, xdim, hexa, at, radius, gaussian)
    units = torch.arange(xdim * ydim, dtype=torch.int32)
    want_w = neighborhood_w(bt, at, torch.tensor(radius, dtype=torch.float32), units, xdim,
                            hexa, gaussian)
    assert torch.equal(w.view(torch.int32), want_w.view(torch.int32))
    emu = som_update_masked_tf32x3(ct, xt, bt, mt, xdim, hexa, at, radius, gaussian)
    assert torch.equal(got.view(torch.int32), emu.view(torch.int32))
    assert torch.equal(got[:, 2], ct[:, 2])
    plain = som_neighborhood_update_idx_plain(ct.clone(), xt, bt, xdim, hexa, at, radius,
                                              gaussian, mask=mt)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=UPDATE_TOL, atol=UPDATE_TOL)
    ref = jps.som_neighborhood_update_idx(
        jnp.asarray(codes), jnp.asarray(xb), jnp.asarray(bmu), xdim, hexa,
        jnp.asarray(alpha), radius, gaussian=gaussian, mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=UPDATE_TOL, atol=UPDATE_TOL)


# -- the A/B tool's update digests ------------------------------------------

@pytest.mark.parametrize("case", [(12, 8, True, False, 70, 37, 3.0),
                                  (8, 6, False, True, 40, 300, 3.0)])
def test_fused_step_ab_update_digests_repeat_on_the_cpu(case):
    """`tools.fused_step_ab`'s update cases on the CPU (the plain K5 and
    K6): both are timed and digested, K6 (masked) unlike K5, and a second
    run on the same seed gives the same digests, so equal digests across
    trees mean equal floats; the tool's cases hold chip_smoke.py's update
    cases and D 300, 512 and 1024."""
    from som_lvq_pak_torch.tools import fused_step_ab

    one, two = (fused_step_ab.run_update(*case, dev=torch.device("cpu"), iters=1)
                for _ in range(2))
    for name in ("k5", "k6"):
        assert len(one[f"{name}_digest"]) == 64 and one[f"{name}_ms"] > 0
        assert one[f"{name}_digest"] == two[f"{name}_digest"]
    assert one["k5_digest"] != one["k6_digest"]
    assert {c[5] for c in fused_step_ab.UPDATE_CASES} >= {5, 37, 64, 200, 300, 512, 1024}
