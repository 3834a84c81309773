"""K5 (csrc/som_update_sm90.cu) and K11 (csrc/som_accum_sm90.cu) on K3's
Hopper update walk, the parts the CPU reaches.

The prologue is K3's (split_sm90_kernel with no next batch): its plain
version (`split_sm90_plain(xb, xb[:0], Dp, bmu=...)`) fills
`ops.som_update.update_scratch` exactly, the batch transposed and split by
`tf32_split`, zeros past D and B, then `k3_table` (zeros where bmu < 0).
An emulation of the walk (W from the prologue's table by the closed form at
the global units offset.., per feature slab of `update_slabs`, per 32-sample
chunk, the three products' sums in their order) is bit-equal to
`som_update_tf32x3` (K5) and `som_neighborhood_accumulate_tf32x3` (K11) and
within 1e-5 of the JAX `som_neighborhood_update_idx` /
`som_neighborhood_accumulate` (interpret mode, as the JAX tests run them on
the CPU) and of the plain versions, at D 5, 37, 64, 200 and 300, hexa and
rect, bubble and gaussian, scalar and per-sample alpha.  The slabs cover
every feature once and K11's grid writes wsum once a row; K11 in the mesh
step's `overlap_segments` pieces (8-row-aligned, not 128) gives the bits of
the whole shard.  The A/B tool's accumulator cases run on the CPU and
repeat.  Inputs from NumPy seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_torch.ops.som_accum import som_neighborhood_accumulate_plain
from som_lvq_pak_torch.ops.som_step import guarded_blend, neighborhood_w
from som_lvq_pak_torch.ops.som_update import (som_neighborhood_update_idx_plain,
                                              update_scratch, update_slab, update_slabs)
from som_lvq_pak_torch.ops.tf32x3 import (CHUNK, k3_table, som_neighborhood_accumulate_tf32x3,
                                          som_update_tf32x3, split_sm90_plain, tf32_split)

TOL = 1e-5
TN = 128  # rows per CTA


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


def _inputs(noc, D, B, seed):
    """A codebook, a batch, its BMUs over `noc` units (a few samples without
    one) and per-sample alphas."""
    rng = np.random.default_rng(seed)
    codes = rng.normal(size=(noc, D)).astype(np.float32)
    xb = rng.normal(size=(B, D)).astype(np.float32)
    bmu = rng.integers(0, noc, size=B).astype(np.int32)
    bmu[:3] = -1
    bmu[B // 2] = -1
    alpha = rng.uniform(0.0, 0.1, size=B).astype(np.float32)
    return codes, xb, bmu, alpha


def _dims(B, D):
    """(Dp, Bp) of the prologue: D padded to whole slabs, B to 64."""
    F = update_slab(D)
    return -(-D // F) * F, -(-B // 64) * 64


def _prologue(xb, bmu, alpha, xdim, hexa):
    """The prologue's scratch as the card fills it (K3's, no next batch)."""
    Dp, _ = _dims(*xb.shape)
    return split_sm90_plain(xb, xb[:0], Dp, bmu=bmu, alpha=alpha, xdim=xdim, hexa=hexa)


# -- the prologue -----------------------------------------------------------------

@pytest.mark.parametrize("B,D,hexa", [(100, 37, True), (64, 5, False), (200, 64, True),
                                      (33, 130, False), (96, 300, True)])
def test_prologue_planes_and_table(B, D, hexa):
    """The prologue's scratch (update_scratch's size): the batch transposed
    (Dp, Bp), split into hi and lo by tf32_split, zeros past B and D; then
    K3's per-sample table (BMU grid x, row, alpha; zeros where bmu < 0 and
    past B), which the unit offset does not enter (it enters W, below)."""
    xdim = 9
    _, xb, bmu, alpha = _inputs(xdim * 7, D, B, seed=B + D)
    xt, bt, at = torch.from_numpy(xb), torch.from_numpy(bmu), torch.from_numpy(alpha)
    flat = _prologue(xt, bt, at, xdim, hexa)
    Dp, Bp = _dims(B, D)
    assert flat.numel() == update_scratch(B, D, "cpu").numel() == 2 * Dp * Bp + 4 * Bp
    hi, lo = flat[:2 * Dp * Bp].view(2, Dp, Bp)
    want_hi, want_lo = tf32_split(xt.T.contiguous())
    assert torch.equal(hi[:D, :B].view(torch.int32), want_hi.view(torch.int32))
    assert torch.equal(lo[:D, :B].view(torch.int32), want_lo.view(torch.int32))
    for plane in (hi, lo):
        assert not plane[D:].any() and not plane[:, B:].any()
    table = flat[2 * Dp * Bp:].view(Bp, 4)
    assert torch.equal(table.view(torch.int32),
                       k3_table(bt, at, Bp, xdim, hexa).view(torch.int32))
    k3 = split_sm90_plain(xt, xt, Dp, bmu=bt, alpha=at, xdim=xdim, hexa=hexa)
    assert torch.equal(table.reshape(-1).view(torch.int32), k3[-4 * Bp:].view(torch.int32))
    assert not table[:B][torch.from_numpy(bmu < 0)].any() and not table[B:].any()


# -- the slabs ----------------------------------------------------------------------

def _k11_grid_writes(n_local, D):
    """How often K11's grid writes each accumulator component and each wsum:
    CTA (x, y) of ceil(n_local / 128) x Dp / F, thread rows 16 warp + g and
    + 8 of its 128, components f0 + 8 j + 2 t + (q & 1) of its slab, with
    the kernel's guards (u < n_local, k < D; wsum where y == 0 and t == 0)."""
    F = update_slab(D)
    Dp, _ = _dims(1, D)
    acc = np.zeros((n_local, D), np.int64)
    wsum = np.zeros(n_local, np.int64)
    warp, lane = np.meshgrid(np.arange(8), np.arange(32), indexing="ij")
    g, t = lane >> 2, lane & 3
    for x in range(-(-n_local // TN)):
        for y in range(Dp // F):
            for j in range(F // 8):
                for q in range(4):
                    u = x * TN + 16 * warp + g + 8 * (q >> 1)
                    k = y * F + 8 * j + 2 * t + (q & 1)
                    on = (u < n_local) & (k < D)
                    np.add.at(acc, (u[on], k[on]), 1)
            if y == 0:
                for h in range(2):
                    u = x * TN + 16 * warp + g + 8 * h
                    on = (t == 0) & (u < n_local)
                    np.add.at(wsum, u[on], 1)
    return acc, wsum


def test_update_slabs_cover_every_feature_once():
    """gridDim.y's slabs (update_slabs): 32 features up to D 32, 64 up to D
    64, else 128, as many as the prologue's Dp rows hold, contiguous from 0
    to D, each non-empty, every feature once."""
    for D in range(1, 1100):
        slabs = update_slabs(D)
        F = update_slab(D)
        assert F == (32 if D <= 32 else 64 if D <= 64 else 128)
        assert len(slabs) * F == _dims(1, D)[0]
        assert slabs[0][0] == 0 and slabs[-1][1] == D
        for (lo, hi), (nxt, _) in zip(slabs, slabs[1:] + [(D, None)]):
            assert lo % F == 0 and lo < hi <= lo + F and hi == nxt


@pytest.mark.parametrize("n_local,D", [(1, 1), (40, 5), (128, 64), (200, 37), (130, 130),
                                       (256, 300), (24, 1024)])
def test_k11_grid_writes_every_component_and_wsum_once(n_local, D):
    """K11's grid with its guards writes each accumulator component of the
    shard once and each row's wsum once (by the slab-0 CTAs only)."""
    acc, wsum = _k11_grid_writes(n_local, D)
    assert (acc == 1).all() and (wsum == 1).all()


# -- the walk -------------------------------------------------------------------------

def _table_w(table, n_rows, offset, xdim, hexa, radius, gaussian):
    """(n_rows, Bp) W of the global units offset.. as the walk builds it
    from the prologue's table: the unit's grid x and row against the BMU's,
    d2 = dx^2 + dy^2 (dy^2 * 0.75 on a hexa map), bubble alpha inside r^2,
    gaussian alpha exp(-d2 / (2 r r)); the table's zeros (bmu < 0) give
    alpha 0."""
    u = offset + torch.arange(n_rows)
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


def _walk(xb, bmu, alpha, n_rows, offset, xdim, hexa, radius, gaussian):
    """The walk on the prologue's scratch, rows of the global units
    offset..: for each slab of update_slabs, for each 32-sample chunk in
    batch order, the chunk's W split into hi and lo (the A fragments), acc
    += (X hi.W lo + X lo.W hi) + X hi.W hi over the slab's planes; wsum the
    float32 sum of the same W (ops.tf32x3's).  Returns (acc, wsum, W)."""
    B, D = xb.shape
    Dp, Bp = _dims(B, D)
    flat = _prologue(xb, bmu, alpha, xdim, hexa)
    planes = flat[:2 * Dp * Bp].view(2, Dp, Bp)
    w = _table_w(flat[2 * Dp * Bp:].view(Bp, 4), n_rows, offset, xdim, hexa, radius,
                 gaussian)[:, :B].contiguous()
    whi, wlo = tf32_split(w)
    acc = torch.empty((n_rows, D), dtype=torch.float32)
    for lo, hi in update_slabs(D):
        xhi, xlo = (planes[p, lo:hi, :B].T.contiguous() for p in range(2))
        a = torch.zeros((n_rows, hi - lo), dtype=torch.float32)
        for s in range(0, B, CHUNK):
            c = slice(s, s + CHUNK)
            a += (wlo[:, c] @ xhi[c] + whi[:, c] @ xlo[c]) + whi[:, c] @ xhi[c]
        acc[:, lo:hi] = a
    return acc, w.sum(1, keepdim=True), w


GEOMETRIES = [  # xdim, ydim, hexa, gaussian, radius, per-sample alpha
    (9, 7, True, True, 2.5, True),     # ragged: 63 rows
    (10, 8, True, False, 3.0, False),  # hexa bubble: exact-boundary pairs at r = 3
    (12, 8, False, False, 3.0, True),
    (8, 6, False, True, 3.0, False),
]


@pytest.mark.parametrize("D", [5, 37, 64, 200, 300])
@pytest.mark.parametrize("xdim,ydim,hexa,gaussian,radius,per_sample", GEOMETRIES)
def test_k5_walk_emulation(xdim, ydim, hexa, gaussian, radius, per_sample, D):
    """K5's walk, then the guarded blend of each slab's columns by its row's
    wsum: W from the table is neighborhood_w's bit for bit; the codebook is
    som_update_tf32x3's bit for bit, within 1e-5 of the JAX update
    (interpret mode) and of the plain K5."""
    B = 80  # two whole chunks and a partial one
    codes, xb, bmu, alpha = _inputs(xdim * ydim, D, B, seed=xdim * ydim + D)
    a = alpha if per_sample else np.full(B, 0.05, np.float32)
    ct, xt, bt, at = (torch.from_numpy(v) for v in (codes, xb, bmu, a))
    acc, wsum, w = _walk(xt, bt, at, xdim * ydim, 0, xdim, hexa, radius, gaussian)
    got = guarded_blend(ct, acc, wsum)
    units = torch.arange(xdim * ydim, dtype=torch.int32)
    want_w = neighborhood_w(bt, at, torch.tensor(radius, dtype=torch.float32), units, xdim,
                            hexa, gaussian)
    assert torch.equal(w.view(torch.int32), want_w.view(torch.int32))
    emu = som_update_tf32x3(ct, xt, bt, xdim, hexa, at, radius, gaussian)
    assert torch.equal(got.view(torch.int32), emu.view(torch.int32))
    alpha_arg = at if per_sample else 0.05
    plain = som_neighborhood_update_idx_plain(ct.clone(), xt, bt, xdim, hexa, alpha_arg,
                                              radius, gaussian)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=TOL, atol=TOL)
    ref = jps.som_neighborhood_update_idx(
        jnp.asarray(codes), jnp.asarray(xb), jnp.asarray(bmu), xdim, hexa,
        jnp.asarray(a) if per_sample else 0.05, radius, gaussian=gaussian)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    assert not torch.equal(got, ct)  # the codebook moved


def _pad128(a):
    """Lane-pad features to 128 for the JAX kernel only."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(np.pad(a, ((0, 0), (0, -a.shape[1] % 128))))


@pytest.mark.parametrize("D", [5, 37, 64, 200, 300])
@pytest.mark.parametrize("xdim,ydim,hexa,gaussian,radius,per_sample", GEOMETRIES)
def test_k11_walk_emulation(xdim, ydim, hexa, gaussian, radius, per_sample, D):
    """K11's walk on a shard of 24 rows from unit 16 of the map: its
    accumulators are som_neighborhood_accumulate_tf32x3's bit for bit and
    within 1e-5 of the JAX som_neighborhood_accumulate (interpret mode,
    features lane-padded to 128 for JAX only) and of the plain K11."""
    B, n_local, offset = 80, 24, 16
    _, xb, bmu, alpha = _inputs(xdim * ydim, D, B, seed=3 * xdim * ydim + D)
    a = alpha if per_sample else np.full(B, 0.05, np.float32)
    xt, bt, at = (torch.from_numpy(v) for v in (xb, bmu, a))
    acc, wsum, _ = _walk(xt, bt, at, n_local, offset, xdim, hexa, radius, gaussian)
    eacc, ewsum = som_neighborhood_accumulate_tf32x3(xt, bt, n_local, xdim, hexa, at,
                                                     radius, gaussian, unit_offset=offset)
    assert torch.equal(acc.view(torch.int32), eacc.view(torch.int32))
    assert torch.equal(wsum.view(torch.int32), ewsum.view(torch.int32))
    alpha_arg = at if per_sample else 0.05
    pacc, pw = som_neighborhood_accumulate_plain(xt, bt, n_local, xdim, hexa, alpha_arg,
                                                 radius, gaussian, unit_offset=offset)
    np.testing.assert_allclose(acc.numpy(), pacc.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(wsum.numpy(), pw.numpy(), rtol=TOL, atol=TOL)
    jacc, jw = jps.som_neighborhood_accumulate(
        _pad128(xb), jnp.asarray(bmu), n_local, xdim, hexa,
        jnp.asarray(a) if per_sample else jnp.float32(0.05), jnp.float32(radius),
        gaussian=gaussian, tile_n=8, unit_offset=offset, interpret=True)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc)[:, :D], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(wsum.numpy(), np.asarray(jw), rtol=TOL, atol=TOL)
    assert float(wsum.max()) > 0


@pytest.mark.parametrize("n_local,segs,D", [(144, 3, 37), (120, 5, 64), (272, 2, 200),
                                            (80, 10, 5)])
def test_k11_overlap_segments_bit_equal_to_whole(n_local, segs, D):
    """K11 in the mixed mesh step's overlap_segments pieces (H = n_local /
    segs rows each, a multiple of 8 and not of 128, unit offset advanced by
    H a piece): the pieces' accumulators and wsum, stacked, are the whole
    shard's bit for bit, as a row's sums depend only on its unit."""
    H = n_local // segs
    assert H % 8 == 0 and H % 128 != 0
    xdim, offset, B = 16, 40, 100
    _, xb, bmu, alpha = _inputs(xdim * 24, D, B, seed=n_local + D)
    xt, bt, at = (torch.from_numpy(v) for v in (xb, bmu, alpha))
    acc, wsum, _ = _walk(xt, bt, at, n_local, offset, xdim, True, 4.0, True)
    parts = [_walk(xt, bt, at, H, offset + k * H, xdim, True, 4.0, True) for k in range(segs)]
    assert torch.equal(torch.cat([p[0] for p in parts]).view(torch.int32),
                       acc.view(torch.int32))
    assert torch.equal(torch.cat([p[1] for p in parts]).view(torch.int32),
                       wsum.view(torch.int32))


# -- the A/B tool's accumulator digests ---------------------------------------------

@pytest.mark.parametrize("case", [(12, 8, True, False, 40, 48, 70, 37, 3.0),
                                  (8, 6, False, True, 16, 24, 40, 300, 3.0)])
def test_fused_step_ab_accum_digests_repeat_on_the_cpu(case):
    """`tools.fused_step_ab`'s accumulator cases on the CPU (the plain K11
    and K12): K11 is timed and digested, K11 then K12 digested, and a
    second run on the same seed gives the same digests, so equal digests
    across trees mean equal floats; the tool's cases hold the mixed mesh
    step's shard and D 5, 37, 200, 300 and 512."""
    from som_lvq_pak_torch.tools import fused_step_ab

    one, two = (fused_step_ab.run_accum(*case, dev=torch.device("cpu"), iters=1)
                for _ in range(2))
    for key in ("k11_digest", "k11_k12_digest"):
        assert len(one[key]) == 64 and one[key] == two[key]
    assert one["k11_ms"] > 0 and one["k11_digest"] != one["k11_k12_digest"]
    assert (256, 256, True, True, 32768, 32768, 2048, 64, 64.0) in fused_step_ab.ACCUM_CASES
    assert {c[7] for c in fused_step_ab.ACCUM_CASES} >= {5, 37, 64, 200, 300, 512}
