"""K13 on K3's Hopper walk (csrc/separable_sm90.cuh), the parts the
CPU reaches: its route by shape, its prologue (the walk's split planes with
no per-sample table) against the `mma.sync` K13's split planes, and the
table rows its W builder reads for each unit against the separable step's
weights.  The kernel itself runs on the card (chip_smoke.py's K13 phases,
tools/fused_step_ab.py's digests).  Inputs from NumPy seeds; every
comparison is bit for bit."""

import numpy as np
import pytest
import torch

from som_lvq_pak_torch.ops import som_step
from som_lvq_pak_torch.ops.som_step import (SM90_MAX_D, k3_route, k13_route, sm90_scratch,
                                            sm90_width, split_width)
from som_lvq_pak_torch.ops.tf32x3 import split_batches_plain, split_sm90_plain


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one CPU thread in this module, as tests/test_torch_ops.py
    runs it: the first vectorized exp that torch spreads over several threads
    in a process came back up to 1.5e-4 off in one thread's share, in about
    0.5% of processes, and the table-rows test compares two exp passes bit
    for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_k13_route_by_shape():
    """K13 takes the walk up to SM90_MAX_D (128) and its mma.sync kernel
    past it, at any D: K3's rule; D 0 raises."""
    for D in range(1, 1025):
        assert k13_route(D) == k3_route(D) == ("sm90" if D <= SM90_MAX_D else "mma_sync")
    with pytest.raises(ValueError):
        k13_route(0)


@pytest.mark.parametrize("B,Bn,D", [(1024, 1024, 64), (100, 77, 5), (1000, 999, 37),
                                    (4096, 4096, 64), (256, 130, 128)])
def test_k13_prologue_is_the_mma_sync_split_transposed(B, Bn, D):
    """The walk's prologue for K13 (no per-sample table: the scratch is
    sm90_scratch(table=False), two planes of each batch) holds the floats of
    the mma.sync K13's split planes, the update batch transposed; the walk's
    wider rows add zeros only."""
    rng = np.random.default_rng(B + D)
    xb = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32))
    xn = torch.from_numpy(rng.normal(size=(Bn, D)).astype(np.float32))
    DP, DO = sm90_width(D), split_width(D)
    Bp, Bnp = -(-B // 64) * 64, -(-Bn // 64) * 64
    flat = split_sm90_plain(xb, xn, DP)
    assert flat.numel() == sm90_scratch(B, Bn, D, "cpu", table=False).numel()
    assert flat.numel() == 2 * DP * (Bp + Bnp)
    old = split_batches_plain(xb, xn, DO)
    o = 0
    planes = []
    for rows in (Bp, Bp, Bnp, Bnp):
        planes.append(old[o:o + rows * DO].reshape(rows, DO))
        o += rows * DO
    thi, tlo = (flat[p * DP * Bp:(p + 1) * DP * Bp].reshape(DP, Bp) for p in (0, 1))
    base = 2 * DP * Bp
    nhi, nlo = (flat[base + p * Bnp * DP:base + (p + 1) * Bnp * DP].reshape(Bnp, DP)
                for p in (0, 1))
    assert torch.equal(_bits(thi[:DO]), _bits(planes[0].T))
    assert torch.equal(_bits(tlo[:DO]), _bits(planes[1].T))
    assert torch.equal(_bits(nhi[:, :DO]), _bits(planes[2]))
    assert torch.equal(_bits(nlo[:, :DO]), _bits(planes[3]))
    assert not thi[DO:].any() and not nhi[:, DO:].any()


@pytest.mark.parametrize("xdim,ydim,hexa", [(128, 128, True), (64, 64, True),
                                            (128, 64, False), (8, 6, True)])
@pytest.mark.parametrize("gaussian", [True, False])
def test_k13_walk_table_rows(xdim, ydim, hexa, gaussian):
    """The walk's W builder reads, for unit u in grid row y = u // xdim and
    column u - y xdim, x-pattern row (hexa: (y & 1) xdim) + column and
    y-factor row y of the table launch's tables (separable_rows); W from
    those rows (gaussian Wx Wy, bubble alpha where Wx + Wy <= r r) is, bit
    for bit, W taken from each unit's own grid position with no table
    (`_unit_w`), and so is the separable step's weights; samples without a
    BMU get 0."""
    rng = np.random.default_rng(xdim + ydim + gaussian)
    noc, B = xdim * ydim, 96
    bmu = torch.from_numpy(rng.integers(0, noc, size=B).astype(np.int32))
    bmu[:5] = -1
    alpha = torch.from_numpy(rng.uniform(0.01, 0.1, size=B).astype(np.float32))
    r = torch.tensor(3.0)
    pat, ytab, a = som_step.separable_tables(bmu, alpha, r, noc, xdim, hexa, gaussian)
    assert pat.shape == ((2 if hexa else 1) * xdim, B) and ytab.shape == (ydim, B)
    prow, yrow = som_step.separable_rows(noc, xdim, hexa)
    for u in range(0, noc, max(1, noc // 97)):
        y, col = u // xdim, u - (u // xdim) * xdim
        assert int(prow[u]) == (((y & 1) * xdim) if hexa else 0) + col
        assert int(yrow[u]) == y
    wx, wy = pat[prow], ytab[yrow]
    w = wx * wy if gaussian else torch.where(wx + wy <= r * r, a[None, :], 0.0)
    want = _unit_w(bmu, alpha, r, noc, xdim, hexa, gaussian)
    assert torch.equal(_bits(w), _bits(want))
    assert torch.equal(_bits(som_step.separable_w(bmu, alpha, r, noc, xdim, hexa, gaussian)),
                       _bits(want))
    assert not want[:, :5].any()


def _unit_w(bmu, alpha, r, noc, xdim, hexa, gaussian):
    """(noc, B) W from each unit's own grid position, no table: dx from the
    unit's and the BMU's x (a hexa odd row shifted by half a unit), dy from
    their rows (times 3/4 on a hexa map), s = 1 / (2 r r); gaussian
    (alpha exp(-dx^2 s)) exp(-dy^2 s), bubble alpha where dx^2 + dy^2 <=
    r r; 0 where bmu < 0."""
    ok = bmu >= 0
    bm = torch.where(ok, bmu, torch.zeros_like(bmu)).long()
    a = torch.where(ok, alpha, torch.zeros_like(alpha))
    s = 1.0 / (2.0 * r * r)
    u = torch.arange(noc)
    yu, yb = u // xdim, bm // xdim
    xu, xb = (u % xdim).to(torch.float32), (bm % xdim).to(torch.float32)
    if hexa:
        xu = xu + 0.5 * (yu % 2).to(torch.float32)
        xb = xb + 0.5 * (yb % 2).to(torch.float32)
    dx = xu[:, None] - xb[None, :]
    dy = (yu[:, None] - yb[None, :]).to(torch.float32)
    dx2, dy2 = dx * dx, (dy * dy) * 0.75 if hexa else dy * dy
    if gaussian:
        return (a[None, :] * torch.exp(-dx2 * s)) * torch.exp(-dy2 * s)
    return torch.where(dx2 + dy2 <= r * r, a[None, :], torch.zeros_like(dx2))


def test_k13_walk_variants_edit_its_lines():
    """tools.fused_step_ab's walk variants find the lines they edit in K13's
    walk (separable_sm90.cuh): no_w reads no table, no_fold cuts its
    fold; the header's variants (no_feed, no_turns) leave it as it is."""
    from som_lvq_pak_torch import _build
    from som_lvq_pak_torch.tools.fused_step_ab import (WALK_VARIANTS, k13_variant_sources,
                                                       walk_variant_sources)

    read = lambda f: open(f"{_build.CSRC}/{f}").read()  # noqa: E731
    src = read("separable_sm90.cuh")
    texts = k13_variant_sources(src, walk_variant_sources(read("fused_step_sm90.cu"),
                                                          read("fused_step_sm90.cuh")))
    assert tuple(texts) == WALK_VARIANTS
    assert {n for n, t in texts.items() if t != src} == {"no_w", "no_fold"}
    assert "__ldg(pat" not in texts["no_w"] and "argmin_fold(S" not in texts["no_fold"]
    with pytest.raises(ValueError):
        k13_variant_sources(src.replace("__ldg(pat + po[h] + s)", "pat[po[h] + s]"),
                            walk_variant_sources(read("fused_step_sm90.cu"),
                                                 read("fused_step_sm90.cuh")))
