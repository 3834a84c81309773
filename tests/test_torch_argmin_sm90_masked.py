"""K4's and K8's Hopper walks (csrc/argmin_masked_sm90.cu, and K8's top-2 fold
in csrc/argmin_sm90.cu) on the CPU: K4's prologue's plain version
(`split_masked_codes_plain`: m and q = m o m split into TF32 hi and lo once
per call), K4's split rule (`k4_sm90_splits`, `k4_sm90_spans`), and NumPy
re-enactments of the two walks' folds, tile by tile and lane by lane as the
kernels run them, on the scores of their split-TF32 emulations.

Tolerances: the prologue bit-equal to `ops.tf32x3.tf32_split`; each fold's
(value, index) pairs bit-equal to the emulation's first minima
(`dist_top2_tf32x3`, `dist_argmin_masked_tf32x3`): the fold keeps the
lexicographically smallest (value, index) pairs of the same floats, so
nothing may differ, on codebooks full of exact ties included."""

import numpy as np
import pytest
import torch

from som_lvq_pak_torch.ops import dist_argmin as da
from som_lvq_pak_torch.ops.distance import keep_of
from som_lvq_pak_torch.ops.tf32x3 import (dist_argmin_masked_tf32x3, dist_top2_tf32x3,
                                          tf32_split, tf32x3_mm)

INT_MAX = np.iinfo(np.int32).max


def _codes(N, D, seed):
    """Rows over six decades of scale."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-3, 3, size=(N, 1))
    return (rng.normal(size=(N, D)) * scale).astype(np.float32)


def _bits(t):
    return np.ascontiguousarray(np.asarray(t, np.float32)).view(np.int32)


@pytest.mark.parametrize("D", [5, 32, 33, 37, 64, 130])
def test_split_masked_codes_is_tf32_split(D):
    codes = _codes(23, D, seed=300 + D)
    got = da.split_masked_codes_plain(torch.from_numpy(codes))
    Dp = da.split_codes_dp(D)
    assert len(got) == 4 and all(t.shape == (23, Dp) for t in got)
    padded = torch.zeros((23, Dp), dtype=torch.float32)
    padded[:, :D] = torch.from_numpy(codes)
    q = torch.from_numpy(codes * codes)  # float32 products, rounded once
    qpad = torch.zeros((23, Dp), dtype=torch.float32)
    qpad[:, :D] = q
    want = (*tf32_split(padded), *tf32_split(qpad))
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert not g[:, D:].any()


def test_split_masked_codes_cpu_is_plain():
    codes = torch.from_numpy(_codes(40, 37, seed=4))
    n = da.split_masked_codes.launches
    got, want = da.split_masked_codes(codes), da.split_masked_codes_plain(codes)
    assert da.split_masked_codes.launches == n
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        da.split_masked_codes(codes.double())
    with pytest.raises(ValueError):
        da.split_masked_codes(codes[:0])


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("B,N", [(1, 4096), (1, 65536), (512, 32768), (1024, 4096),
                                 (1024, 65536), (4096, 65536), (16384, 65536),
                                 (1_000_000, 65536), (777, 3001), (1000, 2), (300, 129)])
def test_k4_sm90_splits_cover_every_code_once(B, N, sms):
    splits = da.k4_sm90_splits(B, N, sms)
    tiles = -(-N // da.K4_TILE)
    assert 1 <= splits <= tiles
    spans = da.k4_sm90_spans(N, splits)
    assert 1 <= len(spans) <= splits
    assert spans[0][0] == 0 and spans[-1][1] == N
    for (lo, hi), (nxt, _) in zip(spans, spans[1:] + [(N, None)]):
        assert lo < hi == nxt  # non-empty, contiguous: every code once
        assert lo % da.K4_TILE == 0 and (hi == N or hi % da.K4_TILE == 0)
        assert splits == 1 or hi - lo >= da.K4_MIN_SPAN * da.K4_TILE or hi == N
    # one CTA an SM: one wave unless the batch alone needs more
    assert -(-B // da.K4_SAMPLES) * len(spans) <= sms or splits == 1


def _tile_lanes(sc, n0, tile, N):
    """The scores (B, 4, tile / 4) lane t holds of the tile at n0, in its
    ascending code order 8 j + 2 t + e (the wgmma accumulator's columns),
    -inf past N; and those codes (4, tile / 4)."""
    c = np.array([[8 * j + 2 * t + e for j in range(tile // 8) for e in (0, 1)]
                  for t in range(4)]) + n0
    s = np.full((sc.shape[0], 4, tile // 4), -np.inf, np.float32)
    ok = c < N
    s[:, ok] = sc[:, c[ok]]
    return s, c


def _lex_greater(v, i, bv, bi):
    return (v > bv) | ((v == bv) & (i < bi))


def _lex_less(v, i, bv, bi):
    return (v < bv) | ((v == bv) & (i < bi))


def _value_of(score):
    """-2 * the score, -0 to +0 (topk_fold.cuh's value_of, argmin_keys.cuh's
    order_bits)."""
    v = np.float32(-2.0) * score
    return np.where(v == 0, np.float32(0.0), v).astype(np.float32)


def _top2_fold(sc, spans, N, tile=128):
    """K8's fold over the (B, N) scores x.m - ||m||^2 / 2: per split, per
    128-code tile, per lane a (best, second) list, entered only where the
    tile's max beats the sample's bar (the highest second of its four lanes
    at the tile's start), then the lane's codes ascending, four at a time
    where their max beats the bar and the lane's second too, each with a
    strict >; the lanes merged by merge_lists at xor 1 and 2; the
    splits' pairs merged in split order (topk_merge_splits<2>).  Returns
    (values, indices) (B, 2), partial distances."""
    B = sc.shape[0]
    pv, pi = [], []
    for lo, hi in spans:
        s = np.full((B, 4, 2), -np.inf, np.float32)
        j = np.full((B, 4, 2), INT_MAX, np.int64)
        for n0 in range(lo, hi, tile):
            S, c = _tile_lanes(sc, n0, tile, N)
            bar = np.broadcast_to(s[:, :, 1].max(-1, keepdims=True), (B, 4))
            gate = S.max(-1) > bar
            for k in range(tile // 4):
                if k % 4 == 0:
                    four = gate & (S[:, :, k:k + 4].max(-1) > np.maximum(bar, s[:, :, 1]))
                v, code = S[:, :, k], c[:, k][None, :]
                enter = four & (v > s[:, :, 1])
                up = enter & (v > s[:, :, 0])
                s1 = np.where(up, s[:, :, 0], np.where(enter, v, s[:, :, 1]))
                j1 = np.where(up, j[:, :, 0], np.where(enter, code, j[:, :, 1]))
                s[:, :, 0] = np.where(up, v, s[:, :, 0])
                j[:, :, 0] = np.where(up, code, j[:, :, 0])
                s[:, :, 1], j[:, :, 1] = s1, j1
        for off in (1, 2):  # merge_lists<2> with lane ^ off
            w, wi = s[:, np.arange(4) ^ off], j[:, np.arange(4) ^ off]
            for t in range(2):
                take = _lex_greater(w[:, :, 1 - t], wi[:, :, 1 - t], s[:, :, t], j[:, :, t])
                s[:, :, t] = np.where(take, w[:, :, 1 - t], s[:, :, t])
                j[:, :, t] = np.where(take, wi[:, :, 1 - t], j[:, :, t])
            swap = _lex_greater(s[:, :, 1], j[:, :, 1], s[:, :, 0], j[:, :, 0])
            s[swap] = s[swap][:, ::-1]
            j[swap] = j[swap][:, ::-1]
        assert (s == s[:, :1]).all() and (j == j[:, :1]).all()  # every lane agrees
        pv.append(_value_of(s[:, 0]))
        pi.append(j[:, 0])
    v = np.full((B, 2), np.inf, np.float32)
    ix = np.full((B, 2), INT_MAX, np.int64)
    for sv, si in zip(pv, pi):  # topk_merge_splits<2>: insert in split order
        for t in range(2):
            d, n = sv[:, t], si[:, t]
            ins = _lex_less(d, n, v[:, 1], ix[:, 1])
            v[:, 1] = np.where(ins, d, v[:, 1])
            ix[:, 1] = np.where(ins, n, ix[:, 1])
            swap = _lex_less(v[:, 1], ix[:, 1], v[:, 0], ix[:, 0])
            v[swap] = v[swap][:, ::-1]
            ix[swap] = ix[swap][:, ::-1]
    return v, ix


def _argmin_fold(sc, spans, N, tile=64):
    """K4's fold over the (B, N) scores (x keep).m - keep.(m o m) / 2: per
    split, per 64-code tile, per lane the tile's max, and the first code
    reaching it only where it beats the running best; the lanes merged
    lexicographically at xor 1 and 2; the splits folded on (-2 * the score,
    index), the packed-u64 atomicMin.  Returns (values, indices) (B,)."""
    B = sc.shape[0]
    v = np.full(B, np.inf, np.float32)
    ix = np.full(B, INT_MAX, np.int64)
    for lo, hi in spans:
        best = np.full((B, 4), -np.inf, np.float32)
        bidx = np.full((B, 4), INT_MAX, np.int64)
        for n0 in range(lo, hi, tile):
            S, c = _tile_lanes(sc, n0, tile, N)
            m = S.max(-1)
            first = np.argmax(S == m[..., None], axis=-1)  # the first code reaching it
            win = m > best
            best = np.where(win, m, best)
            bidx = np.where(win, c[np.arange(4), first], bidx)
        for off in (1, 2):
            ov, oi = best[:, np.arange(4) ^ off], bidx[:, np.arange(4) ^ off]
            take = _lex_greater(ov, oi, best, bidx)
            best, bidx = np.where(take, ov, best), np.where(take, oi, bidx)
        assert (best == best[:, :1]).all() and (bidx == bidx[:, :1]).all()
        d, n = _value_of(best[:, 0]), bidx[:, 0]
        ok = n != INT_MAX
        take = ok & _lex_less(d, n, v, ix)
        v, ix = np.where(take, d, v), np.where(take, n, ix)
    return v, ix


def _tie_codebook(N, D, dup, pattern, seed):
    """N normal codes, each distinct row `dup` times: as blocks ("tile": rows
    r, r + N / dup, ... tie across tiles and lanes) or in runs ("repeat":
    rows r, r + 1 tie inside a lane); or ("lane") one row for all the codes
    a lane holds in a tile, each lane and tile its own: every lane's second
    ties with the codes after it."""
    rng = np.random.default_rng(seed)
    if pattern == "lane":
        c = np.arange(N)
        base = rng.normal(size=(4 * (N // 64 + 1), D)).astype(np.float32)
        return np.ascontiguousarray(base[(c // 64) * 4 + (c % 8) // 2])
    base = rng.normal(size=(-(-N // dup), D)).astype(np.float32)
    if dup == 1:
        return base[:N]
    out = np.tile(base, (dup, 1)) if pattern == "tile" else np.repeat(base, dup, axis=0)
    return np.ascontiguousarray(out[:N])


def _clamped(v, x2):
    return torch.clamp(torch.from_numpy(np.ascontiguousarray(v)) + x2, min=0.0).numpy()


@pytest.mark.parametrize("N,dup,pattern,splits", [
    (2, 1, "tile", 1), (200, 2, "tile", 1), (200, 2, "repeat", 2), (333, 3, "tile", 3),
    (333, 3, "repeat", 1), (1000, 1, "tile", 3), (1000, 2, "tile", 4),
    (1000, 2, "repeat", 5), (129, 1, "tile", 2), (384, 3, "repeat", 3),
    (1000, 1, "lane", 2)])
def test_k8_top2_fold_reenacted_matches_tf32x3(N, dup, pattern, splits):
    rng = np.random.default_rng(N + 7 * dup + splits)
    D, B = 37, 160
    codes = _tie_codebook(N, D, dup, pattern, seed=N + dup)
    x = rng.normal(size=(B, D)).astype(np.float32)
    x[3] = codes[min(5, N - 1)]  # a sample on a code: its two copies tie at the top
    xt, ct = torch.from_numpy(x), torch.from_numpy(codes)
    m2 = (ct * ct).sum(-1)
    sc = (tf32x3_mm(xt, ct.T) - 0.5 * m2[None, :]).numpy()
    v, ix = _top2_fold(sc, da.k1_sm90_spans(N, splits), N)
    d1, i1, d2, i2 = dist_top2_tf32x3(xt, ct)
    x2 = (xt * xt).sum(-1)
    assert np.array_equal(_bits(_clamped(v[:, 0], x2)), _bits(d1))
    assert np.array_equal(_bits(_clamped(v[:, 1], x2)), _bits(d2))
    assert np.array_equal(ix[:, 0], i1.numpy()) and np.array_equal(ix[:, 1], i2.numpy())
    if dup > 1 and N % dup == 0:  # exact ties went to the lower copy
        assert (ix[:, 0] < N).all() and (ix[:, 0] != ix[:, 1]).all()


@pytest.mark.parametrize("N,dup,pattern,splits,D", [
    (2, 1, "tile", 1, 5), (100, 2, "tile", 1, 37), (100, 2, "repeat", 2, 37),
    (333, 3, "tile", 3, 64), (333, 3, "repeat", 1, 5), (1000, 1, "tile", 3, 37),
    (1000, 2, "repeat", 4, 130), (65, 1, "tile", 2, 37), (640, 2, "tile", 5, 33),
    (1000, 1, "lane", 3, 37)])
def test_k4_argmin_fold_reenacted_matches_tf32x3(N, dup, pattern, splits, D):
    rng = np.random.default_rng(N + 11 * dup + splits + D)
    B = 160
    codes = _tie_codebook(N, D, dup, pattern, seed=N + dup + D)
    x = rng.normal(size=(B, D)).astype(np.float32)
    mask = (rng.uniform(size=(B, D)) < 0.3).astype(np.uint8)
    mask[::7] = 1  # fully masked rows: score 0 everywhere, index 0
    xt, ct, mt = torch.from_numpy(x), torch.from_numpy(codes), torch.from_numpy(mask)
    keep = keep_of(mt)
    xk = xt * keep
    qhi, qlo = tf32_split(ct * ct)
    s1 = tf32x3_mm(xk, ct.T)
    s2 = keep @ qlo.T + keep @ qhi.T
    sc = (s1 - 0.5 * s2).numpy()
    v, ix = _argmin_fold(sc, da.k4_sm90_spans(N, splits), N)
    want_v, want_i = dist_argmin_masked_tf32x3(xt, ct, mt)
    got_v = _clamped(v, (xk * xk).sum(-1))
    assert np.array_equal(_bits(got_v), _bits(want_v))
    assert np.array_equal(ix, want_i.numpy())
    full = mask.all(1)
    assert full.any() and (ix[full] == 0).all() and (got_v[full] == 0).all()
