"""K10 on K8's Hopper walk and K14's main form on K13's Hopper walk with its
batch split across a thread-block cluster: the parts the CPU can hold.

* K10 (csrc/argmin_sm90.cu, `dist_topk_sm90_kernel`): the plain
  `dist_topk` against the JAX kernel in interpret mode at k 1, 2, 3, 5, 8
  and 16, on random and tie-heavy codebooks and in the reversed tie order
  (`dist_topk_reference`); a NumPy re-enactment of the walk's fold at list
  width KM (four lanes a sample, each with the codes of its accumulator
  columns, the sample's bar the highest KM-th of its lanes' lists, codes
  visited four at a time, the lanes merged by merge_lists, the splits by
  topk_merge_splits) held to the exact lexicographic top k (hypothesis, on
  random and duplicated scores) and bit for bit to the split-TF32 emulation
  of K10 (`dist_topk_tf32x3`); the wrapper's scratch and splits.
* K14 (csrc/separable_sm90.cuh): the plain K14 with the update
  summed in the batch ranges of a cluster of c CTAs (`cluster_ranges`, the
  partials added in rank order) against the JAX K14 at c 1, 2, 4 and 8, for
  gaussian and bubble, hexa and rect, each bf16 option and a bf16 codebook,
  at the tolerances of tests/test_torch_factored.py's K14 test; the
  cluster choice `k14_cluster`, `cluster_ranges` and `k14_route` at their
  boundaries.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from som_lvq_pak_tpu.ops import pallas_distance as jpd
from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_torch.ops import dist_argmin as da
from som_lvq_pak_torch.ops import som_step
from som_lvq_pak_torch.ops.dist_topk import (dist_topk, dist_topk_reference,
                                             topk_scratch_floats)
from som_lvq_pak_torch.ops.tf32x3 import dist_topk_tf32x3, tf32x3_mm
from test_torch_argmin_sm90_masked import (_bits, _clamped, _lex_greater, _lex_less,
                                           _tie_codebook, _tile_lanes, _value_of)
from test_torch_factored import (TOL, _bf16_ulp_close, _inputs, _jax, _pad128,
                                 assert_own_scoring, assert_winners_agree)

T = torch.from_numpy
INT_MAX = np.iinfo(np.int32).max
KS = [1, 2, 3, 5, 8, 16]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run torch on one CPU thread in this module, as
    tests/test_torch_factored.py does for the gaussian step."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- K10: the plain version against JAX ----------------------------------------

def _topk_codebook(pattern, N, D, seed):
    if pattern == "random":
        return np.random.default_rng(seed).normal(size=(N, D)).astype(np.float32)
    return _tie_codebook(N, D, 3, pattern, seed)


@pytest.mark.parametrize("pattern", ["random", "tile", "repeat"])
@pytest.mark.parametrize("k", KS)
def test_dist_topk_plain_matches_jax(k, pattern):
    """Values to 1e-5, indices equal (exact ties: the lower index first)."""
    D, N = 7, 60
    codes = _topk_codebook(pattern, N, D, seed=40 + k)
    x = np.random.default_rng(50 + k).normal(size=(40, D)).astype(np.float32)
    x[0] = codes[4]  # a sample on a code: its copies tie at the top
    val, idx = dist_topk(T(x), T(codes), k)
    jval, jidx = jpd.dist_topk(jnp.asarray(x), jnp.asarray(codes), k,
                               tile_b=8, tile_n=128, interpret=True)
    assert val.shape == (40, k) and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pattern", ["random", "tile"])
@pytest.mark.parametrize("k", KS)
def test_dist_topk_reference_order_matches_jax(k, pattern):
    """The reversed tie order (`dist_topk_reference`: K10 on the reversed
    codebook, each index mapped back): the JAX kernel on the reversed
    codebook, its indices mapped back alike; equal distances go to the
    highest index first."""
    D, N = 5, 48
    codes = _topk_codebook(pattern, N, D, seed=60 + k)
    x = np.random.default_rng(70 + k).normal(size=(24, D)).astype(np.float32)
    rev = np.ascontiguousarray(codes[::-1])
    val, idx = dist_topk_reference(T(x), T(rev), k)
    jval, jidx = jpd.dist_topk(jnp.asarray(x), jnp.asarray(rev), k, tile_b=8,
                               tile_n=128, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), N - 1 - np.asarray(jidx))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=1e-5, atol=1e-5)
    if pattern == "tile" and k >= 2:  # copies N / 3 apart: the later one first
        first, second = idx.numpy()[:, 0], idx.numpy()[:, 1]
        tie = (codes[first] == codes[second]).all(1)
        assert tie.any() and (first[tie] > second[tie]).all()


# -- K10: the walk's fold re-enacted -------------------------------------------

def _push(s, j, v, code, on):
    """ListFold::visit where `on`: (v, code) into each lane's list (..., KM)
    sorted high first, past every equal score, the last pair dropped."""
    KM = s.shape[-1]
    enter = on & (v > s[..., KM - 1])
    placed = ~enter
    for t in range(KM - 1, 0, -1):
        up = ~placed & (v > s[..., t - 1])
        keep = ~placed
        s[..., t] = np.where(keep, np.where(up, s[..., t - 1], v), s[..., t])
        j[..., t] = np.where(keep, np.where(up, j[..., t - 1], code), j[..., t])
        placed = placed | ~up
    s[..., 0] = np.where(~placed, v, s[..., 0])
    j[..., 0] = np.where(~placed, code, j[..., 0])


def _merge_lists(s, j, w, wi):
    """topk_fold.cuh's merge_lists on the last axis: the better of s[t] and
    w[KM - 1 - t], then the bitonic half-cleaners."""
    KM = s.shape[-1]
    for t in range(KM):
        take = _lex_greater(w[..., KM - 1 - t], wi[..., KM - 1 - t], s[..., t], j[..., t])
        s[..., t] = np.where(take, w[..., KM - 1 - t], s[..., t])
        j[..., t] = np.where(take, wi[..., KM - 1 - t], j[..., t])
    h = KM // 2
    while h:
        for t in range(KM):
            if t & h:
                continue
            sw = _lex_greater(s[..., t + h], j[..., t + h], s[..., t], j[..., t])
            a, ai = s[..., t].copy(), j[..., t].copy()
            s[..., t] = np.where(sw, s[..., t + h], a)
            j[..., t] = np.where(sw, j[..., t + h], ai)
            s[..., t + h] = np.where(sw, a, s[..., t + h])
            j[..., t + h] = np.where(sw, ai, j[..., t + h])
        h //= 2


def _topk_fold(sc, spans, N, KM, k, tile=128):
    """K10's fold over the (B, N) scores x.m - ||m||^2 / 2 at list width KM
    (k <= KM): per split, per 128-code tile, per lane a sorted list of KM
    (score, code), entered only where the tile's max over the lane's codes
    beats the sample's bar (the highest KM-th of its four lanes at the
    tile's start), then the lane's codes ascending, four at a time where
    their max beats the bar and the lane's own KM-th too, each with a strict
    >; the lanes merged by merge_lists at xor 1 and 2; the splits' k pairs
    inserted in split order (topk_merge_splits<KM>).  Returns (values,
    indices) (B, k), partial distances."""
    B = sc.shape[0]
    parts = []
    for lo, hi in spans:
        s = np.full((B, 4, KM), -np.inf, np.float32)
        j = np.full((B, 4, KM), INT_MAX, np.int64)
        for n0 in range(lo, hi, tile):
            S, c = _tile_lanes(sc, n0, tile, N)
            bar = np.broadcast_to(s[:, :, KM - 1].max(-1, keepdims=True), (B, 4))
            gate = S.max(-1) > bar
            for q in range(tile // 4):
                if q % 4 == 0:
                    four = gate & (S[:, :, q:q + 4].max(-1) > np.maximum(bar, s[:, :, KM - 1]))
                _push(s, j, S[:, :, q], np.broadcast_to(c[:, q][None, :], (B, 4)), four)
        for off in (1, 2):
            lanes = np.arange(4) ^ off
            _merge_lists(s, j, s[:, lanes].copy(), j[:, lanes].copy())
        assert (s == s[:, :1]).all() and (j == j[:, :1]).all()  # every lane agrees
        parts.append((_value_of(s[:, 0, :k]), j[:, 0, :k]))
    v = np.full((B, KM), np.inf, np.float32)
    ix = np.full((B, KM), INT_MAX, np.int64)
    for pv, pi in parts:  # topk_fold.cuh's insert, split by split
        for t in range(k):
            d, n = pv[:, t], pi[:, t]
            ins = _lex_less(d, n, v[:, KM - 1], ix[:, KM - 1])
            v[:, KM - 1] = np.where(ins, d, v[:, KM - 1])
            ix[:, KM - 1] = np.where(ins, n, ix[:, KM - 1])
            for u in range(KM - 1, 0, -1):
                sw = _lex_less(v[:, u], ix[:, u], v[:, u - 1], ix[:, u - 1])
                a, ai = v[:, u - 1].copy(), ix[:, u - 1].copy()
                v[:, u - 1] = np.where(sw, v[:, u], a)
                ix[:, u - 1] = np.where(sw, ix[:, u], ai)
                v[:, u] = np.where(sw, a, v[:, u])
                ix[:, u] = np.where(sw, ai, ix[:, u])
    return v[:, :k], ix[:, :k]


def _exact_topk(sc, k):
    """The k smallest (value, index) pairs of the partial distances -2 *
    score (-0 folded to +0), lexicographic."""
    d = _value_of(sc)
    order = np.stack([np.lexsort((np.arange(d.shape[1]), row)) for row in d])[:, :k]
    return np.take_along_axis(d, order, 1), order


def km_of(k):
    return min(m for m in (2, 4, 8, 16) if m >= k)


@settings(max_examples=60, deadline=None)
@given(N=st.integers(1, 700), KM=st.sampled_from([2, 4, 8, 16]),
       splits=st.integers(1, 6), levels=st.sampled_from([3, 20, 1000]),
       data=st.data())
def test_k10_fold_gives_the_exact_top_k(N, KM, splits, levels, data):
    """The pruned fold on integer scores (few levels: many exact ties) is the
    exact lexicographic top k at every k <= KM, split by split too."""
    k = data.draw(st.integers(1, min(KM, N)))
    seed = data.draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    sc = rng.integers(-levels, levels, size=(6, N)).astype(np.float32)
    if data.draw(st.booleans()):  # every score twice: a copy in another lane or tile
        sc = np.concatenate([sc, sc], 1)[:, :N]
    v, ix = _topk_fold(sc, da.k1_sm90_spans(N, splits), N, KM, k)
    wv, wi = _exact_topk(sc, k)
    assert np.array_equal(_bits(v), _bits(wv)) and np.array_equal(ix, wi)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("N,pattern,splits,D", [
    (999, "random", 2, 5), (998, "tile", 3, 5), (1000, "repeat", 1, 37),
    (1000, "lane", 4, 64), (300, "tile", 2, 130), (17, "random", 1, 5)])
def test_k10_fold_reenacted_matches_tf32x3(k, N, pattern, splits, D):
    """The fold on the split-TF32 scores the walk computes (K1's floats) is
    `dist_topk_tf32x3`'s k pairs bit for bit, its column 0 the argmin's."""
    if k > N:
        pytest.skip(f"k={k} > N={N}: the wrapper refuses it")
    rng = np.random.default_rng(N + k + D)
    codes = (_topk_codebook("random", N, D, seed=N + D) if pattern == "random"
             else _tie_codebook(N, D, 2, pattern, seed=N + D))
    x = rng.normal(size=(96, D)).astype(np.float32)
    x[5] = codes[min(7, N - 1)]
    xt, ct = T(x), T(codes)
    m2 = (ct * ct).sum(-1)
    sc = (tf32x3_mm(xt, ct.T) - 0.5 * m2[None, :]).numpy()
    v, ix = _topk_fold(sc, da.k1_sm90_spans(N, splits), N, km_of(k), k)
    wv, wi = dist_topk_tf32x3(xt, ct, k)
    x2 = (xt * xt).sum(-1)[:, None]
    assert np.array_equal(_bits(_clamped(v, x2)), _bits(wv))
    assert np.array_equal(ix, wi.numpy())


def test_k10_scratch_and_splits():
    """The wrapper's one scratch (K1's prologue, then the splits' (splits, B,
    k) pairs) and K1's splits: one wave of one CTA an SM at the mesh rank's
    shape."""
    assert topk_scratch_floats(512, 32768, 64, 2, 33) == (
        2 * 32768 * 64 + 32768 + 2 * 33 * 512 * 2)
    assert topk_scratch_floats(10, 5, 37, 3, 1) == 2 * 5 * 64 + 8 + 2 * 10 * 3
    splits = da.k1_sm90_splits(512, 32768, 132)
    assert splits == 33 and -(-512 // da.K1_SAMPLES) * splits <= 132


# -- K14: the cluster split against JAX ---------------------------------------

XDIM, YDIM, B14, D14 = 16, 8, 256, 64
K14_CASES = [(True, True, dict()), (True, True, dict(wxa_bf16=True)),
             (True, False, dict(batch_bf16=True)),
             (False, True, dict(wxa_bf16=True, batch_bf16=True)),
             (False, False, dict())]


@functools.lru_cache(maxsize=None)
def _k14_inputs():
    return _inputs(XDIM * YDIM, D14, B14, B14, seed=29)


@functools.lru_cache(maxsize=None)
def _k14_jax(hexa, gaussian, flags, bf16=False):
    codes, xb, bmu, xn, alpha = _k14_inputs()
    kw = dict(tile_n=32, batch_chunk=128, **dict(flags))
    if bf16:
        c16 = codes.astype(jnp.bfloat16).astype(np.float32)
        jc, ji, jv = jps.som_fused_train_step(
            _pad128(c16).astype(jnp.bfloat16), _pad128(xb), jnp.asarray(bmu), _pad128(xn),
            XDIM, hexa, jnp.asarray(alpha), 3.0, gaussian=gaussian, **kw)
        return np.asarray(jc.astype(jnp.float32))[:, :D14], np.asarray(ji), np.asarray(jv)
    return _jax(codes, xb, bmu, xn, XDIM, hexa, alpha, 3.0, gaussian, **kw)


def _k14_plain(hexa, gaussian, flags, cluster, bf16=False):
    codes, xb, bmu, xn, alpha = _k14_inputs()
    c = T(codes.copy())
    if bf16:
        c = c.to(torch.bfloat16)
    out, i, v = som_step.som_fused_factored_chunked_step_plain(
        c, T(xb), T(bmu), T(xn), XDIM, hexa, T(alpha), 3.0, gaussian,
        batch_chunk=128, cluster=cluster, **flags)
    return out.to(torch.float32).numpy(), i.numpy(), v.numpy()


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("hexa,gaussian,flags", K14_CASES,
                         ids=["hexa-gauss-f32", "hexa-gauss-wxa", "hexa-bubble-batch",
                              "rect-gauss-both", "rect-bubble-f32"])
def test_k14_cluster_split_matches_jax(hexa, gaussian, flags, cluster):
    """The update summed over the c ranks' batch ranges, the partials added
    in rank order: codes within 1e-5 of JAX's K14; winners agree (under
    batch_bf16 on the bf16-rounded rows), values within 1e-4 (5e-3 under
    batch_bf16, test_torch_factored.py's reasons) and within 1e-4 of the
    scoring of its own rows."""
    c, i, v = _k14_plain(hexa, gaussian, flags, cluster)
    jc, ji, jv = _k14_jax(hexa, gaussian, tuple(sorted(flags.items())))
    _, _, _, xn, _ = _k14_inputs()
    np.testing.assert_allclose(c, jc, rtol=TOL, atol=TOL)
    bb = bool(flags.get("batch_bf16"))
    assert_winners_agree(xn, c, i, ji, bf16_score=bb)
    np.testing.assert_allclose(v, jv, rtol=0.0 if bb else 1e-4, atol=5e-3 if bb else 1e-4)
    assert_own_scoring(xn, c, i, v, bb)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_k14_cluster_split_bf16_codebook_matches_jax(cluster):
    """A bf16 codebook (SOMTrainer(bf16=True)) under both bf16 options: each
    entry within one bf16 ulp of JAX's, winners within 1e-2 relative,
    values within 5e-3."""
    flags = dict(wxa_bf16=True, batch_bf16=True)
    c, i, v = _k14_plain(True, True, flags, cluster, bf16=True)
    jc, ji, jv = _k14_jax(True, True, tuple(sorted(flags.items())), bf16=True)
    _, _, _, xn, _ = _k14_inputs()
    _bf16_ulp_close(c, jc)
    assert_winners_agree(xn, c, i, ji, tol=1e-2, bf16_score=True)
    np.testing.assert_allclose(v, jv, rtol=0.0, atol=5e-3)


@pytest.mark.parametrize("cluster", [2, 4, 8])
def test_k14_cluster_split_moves_only_the_rounding(cluster):
    """At c > 1 the batch sum is reassociated at c - 1 points: the codebook
    within 1e-5 of c = 1's, and not further from JAX's than the tolerance."""
    c1, _, _ = _k14_plain(True, True, {}, 1)
    cc, _, _ = _k14_plain(True, True, {}, cluster)
    np.testing.assert_allclose(cc, c1, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B", [1, 31, 32, 33, 100, 256, 1000, 4096, 4097])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_cluster_ranges_are_whole_chunks_in_rank_order(B, cluster):
    """Rank r's samples: the 32-sample update chunks [r n / c, (r + 1) n /
    c) of n = ceil(B / 32) (csrc/separable_sm90.cuh's range_lo),
    contiguous, every sample once, the last cut at B."""
    ranges = som_step.cluster_ranges(B, cluster)
    n = -(-B // 32)
    assert len(ranges) == cluster and ranges[0][0] == 0 and ranges[-1][1] == B
    for r, (lo, hi) in enumerate(ranges):
        assert lo == min(B, (r * n // cluster) * 32) and lo <= hi
        assert hi == B or hi % 32 == 0
        assert r == 0 or lo == ranges[r - 1][1]
    sizes = [-(-(hi - lo) // 32) for lo, hi in ranges]
    assert max(sizes) - min(sizes) <= 1


def test_cluster_ranges_reject_other_sizes():
    for c in (0, 3, 16):
        with pytest.raises(ValueError):
            som_step.cluster_ranges(256, c)


@pytest.mark.parametrize("tiles,sms,want", [
    (1, 132, 8), (8, 132, 8), (16, 132, 8), (17, 132, 4), (32, 132, 4), (33, 132, 4),
    (34, 132, 2), (66, 132, 2), (67, 132, 1), (128, 132, 1), (132, 132, 1),
    (512, 132, 1), (16, 114, 4), (14, 114, 8)])
def test_k14_cluster_choice(tiles, sms, want):
    """The largest cluster in (1, 2, 4, 8) whose tiles x size CTAs fill at
    most one wave of one CTA an SM: the trainer's K14 maps 32x32, 64x32 and
    64x64 (8, 16 and 32 tiles) take 8, 8 and 4 on an H100's 132 SMs, 128x128
    and 256x256 one."""
    got = som_step.k14_cluster(tiles, sms)
    assert got == want and got in som_step.K14_CLUSTERS
    assert got == 1 or tiles * got <= sms


def test_k14_route_at_its_boundary():
    assert som_step.k14_route(1) == som_step.k14_route(128) == "sm90"
    assert som_step.k14_route(129) == som_step.k14_route(512) == "mma_sync"
    with pytest.raises(ValueError):
        som_step.k14_route(0)


def test_k14_variant_sources_edit_the_walk():
    """tools/fused_step_ab.py's K14 variants: no_w reads no table (K13's
    edit of the same line), no_exchange has no cluster barrier in the
    consumers or the producer and reads no other rank's partial; each edit
    is checked against the header's lines."""
    from som_lvq_pak_torch import _build
    from som_lvq_pak_torch.tools import fused_step_ab as ab

    with open(f"{_build.CSRC}/separable_sm90.cuh") as f:
        src = f.read()
    v = ab.k14_variant_sources(src)
    assert list(v) == list(ab.K14_VARIANTS) and v["walk"] == src
    assert "__ldg(pat + po[h] + s)" in src and "__ldg(pat + po[h] + s)" not in v["no_w"]
    assert src.count("cluster_sync();") == 2 and src.count("cluster_sync_thread();") == 4
    assert "cluster_sync" not in v["no_exchange"].split("#pragma once")[1]
    assert "r < 0; ++r" in v["no_exchange"] and "ld_cluster_v4" in v["no_exchange"]
    with pytest.raises(ValueError):
        ab.k14_variant_sources(src.replace("  sm90::cluster_sync();\n", ""))


@pytest.mark.parametrize("B,N,D,dup", [(40, 61, 5, True), (33, 130, 37, False)])
def test_fused_step_ab_topk_digests_repeat_on_the_cpu(B, N, D, dup):
    """`tools.fused_step_ab`'s top-k cases on the CPU (the plain K10): every
    k from 1 to 16 of the list widths in file and reversed order is
    digested, and a second run on the same seed gives the same digests, so
    equal digests across trees mean equal pairs."""
    from som_lvq_pak_torch.tools import fused_step_ab

    one, two = (fused_step_ab.run_topk(B, N, D, dup, torch.device("cpu")) for _ in range(2))
    keys = [k for k in one if k.endswith("_digest")]
    assert len(keys) == 2 * len(KS) and one == two
    assert all(len(one[k]) == 64 for k in keys)
