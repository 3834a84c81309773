"""K1's and K2's Hopper walk (csrc/argmin_sm90.cu) on the CPU: its prologue's
plain version (`split_codes_plain`: the codebook split into TF32 hi and lo
once per call, ||m||^2 in the order the card sums it), its split rule
(`k1_sm90_splits`, `k1_sm90_spans`) and the plain K1/K2 against the JAX
package's Pallas kernels in interpret mode.

Tolerances: hi and lo bit-equal to `ops.tf32x3.tf32_split`; ||m||^2 within
1e-6 relative of the float64 sum (64-term float32 sums in a tree) and
bit-equal to an exact re-enactment of the kernel's order (Fractions for its
fused multiply-adds); the plain K1/K2 as tests/test_torch_ops.py holds them
(winners equal except where the float64 distances differ by less than 1e-5
relative, values within 1e-5)."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.ops import pallas_distance as jpd
from som_lvq_pak_torch.ops import dist_argmin as da
from som_lvq_pak_torch.ops.tf32x3 import tf32_split

TOL = 1e-5


def _codes(N, D, seed):
    """Rows over six decades of scale, so the sums round at every step."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-3, 3, size=(N, 1))
    return (rng.normal(size=(N, D)) * scale).astype(np.float32)


def _round32(t: Fraction) -> np.float32:
    """The float32 nearest to the exact `t`, ties to the even mantissa."""
    r = np.float32(float(t))
    cands = (np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - t),
                                     int(np.array(c, np.float32).view(np.int32)) & 1))


def _fma_exact(a, b, c) -> np.float32:
    return _round32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def _m2_reenacted(row: np.ndarray) -> np.float32:
    """||m||^2 of one row as split_codes_kernel sums it: per 64-feature slab,
    lane f's fma(v[f + 32], v[f + 32], v[f] v[f]), the xor tree over 16, 8,
    4, 2, 1 (lane 0's value), the slabs left to right."""
    slabs = -(-row.size // 64)
    v = np.zeros(64 * slabs, np.float32)
    v[:row.size] = row
    m = None
    for sl in range(slabs):
        lanes = np.array([_fma_exact(v[64 * sl + 32 + f], v[64 * sl + 32 + f],
                                     v[64 * sl + f] * v[64 * sl + f]) for f in range(32)],
                         np.float32)
        for off in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[np.arange(32) ^ off]
        m = lanes[0] if m is None else np.float32(m + lanes[0])
    return m


@pytest.mark.parametrize("D", [5, 32, 33, 37, 64, 130])
def test_split_codes_hi_lo_are_tf32_split(D):
    codes = _codes(23, D, seed=D)
    hi, lo, _ = da.split_codes_plain(torch.from_numpy(codes))
    Dp = da.split_codes_dp(D)
    assert hi.shape == lo.shape == (23, Dp) and Dp % 32 == 0 and Dp >= D
    padded = torch.zeros((23, Dp), dtype=torch.float32)
    padded[:, :D] = torch.from_numpy(codes)
    want_hi, want_lo = tf32_split(padded)
    assert torch.equal(hi.view(torch.int32), want_hi.view(torch.int32))
    assert torch.equal(lo.view(torch.int32), want_lo.view(torch.int32))
    assert not hi[:, D:].any() and not lo[:, D:].any()


@pytest.mark.parametrize("D", [5, 37, 64, 130])
def test_split_codes_m2_near_float64(D):
    codes = _codes(200, D, seed=100 + D)
    _, _, m2 = da.split_codes_plain(torch.from_numpy(codes))
    want = (codes.astype(np.float64) ** 2).sum(1)
    np.testing.assert_allclose(m2.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("D", [5, 37, 64, 130])
def test_split_codes_m2_is_the_kernels_order(D):
    codes = _codes(9, D, seed=200 + D)
    _, _, m2 = da.split_codes_plain(torch.from_numpy(codes))
    want = np.array([_m2_reenacted(r) for r in codes], np.float32)
    assert np.array_equal(m2.numpy().view(np.int32), want.view(np.int32))


def test_fma32_rounds_once():
    rng = np.random.default_rng(7)
    n = 3000
    a, b, c = (rng.normal(size=n) * 10.0 ** rng.uniform(-8, 8, size=n)
               for _ in range(3))
    a, b, c = (np.asarray(t, np.float32) for t in (a, b, c))
    # the float64 sum on a float32 midpoint with the exact sum below it:
    # rounding twice goes up to 1 + 2^-22, once stays at 1 + 2^-23
    a[0], b[0], c[0] = 1 + 2.0 ** -23, 2.0 ** -24 * (1 - 2.0 ** -23), 1 + 2.0 ** -23
    got = da._fma32(*(torch.from_numpy(t) for t in (a, b, c))).numpy()
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    twice = np.float32(np.float64(a[0]) * np.float64(b[0]) + np.float64(c[0]))
    assert twice == np.float32(1 + 2.0 ** -22) and got[0] == np.float32(1 + 2.0 ** -23)


def test_split_codes_cpu_is_plain():
    codes = torch.from_numpy(_codes(40, 37, seed=3))
    n = da.split_codes.launches
    got, want = da.split_codes(codes), da.split_codes_plain(codes)
    assert da.split_codes.launches == n
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        da.split_codes(codes.double())
    with pytest.raises(ValueError):
        da.split_codes(codes[:0])


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("B,N", [(1, 4096), (1, 65536), (512, 32768), (1024, 4096),
                                 (1024, 65536), (4096, 65536), (16384, 65536),
                                 (1_000_000, 65536), (777, 3001), (1000, 2), (300, 129)])
def test_k1_sm90_splits_cover_every_code_once(B, N, sms):
    splits = da.k1_sm90_splits(B, N, sms)
    tiles = -(-N // da.K1_TILE)
    assert 1 <= splits <= tiles
    spans = da.k1_sm90_spans(N, splits)
    assert 1 <= len(spans) <= splits
    assert spans[0][0] == 0 and spans[-1][1] == N
    for (lo, hi), (nxt, _) in zip(spans, spans[1:] + [(N, None)]):
        assert lo < hi == nxt  # non-empty, contiguous: every code once
        assert lo % da.K1_TILE == 0 and (hi == N or hi % da.K1_TILE == 0)
        # a split has tiles to overlap in its ring
        assert splits == 1 or hi - lo >= da.K1_MIN_SPAN * da.K1_TILE or hi == N
    # one CTA an SM: the grid is at most one wave unless the batch alone
    # needs more (then the codebook is not split)
    b_tiles = -(-B // da.K1_SAMPLES)
    assert b_tiles * len(spans) <= sms or splits == 1


def _pad128(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(np.pad(a, ((0, 0), (0, -a.shape[1] % 128))))


def _assert_winners_agree(x, codes, i_port, i_ref):
    i_port = np.asarray(i_port, np.int64)
    i_ref = np.asarray(i_ref, np.int64)
    bad = np.nonzero(i_port != i_ref)[0]
    if bad.size:
        x64 = np.asarray(x, np.float64)[bad]
        c64 = np.asarray(codes, np.float64)
        d_a = ((x64 - c64[i_port[bad]]) ** 2).sum(-1)
        d_b = ((x64 - c64[i_ref[bad]]) ** 2).sum(-1)
        gap = np.abs(d_a - d_b) / np.maximum(np.maximum(d_a, d_b), 1e-30)
        assert gap.max() < TOL, (bad, gap)


@pytest.mark.parametrize("B,N,D", [(1, 300, 64), (50, 257, 37), (33, 129, 130),
                                   (129, 384, 32)])
@pytest.mark.parametrize("form", ["classic", "max_score"])
def test_dist_argmin_cpu_matches_jax(B, N, D, form):
    rng = np.random.default_rng(B + N + D)
    x = rng.normal(size=(B, D)).astype(np.float32)
    codes = rng.normal(size=(N, D)).astype(np.float32)
    port, ref = ((da.dist_argmin, jpd.dist_argmin) if form == "classic"
                 else (da.dist_argmin_t, jpd.dist_argmin_t))
    v, i = port(torch.from_numpy(x), torch.from_numpy(codes))
    jv, ji = ref(_pad128(x), _pad128(codes))
    assert i.dtype == torch.int32 and v.dtype == torch.float32
    _assert_winners_agree(x, codes, i.numpy(), ji)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)


def test_fold_ab_variants_edit_the_walk():
    from som_lvq_pak_torch import _build
    from som_lvq_pak_torch.tools import argmin_fold_ab as ab

    with open(f"{_build.CSRC}/argmin_sm90.cu") as f:
        src = f.read()
    v = ab.variant_sources(src)
    assert list(v) == list(ab.VARIANTS) and v["walk"] == src
    assert "bar_sync" in src and all("bar_sync" not in v[n] for n in ("no_turns", "per_score"))
    assert "if (sc > best[h])" in v["per_score"] and "fmaxf" not in v["per_score"]
    assert "S[0] > best[0]" in v["no_fold"] and "bar_sync" in v["no_fold"]
    assert v["no_turns"].count("fmaxf") == src.count("fmaxf")
    with pytest.raises(ValueError):
        ab.variant_sources(src.replace("    __syncwarp();\n", ""))


def test_fold_ab_variants_edit_k8_and_k4():
    from som_lvq_pak_torch import _build
    from som_lvq_pak_torch.tools import argmin_fold_ab as ab

    with open(f"{_build.CSRC}/argmin_sm90.cu") as f:
        v = ab.variant_sources(f.read())
    # K8's top-2 fold (K10's list fold, one walk) sits inside the fold the
    # variants replace
    assert "list.visit" in v["no_turns"] and "list.visit" not in v["no_fold"]
    with open(f"{_build.CSRC}/argmin_masked_sm90.cu") as f:
        src = f.read()
    m = ab.masked_variant_sources(src)
    assert list(m) == ["walk", "no_fold"] and m["walk"] == src
    assert src.count("fmaxf") > 0 and "fmaxf" not in m["no_fold"]
    assert "S1[0] - 0.5f * S2[0] > best[0]" in m["no_fold"]
    assert "list.s[0][0] = S[0]" in v["no_fold"]
    assert m["no_fold"].count("bar_sync") == src.count(
        "bar_sync")
    with pytest.raises(ValueError):
        ab.masked_variant_sources(src.replace("    __syncwarp();\n", ""))
