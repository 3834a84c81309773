"""The port's kNN front end (ops.distance: `topk_winners` with
reference_ties, `chunked_topk`, `pairwise_topk_mode`, `auto_pairwise_topk`;
ops.dist_topk.dist_topk_reference) and the host tools' fast modes on the
CPU (the plain versions) against the JAX package's.

Tolerances: indices equal except at near-ties, where the two lists' j-th
neighbours' float64 distances (over the kept components) differ by less
than 1e-5 relative; values within 1e-5 relative, plus 1e-5 of the
squared-norm scale (the expanded form ||x||^2 - 2 x.m + ||m||^2 cancels
to that).  Exact ties (every code twice) are equal indices: the later
copy first, as ops.exact.pairwise_topk orders them.  A result at two
chunk sizes is bit-equal.  SOMVQ_AUTO_TOPK_PAIRS is monkeypatched to 0
where both packages must take their device route; the fast tools
(`knn_correct_mask`, `eveninit`, `setlabel`, `elimin`, `knn_accuracy`)
then give the JAX package's fast results on the repo's golden data."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.data import io as jio
from som_lvq_pak_tpu.models import eval as jeval
from som_lvq_pak_tpu.models import lvq as jlvq
from som_lvq_pak_tpu.models import tools as jtools
from som_lvq_pak_tpu.ops import distance as jdistance
from som_lvq_pak_torch.data import io as pio
from som_lvq_pak_torch.data.labels import GLOBAL_LABELS
from som_lvq_pak_torch.models import eval as peval
from som_lvq_pak_torch.models import lvq, tools
from som_lvq_pak_torch.ops import distance, exact
from som_lvq_pak_torch.ops.dist_topk import dist_topk_reference

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
F32 = np.float32
TOL = 1e-5
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run torch on one CPU thread in this module, as the port's other
    test modules do (see tests/test_torch_masked.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_port_labels():
    GLOBAL_LABELS.reset()
    yield
    GLOBAL_LABELS.reset()


def _d64(x, codes, mask, rows, idx):
    """(len(rows), k) float64 distances of x[rows] to codes[idx] over the
    kept components."""
    keep = 1.0 if mask is None else (mask[rows] == 0).astype(np.float64)[:, None, :]
    diff = np.asarray(x, np.float64)[rows][:, None, :] - np.asarray(codes, np.float64)[idx]
    return (diff * diff * keep).sum(-1)


def assert_knn_agree(x, codes, mask, i_port, i_ref):
    """Equal index lists, except rows where each column's two candidates
    lie within TOL relative in float64."""
    i_port, i_ref = np.asarray(i_port, np.int64), np.asarray(i_ref, np.int64)
    assert i_port.shape == i_ref.shape
    bad = np.nonzero((i_port != i_ref).any(axis=1))[0]
    if bad.size:
        da = _d64(x, codes, mask, bad, i_port[bad])
        db = _d64(x, codes, mask, bad, i_ref[bad])
        gap = np.abs(da - db) / np.maximum(np.maximum(da, db), 1e-30)
        assert gap.max() < TOL, (bad, gap.max())
    return bad.size


def assert_values_close(x, codes, v_port, v_ref):
    scale = float((np.asarray(x, np.float64) ** 2).sum(-1).max()
                  + (np.asarray(codes, np.float64) ** 2).sum(-1).max())
    np.testing.assert_allclose(np.asarray(v_port), np.asarray(v_ref), rtol=TOL,
                               atol=TOL * scale)


def _inputs(seed, B, N, D, dup=False, masked=False, golden=False):
    """x (B, D), codes (N, D) and a mask or None: normal points, or rows of
    elimin.dat (golden); with dup every code twice (rows i and i + N/2);
    with masked, components masked with p 0.2 and every 11th row
    entirely."""
    rng = np.random.default_rng(seed)
    if golden:
        pts = pio.read_data(os.path.join(GOLDEN, "elimin.dat")).points
        x = pts[rng.choice(pts.shape[0], B, replace=False)]
        codes = pts[rng.choice(pts.shape[0], N, replace=False)]
    else:
        x = rng.normal(size=(B, D)).astype(F32)
        codes = rng.normal(size=(N, D)).astype(F32)
    if dup:
        codes = np.concatenate([codes[:N // 2], codes[:N // 2]])
        x[::5] = codes[rng.integers(0, N // 2, size=x[::5].shape[0])]  # distance-0 ties
    mask = None
    if masked:
        mask = (rng.random(x.shape) < 0.2).astype(np.uint8)
        mask[::11] = 1
        x = np.where(mask != 0, F32(0), x)
    return np.ascontiguousarray(x, F32), np.ascontiguousarray(codes, F32), mask


CASES = [  # (B, N, D, k, dup, masked, golden)
    (300, 257, 5, 1, False, False, False),
    (300, 257, 5, 5, False, False, False),
    (200, 600, 37, 16, False, False, False),
    (150, 90, 20, 20, False, False, False),    # k > 16
    (200, 160, 6, 4, True, False, False),      # exact ties
    (200, 160, 6, 17, True, True, False),      # ties, masked, k > 16
    (250, 300, 9, 5, False, True, False),      # masked, fully masked rows
    (400, 500, 20, 5, False, False, True),     # elimin.dat rows
]


@pytest.mark.parametrize("B,N,D,k,dup,masked,golden", CASES)
def test_chunked_topk_matches_jax(B, N, D, k, dup, masked, golden):
    x, codes, mask = _inputs(B + N + k, B, N, D, dup, masked, golden)
    ip, vp = distance.chunked_topk(T(x), T(codes), k, None if mask is None else T(mask),
                                   chunk=64)
    ij, vj = jdistance.chunked_topk(jnp.asarray(x), jnp.asarray(codes), k,
                                    None if mask is None else jnp.asarray(mask), chunk=64)
    assert ip.dtype == torch.int64 and ip.shape == (B, k)
    assert_knn_agree(x, codes, mask, ip.numpy(), np.asarray(ij))
    assert_values_close(x, codes, vp.numpy(), np.asarray(vj))
    ie, _ = exact.pairwise_topk(x, codes, k, mask)  # the C order, on the host
    assert_knn_agree(x, codes, mask, ip.numpy(), ie)
    if dup:
        # exact ties: the later copy first, in both packages and the host's
        np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(ip.numpy(), ie)
        rows = np.ones(B, bool) if mask is None else ~mask.all(axis=1)
        first = ip[:, 0].numpy()[rows]
        assert (first >= N // 2).all()
        np.testing.assert_array_equal(ip[:, 1].numpy()[rows], first - N // 2)
    if masked:
        # every component masked: every distance 0, the highest indices first
        np.testing.assert_array_equal(ip[::11].numpy(),
                                      np.broadcast_to(np.arange(N - 1, N - 1 - k, -1),
                                                      ip[::11].shape))
        assert (vp[::11] == 0).all()
    assert distance.chunked_topk.plain_launches == 0  # the CPU is no device route


@pytest.mark.parametrize("masked,k", [(False, 5), (True, 5), (False, 17)])
def test_chunked_topk_does_not_depend_on_the_chunk(masked, k):
    """Chunks of 2, 3 and 64 rows (each with a tail) and one whole chunk
    give the same indices and values bit for bit; a one-row chunk is
    refused (BLAS sums a one-row product in another order)."""
    x, codes, mask = _inputs(7 + k, 301, 211, 7, dup=True, masked=masked)
    m = None if mask is None else T(mask)
    iw, vw = distance.chunked_topk(T(x), T(codes), k, m, chunk=4096)
    for chunk in (2, 3, 64, 300):
        ic, vc = distance.chunked_topk(T(x), T(codes), k, m, chunk=chunk)
        assert torch.equal(ic, iw) and torch.equal(vc.view(torch.int32), vw.view(torch.int32))
    with pytest.raises(ValueError, match="one-row"):
        distance.chunked_topk(T(x), T(codes), k, m, chunk=1)
    with pytest.raises(ValueError, match="codes"):
        distance.chunked_topk(T(x), T(codes), 212, m)


@pytest.mark.parametrize("dup", [False, True])
def test_k10_route_on_the_reversed_codebook(dup, monkeypatch):
    """K10's route in the reference order, run on the CPU through its plain
    version: dist_topk on the codebook in reverse row order, mapped back,
    equals topk_winners(reference_ties=True) (indices exactly, values
    clamped at 0), and chunked_topk taking that route gives the plain
    route's indices at any chunk, its default included."""
    x, codes, _ = _inputs(31 + dup, 333, 258, 16, dup=dup)
    vr, ir = dist_topk_reference(T(x), T(codes).flip(0), 5)
    it, vt = distance.topk_winners(T(x), T(codes), 5, reference_ties=True)
    assert ir.dtype == torch.int32
    assert torch.equal(ir.long(), it)
    assert torch.equal(vr, torch.clamp(vt, min=0.0))
    plain_i, _ = distance.chunked_topk(T(x), T(codes), 5, chunk=100)
    monkeypatch.setattr(distance, "k10_route", lambda *a: True)
    ik, vk = distance.chunked_topk(T(x), T(codes), 5, chunk=100)
    assert torch.equal(ik, plain_i) and ik.dtype == torch.int64
    ik2, vk2 = distance.chunked_topk(T(x), T(codes), 5, chunk=7)
    assert torch.equal(ik2, ik) and torch.equal(vk2, vk)
    ik3, vk3 = distance.chunked_topk(T(x), T(codes), 5)  # K10's default chunk
    assert torch.equal(ik3, ik) and torch.equal(vk3, vk)
    if dup:
        assert (ik[:, 0] >= 129).all()


def test_k10_route_rule():
    """K10 takes a CUDA tensor without a mask at k <= 16 (and k <= N); a
    mask, k > 16 or a CPU tensor take the plain version."""
    x = torch.zeros((4, 3))
    assert not distance.k10_route(x, torch.zeros((20, 3)), 5, None)


@pytest.mark.parametrize("masked", [False, True])
def test_auto_pairwise_topk_routes(masked, monkeypatch):
    """Up to SOMVQ_AUTO_TOPK_PAIRS pairs (2^25 by default) the exact host
    path, bit-equal to ops.exact.pairwise_topk; at 0 both packages take
    their device route (the port's plain version on "cpu"); a negative
    threshold keeps the host at every size.  pairwise_topk_mode routes
    parity to the host and fast to auto_pairwise_topk."""
    x, codes, mask = _inputs(41 + masked, 220, 180, 12, masked=masked)
    ie, ve = exact.pairwise_topk(x, codes, 5, mask)
    ih, vh = distance.auto_pairwise_topk(x, codes, 5, mask, device="cpu")
    np.testing.assert_array_equal(ih, ie)
    np.testing.assert_array_equal(vh.view(np.int32), ve.view(np.int32))
    monkeypatch.setenv("SOMVQ_AUTO_TOPK_PAIRS", "0")
    idv, vdv = distance.auto_pairwise_topk(x, codes, 5, mask, device="cpu")
    ijd, vjd = jdistance.auto_pairwise_topk(x, codes, 5, mask)
    assert isinstance(idv, np.ndarray) and idv.shape == (220, 5)
    assert_knn_agree(x, codes, mask, idv, ijd)
    assert_values_close(x, codes, vdv, vjd)
    im, _ = distance.pairwise_topk_mode(x, codes, 5, mask, mode="fast", device="cpu")
    np.testing.assert_array_equal(im, idv)
    ip, vp = distance.pairwise_topk_mode(x, codes, 5, mask, mode="parity")
    np.testing.assert_array_equal(ip, ie)
    monkeypatch.setenv("SOMVQ_AUTO_TOPK_PAIRS", "-1")
    ineg, _ = distance.auto_pairwise_topk(x, codes, 5, mask, device="cpu")
    np.testing.assert_array_equal(ineg, ie)
    with pytest.raises(ValueError, match="mode"):
        distance.pairwise_topk_mode(x, codes, 5, mask, mode="exact")


def _golden(name):
    path = os.path.join(GOLDEN, name)
    return jio.read_data(path), pio.read_data(path)


@pytest.mark.parametrize("knn", [1, 5])
def test_knn_correct_mask_and_eveninit_fast_match_jax(knn):
    """The self-kNN correctness sweep and eveninit/propinit with
    mode="fast" (chunked_topk; the port on "cpu") on elimin.dat, equal to
    the JAX package's fast mode and to its parity mode here."""
    jd, pd = _golden("elimin.dat")
    cm = lvq.knn_correct_mask(pd, knn, mode="fast", device="cpu")
    np.testing.assert_array_equal(cm, jlvq.knn_correct_mask(jd, knn, mode="fast"))
    np.testing.assert_array_equal(cm, lvq.knn_correct_mask(pd, knn, mode="parity"))
    for prop in (False, True):
        je = jlvq.eveninit(jd, 150, knn=knn, proportional=prop, mode="fast")
        pe = lvq.eveninit(pd, 150, knn=knn, proportional=prop, mode="fast", device="cpu")
        np.testing.assert_array_equal(pe.points, je.points)
        np.testing.assert_array_equal(pe.labels, je.labels)


def test_setlabel_elimin_knn_accuracy_fast_match_jax(monkeypatch):
    """setlabel (200 codes against elimin.dat), elimin and knn_accuracy
    with mode="fast", both packages on their device route
    (SOMVQ_AUTO_TOPK_PAIRS=0), equal; also over a StreamingReader."""
    from som_lvq_pak_tpu.data.streaming import StreamingReader as JStreamingReader
    from som_lvq_pak_torch.data.streaming import StreamingReader

    monkeypatch.setenv("SOMVQ_AUTO_TOPK_PAIRS", "0")
    (jc, pc), (jd, pd) = _golden("lvq_e.cod"), _golden("elimin.dat")
    (jo, po), (jx, px) = _golden("lvq_o.cod"), _golden("classify.dat")
    js = jtools.setlabel(jc, jd, knn=5, mode="fast")
    ps = tools.setlabel(pc, pd, knn=5, device="cpu")
    np.testing.assert_array_equal(ps.labels, js.labels)
    path = os.path.join(GOLDEN, "elimin.dat")
    np.testing.assert_array_equal(
        tools.setlabel(pc, StreamingReader(path, buffer=600), knn=5, device="cpu").labels,
        jtools.setlabel(jc, JStreamingReader(path, buffer=600), knn=5, mode="fast").labels)
    je, pe = jtools.elimin(jx, knn=5, mode="fast"), tools.elimin(px, knn=5, device="cpu")
    np.testing.assert_array_equal(pe.points, je.points)
    assert 0 < pe.n < px.n
    for data in ("elimin.dat", "classify.dat"):
        jdat, pdat = _golden(data)
        assert peval.knn_accuracy(pdat, po, knn=5, device="cpu") == \
            jeval.knn_accuracy(jdat, jo, knn=5, mode="fast")
