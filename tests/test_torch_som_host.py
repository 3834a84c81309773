"""The port's host SOM paths against the JAX package, bit for bit: the copy
of ops/exact.py, the grid-distance matrices and neighbourhood weights, the
sample order and the weighted alpha, `streamed_samples`, `lininit`,
`som_train(mode="parity")` (in memory and streamed), the parity
`find_qerror` and `find_qerror2`, and `accuracy`/`classify` with
parity=True; then the in-repo goldens of the C package byte for byte
through the port's `write_data`.  Inputs are made from a seed with NumPy.
Every comparison is exact (the parity paths are host NumPy with the C
package's float32 op order in both packages)."""

import io
import os
from dataclasses import replace

import numpy as np
import pytest

from som_lvq_pak_tpu.data import read_data as jread_data
from som_lvq_pak_tpu.data.dataset import Dataset, Neighborhood, Topology
from som_lvq_pak_tpu.data.labels import GLOBAL_LABELS as JAX_LABELS
from som_lvq_pak_tpu.data.streaming import StreamingReader as JStreamingReader
from som_lvq_pak_tpu.data.streaming import streamed_samples as jstreamed_samples
from som_lvq_pak_tpu.models import common as jcommon
from som_lvq_pak_tpu.models import eval as jeval
from som_lvq_pak_tpu.models import som as jsom
from som_lvq_pak_tpu.ops import exact as jexact
from som_lvq_pak_tpu.ops import neighborhood as jneighborhood
from som_lvq_pak_tpu.utils.rng import CRandom as JCRandom
from som_lvq_pak_torch.convert import as_port_dataset
from som_lvq_pak_torch.data import io as pio
from som_lvq_pak_torch.data.dataset import Dataset as PDataset
from som_lvq_pak_torch.data.labels import LabelTable
from som_lvq_pak_torch.data.streaming import StreamingReader, streamed_samples
from som_lvq_pak_torch.models import common, som
from som_lvq_pak_torch.models import eval as peval
from som_lvq_pak_torch.ops import exact, neighborhood
from som_lvq_pak_torch.utils.rng import CRandom

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
F32 = np.float32


def _bits(a):
    return np.asarray(a, F32).view(np.int32)


def _equal(a, b):
    """Bit-equal float32 arrays (or equal scalars)."""
    np.testing.assert_array_equal(_bits(a), _bits(b))


def _data(seed, n=200, dim=6, masked=False, weights=False, fixed_xdim=None):
    """A JAX package Dataset of normal points (and its port twin): with
    masked, components masked with p 0.15 and every 23rd row entirely; with
    weights, weight= tokens in [0.5, 2) and some 0 (no token); with
    fixed_xdim, a fixed=x,y token on every 5th sample."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, dim)) * 2).astype(F32)
    mask = weight = fixed = None
    if masked:
        mask = (rng.random((n, dim)) < 0.15).astype(np.uint8)
        mask[::23] = 1
        pts = np.where(mask != 0, F32(0), pts)
    if weights:
        weight = rng.uniform(0.5, 2.0, size=n).astype(F32)
        weight[::7] = 0.0
    if fixed_xdim is not None:
        fixed = np.full((n, 2), -1, np.int32)
        fixed[::5, 0] = rng.integers(0, fixed_xdim, size=fixed[::5].shape[0])
        fixed[::5, 1] = rng.integers(0, 3, size=fixed[::5].shape[0])
    jd = Dataset(points=pts, mask=mask, weight=weight, fixed=fixed)
    return jd, as_port_dataset(jd)


def _codes(jdata, xdim, ydim, neigh=Neighborhood.GAUSSIAN, topol=Topology.HEXA, seed=123):
    jc = jsom.randinit(jdata, topol, neigh, xdim, ydim, JCRandom(seed))
    return jc, as_port_dataset(jc)


def _write_str(ds, writer):
    buf = io.StringIO()
    writer(ds, None, fileobj=buf)
    return buf.getvalue()


# -- ops/exact.py -----------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_exact_bit_equal_to_jax(masked):
    """Every function of the copied ops/exact.py on the same inputs, with
    exact ties (every code twice) and an all-masked sample."""
    rng = np.random.default_rng(3 + masked)
    X = rng.normal(size=(40, 7)).astype(F32)
    base = rng.normal(size=(15, 7)).astype(F32)
    codes = np.concatenate([base, base])  # every code twice: exact ties
    X[5] = base[4]  # a sample on a code: distance 0 to two codes
    xm = None
    if masked:
        xm = (rng.random(X.shape) < 0.2).astype(np.uint8)
        xm[3] = 1  # all masked
        xm[5] = 0
    _equal(exact.pairwise_sq_distances(X, codes, xm),
           jexact.pairwise_sq_distances(X, codes, xm))
    for i in range(X.shape[0]):
        m = None if xm is None else xm[i]
        _equal(exact.seq_sq_distances(X[i], codes, m), jexact.seq_sq_distances(X[i], codes, m))
        wi, wd = exact.find_winner_euc(X[i], codes, m)
        ji, jd = jexact.find_winner_euc(X[i], codes, m)
        assert wi == ji and _bits(wd) == _bits(jd)
        for knn in (1, 3):
            ki, kd = exact.find_winner_knn(X[i], codes, knn, m)
            kji, kjd = jexact.find_winner_knn(X[i], codes, knn, m)
            np.testing.assert_array_equal(ki, kji)
            _equal(kd, kjd)
        _equal(exact.adapt_vector(codes[i % 30], X[i], F32(0.3), m),
               jexact.adapt_vector(codes[i % 30], X[i], F32(0.3), m))
        assert exact.vector_dist_euc(X[i], codes[0], m, None) == \
            jexact.vector_dist_euc(X[i], codes[0], m, None)
    assert exact.find_winner_euc(X[5], codes)[0] == 4  # the first of a tie
    ti, td = exact.pairwise_topk(X, codes, 4, xm)
    tji, tjd = jexact.pairwise_topk(X, codes, 4, xm)
    np.testing.assert_array_equal(ti, tji)
    _equal(td, tjd)
    ym = None if xm is None else xm[::-1][:30].copy()
    _equal(exact.pairwise_dist_euc(X, codes, xm, ym), jexact.pairwise_dist_euc(X, codes, xm, ym))
    if masked:
        assert exact.find_winner_euc(X[3], codes, xm[3]) == (-1, F32(-1.0))
        assert exact.vector_dist_euc(X[3], codes[0], xm[3]) == -1.0


# -- ops/neighborhood.py -----------------------------------------------------------

@pytest.mark.parametrize("xdim,ydim", [(7, 5), (12, 8), (4, 3), (1, 5), (6, 1)])
@pytest.mark.parametrize("topol", [Topology.HEXA, Topology.RECT])
def test_grid_distance_matrix_bit_equal(xdim, ydim, topol):
    """Hexa and rect matrices (odd ydim included) and the NumPy weights of
    both neighbourhoods from them."""
    gd = neighborhood.grid_distance_matrix(topol, xdim, ydim)
    _equal(gd, jneighborhood.grid_distance_matrix(topol, xdim, ydim))
    fn = neighborhood.hexa_dist_matrix if topol == Topology.HEXA else neighborhood.rect_dist_matrix
    _equal(fn(xdim, ydim), gd)
    bmu = np.arange(xdim * ydim)[::3]
    for gaussian in (False, True):
        _equal(neighborhood.neighborhood_weights(gd, bmu, F32(2.5), F32(0.1), gaussian),
               jneighborhood.neighborhood_weights(gd, bmu, F32(2.5), F32(0.1), gaussian))
    with pytest.raises(ValueError, match="topology"):
        neighborhood.grid_distance_matrix(Topology.LVQ, xdim, ydim)


# -- models/common.py, data/streaming.py ------------------------------------------------

@pytest.mark.parametrize("random_order", [False, True])
@pytest.mark.parametrize("buffer", [0, 37, "n", "n+1"])
def test_sample_order_bit_equal(random_order, buffer):
    n = 100
    b = {"n": n, "n+1": n + 1}.get(buffer, buffer)
    for length in (1, 99, 100, 355):
        got = common.sample_order(n, length, random_order, CRandom(7), buffer=b)
        want = jcommon.sample_order(n, length, random_order, JCRandom(7), buffer=b)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    if random_order:
        with pytest.raises(ValueError, match="CRandom"):
            common.sample_order(n, 5, True, None)


def test_effective_alpha_bit_equal():
    rng = np.random.default_rng(9)
    talp = rng.uniform(0, 0.5, size=500).astype(F32)
    w = rng.uniform(0.2, 3.0, size=500).astype(F32)
    w[::9] = 0.0  # no weight= token: alpha unchanged
    _equal(common.effective_alpha(talp, w, True), jcommon.effective_alpha(talp, w, True))
    assert common.effective_alpha(talp, w, False) is talp
    assert common.effective_alpha(talp, None, True) is talp


def _data_file(tmp_path, n=90, dim=4, seed=2):
    """A data file whose first component is the row number."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, dim)).astype(F32)
    pts[:, 0] = np.arange(n)
    path = str(tmp_path / "rows.dat")
    pio.write_data(PDataset(points=pts), path)
    return path, n


@pytest.mark.parametrize("random_order", [False, True])
@pytest.mark.parametrize("buffer", [25, 30, 90, 91])
def test_streamed_samples_follow_sample_order(tmp_path, random_order, buffer):
    """`streamed_samples` visits the rows of `sample_order(..., buffer=B)`
    index for index (its chunks' rows carry their file row), as the JAX
    package's does."""
    path, n = _data_file(tmp_path)
    rlen = 250
    got = [int(c.points[s, 0]) for c, s in streamed_samples(
        StreamingReader(path, buffer=buffer), rlen, random_order, CRandom(5))]
    want = common.sample_order(n, rlen, random_order, CRandom(5), buffer=buffer)
    np.testing.assert_array_equal(got, want)
    jgot = [int(c.points[s, 0]) for c, s in jstreamed_samples(
        JStreamingReader(path, buffer=buffer), rlen, random_order, JCRandom(5))]
    assert got == jgot


# -- lininit -----------------------------------------------------------------

@pytest.mark.parametrize("xdim,ydim,masked", [(12, 8, False), (7, 5, False), (7, 5, True)])
def test_lininit_bit_equal(xdim, ydim, masked):
    jd, pd = _data(11, n=120, dim=5, masked=masked)
    got = som.lininit(pd, Topology.HEXA, Neighborhood.BUBBLE, xdim, ydim, CRandom(3))
    want = jsom.lininit(jd, Topology.HEXA, Neighborhood.BUBBLE, xdim, ydim, JCRandom(3))
    _equal(got.points, want.points)
    assert (got.topol, got.neigh, got.xdim, got.ydim) == (want.topol, want.neigh, xdim, ydim)
    for part, jpart in zip(som.find_eigenvectors(pd, CRandom(4)),
                           jsom.find_eigenvectors(jd, JCRandom(4))):
        _equal(part, jpart)
    with pytest.raises(ValueError, match="3 samples"):
        som.lininit(replace(pd, points=pd.points[:2], mask=None), Topology.HEXA,
                    Neighborhood.BUBBLE, xdim, ydim, CRandom(3))


# -- som_train(mode="parity") ----------------------------------------------------------

TRAIN_CASES = {
    "plain": dict(),
    "bubble_rect": dict(neigh=Neighborhood.BUBBLE, topol=Topology.RECT),
    "use_weights": dict(weights=True, train=dict(use_weights=True)),
    "use_fixed": dict(fixed=True, train=dict(use_fixed=True)),
    "masked": dict(masked=True),
    "random_buffer": dict(train=dict(random_order=True, buffer=37)),
    "random_inverse_t": dict(train=dict(random_order=True, alpha_type="inverse_t")),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_som_train_parity_bit_equal(case):
    cfg = TRAIN_CASES[case]
    jd, pd = _data(21, n=150, dim=5, masked=cfg.get("masked", False),
                   weights=cfg.get("weights", False),
                   fixed_xdim=6 if cfg.get("fixed") else None)
    jc, pc = _codes(jd, 6, 4, cfg.get("neigh", Neighborhood.GAUSSIAN),
                    cfg.get("topol", Topology.HEXA))
    kw = dict(rlen=400, alpha=0.05, radius=3.0, **cfg.get("train", {}))
    jrng = JCRandom(3) if kw.get("random_order") else None
    prng = CRandom(3) if kw.get("random_order") else None
    seen, jseen, ticks = [], [], []

    class Snap:
        interval = 100

        def __init__(self, into):
            self.into = into

        def __call__(self, le, ds):
            self.into.append((le, ds.points.copy()))

    got = som.som_train(pc, pd, rng=prng, mode="parity", snapshot=Snap(seen),
                        progress=ticks.append, **kw)
    want = jsom.som_train(jc, jd, rng=jrng, mode="parity", snapshot=Snap(jseen), **kw)
    _equal(got.points, want.points)
    assert [le for le, _ in seen] == [le for le, _ in jseen] == [100, 200, 300]
    for (_, a), (_, b) in zip(seen, jseen):
        _equal(a, b)
    assert ticks[0] == 400 and ticks[-1] == 0
    assert not np.array_equal(got.points, pc.points)


@pytest.mark.parametrize("random_order", [False, True])
def test_som_train_streamed_bit_equal(tmp_path, random_order):
    """A StreamingReader trains on the bounded-memory parity path, equal to
    the full-load run with buffer=B and to the JAX package's streamed run;
    fast mode refuses a stream, as in the JAX package."""
    jd, pd = _data(31, n=120, dim=5, masked=True, weights=True)
    path = str(tmp_path / "d.dat")
    pio.write_data(pd, path)
    pd = pio.read_data(path)
    jc, pc = _codes(jd, 5, 4)
    kw = dict(rlen=300, alpha=0.05, radius=3.0, random_order=random_order,
              use_weights=True, mode="parity")
    got = som.som_train(pc, StreamingReader(path, buffer=37), rng=CRandom(3), **kw)
    full = som.som_train(pc, pd, rng=CRandom(3), buffer=37, **kw)
    want = jsom.som_train(jc, JStreamingReader(path, buffer=37), rng=JCRandom(3), **kw)
    _equal(got.points, full.points)
    _equal(got.points, want.points)
    with pytest.raises(ValueError, match="parity"):
        som.som_train(pc, StreamingReader(path, buffer=37), 10, 0.05, 2.0, mode="fast")


# -- find_qerror / find_qerror2, parity ---------------------------------------------------

@pytest.mark.parametrize("neigh", [Neighborhood.BUBBLE, Neighborhood.GAUSSIAN])
@pytest.mark.parametrize("masked", [False, True])
def test_qerrors_parity_bit_equal(tmp_path, neigh, masked):
    """find_qerror and find_qerror2 (radius 1, 2.5) in parity mode, in
    memory and over a StreamingReader, equal the JAX package's."""
    jd, pd = _data(41, n=130, dim=5, masked=masked)
    jc, pc = _codes(jd, 6, 5, neigh)
    jc = jsom.som_train(jc, jd, 200, 0.1, 3.0, mode="parity")
    pc = as_port_dataset(jc)
    path = str(tmp_path / "q.dat")
    pio.write_data(pd, path)
    q = som.find_qerror(pc, pd, mode="parity")
    assert q == jsom.find_qerror(jc, jd, mode="parity") > 0
    assert som.find_qerror(pc, StreamingReader(path, buffer=40), mode="parity") == \
        jsom.find_qerror(jc, JStreamingReader(path, buffer=40), mode="parity")
    for radius in (1.0, 2.5):
        q2 = som.find_qerror2(pc, pd, radius, mode="parity")
        assert q2 == jsom.find_qerror2(jc, jd, radius, mode="parity") > 0
        assert som.find_qerror2(pc, StreamingReader(path, buffer=40), radius,
                                mode="parity") == \
            jsom.find_qerror2(jc, JStreamingReader(path, buffer=40), radius, mode="parity")
    with pytest.raises(ValueError, match="mode"):
        som.find_qerror2(pc, pd, 1.0, mode="exact")


@pytest.mark.parametrize("masked", [False, True])
def test_accuracy_and_classify_parity_equal_jax(masked):
    """accuracy/classify(parity=True): the report byte for byte, the 0/1
    stream and the labels, with ties (every code twice) and empty rows."""
    table = LabelTable()
    rng = np.random.default_rng(51)
    base = rng.normal(size=(10, 6)).astype(F32)
    codes = np.concatenate([base, base])
    clab = np.concatenate([np.arange(10) % 3 + 1, np.arange(10) % 4 + 1]).astype(np.int32)
    X = (base[rng.integers(0, 10, size=300)] + rng.normal(size=(300, 6)) * 0.8).astype(F32)
    names = {i: JAX_LABELS.to_index(f"k{i}") for i in range(1, 5)}
    lab = np.array([names[i] for i in rng.integers(1, 5, size=300)], np.int32)
    mask = None
    if masked:
        mask = (rng.random(X.shape) < 0.2).astype(np.uint8)
        mask[::31] = 1
        X = np.where(mask != 0, F32(0), X)
    jcodes = Dataset(points=codes, labels=np.array([names[i] for i in clab])[:, None],
                     topol=Topology.LVQ)
    jdata = Dataset(points=X, mask=mask, labels=lab[:, None])
    kw = dict(labels=table, source_labels=JAX_LABELS)
    pcodes, pdata = as_port_dataset(jcodes, **kw), as_port_dataset(jdata, **kw)
    jpct, jrep, jok = jeval.accuracy(jdata, jcodes, parity=True)
    pct, rep, ok = peval.accuracy(pdata, pcodes, labels=table, parity=True, device="cpu")
    assert (pct, rep) == (jpct, jrep) and 0 < pct < 100
    np.testing.assert_array_equal(ok, jok)
    jout, jnames = jeval.classify(jdata, jcodes, parity=True)
    out, pnames = peval.classify(pdata, pcodes, labels=table, parity=True)
    assert pnames == jnames
    assert ("# empty datavector" in pnames) == masked


# -- the C package's goldens, byte for byte ----------------------------------------------

GOLDEN_RUNS = {
    # tests/test_som_parity.py:166-212: vsom -weights 1, -buffer 37 -rand 3,
    # -buffer 120 -rand 3, -fixed 1
    "wmask_w.cod": ("wmask.dat", "wmask_r.cod",
                    dict(rlen=300, alpha=0.05, radius=4, use_weights=True)),
    "wmask_br.cod": ("wmask.dat", "wmask_r.cod",
                     dict(rlen=300, alpha=0.05, radius=4, random_order=True, buffer=37)),
    "wmask_b120.cod": ("wmask.dat", "wmask_r.cod",
                       dict(rlen=300, alpha=0.05, radius=4, random_order=True, buffer=120)),
    "fix_fv.cod": ("fix.dat", "fix_r.cod", dict(rlen=200, alpha=0.1, radius=2, use_fixed=True)),
}


@pytest.mark.parametrize("golden", list(GOLDEN_RUNS))
def test_som_train_parity_matches_golden(golden):
    data_name, codes_name, kw = GOLDEN_RUNS[golden]
    data = pio.read_data(os.path.join(GOLDEN, data_name))
    codes = pio.read_data(os.path.join(GOLDEN, codes_name))
    if golden == "wmask_b120.cod":
        assert kw["buffer"] == data.n  # buffer == n stays buffered
    rng = CRandom(3) if kw.get("random_order") else None
    out = som.som_train(codes, data, rng=rng, mode="parity", **kw)
    with open(os.path.join(GOLDEN, golden)) as f:
        assert _write_str(out, pio.write_data) == f.read()
    # the JAX package's run writes the same bytes
    jrng = JCRandom(3) if kw.get("random_order") else None
    jout = jsom.som_train(jread_data(os.path.join(GOLDEN, codes_name)),
                          jread_data(os.path.join(GOLDEN, data_name)), rng=jrng, **kw)
    _equal(out.points, jout.points)
