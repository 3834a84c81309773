"""The port's LVQ pipeline on the host against the JAX package, bit for
bit: `eveninit` (even and proportional), `balance` and its `.lra` bytes,
`olvq1_train` from `lvq_b.cod` + `lvq_b.lra` (in order and in the
reference's random order), `lvq1/2/3_train` in memory and over a
StreamingReader, `class_nearest_stats`, `deviations`, the
`mindist`/`stddev` reports, `setlabel`/`elimin`/`knn_accuracy` with
mode="parity", `vcal`, `visual`, `extract`, `showlabs` and
`confusion_matrix(parity=True)`; the `.lra` files with their base-name
quirk, `write_data_chunks`, the in-repo goldens `lvq_mindist.txt` and
`mcnemar.txt` byte for byte, and the parity kNN never taking the device
route.  Inputs are the repo's golden files (`elimin.dat`, 1,794 x 20
labelled; `classify.dat`, 1,962 x 20; the `lvq_*.cod` codebooks) or made
from a seed with NumPy.  Every comparison is exact: the parity paths are
host NumPy with the C package's float32 op order in both packages, and
codebooks are compared through each package's `write_data` and bit for
bit."""

import inspect
import io
import os
import shutil

import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.data import io as jio
from som_lvq_pak_tpu.data.dataset import Dataset, Topology
from som_lvq_pak_tpu.data.labels import GLOBAL_LABELS as JAX_LABELS
from som_lvq_pak_tpu.data.streaming import StreamingReader as JStreamingReader
from som_lvq_pak_tpu.models import eval as jeval
from som_lvq_pak_tpu.models import lvq as jlvq
from som_lvq_pak_tpu.models import tools as jtools
from som_lvq_pak_tpu.utils.rng import CRandom as JCRandom
from som_lvq_pak_torch.convert import as_port_dataset
from som_lvq_pak_torch.data import io as pio
from som_lvq_pak_torch.data.labels import GLOBAL_LABELS
from som_lvq_pak_torch.data.streaming import StreamingReader
from som_lvq_pak_torch.models import eval as peval
from som_lvq_pak_torch.models import lvq, tools
from som_lvq_pak_torch.ops import distance
from som_lvq_pak_torch.utils.rng import CRandom

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
F32 = np.float32


@pytest.fixture(autouse=True)
def fresh_port_labels():
    """The port's global label table afresh for each test, as the JAX
    package's (tests/conftest.py): both read the same files in the same
    order, so their ids agree."""
    GLOBAL_LABELS.reset()
    yield
    GLOBAL_LABELS.reset()


def _gold(name):
    return os.path.join(GOLDEN, name)


def _read(name):
    """A golden file through both packages' readers: (JAX, port)."""
    return jio.read_data(_gold(name)), pio.read_data(_gold(name))


def _text(ds, writer):
    buf = io.StringIO()
    writer(ds, None, fileobj=buf)
    return buf.getvalue()


def _same(jds, pds):
    """The same file text through each package's writer, points bit for
    bit."""
    assert _text(pds, pio.write_data) == _text(jds, jio.write_data)
    np.testing.assert_array_equal(np.asarray(pds.points, F32).view(np.int32),
                                  np.asarray(jds.points, F32).view(np.int32))


# -- the LVQ initialisers ------------------------------------------------------

@pytest.mark.parametrize("proportional", [False, True])
@pytest.mark.parametrize("name,noc", [("elimin.dat", 200), ("classify.dat", 97)])
def test_eveninit_parity_bit_equal(name, noc, proportional):
    """eveninit/propinit (the quota's float32 expression) with the exact
    self-kNN; 97 codes leave a shortfall for the second pass."""
    jd, pd = _read(name)
    _same(jlvq.eveninit(jd, noc, knn=5, proportional=proportional),
          lvq.eveninit(pd, noc, knn=5, proportional=proportional, mode="parity"))
    np.testing.assert_array_equal(lvq.knn_correct_mask(pd, 3, mode="parity"),
                                  jlvq.knn_correct_mask(jd, 3))
    assert lvq.pick_codes(50, pd).n == 50
    _same(jlvq.pick_codes(50, jd), lvq.pick_codes(50, pd))


def test_balance_parity_bit_equal(tmp_path, monkeypatch):
    """balance with the port's defaults: the codebook, the short `.lra`
    sidecar (the stale count) and the report, against the JAX package's
    and the golden `lvq_b.lra` format.  Relative names from tmp_path: the
    sidecar's name is cut at the path's first '.', so no directory above
    may hold one."""
    (jcodes, pcodes), (jd, pd) = _read("lvq_e.cod"), _read("elimin.dat")
    monkeypatch.chdir(tmp_path)
    jrep, prep = [], []
    jout = jlvq.balance(jcodes, jd, knn=5, alpha_file_out="j.cod", report=jrep.append)
    pout = lvq.balance(pcodes, pd, knn=5, alpha_file_out="p.cod", report=prep.append)
    _same(jout, pout)
    with open(tmp_path / "j.lra") as fj, open(tmp_path / "p.lra") as fp:
        jlra, plra = fj.read(), fp.read()
    assert plra == jlra and len(plra.splitlines()) <= pout.n
    assert prep == jrep and len(prep) > 1


@pytest.mark.parametrize("median", [False, True])
@pytest.mark.parametrize("name", ["lvq_e.cod", "lvq_b.cod", "elimin.dat"])
def test_class_statistics_bit_equal(name, median):
    jc, pc = _read(name)
    jl, jdist, jnoe = jlvq.class_nearest_stats(jc, median=median)
    pl, pdist, pnoe = lvq.class_nearest_stats(pc, median=median)
    assert pl == jl
    np.testing.assert_array_equal(pdist.view(np.int32), jdist.view(np.int32))
    np.testing.assert_array_equal(pnoe, jnoe)
    np.testing.assert_array_equal(lvq.deviations(pc, pl, pnoe).view(np.int32),
                                  jlvq.deviations(jc, jl, jnoe).view(np.int32))


def test_reports_bit_equal():
    """mindist (with and without data, whose labels the codebook lacks are
    skipped), stddev, showlabs and extract."""
    (jc, pc), (jd, pd) = _read("lvq_o.cod"), _read("elimin.dat")
    assert tools.mindist_report(pc) == jtools.mindist_report(jc)
    assert tools.mindist_report(pc, pd) == jtools.mindist_report(jc, jd)
    assert tools.stddev_report(pd) == jtools.stddev_report(jd)
    assert tools.showlabs(pd) == jtools.showlabs(jd)
    lab = int(pd.first_labels()[3])
    assert lab == int(jd.first_labels()[3])
    _same(jtools.extract(jd, lab), tools.extract(pd, lab))
    assert 0 < tools.extract(pd, lab).n < pd.n


# -- the trainers' parity loops ---------------------------------------------

@pytest.mark.parametrize("random_order", [False, True])
@pytest.mark.parametrize("full", [False, True])
def test_olvq1_resume_from_lra_bit_equal(full, random_order, monkeypatch):
    """olvq1 (alpha 0) from lvq_b.cod with lvq_b.lra, in order and in the
    random order of CRandom(71).  The golden sidecar holds 197 rates for
    200 codes, so it reads as absent and the rates start at 0.3, as the
    reference's lvqexample runs; a full sidecar (its 197 rates and three of
    0.3) takes the clip-to-0 quirk.  The sidecar is read by its relative
    name: its name is cut at the path's first '.'."""
    (jc, pc), (jd, pd) = _read("lvq_b.cod"), _read("elimin.dat")
    monkeypatch.chdir(GOLDEN)
    assert pio.read_alpha_file("lvq_b.lra", pc.n) is None
    assert jio.read_alpha_file("lvq_b.lra", jc.n) is None
    jal = pal = None
    if full:
        jal = np.concatenate([jio.read_alpha_file("lvq_b.lra", 197), np.full(3, 0.3, F32)])
        pal = np.concatenate([pio.read_alpha_file("lvq_b.lra", 197), np.full(3, 0.3, F32)])
        np.testing.assert_array_equal(pal.view(np.int32), jal.view(np.int32))
    kw = dict(rlen=2500, alpha=0.0, random_order=random_order)
    jrng, prng = (JCRandom(), CRandom()) if random_order else (None, None)
    if random_order:
        jrng.init_random(71)
        prng.init_random(71)
    jout, ja = jlvq.olvq1_train(jc, jd, init_alphas=jal, rng=jrng, return_alphas=True, **kw)
    pout, pa = lvq.olvq1_train(pc, pd, init_alphas=pal, rng=prng, return_alphas=True,
                               mode="parity", **kw)
    _same(jout, pout)
    np.testing.assert_array_equal(pa.view(np.int32), ja.view(np.int32))
    assert (pa == 0).any() == full  # wrong winners' rates clipped to 0


class _Snap:
    interval = 400

    def __init__(self):
        self.seen = []

    def __call__(self, le, ds):
        self.seen.append((le, ds.points.copy()))


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("algo", ["lvq1", "lvq2", "lvq3", "olvq1"])
def test_lvq_trainers_parity_bit_equal(algo, stream):
    """lvq1/lvq2/lvq3/olvq1 from lvq_b.cod over elimin.dat, in memory
    (with the snapshot and progress hooks) or over a StreamingReader of
    300-row refills in the reference's random order (bit-equal to the
    buffered full-load order)."""
    (jc, pc) = _read("lvq_b.cod")
    if stream:
        jd = JStreamingReader(_gold("elimin.dat"), buffer=300)
        pd = StreamingReader(_gold("elimin.dat"), buffer=300)
    else:
        jd, pd = jio.read_data(_gold("elimin.dat")), pio.read_data(_gold("elimin.dat"))
    jrng, prng = JCRandom(), CRandom()
    jrng.init_random(5)
    prng.init_random(5)
    kw = dict(random_order=stream)
    jsnap, psnap = _Snap(), _Snap()
    jprog, pprog = [], []
    hooks = lambda snap, prog: dict(snapshot=snap, progress=prog.append)  # noqa: E731
    args = {"lvq1": (1500, 0.05), "lvq2": (1500, 0.05, 0.3), "lvq3": (1500, 0.05, 0.3, 0.1),
            "olvq1": (1500, 0.3)}[algo]
    jfn = getattr(jlvq, f"{algo}_train")
    pfn = getattr(lvq, f"{algo}_train")
    jout = jfn(jc, jd, *args, rng=jrng, **kw, **hooks(jsnap, jprog))
    pout = pfn(pc, pd, *args, rng=prng, mode="parity", **kw, **hooks(psnap, pprog))
    _same(jout, pout)
    assert pprog == jprog and pprog[-1] == 0
    assert [le for le, _ in psnap.seen] == [le for le, _ in jsnap.seen] == [400, 800, 1200]
    for (_, a), (_, b) in zip(psnap.seen, jsnap.seen):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert not np.array_equal(pout.points, pc.points)
    if stream:
        with pytest.raises(ValueError, match="parity"):
            pfn(pc, pd, *args, rng=prng, **kw)


# -- the host kNN tools ---------------------------------------------------------

def test_setlabel_elimin_knn_accuracy_parity_bit_equal():
    """setlabel (codes query the data), elimin (knn capped at 10) and
    knn_accuracy with mode="parity", in memory and over StreamingReaders
    of 500-row refills (setlabel's merge by the global index)."""
    (jc, pc), (jd, pd) = _read("lvq_e.cod"), _read("elimin.dat")
    jx, px = _read("classify.dat")
    _same(jtools.setlabel(jc, jd, knn=5), tools.setlabel(pc, pd, knn=5, mode="parity"))
    _same(jtools.setlabel(jc, JStreamingReader(_gold("elimin.dat"), buffer=500), knn=5),
          tools.setlabel(pc, StreamingReader(_gold("elimin.dat"), buffer=500), knn=5,
                         mode="parity"))
    for knn in (3, 12):
        jout = jtools.elimin(jx, knn=knn)
        pout = tools.elimin(px, knn=knn, mode="parity")
        _same(jout, pout)
        assert 0 < pout.n < px.n
    (jo, po) = _read("lvq_o.cod")
    for data in ("elimin.dat", "classify.dat"):
        jdat, pdat = _read(data)
        assert peval.knn_accuracy(pdat, po, knn=5, mode="parity") == \
            jeval.knn_accuracy(jdat, jo, knn=5)
    assert peval.knn_accuracy(StreamingReader(_gold("elimin.dat"), buffer=500), po,
                              knn=5, mode="parity") == \
        jeval.knn_accuracy(JStreamingReader(_gold("elimin.dat"), buffer=500), jo, knn=5)


@pytest.mark.parametrize("stream", [False, True])
def test_confusion_matrix_parity_bit_equal(stream):
    (jo, po) = _read("lvq_b.cod")
    if stream:
        jd = JStreamingReader(_gold("elimin.dat"), buffer=700)
        pd = StreamingReader(_gold("elimin.dat"), buffer=700)
    else:
        jd, pd = _read("elimin.dat")
    jrep, jmat, jok = jeval.confusion_matrix(jd, jo)
    prep, pmat, pok = peval.confusion_matrix(pd, po, parity=True)
    assert prep == jrep
    np.testing.assert_array_equal(pmat, jmat)
    np.testing.assert_array_equal(pok, jok)
    assert pok.dtype == np.uint8 and 0 < pok.sum() < pok.size == pmat.sum()


def _map_data(seed, masked):
    """Labelled 5-dim samples around som_v.cod's units (a JAX Dataset and
    its port twin, one label table each); with masked, components masked
    with p 0.2 and every 9th row entirely."""
    rng = np.random.default_rng(seed)
    jcodes = jio.read_data(_gold("som_v.cod"))
    pcodes = pio.read_data(_gold("som_v.cod"))
    pts = (jcodes.points[rng.integers(0, jcodes.n, size=300)]
           + rng.normal(size=(300, 5)) * 2.0).astype(F32)
    names = [JAX_LABELS.to_index(f"z{i}") for i in range(1, 5)]
    for i in range(1, 5):
        GLOBAL_LABELS.to_index(f"z{i}")
    lab = np.array(names, np.int32)[rng.integers(0, 4, size=300)]
    lab[::13] = 0  # unlabelled samples
    mask = None
    if masked:
        mask = (rng.random(pts.shape) < 0.2).astype(np.uint8)
        mask[::9] = 1
        pts = np.where(mask != 0, F32(0), pts)
    jd = Dataset(points=pts, mask=mask, labels=lab[:, None])
    return jcodes, pcodes, jd, as_port_dataset(jd, source_labels=JAX_LABELS)


@pytest.mark.parametrize("masked", [False, True])
def test_vcal_visual_bit_equal(masked):
    """vcal (numlabs 1, 2 and all) and visual (EMPTY_LINE rows under a
    mask) on the 12x8 som_v.cod map."""
    jcodes, pcodes, jd, pd = _map_data(77, masked)
    for numlabs in (1, 2, 0):
        _same(jtools.vcal(jcodes, jd, numlabs=numlabs), tools.vcal(pcodes, pd, numlabs=numlabs))
    jv, pv = jtools.visual(jcodes, jd), tools.visual(pcodes, pd)
    _same(jv, pv)
    assert (pv.points[:, 0] == -1).any() == masked


# -- file formats --------------------------------------------------------------

@pytest.mark.parametrize("name", ["b.cod", "..lvq.b.cod", "x", ".hidden", "a.b.c.gz",
                                  "dir/my.codes.cod", "..", ""])
def test_alpha_basename_quirk_equal_to_jax(name):
    """strtok(basename, ".") + ".lra": leading dots skipped, the name cut
    at the next dot (directories included)."""
    assert pio._alpha_basename(name) == jio._alpha_basename(name)


def test_alpha_file_round_trip(tmp_path, monkeypatch):
    """write/read/invalidate through the quirk's name, the golden `%g`
    text, a short file read as absent."""
    monkeypatch.chdir(tmp_path)
    shutil.copyfile(_gold("lvq_b.lra"), "gold.lra")  # a relative name: no '.' above
    al = pio.read_alpha_file("gold.lra", 197)
    pio.write_alpha_file("..lvq.b.cod", al)
    with open(tmp_path / "lvq.lra") as f, open(_gold("lvq_b.lra")) as g:
        assert f.read() == g.read()
    back = pio.read_alpha_file("lvq.other.cod", 197)
    np.testing.assert_array_equal(back.view(np.int32), al.view(np.int32))
    assert pio.read_alpha_file("lvq.cod", 198) is None  # short
    assert pio.read_alpha_file("nothing.cod", 1) is None
    pio.invalidate_alpha_file("lvq.x")
    assert not (tmp_path / "lvq.lra").exists()
    pio.invalidate_alpha_file("lvq.x")  # absent: nothing to do
    assert pio.read_alpha_file("gold.lra", 200) is None  # 197 lines for 200 codes


@pytest.mark.parametrize("sizes", [(700, 0, 1094), (1794,), (1, 1793), ()])
def test_write_data_chunks_equal_to_write_data(tmp_path, sizes):
    """Chunks (an empty one included) give write_data's bytes of their
    concatenation, and the JAX writer's; no chunk gives the header of
    `meta` (and its comments) alone."""
    jd, pd = _read("elimin.dat")
    bounds = np.cumsum((0,) + sizes)
    chunks = [pd.take(np.arange(a, b)) for a, b in zip(bounds[:-1], bounds[1:])]
    n = pio.write_data_chunks(iter(chunks), str(tmp_path / "p.dat"), comments="# c",
                              meta=pd)
    jio.write_data_chunks(iter([jd.take(np.arange(a, b))
                                for a, b in zip(bounds[:-1], bounds[1:])]),
                          str(tmp_path / "j.dat"), comments="# c", meta=jd)
    whole = pd.take(np.arange(bounds[-1]))
    pio.write_data(whole, str(tmp_path / "w.dat"), comments="# c")
    got = (tmp_path / "p.dat").read_text()
    assert n == bounds[-1]
    assert got == (tmp_path / "j.dat").read_text() == (tmp_path / "w.dat").read_text()
    if not sizes:
        assert got == "20\n# c\n"


# -- the in-repo goldens --------------------------------------------------------

def test_mindist_golden():
    """mindist of lvq_e.cod (tests/test_tools.py:90-94), byte for byte."""
    codes = pio.read_data(_gold("lvq_e.cod"))
    with open(_gold("lvq_mindist.txt")) as f:
        assert tools.mindist_report(codes) == f.read()


def test_mcnemar_golden():
    """mcnemar of lvq_o.cfo against lvq_b.cfo
    (tests/test_lvq_parity.py:148-153), byte for byte; equal streams, an
    insignificant difference and the two errors as the JAX package's."""
    c1 = np.loadtxt(_gold("lvq_o.cfo"), dtype=np.int64)
    c2 = np.loadtxt(_gold("lvq_b.cfo"), dtype=np.int64)
    with open(_gold("mcnemar.txt")) as f:
        assert peval.mcnemar(c1, c2) == f.read()
    assert peval.mcnemar(c1, c1) == jeval.mcnemar(c1, c1)
    near = c1.copy()
    near[:2] = 1 - near[:2]
    assert peval.mcnemar(c1, near) == jeval.mcnemar(c1, near)
    assert "not significant" in peval.mcnemar(c1, near)
    with pytest.raises(ValueError, match="Unequal"):
        peval.mcnemar(c1, c2[:-1])
    with pytest.raises(ValueError, match="other than"):
        peval.mcnemar(c1, c2 * 2)


# -- routing and defaults -------------------------------------------------------

def test_parity_knn_never_routes_to_device(monkeypatch):
    """The port's twin of tests/test_tools.py:97-125: mode="parity" kNN
    takes the exact host path at every size, even with
    SOMVQ_AUTO_TOPK_PAIRS=0, and mode="fast" is the one that goes through
    the scale-aware router."""
    def boom(*a, **k):
        raise AssertionError("parity kNN routed through the device path")

    monkeypatch.setattr(distance, "auto_pairwise_topk", boom)
    monkeypatch.setattr(distance, "chunked_topk", boom)
    monkeypatch.setattr(lvq, "chunked_topk", boom)
    monkeypatch.setenv("SOMVQ_AUTO_TOPK_PAIRS", "0")
    small = pio.read_data(_gold("elimin.dat")).take(np.arange(60))
    assert lvq.knn_correct_mask(small, 3, mode="parity").shape == (60,)
    codes = lvq.pick_codes(10, small)
    tools.setlabel(codes, small, knn=3, mode="parity")
    tools.elimin(small, knn=3, mode="parity")
    peval.knn_accuracy(small, codes, knn=3, mode="parity")
    lvq.eveninit(small, 10, knn=3, mode="parity")
    for call in (lambda: tools.setlabel(codes, small, knn=3, device="cpu"),
                 lambda: tools.elimin(small, knn=3, device="cpu"),
                 lambda: peval.knn_accuracy(small, codes, knn=3, device="cpu"),
                 lambda: lvq.knn_correct_mask(small, 3, device="cpu")):
        with pytest.raises(AssertionError, match="device path"):
            call()


def test_lvq_entry_points_default_to_the_gpu():
    """eveninit, knn_correct_mask, pick_inside_codes, the four trainers,
    setlabel, elimin, knn_accuracy and confusion_matrix default to the
    fast path on "cuda" (the JAX package's to parity); without a GPU they
    raise and never fall back, and their parity paths need no device."""
    for fn in (lvq.eveninit, lvq.knn_correct_mask, lvq.pick_inside_codes, lvq.lvq1_train,
               lvq.olvq1_train, lvq.lvq2_train, lvq.lvq3_train, tools.setlabel,
               tools.elimin, peval.knn_accuracy, distance.pairwise_topk_mode):
        params = inspect.signature(fn).parameters
        assert params["mode"].default == "fast" and params["device"].default == "cuda"
    for fn in (peval.confusion_matrix, distance.auto_pairwise_topk):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(peval.confusion_matrix).parameters["parity"].default is False
    if torch.cuda.is_available():
        return
    data = pio.read_data(_gold("elimin.dat")).take(np.arange(80))
    codes = lvq.pick_codes(8, data)
    for call in (lambda: lvq.eveninit(data, 8), lambda: lvq.knn_correct_mask(data, 3),
                 lambda: lvq.lvq1_train(codes, data, 10, 0.05),
                 lambda: lvq.olvq1_train(codes, data, 10, 0.3),
                 lambda: lvq.lvq3_train(codes, data, 10, 0.05, 0.3, 0.1),
                 lambda: peval.confusion_matrix(data, codes)):
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call()
    assert lvq.eveninit(data, 8, mode="parity").topol == Topology.LVQ
    assert lvq.olvq1_train(codes, data, 10, 0.3, mode="parity").n == 8
    assert peval.confusion_matrix(data, codes, parity=True)[1].sum() == 80
