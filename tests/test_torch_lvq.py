"""The port's LVQ family against the JAX package: the plain top-2 winner
search (K8/K9's plain version), `topk_winners`, the three minibatch LVQ
steps, LVQTrainer (lvq1, lvq2, lvq3) and OLVQ1Trainer on streams, resume,
the fast `accuracy`/`classify` reports, and the copied hitlist.  The JAX
side runs its Pallas kernels in interpret mode.

Tolerances: winners equal except at near-ties, where the two candidates'
float64 distances over the kept components differ by less than 1e-5
relative (the packages sum in different orders); top-2 values to 1e-5
relative; one step's codes and alphas to 1e-5; trained codebooks on the
same stream to 1e-4 (a few dozen steps of float32 sums in two orders);
an interrupted-then-resumed run equals the uninterrupted one to 1e-6 (CPU
runs are deterministic)."""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.data import read_data
from som_lvq_pak_tpu.data.dataset import Dataset
from som_lvq_pak_tpu.data.labels import GLOBAL_LABELS as JAX_LABELS
from som_lvq_pak_tpu.data.streaming import StreamingReader as JStreamingReader
from som_lvq_pak_tpu.models import eval as jeval
from som_lvq_pak_tpu.models import fast as jfast
from som_lvq_pak_tpu.models.trainer import LVQTrainer as JLVQTrainer
from som_lvq_pak_tpu.models.trainer import OLVQ1Trainer as JOLVQ1Trainer
from som_lvq_pak_tpu.ops import distance as jdistance
from som_lvq_pak_tpu.ops import pallas_distance as jpd
from som_lvq_pak_tpu.utils import hitlist as jhitlist
from som_lvq_pak_torch.convert import (as_port_dataset, labeled_samples_to_torch,
                                       lvq_codebook_to_torch)
from som_lvq_pak_torch.data import io as pio
from som_lvq_pak_torch.data.dataset import Dataset as PDataset
from som_lvq_pak_torch.data.labels import LabelTable
from som_lvq_pak_torch.data.streaming import StreamingReader
from som_lvq_pak_torch.models import eval as peval
from som_lvq_pak_torch.models import fast
from som_lvq_pak_torch.models.trainer import LVQTrainer, OLVQ1Trainer
from som_lvq_pak_torch.ops.dist_top2 import dist_top2, dist_top2_plain
from som_lvq_pak_torch.ops.distance import topk_winners
from som_lvq_pak_torch.utils import hitlist

TOL = 1e-5
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
PARITY_ACCURACY = 90.11  # lvqexample golden, percent (BASELINE.md)
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run torch on one CPU thread in this module, as the port's other
    test modules do (see tests/test_torch_masked.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def table():
    """One port label table for a test's codebook and data: LVQ compares
    their label ids."""
    return LabelTable()


def _mask(rng, shape, p=0.2, full_every=7):
    m = (rng.random(shape) < p).astype(np.uint8)
    m[::full_every] = 1
    return m


def assert_winners_agree(x, codes, mask, i_port, i_ref):
    """Equal indices, except where the two candidates' float64 distances
    over the kept components differ by less than TOL relative."""
    i_port = np.asarray(i_port, np.int64)
    i_ref = np.asarray(i_ref, np.int64)
    bad = np.nonzero(i_port != i_ref)[0]
    if bad.size:
        keep = 1.0 if mask is None else (mask[bad] == 0).astype(np.float64)
        x64 = np.asarray(x, np.float64)[bad]
        c64 = np.asarray(codes, np.float64)
        da = (((x64 - c64[i_port[bad]]) ** 2) * keep).sum(-1)
        db = (((x64 - c64[i_ref[bad]]) ** 2) * keep).sum(-1)
        gap = np.abs(da - db) / np.maximum(np.maximum(da, db), 1e-30)
        assert gap.max() < TOL, (bad, gap)


# -- the winner pair ---------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("B,N,D,dup", [(37, 53, 5, False), (70, 600, 37, False),
                                       (70, 99, 5, True), (129, 130, 37, True),
                                       (20, 2, 5, False)])
def test_dist_top2_plain_matches_jax(B, N, D, dup, masked):
    """N not a multiple of the JAX tiles (600 spans two 512-row tiles), D 5
    and 37, every code three times (the lower copies must win the best and
    the second), fully masked rows (0, 0, 0, 1)."""
    rng = np.random.default_rng(B * N + D)
    x = rng.normal(size=(B, D)).astype(np.float32)
    if dup:
        base = rng.normal(size=(N // 3, D)).astype(np.float32)
        codes = np.concatenate([base, base, base])
    else:
        codes = rng.normal(size=(N, D)).astype(np.float32)
    mask = _mask(rng, (B, D)) if masked else None
    got = dist_top2_plain(T(x), T(codes), None if mask is None else T(mask))
    ref = jpd.dist_top2(jnp.asarray(x), jnp.asarray(codes),
                        mask=None if mask is None else jnp.asarray(mask))
    assert [t.dtype for t in got] == [torch.float32, torch.int32] * 2
    for k in (1, 3):
        assert_winners_agree(x, codes, mask, got[k].numpy(), ref[k])
    for k in (0, 2):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=TOL, atol=TOL)
    assert (got[1] != got[3]).all()
    full = np.zeros(B, bool) if mask is None else mask.all(axis=1)
    if dup:  # rows with a component left: the first copy, then the second
        n, i1, i2 = N // 3, got[1].numpy()[~full], got[3].numpy()[~full]
        assert i1.max() < n and (i2 == i1 + n).all()
    if masked:
        assert full.any()
        for k, want in enumerate((0, 0, 0, 1)):
            assert (got[k].numpy()[full] == want).all()
    # the CPU route of the wrapper is the plain version, and no launch
    before = dist_top2.launches
    again = dist_top2(T(x), T(codes), None if mask is None else T(mask))
    assert dist_top2.launches == before
    for a, b in zip(again, got):
        assert torch.equal(a, b)


def test_topk_winners_exact_ties_match_jax():
    """Every code three times: k = 2 and 3 pick the copies lowest index
    first, as lax.top_k does, masked or not."""
    rng = np.random.default_rng(8)
    base = rng.normal(size=(11, 6)).astype(np.float32)
    codes = np.concatenate([base, base, base])
    x = rng.normal(size=(40, 6)).astype(np.float32)
    mask = _mask(rng, x.shape)
    for k in (2, 3):
        for m in (None, mask):
            idx, val = topk_winners(T(x), T(codes), k, None if m is None else T(m))
            jidx, jval = jdistance.topk_winners(jnp.asarray(x), jnp.asarray(codes), k,
                                                None if m is None else jnp.asarray(m))
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
            np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=TOL, atol=TOL)
            rest = slice(None) if m is None else ~m.all(axis=1)
            np.testing.assert_array_equal(idx.numpy()[rest, 1], idx.numpy()[rest, 0] + 11)
    with pytest.raises(ValueError):
        topk_winners(T(x), T(codes), 34)


def test_dist_top2_needs_two_codes():
    x, c = torch.randn(5, 3), torch.randn(1, 3)
    for call in (lambda: dist_top2(x, c), lambda: dist_top2_plain(x, c),
                 lambda: dist_top2(x, c, mask=torch.zeros(5, 3, dtype=torch.uint8))):
        with pytest.raises(ValueError, match="two codes"):
            call()


# -- the batch steps -----------------------------------------------------------

def _step_inputs(masked, seed=3, B=96, N=40, D=6):
    """Clustered data so that many samples fall in the lvq2.1 window, three
    classes, codes of every class."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 1.5, size=(6, D)).astype(np.float32)
    cls = rng.integers(0, 6, size=B)
    x = (centres[cls] + rng.normal(size=(B, D))).astype(np.float32)
    xl = (cls % 3 + 1).astype(np.int32)
    ccls = rng.integers(0, 6, size=N)
    codes = (centres[ccls] + rng.normal(size=(N, D))).astype(np.float32)
    cl = (ccls % 3 + 1).astype(np.int32)
    alphas = rng.uniform(0.05, 0.3, size=N).astype(np.float32)
    mask = _mask(rng, (B, D), p=0.15, full_every=11) if masked else None
    if masked:
        x = np.where(mask != 0, np.float32(0), x)
    return x, xl, codes, cl, alphas, mask


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("step", ["lvq1", "olvq1", "olvq1_m2", "lvq2", "lvq3"])
def test_batch_step_matches_jax(step, masked, use_pallas):
    """One step of each LVQ rule against the JAX step with its Pallas
    kernels (interpret mode) and with its XLA winners."""
    x, xl, codes, cl, alphas, mask = _step_inputs(masked)
    jm = None if mask is None else jnp.asarray(mask)
    pm = None if mask is None else T(mask)
    J = dict(use_pallas=use_pallas, mask=jm)
    jc, jcl, jx, jxl = map(jnp.asarray, (codes, cl, x, xl))
    c = T(codes.copy())
    if step == "lvq1":
        out = fast.lvq1_batch_step(c, T(cl), T(x), T(xl), 0.05, mask=pm)
        ref = jfast.lvq1_batch_step(jc, jcl, jx, jxl, jnp.float32(0.05), **J)
    elif step in ("lvq2", "lvq3"):
        out = fast.lvq23_batch_step(c, T(cl), T(x), T(xl), 0.05, 0.3, epsilon=0.1,
                                    lvq3=step == "lvq3", mask=pm)
        ref = jfast.lvq23_batch_step(jc, jcl, jx, jxl, jnp.float32(0.05),
                                     jnp.float32(0.3), epsilon=jnp.float32(0.1),
                                     lvq3=step == "lvq3", **J)
        assert not np.array_equal(out.numpy(), codes)  # the window rule fired
    else:
        m2 = T((codes ** 2).sum(1)) if step == "olvq1_m2" else None
        res = fast.olvq1_batch_step(c, T(cl), T(alphas), T(x), T(xl), clip=0.3,
                                    mask=pm, m2=m2)
        jres = jfast.olvq1_batch_step(
            jc, jcl, jnp.asarray(alphas), jx, jxl, clip=0.3,
            m2=None if m2 is None else jnp.asarray((codes ** 2).sum(1)), **J)
        assert len(res) == len(jres) == (3 if m2 is not None else 2)
        for a, b in zip(res[1:], jres[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)
        out, ref = res[0], jres[0]
    assert out.data_ptr() == c.data_ptr()  # updated in place
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    if masked:  # a component masked in every sample stays exactly as it was
        mask2 = mask.copy()
        mask2[:, 2] = 1
        c2 = T(codes.copy())
        if step == "lvq1":
            fast.lvq1_batch_step(c2, T(cl), T(x), T(xl), 0.05, mask=T(mask2))
        elif step in ("lvq2", "lvq3"):
            fast.lvq23_batch_step(c2, T(cl), T(x), T(xl), 0.05, 0.3, epsilon=0.1,
                                  lvq3=step == "lvq3", mask=T(mask2))
        else:
            fast.olvq1_batch_step(c2, T(cl), T(alphas), T(x), T(xl), mask=T(mask2))
        np.testing.assert_array_equal(c2.numpy()[:, 2], codes[:, 2])


def test_olvq1_alpha_saturates_at_the_clip():
    """Eight wrong hits on one code in a batch: the rate saturates at the
    clip, as tests/test_trainer.py holds the JAX step to."""
    codes = torch.tensor([[0.0, 0.0], [10.0, 10.0]])
    x = torch.full((8, 2), 0.1)
    _, a = fast.olvq1_batch_step(codes, torch.tensor([1, 2], dtype=torch.int32),
                                 torch.full((2,), 0.3), x,
                                 torch.full((8,), 2, dtype=torch.int32), clip=0.3)
    assert torch.equal(a, torch.tensor([0.3, 0.3]))


# -- the trainers --------------------------------------------------------------

def _golden(table):
    """lvq_b.cod (200 codes, 20-D, the balanced lvqexample codebook) and
    elimin.dat (1794 labelled vectors), in both packages, the port's in
    one label table."""
    codes = read_data(os.path.join(GOLDEN, "lvq_b.cod"))
    data = read_data(os.path.join(GOLDEN, "elimin.dat"))
    kw = dict(labels=table, source_labels=JAX_LABELS)
    return codes, data, as_port_dataset(codes, **kw), as_port_dataset(data, **kw)


def _stream(data, masked_chunks=(), chunk=256, cls=Dataset, seed=5):
    """Chunks of `data` (a JAX package Dataset) as either package's
    Datasets; the chunks in `masked_chunks` get missing components."""
    rng = np.random.default_rng(seed)
    for k, lo in enumerate(range(0, data.n, chunk)):
        sl = slice(lo, lo + chunk)
        pts, mask = data.points[sl], None
        if k in masked_chunks:
            mask = _mask(rng, pts.shape, p=0.1, full_every=37)
            pts = np.where(mask != 0, np.float32(0), pts)
        yield cls(points=pts, mask=mask, labels=data.labels[sl])


TRAINERS = [("lvq1", dict(alpha=0.05)), ("lvq2", dict(alpha=0.05)),
            ("lvq3", dict(alpha=0.05)), ("olvq1", {})]


def _trainers(algorithm, jcodes, pcodes, **kw):
    if algorithm == "olvq1":
        return (JOLVQ1Trainer(jcodes, alpha=0.3, use_pallas=True, **kw),
                OLVQ1Trainer(pcodes, alpha=0.3, device="cpu", **kw))
    return (JLVQTrainer(jcodes, algorithm, winlen=0.3, epsilon=0.1, use_pallas=True, **kw),
            LVQTrainer(pcodes, algorithm, winlen=0.3, epsilon=0.1, device="cpu", **kw))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("algorithm,fit_kw", TRAINERS)
def test_trainer_on_stream_matches_jax(algorithm, fit_kw, masked, table):
    """The same chunk stream through both packages' trainers (B 64, 24
    steps); with `masked`, chunks 1 and 4 carry missing components, so
    clean and masked batches (K1/K4, K8/K9 on the card) alternate."""
    jcodes, jdata, pcodes, pdata = _golden(table)
    chunks = (1, 4) if masked else ()
    jt, pt = _trainers(algorithm, jcodes, pcodes, batch_size=64)
    ref = jt.fit(_stream(jdata, chunks), rlen=64 * 24, **fit_kw)
    out = pt.fit(_stream(pdata, chunks, cls=PDataset), rlen=64 * 24, **fit_kw)
    assert out.points.shape == jcodes.points.shape
    assert not np.array_equal(out.points, jcodes.points)
    np.testing.assert_array_equal(out.labels, pcodes.labels)
    np.testing.assert_allclose(out.points, ref.points, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("algorithm,fit_kw", [TRAINERS[2], TRAINERS[3]])
def test_resume_from_jax_checkpoint(algorithm, fit_kw, table, tmp_path):
    """A checkpoint the JAX trainer wrote (codes, alphas for olvq1, a
    prng_key the port ignores) resumes in the port on the same stream."""
    jcodes, jdata, pcodes, pdata = _golden(table)
    d = str(tmp_path / "ck")
    jt, _ = _trainers(algorithm, jcodes, pcodes, batch_size=64, checkpoint_dir=d,
                      checkpoint_interval=4)
    full = jt.fit(_stream(jdata), rlen=64 * 16, **fit_kw)
    _, pt = _trainers(algorithm, jcodes, pcodes, batch_size=64, checkpoint_dir=d)
    pt.ckpt.keep = 0
    for s in pt.ckpt.steps():
        if s > 8:
            os.remove(os.path.join(d, f"step_{s}.npz"))
    st = pt.ckpt.load()
    assert st.step == 8 and st.prng_key is not None
    assert (st.alphas is not None) == (algorithm == "olvq1")
    out = pt.fit(_stream(pdata, cls=PDataset), rlen=64 * 16, **fit_kw)
    np.testing.assert_allclose(out.points, full.points, rtol=1e-4, atol=1e-4)
    assert pt.ckpt.latest_step() == 16


@pytest.mark.parametrize("form", ["dataset", "stream"])
@pytest.mark.parametrize("algorithm,fit_kw", [TRAINERS[2], TRAINERS[3]])
def test_resume_equals_uninterrupted(algorithm, fit_kw, form, table, tmp_path):
    """Interrupted at a checkpoint, then resumed, equals the uninterrupted
    run: the Dataset sampler draws batch b from (seed, b) alone, a stream
    is fast-forwarded.  The LVQ rule checkpoints after >= interval elapsed
    batches, the olvq1 rule at (b + 1) % interval == 0 with the alphas."""
    jcodes, jdata, pcodes, pdata = _golden(table)

    def data():
        return pdata if form == "dataset" else _stream(pdata, (2,), cls=PDataset)

    d = str(tmp_path / "ck")
    kw = dict(batch_size=64, seed=4, checkpoint_dir=d)
    _, full_t = _trainers(algorithm, jcodes, pcodes, checkpoint_interval=3, **kw)
    full_t.ckpt.keep = 0
    full = full_t.fit(data(), rlen=64 * 10, **fit_kw)
    assert full_t.ckpt.steps() == [3, 6, 9, 10]
    full_alphas = full_t.ckpt.load(10).alphas
    _, tr = _trainers(algorithm, jcodes, pcodes, **kw)
    for s in tr.ckpt.steps():
        if s > 6:
            os.remove(os.path.join(d, f"step_{s}.npz"))
    resumed = tr.fit(data(), rlen=64 * 10, **fit_kw)
    np.testing.assert_allclose(resumed.points, full.points, rtol=1e-6, atol=1e-6)
    if algorithm == "olvq1":
        np.testing.assert_array_equal(tr.ckpt.load().alphas, full_alphas)


def test_dataset_sampler_is_seeded_per_batch(table):
    """Dataset input: the same seed gives the same codebook, another seed
    another one, and masks travel with their samples."""
    _, jdata, pcodes, pdata = _golden(table)
    kw = dict(rlen=64 * 6, alpha=0.05)
    a = LVQTrainer(pcodes, "lvq3", batch_size=64, seed=1, device="cpu").fit(pdata, **kw)
    b = LVQTrainer(pcodes, "lvq3", batch_size=64, seed=1, device="cpu").fit(pdata, **kw)
    c = LVQTrainer(pcodes, "lvq3", batch_size=64, seed=2, device="cpu").fit(pdata, **kw)
    np.testing.assert_array_equal(a.points, b.points)
    assert not np.array_equal(a.points, c.points)
    mask = np.zeros_like(pdata.points, dtype=np.uint8)
    mask[:, 4] = 1
    masked = PDataset(points=np.where(mask != 0, 0, pdata.points), mask=mask,
                      labels=pdata.labels)
    out = OLVQ1Trainer(pcodes, batch_size=64, device="cpu").fit(masked, rlen=64 * 6)
    np.testing.assert_array_equal(out.points[:, 4], pcodes.points[:, 4])
    x, lab, mk = labeled_samples_to_torch(masked, "cpu")
    assert lab.dtype == torch.int32 and torch.equal(lab, T(pdata.first_labels()))
    assert mk.dtype == torch.uint8 and x.shape == mk.shape
    codes, clab, meta = lvq_codebook_to_torch(pcodes, "cpu")
    assert torch.equal(clab, T(pcodes.first_labels())) and meta.points.shape[0] == 0


def test_unported_and_bad_inputs_raise(table):
    _, _, pcodes, pdata = _golden(table)
    # a batch that does not split over the mesh's data axis
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 1})
    with pytest.raises(ValueError, match="does not split"):
        LVQTrainer(pcodes, batch_size=63, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        OLVQ1Trainer(pcodes, batch_size=63, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="olvq1"):
        LVQTrainer(pcodes, "olvq1", device="cpu")
    with pytest.raises(RuntimeError, match="stream exhausted"):
        LVQTrainer(pcodes, "lvq2", batch_size=64, device="cpu").fit(
            _stream(pdata, cls=PDataset), rlen=64 * 40, alpha=0.05)
    out = OLVQ1Trainer(pcodes, batch_size=64, device="cpu").fit(
        _stream(pdata, cls=PDataset), rlen=64 * 40, allow_short_stream=True)
    assert np.isfinite(out.points).all()
    # parity=True is ported: the host path, equal to the JAX package's
    jcodes, jdata = _golden(table)[:2]
    jpct, jrep, jok = jeval.accuracy(jdata, jcodes, parity=True)
    pct, rep, ok = peval.accuracy(pdata, pcodes, labels=table, parity=True, device="cpu")
    assert (pct, rep) == (jpct, jrep)
    np.testing.assert_array_equal(ok, jok)
    jnames = jeval.classify(jdata, jcodes, parity=True)[1]
    assert peval.classify(pdata, pcodes, labels=table, parity=True, device="cpu")[1] == jnames


def test_olvq1_quality_on_ex1_ex2(ref_dir, table):
    """The JAX package's tests/test_trainer_quality.py:99-113 through the
    port: OLVQ1Trainer from lvq_b.cod on ex1.dat, accuracy on ex2.dat
    within 1.5 points of the reference pipeline's 90.11 %."""
    kw = dict(labels=table, source_labels=JAX_LABELS)
    codes = as_port_dataset(read_data(os.path.join(GOLDEN, "lvq_b.cod")), **kw)
    train = as_port_dataset(read_data(os.path.join(ref_dir, "ex1.dat")), **kw)
    test = as_port_dataset(read_data(os.path.join(ref_dir, "ex2.dat")), **kw)
    out = OLVQ1Trainer(codes, batch_size=64, alpha=0.3, seed=1, device="cpu").fit(
        train, rlen=5000)
    pct, _, _ = peval.accuracy(test, out, labels=table, device="cpu")
    assert pct > PARITY_ACCURACY - 1.5, f"olvq1 minibatch accuracy {pct:.2f}%"


# -- accuracy and classify -------------------------------------------------------

def _synthetic(masked):
    """Labelled 2-class data with some class ids the codebook never has,
    and (masked) missing components with a few fully masked rows."""
    rng = np.random.default_rng(11)
    names = ["alpha", "beta", "gamma", "delta"]
    x = rng.normal(size=(300, 5)).astype(np.float32)
    lab = rng.integers(0, 4, size=300)
    x[:, 0] += 2.0 * (lab % 2)
    codes = rng.normal(size=(12, 5)).astype(np.float32)
    clab = np.arange(12) % 3
    mask = _mask(rng, x.shape, p=0.2, full_every=29) if masked else None
    if masked:
        x = np.where(mask != 0, np.float32(0), x)
    ids = np.array([JAX_LABELS.to_index(n) for n in names], np.int32)
    data = Dataset(points=x, mask=mask, labels=ids[lab][:, None])
    cod = Dataset(points=codes, labels=ids[clab][:, None])
    return cod, data


@pytest.mark.parametrize("case", ["lvq_o+classify", "lvq_o+elimin", "synthetic",
                                  "synthetic_masked"])
def test_accuracy_and_classify_reports_equal_jax(case, table):
    """The report text byte for byte, the per-sample 0/1 stream, and
    classify's labels and names against the JAX package's parity=False."""
    if case.startswith("lvq_o"):
        codes = read_data(os.path.join(GOLDEN, "lvq_o.cod"))
        name = "classify.dat" if case.endswith("classify") else "elimin.dat"
        data = read_data(os.path.join(GOLDEN, name))
    else:
        codes, data = _synthetic(case.endswith("masked"))
    jpct, jrep, jok = jeval.accuracy(data, codes, parity=False)
    kw = dict(labels=table, source_labels=JAX_LABELS)
    pcodes, pdata = as_port_dataset(codes, **kw), as_port_dataset(data, **kw)
    pct, rep, ok = peval.accuracy(pdata, pcodes, labels=table, device="cpu")
    assert rep == jrep and pct == jpct
    np.testing.assert_array_equal(ok, jok)
    if case != "lvq_o+classify":
        assert 0 < pct < 100
    jout, jnames = jeval.classify(data, codes, parity=False)
    out, names = peval.classify(pdata, pcodes, labels=table, device="cpu")
    assert names == jnames
    assert [table.to_label(int(i)) for i in out.labels[:, 0]] == \
        [JAX_LABELS.to_label(int(i)) for i in jout.labels[:, 0]]
    if case == "synthetic_masked":
        assert "# empty datavector" in names


def test_accuracy_streaming_reader_equals_jax(table):
    """A StreamingReader evaluates chunk by chunk with the same report."""
    jr = JStreamingReader(os.path.join(GOLDEN, "elimin.dat"), buffer=300)
    jpct, jrep, jok = jeval.accuracy(jr, read_data(os.path.join(GOLDEN, "lvq_o.cod")),
                                     parity=False)
    pcodes = pio.read_data(os.path.join(GOLDEN, "lvq_o.cod"), labels=table)
    pr = StreamingReader(os.path.join(GOLDEN, "elimin.dat"), buffer=300, labels=table)
    pct, rep, ok = peval.accuracy(pr, pcodes, labels=table, device="cpu")
    assert (pct, rep) == (jpct, jrep)
    np.testing.assert_array_equal(ok, jok)


# -- the copied hitlist ----------------------------------------------------------

def test_hitlist_equal_to_jax_and_closed_form_order():
    rng = np.random.default_rng(2)
    for _ in range(200):
        seq = rng.integers(1, rng.integers(2, 9), size=rng.integers(1, 80))
        mine, ref = hitlist.Hitlist.from_labels(seq), jhitlist.Hitlist.from_labels(seq)
        assert mine.items() == ref.items() and mine.head == ref.head
        assert [lab for lab, _ in mine.items()] == peval.hitlist_order(seq).tolist()
        assert hitlist.majority_label(seq) == jhitlist.majority_label(seq)
    neigh = rng.integers(0, 6, size=(500, 7))
    np.testing.assert_array_equal(hitlist.majority_label_matrix(neigh, 6),
                                  jhitlist.majority_label_matrix(neigh, 6))
    assert peval.hitlist_order(np.zeros(0, np.int32)).size == 0
