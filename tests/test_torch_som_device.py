"""The port's device SOM paths on the CPU (the plain versions of K1, K4 and
K5) against the JAX package's fast paths: the online `som_train` scan,
`find_qerror2(mode="fast")`, `vfind_trials` and `som_train_fast`.  Inputs
are made from a seed with NumPy.

Tolerances:
- the online scan with every sample on a fixed winner: codebook within
  1e-6 (absolute and relative) of JAX `som_train(mode="fast")` (the same
  float32 expressions; only exp may round differently);
- with free winners (6x4 map): the parity qerror of the two codebooks
  within 1e-3 relative (near-tie winners may flip and then steer the runs
  apart a little);
- fast `find_qerror2`: within 1e-4 relative of JAX fast (float32 sums in
  other orders, a near-tie winner) and 5e-4 of parity (the JAX package's
  gate, tests/test_som_parity.py:227);
- `vfind_trials`: the initial codebooks bit for bit, each trial's qerror
  within 1e-3 relative of JAX's, the same best trial where its two best
  differ by more than that;
- `som_train_fast`: bit-equal to the port's own `som_batch_step` loop over
  its drawn batches; its qerror within 2% of JAX `som_train_fast` at the
  same settings (the two draw different batches by design).

Torch runs on one CPU thread here (see tests/test_torch_masked.py)."""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.data.dataset import Dataset, Neighborhood, Topology
from som_lvq_pak_tpu.data.streaming import StreamingReader as JStreamingReader
from som_lvq_pak_tpu.models import fast as jfast
from som_lvq_pak_tpu.models import som as jsom
from som_lvq_pak_tpu.utils.rng import CRandom as JCRandom
from som_lvq_pak_torch.convert import as_port_dataset, codebook_to_torch
from som_lvq_pak_torch.data import io as pio
from som_lvq_pak_torch.data.streaming import StreamingReader
from som_lvq_pak_torch.models import fast, som
from som_lvq_pak_torch.models.common import alpha_schedule, radius_schedule

F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed, n=240, dim=5, masked=False, centres=6):
    """Clustered points (a JAX package Dataset and its port twin); with
    masked, components masked with p 0.15 and every 29th row entirely."""
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 3.0, size=(centres, dim)).astype(F32)
    pts = (c[rng.integers(0, centres, size=n)] + rng.normal(size=(n, dim))).astype(F32)
    mask = None
    if masked:
        mask = (rng.random((n, dim)) < 0.15).astype(np.uint8)
        mask[::29] = 1
        pts = np.where(mask != 0, F32(0), pts)
    jd = Dataset(points=pts, mask=mask)
    return jd, as_port_dataset(jd)


def _codes(jdata, xdim=6, ydim=4, neigh=Neighborhood.GAUSSIAN, topol=Topology.HEXA):
    jc = jsom.randinit(jdata, topol, neigh, xdim, ydim, JCRandom(123))
    return jc, as_port_dataset(jc)


def _rel(a, b):
    return abs(a - b) / abs(b)


# -- the online scan ---------------------------------------------------------

@pytest.mark.parametrize("neigh", [Neighborhood.GAUSSIAN, Neighborhood.BUBBLE])
@pytest.mark.parametrize("masked", [False, True])
def test_online_scan_on_fixed_winners_equals_jax(neigh, masked):
    """Every sample carries a fixed winner, so both scans move the same
    units by the same float32 expressions: codebooks within 1e-6."""
    jd, _ = _data(3, masked=masked)
    rng = np.random.default_rng(4)
    fixed = np.stack([rng.integers(0, 6, jd.n), rng.integers(0, 4, jd.n)], 1).astype(np.int32)
    jd = replace(jd, fixed=fixed)
    pd = as_port_dataset(jd)
    jc, pc = _codes(jd, neigh=neigh)
    kw = dict(rlen=500, alpha=0.05, radius=3.0, random_order=True, use_fixed=True)
    got = som.som_train(pc, pd, rng=som.CRandom(7), device="cpu", **kw)
    want = jsom.som_train(jc, jd, rng=JCRandom(7), mode="fast", **kw)
    np.testing.assert_allclose(got.points, want.points, rtol=1e-6, atol=1e-6)
    assert not np.allclose(got.points, pc.points)


@pytest.mark.parametrize("neigh,topol,masked", [
    (Neighborhood.GAUSSIAN, Topology.HEXA, False),
    (Neighborhood.BUBBLE, Topology.RECT, False),
    (Neighborhood.GAUSSIAN, Topology.HEXA, True)])
def test_online_scan_free_winners_matches_jax(neigh, topol, masked):
    """Free winners on a 6x4 map, weights and the sample order too: the
    parity qerror of the two codebooks within 1e-3 relative, and the scan
    trains (its qerror below the initial codebook's)."""
    jd, _ = _data(5, masked=masked)
    w = np.random.default_rng(6).uniform(0.5, 2.0, size=jd.n).astype(F32)
    jd = replace(jd, weight=w)
    pd = as_port_dataset(jd)
    jc, pc = _codes(jd, neigh=neigh, topol=topol)
    kw = dict(rlen=1200, alpha=0.05, radius=3.0, use_weights=True)
    got = som.som_train(pc, pd, device="cpu", **kw)
    want = jsom.som_train(jc, jd, mode="fast", **kw)
    qg = jsom.find_qerror(Dataset(points=got.points), jd, mode="parity")
    qw = jsom.find_qerror(want, jd, mode="parity")
    assert _rel(qg, qw) < 1e-3
    assert qg < jsom.find_qerror(jc, jd, mode="parity")
    np.testing.assert_allclose(got.points, want.points, rtol=1e-2, atol=1e-2)


def test_online_scan_agrees_with_parity_and_rejects_bad_input():
    """The fast scan follows the parity scan on a short run (the JAX
    package's own check, tests/test_som_parity.py:120-123), and bad
    arguments raise."""
    jd, pd = _data(8)
    _, pc = _codes(jd)
    par = som.som_train(pc, pd, 60, 0.05, 3.0, mode="parity")
    fst = som.som_train(pc, pd, 60, 0.05, 3.0, device="cpu")
    np.testing.assert_allclose(par.points, fst.points, rtol=1e-3, atol=1e-2)
    with pytest.raises(ValueError, match="mode"):
        som.som_train(pc, pd, 10, 0.05, 3.0, mode="online", device="cpu")
    with pytest.raises(ValueError, match="not a map"):
        som.som_train(replace(pc, topol=Topology.LVQ), pd, 10, 0.05, 3.0, device="cpu")
    with pytest.raises(ValueError, match="dimension"):
        som.som_train(pc, replace(pd, points=pd.points[:, :3], mask=None), 10, 0.05, 3.0,
                      device="cpu")


# -- find_qerror2, fast -------------------------------------------------------

@pytest.mark.parametrize("neigh", [Neighborhood.BUBBLE, Neighborhood.GAUSSIAN])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("remainder", [False, True])
def test_find_qerror2_fast_matches_jax(neigh, masked, remainder, monkeypatch):
    """In memory and as a data tensor; with `remainder`, the port's chunk
    rule shrunk so 240 samples run in chunks of 45 and a last one of 15."""
    jd, pd = _data(12, masked=masked)
    jc, _ = _codes(jd, neigh=neigh)
    jc = jsom.som_train(jc, jd, 600, 0.05, 3.0, mode="parity")
    pc = as_port_dataset(jc)
    if remainder:
        monkeypatch.setattr(som, "_QERROR2_ELEMS", 45 * pc.n)
    for radius in (1.0, 2.5):
        got = som.find_qerror2(pc, pd, radius, device="cpu")
        assert _rel(got, jsom.find_qerror2(jc, jd, radius, mode="fast")) < 1e-4
        assert _rel(got, jsom.find_qerror2(jc, jd, radius, mode="parity")) < 5e-4
        X = torch.from_numpy(pd.points)
        mk = None if pd.mask is None else torch.from_numpy(pd.mask)
        assert _rel(som.find_qerror2(pc, X, radius, mask=mk), got) < 1e-6


def test_find_qerror2_fast_on_a_stream(tmp_path):
    """Over a StreamingReader: the chunks' totals summed, against the JAX
    package's fast stream and the port's in-memory value."""
    jd, pd = _data(13, masked=True)
    jc, _ = _codes(jd)
    jc = jsom.som_train(jc, jd, 600, 0.05, 3.0, mode="parity")
    pc = as_port_dataset(jc)
    path = str(tmp_path / "q2.dat")
    pio.write_data(pd, path)
    got = som.find_qerror2(pc, StreamingReader(path, buffer=70), 2.0, device="cpu")
    want = jsom.find_qerror2(jc, JStreamingReader(path, buffer=70), 2.0, mode="fast")
    assert _rel(got, want) < 1e-4
    assert _rel(got, som.find_qerror2(pc, pio.read_data(path), 2.0, device="cpu")) < 1e-4
    with pytest.raises(ValueError, match="mask="):
        som.find_qerror2(pc, StreamingReader(path, buffer=70), 2.0,
                         mask=torch.zeros((1, 5)), device="cpu")


# -- vfind_trials ----------------------------------------------------------------

PHASES = [(240, 0.05, 3.0), (170, 0.02, 1.5)]  # 170 = 5 batches of 32 and 10


def test_vfind_initial_codebooks_equal_jax_randinit():
    jd, pd = _data(14)
    stacks = som.vfind_codebooks(pd, [4, 3, 2, 1], Topology.HEXA, Neighborhood.GAUSSIAN,
                                 6, 4, [], device="cpu")
    for trial, M in zip([4, 3, 2, 1], stacks):
        want = jsom.randinit(jd, Topology.HEXA, Neighborhood.GAUSSIAN, 6, 4,
                             JCRandom(trial)).points
        np.testing.assert_array_equal(M.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("qmode", [0, 1])
def test_vfind_trials_matches_jax(qmode):
    """Four trials, two phases (the second ending on a short batch): each
    trial's qerror within 1e-3 relative of the JAX package's, the best trial
    the same where the two best differ by more; a trial's codebook is the
    same bit for bit whichever trials run beside it."""
    jd, pd = _data(15)
    jt, pt = _data(16, n=100)
    kw = dict(phases=PHASES, qmode=qmode, batch_size=32)
    best, trial, q, qs = som.vfind_trials(pd, pt, 4, Topology.HEXA, Neighborhood.GAUSSIAN,
                                          6, 4, device="cpu", **kw)
    jbest, jtrial, jq, jqs = jsom.vfind_trials(jd, jt, 4, Topology.HEXA,
                                               Neighborhood.GAUSSIAN, 6, 4, **kw)
    assert list(qs) == list(jqs) == [4, 3, 2, 1]
    for t in qs:
        assert _rel(qs[t], jqs[t]) < 1e-3
    ranked = sorted(jqs.values())
    if _rel(ranked[1], ranked[0]) > 1e-3:
        assert trial == jtrial
    assert q == qs[trial] == min(qs.values())
    alone = som.vfind_codebooks(pd, [trial], Topology.HEXA, Neighborhood.GAUSSIAN, 6, 4,
                                PHASES, batch_size=32, device="cpu")[0]
    np.testing.assert_array_equal(alone.numpy().view(np.int32), best.points.view(np.int32))
    assert som.vfind_trials(pd, pt, 0, Topology.HEXA, Neighborhood.GAUSSIAN, 6, 4,
                            PHASES, device="cpu") == (None, 0, float("inf"), {})


# -- som_train_fast -------------------------------------------------------------

@pytest.mark.parametrize("neigh", [Neighborhood.GAUSSIAN, Neighborhood.BUBBLE])
def test_som_train_fast_is_its_step_loop_and_matches_jax(neigh):
    jd, pd = _data(17, n=600)
    jc, pc = _codes(jd, 8, 6, neigh)
    # long enough to converge: the two draw different batches, and over
    # seeds 0-3 the two qerrors then differ by at most 0.8%
    rlen, bs, alpha, radius = 12000, 64, 0.05, 4.0
    got = fast.som_train_fast(pc, pd, rlen, alpha, radius, batch_size=bs, seed=3,
                              device="cpu")
    # the same batches through som_batch_step by hand
    nb = rlen // bs
    idx = fast.train_fast_indices(nb, bs, pd.n, 3)
    assert idx.shape == (nb, bs) and int(idx.min()) >= 0 and int(idx.max()) < pd.n
    M = codebook_to_torch(pc, "cpu")[0]
    X = torch.from_numpy(pd.points)
    talp = alpha_schedule(rlen, alpha)[::bs]
    trad = radius_schedule(rlen, radius)[::bs]
    for b in range(nb):
        fast.som_batch_step(M, X[idx[b]], 8, True, torch.tensor(talp[b]), float(trad[b]),
                            gaussian=neigh == Neighborhood.GAUSSIAN)
    np.testing.assert_array_equal(got.points.view(np.int32), M.numpy().view(np.int32))
    want = jfast.som_train_fast(jc, jd, rlen, alpha, radius, batch_size=bs, seed=3)
    qg = jsom.find_qerror(Dataset(points=got.points), jd, mode="parity")
    qw = jsom.find_qerror(want, jd, mode="parity")
    assert _rel(qg, qw) < 0.02
    assert qg < 0.8 * jsom.find_qerror(jc, jd, mode="parity")
    again = fast.som_train_fast(pc, pd, rlen, alpha, radius, batch_size=bs, seed=3,
                                update="mean", device="cpu")
    np.testing.assert_array_equal(again.points, got.points)  # update= does nothing
    with pytest.raises(ValueError, match="map"):
        fast.som_train_fast(replace(pc, topol=Topology.LVQ), pd, 100, 0.05, 2.0,
                            device="cpu")
