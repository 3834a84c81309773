"""The port's per-sample LVQ scans (models.lvq's fast modes: `_lvq1_fast`,
`_olvq1_fast`, `_lvq23_fast` through `lvq1_train`, `olvq1_train`,
`lvq2_train` and `lvq3_train`) on the CPU, where their winners come from
the plain versions of K1/K4 and K8/K9, against the JAX package's jitted
scans on the same order and schedule, from `lvq_b.cod` over `elimin.dat`.

Tolerances: codebooks and olvq1's alphas within 1e-5 (relative, and 1e-5
absolute).  The two packages score each code in another float32 form (the
port's plain K1 ranks ||m||^2 - 2 x.m, the JAX scan the full XLA
distance), so a winner may differ only at a near-tie; any winner that
differed on this data would move another row and show far beyond that
tolerance.  A sample with every component masked wins code 0 in both
(every distance 0), its update all masked, and olvq1's alpha[0] moves as
in the JAX scan."""

import os

import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.data import io as jio
from som_lvq_pak_tpu.data.dataset import Dataset, Topology
from som_lvq_pak_tpu.data.labels import GLOBAL_LABELS as JAX_LABELS
from som_lvq_pak_tpu.models import lvq as jlvq
from som_lvq_pak_tpu.utils.rng import CRandom as JCRandom
from som_lvq_pak_torch.convert import as_port_dataset
from som_lvq_pak_torch.data.labels import LabelTable
from som_lvq_pak_torch.models import common, lvq
from som_lvq_pak_torch.ops.dist_argmin import dist_argmin
from som_lvq_pak_torch.ops.dist_top2 import dist_top2
from som_lvq_pak_torch.utils.rng import CRandom

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
F32 = np.float32
TOL = 1e-5
STEPS = 600


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run torch on one CPU thread in this module, as the port's other
    test modules do (see tests/test_torch_masked.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(masked=False, seed=3):
    """lvq_b.cod and elimin.dat as JAX Datasets and port twins in one port
    label table; with masked, components masked with p 0.2 and every 7th
    row entirely, those rows labelled as code 0 (so olvq1's alpha[0]
    shrinks on them)."""
    jc = jio.read_data(os.path.join(GOLDEN, "lvq_b.cod"))
    jd = jio.read_data(os.path.join(GOLDEN, "elimin.dat"))
    if masked:
        rng = np.random.default_rng(seed)
        mask = (rng.random(jd.points.shape) < 0.2).astype(np.uint8)
        mask[::7] = 1
        labels = jd.labels.copy()
        labels[::7, 0] = jc.labels[0, 0]
        jd = Dataset(points=np.where(mask != 0, F32(0), jd.points), mask=mask, labels=labels)
    table = LabelTable()
    kw = dict(labels=table, source_labels=JAX_LABELS)
    return jc, jd, as_port_dataset(jc, **kw), as_port_dataset(jd, **kw)


def _rngs(seed):
    j, p = JCRandom(), CRandom()
    j.init_random(seed)
    p.init_random(seed)
    return j, p


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL, atol=TOL)


ALGOS = {
    "lvq1": (STEPS, 0.05),
    "lvq2": (STEPS, 0.05, 0.3),
    "lvq3": (STEPS, 0.05, 0.3, 0.1),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("algo", list(ALGOS))
def test_lvq_scans_match_jax(algo, masked):
    """lvq1 (K1/K4's plain winner) and lvq2/lvq3 (K8/K9's plain pair) in
    the reference's random order of CRandom(9), linear alpha."""
    jc, jd, pc, pd = _inputs(masked)
    jrng, prng = _rngs(9)
    args = ALGOS[algo]
    jout = getattr(jlvq, f"{algo}_train")(jc, jd, *args, random_order=True, rng=jrng,
                                          mode="fast")
    pout = getattr(lvq, f"{algo}_train")(pc, pd, *args, random_order=True, rng=prng,
                                         device="cpu")
    assert pout.points.dtype == np.float32 and pout.points.shape == (200, 20)
    _close(pout.points, jout.points)
    moved = (pout.points != pc.points).any(axis=1).sum()
    assert moved > 20
    np.testing.assert_array_equal(pout.labels, pc.labels)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("alpha,init", [(0.3, False), (0.0, True)])
def test_olvq1_scan_matches_jax(alpha, init, masked):
    """olvq1 in file order with one rate of 0.3, or from lvq_b.lra's 197
    rates padded with 0.3 (alpha 0: wrong winners' rates clip to 0); the
    codebook and the rates.  Masked: the fully masked rows win code 0 and
    shrink alpha[0], in both packages."""
    jc, jd, pc, pd = _inputs(masked)
    al = None
    if init:
        al = np.concatenate([jio.read_alpha_file(os.path.join(GOLDEN, "lvq_b.lra"), 197),
                             np.full(3, 0.3, F32)])
    jout, ja = jlvq.olvq1_train(jc, jd, STEPS, alpha, init_alphas=al, mode="fast",
                                return_alphas=True)
    pout, pa = lvq.olvq1_train(pc, pd, STEPS, alpha, init_alphas=al, return_alphas=True,
                               device="cpu")
    _close(pout.points, jout.points)
    _close(pa, ja)
    assert pa.dtype == np.float32 and pa.shape == (200,)
    start = np.full(200, 0.3, F32) if al is None else al
    assert (pa != start).sum() > 20
    if init:
        assert (pa == 0).any()
    if masked:
        # alpha[0] shrank on the fully masked rows, its row did not move there
        assert pa[0] < start[0]


def test_fully_masked_sample_wins_code_0():
    """K1/K4's and K8/K9's plain versions give a sample with every
    component masked index 0 (and 0, 1 for the pair) at distance 0, as the
    JAX scans' argmin and top_k of an all-zero row."""
    rng = np.random.default_rng(4)
    codes = torch.from_numpy(rng.normal(size=(30, 6)).astype(F32))
    x = torch.from_numpy(rng.normal(size=(1, 6)).astype(F32))
    m = torch.ones((1, 6), dtype=torch.uint8)
    v, i = dist_argmin(x, codes, mask=m)
    assert int(i) == 0 and float(v) == 0.0
    d1, i1, d2, i2 = dist_top2(x, codes, mask=m)
    assert (int(i1), int(i2), float(d1), float(d2)) == (0, 1, 0.0, 0.0)


def test_olvq1_scan_n_active_freezes_the_appended_codes():
    """n_active = 150: codes 150.. compete for winners but keep their rows
    and rates bit for bit (balance's stale count), as in the JAX scan."""
    jc, jd, pc, pd = _inputs()
    jout, ja = jlvq.olvq1_train(jc, jd, STEPS, 0.3, mode="fast", return_alphas=True,
                                n_active=150)
    pout, pa = lvq.olvq1_train(pc, pd, STEPS, 0.3, return_alphas=True, n_active=150,
                               device="cpu")
    _close(pout.points, jout.points)
    _close(pa, ja)
    np.testing.assert_array_equal(pout.points[150:].view(np.int32),
                                  pc.points[150:].view(np.int32))
    assert (pa[150:] == F32(0.3)).all() and (pa[:150] != F32(0.3)).any()
    # the frozen codes did win: the same run with every code active moves them
    full = lvq.olvq1_train(pc, pd, STEPS, 0.3, device="cpu")
    assert (full.points[150:] != pc.points[150:]).any()


@pytest.mark.parametrize("algo", ["lvq2", "lvq3"])
def test_lvq23_window_with_a_zero_second_distance(algo):
    """Samples that sit on two codes of different classes (nds == 0): the
    window test where(nds > 0, ds / nds, inf) > wl holds, the update is 0
    (x - m = 0), nothing turns NaN; and samples on two same-class codes
    (lvq3's epsilon rule at distance 0).  Equal to the JAX scan."""
    rng = np.random.default_rng(12)
    base = rng.normal(size=(12, 4)).astype(F32) * 3
    codes = np.concatenate([base, base])
    clab = np.concatenate([np.arange(12) % 3 + 1, (np.arange(12) + (np.arange(12) % 2)) % 3 + 1])
    x = np.concatenate([base[rng.integers(0, 12, size=40)],
                        base[rng.integers(0, 12, size=40)] + rng.normal(size=(40, 4)).astype(F32)])
    names = [JAX_LABELS.to_index(f"w{i}") for i in range(1, 4)]
    jc = Dataset(points=codes, labels=np.array(names, np.int32)[clab - 1][:, None],
                 topol=Topology.LVQ)
    jd = Dataset(points=x.astype(F32),
                 labels=np.array(names, np.int32)[rng.integers(0, 3, size=80)][:, None])
    table = LabelTable()
    kw = dict(labels=table, source_labels=JAX_LABELS)
    pc, pd = as_port_dataset(jc, **kw), as_port_dataset(jd, **kw)
    args = ALGOS[algo][1:]
    jout = getattr(jlvq, f"{algo}_train")(jc, jd, 160, *args, mode="fast")
    pout = getattr(lvq, f"{algo}_train")(pc, pd, 160, *args, device="cpu")
    assert np.isfinite(pout.points).all()
    _close(pout.points, jout.points)
    assert (pout.points != pc.points).any()


def test_scan_blocks_cover_the_order(monkeypatch):
    """A scan longer than one gathered block of steps (the block cut to 64
    here) equals the one-block scan bit for bit."""
    jc, jd, pc, pd = _inputs(masked=True)
    one, a1 = lvq.olvq1_train(pc, pd, 300, 0.3, return_alphas=True, device="cpu")
    l3 = lvq.lvq3_train(pc, pd, 300, 0.05, 0.3, 0.1, device="cpu")
    monkeypatch.setattr(common, "SCAN_BLOCK", 64)
    many, a2 = lvq.olvq1_train(pc, pd, 300, 0.3, return_alphas=True, device="cpu")
    np.testing.assert_array_equal(many.points.view(np.int32), one.points.view(np.int32))
    np.testing.assert_array_equal(a2.view(np.int32), a1.view(np.int32))
    np.testing.assert_array_equal(
        lvq.lvq3_train(pc, pd, 300, 0.05, 0.3, 0.1, device="cpu").points.view(np.int32),
        l3.points.view(np.int32))
