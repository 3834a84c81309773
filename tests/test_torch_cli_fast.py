"""The port's `-fast` tools against the JAX CLI's, the quality contract.
The port's tools run through `cli.main(..., device="cpu")`, so on the plain
versions of the kernels; the JAX CLI's `-fast` tools run on its CPU path
(Pallas in interpret mode).  Each port run is also held bit-equal to the
same call through the port's Python API (its "twin": the same arguments
and seed), which shows what the CLI drives.

Tolerances (stated by the contract; each sets the gate of one test):
- `vsom -fast` on wmask.dat (masked, 6x5 hexa gaussian from wmask_r.cod):
  per-sample qerror (the parity `find_qerror`) within 2% of the JAX run's,
  in memory (the two packages' Dataset samplers differ by design) and
  streamed (`-buffer`, the same batches in both); `-bf16stream` within 1%
  of the float32 stream; every output bit-equal to its API twin.
- `olvq1/lvq1/lvq2/lvq3 -fast` on elimin.dat, streamed (`-buffer 500`):
  the accuracy on classify.dat within 0.5 points of the JAX run's; the
  codebook bit-equal to its API twin.
- `qerror -fast` (and `-qetype 1`, and `-buffer`): the printed number
  within 1e-4 relative of the JAX `-fast` line.
- `vfind -fast`: the same best trial as the JAX run unless the JAX run's
  two best qerrors are within 1%; each trial's qerror within 2% of the
  JAX trial's; the best map bit-equal to the API's `vfind_trials`.
- `eveninit`, `knntest`, `setlabel` and `elimin -fast` with
  SOMVQ_AUTO_TOPK_PAIRS=0 (both packages on their device route): the
  self-kNN lists of the two routes equal except at near-ties (every
  differing column's two neighbours within 1e-5 relative in float64), and
  where they are equal the outputs byte-equal.
- `sammon_fast` on som_2.cod for 50 iterations: finite; its mapping error
  under 1.5x the parity `sammon`'s (tests/test_sammon.py:68-82) and within
  1.5x of the JAX `sammon_fast`'s both ways; its first two iterations
  within 1e-6 of the JAX layout.  The iteration amplifies a one-ulp
  difference of its float32 sums to order one within ten iterations (the
  JAX package's parity and fast paths end 5% apart at 50), so no closer
  gate holds for sums taken in another order."""

import io
import os
import sys

import numpy as np
import pytest
import torch

from som_lvq_pak_tpu import cli as jcli
from som_lvq_pak_tpu.cli.params import verbose as jverbose
from som_lvq_pak_tpu.data.labels import GLOBAL_LABELS as JAX_LABELS
from som_lvq_pak_tpu.models.sammon import sammon_fast as jsammon_fast
from som_lvq_pak_tpu.ops import distance as jdistance
from som_lvq_pak_torch import cli as pcli
from som_lvq_pak_torch.cli.params import verbose as pverbose
from som_lvq_pak_torch.data.io import read_data, write_data
from som_lvq_pak_torch.data.labels import GLOBAL_LABELS
from som_lvq_pak_torch.data.streaming import StreamingReader
from som_lvq_pak_torch.models import sammon, som
from som_lvq_pak_torch.models.trainer import LVQTrainer, OLVQ1Trainer, SOMTrainer
from som_lvq_pak_torch.ops import distance, exact
from som_lvq_pak_torch.utils.rng import CRandom

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _gold(name):
    return os.path.join(GOLDEN, name)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run torch on one CPU thread in this module, as the port's other
    test modules that run the gaussian step do (tests/test_torch_masked.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def reset_state(monkeypatch, tmp_path):
    jverbose(1)
    pverbose(1)
    monkeypatch.chdir(tmp_path)
    yield
    jverbose(1)
    pverbose(1)
    GLOBAL_LABELS.reset()


def _call(main, argv, stdin=None, **kw):
    JAX_LABELS.reset()
    GLOBAL_LABELS.reset()
    old = sys.stdout, sys.stderr, sys.stdin
    sys.stdout, sys.stderr = io.StringIO(), io.StringIO()
    sys.stdin = io.StringIO(stdin or "")
    try:
        rc = main([str(a) for a in argv], **kw)
        out = rc, sys.stdout.getvalue(), sys.stderr.getvalue()
    finally:
        sys.stdout, sys.stderr, sys.stdin = old
    assert out[0] == 0, out
    return out


def jax_run(*argv, stdin=None):
    return _call(jcli.main, argv, stdin)


def port_run(*argv, stdin=None):
    return _call(pcli.main, argv, stdin, device="cpu")


def _text(ds):
    buf = io.StringIO()
    write_data(ds, None, fileobj=buf)
    return buf.getvalue()


def _file(name):
    with open(name) as f:
        return f.read()


def _qerror(cod, data):
    d = read_data(_gold(data))
    return som.find_qerror(read_data(cod), d, mode="parity") / d.n


def _accuracy(cod):
    _, out, _ = port_run("accuracy", "-din", _gold("classify.dat"), "-cin", cod)
    return float(out.strip().splitlines()[-1].split()[-2])


def _seed(rand):
    rng = CRandom()
    rng.init_random(rand)
    return rng.state % (1 << 31)


# -- vsom -fast ------------------------------------------------------------------

VSOM = ["-din", _gold("wmask.dat"), "-cin", _gold("wmask_r.cod"), "-rlen", 6000,
        "-alpha", 0.05, "-radius", 3, "-batch", 64, "-rand", 7, "-fast"]


@pytest.mark.parametrize("buffer", [0, 40])
def test_vsom_fast_quality_and_api_twin(buffer):
    extra = ["-buffer", buffer] if buffer else []
    jax_run("vsom", *VSOM, *extra, "-cout", "j.cod")
    port_run("vsom", *VSOM, *extra, "-cout", "p.cod")
    qj, qp = _qerror("j.cod", "wmask.dat"), _qerror("p.cod", "wmask.dat")
    assert abs(qp - qj) <= 0.02 * qj, (qp, qj)
    assert qp < _qerror(_gold("wmask_r.cod"), "wmask.dat")

    def twin(stream_bf16=False):
        tr = SOMTrainer(read_data(_gold("wmask_r.cod")), batch_size=64, device="cpu",
                        seed=_seed(7), stream_bf16=stream_bf16)
        data = (StreamingReader(_gold("wmask.dat"), buffer).chunks(laps=None) if buffer
                else read_data(_gold("wmask.dat")))
        return _text(tr.fit(data, 6000, 0.05, 3.0))

    assert _file("p.cod") == twin()
    if buffer:
        port_run("vsom", *VSOM, *extra, "-bf16stream", "-cout", "b.cod")
        q16 = _qerror("b.cod", "wmask.dat")
        assert abs(q16 - qp) <= 0.01 * qp, (q16, qp)
        assert _file("b.cod") == twin(stream_bf16=True)


def test_vsom_fast_ignores_bf16stream_in_memory():
    """-bf16stream without -buffer: the JAX CLI's warning, the same run."""
    _, _, jerr = jax_run("vsom", *VSOM, "-bf16stream", "-cout", "j.cod")
    _, _, perr = port_run("vsom", *VSOM, "-bf16stream", "-cout", "p.cod")
    assert perr == jerr and "-bf16stream only affects" in perr
    port_run("vsom", *VSOM, "-cout", "q.cod")
    assert _file("p.cod") == _file("q.cod")


# -- the LVQ trainers with -fast ------------------------------------------------

LVQ = {"olvq1": [], "lvq1": ["-alpha", 0.05], "lvq2": ["-alpha", 0.05, "-win", 0.3],
       "lvq3": ["-alpha", 0.05, "-win", 0.3, "-epsilon", 0.1]}


@pytest.mark.parametrize("algo", list(LVQ))
def test_lvqtrain_fast_quality_and_api_twin(algo):
    argv = ["-din", _gold("elimin.dat"), "-cin", _gold("lvq_b.cod"), "-rlen", 5000,
            "-batch", 64, "-buffer", 500, "-fast", *LVQ[algo]]
    jax_run(algo, *argv, "-cout", "j.cod")
    port_run(algo, *argv, "-cout", "p.cod")
    pj, pp = _accuracy("j.cod"), _accuracy("p.cod")
    assert abs(pp - pj) <= 0.5, (pp, pj)
    assert pp > 90.0
    codes = read_data(_gold("lvq_b.cod"))
    feed = StreamingReader(_gold("elimin.dat"), 500).chunks(laps=None)
    if algo == "olvq1":
        out = OLVQ1Trainer(codes, batch_size=64, alpha=0.3, device="cpu").fit(feed, 5000)
    else:
        tr = LVQTrainer(codes, algorithm=algo, batch_size=64, winlen=0.3, epsilon=0.1,
                        device="cpu")
        out = tr.fit(feed, 5000, 0.05)
    assert _file("p.cod") == _text(out)


# -- qerror -fast ----------------------------------------------------------------

@pytest.mark.parametrize("flags", [(), ("-qetype", 1), ("-qetype", 1, "-radius", 2),
                                   ("-buffer", 50), ("-v", 0)])
@pytest.mark.parametrize("data,cod", [("wmask.dat", "wmask_w.cod"), ("fix.dat", "som_2.cod"),
                                      ("fix.dat", "som_g.cod")])
def test_qerror_fast_equal_jax(data, cod, flags):
    argv = ["qerror", "-fast", "-din", _gold(data), "-cin", _gold(cod), *flags]
    _, jout, jerr = jax_run(*argv)
    _, pout, perr = port_run(*argv)
    qj, qp = (float(o.split(" is ")[-1].split()[0] if " is " in o else o)
              for o in (jout, pout))
    assert abs(qp - qj) <= 1e-4 * abs(qj), (qp, qj)
    head = lambda o: o.split(" is ")[0] if " is " in o else ""  # noqa: E731
    assert head(pout) == head(jout) and perr == jerr
    if not flags or flags == ("-v", 0):
        d = read_data(_gold(data))
        api = som.find_qerror(read_data(_gold(cod)), d, mode="fast", device="cpu")
        assert "%f" % (np.float32(api) / np.float32(d.n)) in pout


# -- vfind -fast -----------------------------------------------------------------

def _vfind_answers(data, out, trials=4):
    return "\n".join([str(trials), data, data, out, "hexa", "gaussian", "5", "4",
                      "600", "0.05", "3", "900", "0.02", "1.5"]) + "\n"


def _trial_qerrors(err):
    return {int(a): float(b) for a, b in
            (line.split(":") for line in err.splitlines() if line.strip()[:1].isdigit())}


@pytest.mark.parametrize("qetype", [0, 1])
def test_vfind_fast_same_best_trial(qetype):
    d = _gold("fix.dat")
    _, jout, jerr = jax_run("vfind", "-fast", "-qetype", qetype,
                            stdin=_vfind_answers(d, "j.cod"))
    _, pout, perr = port_run("vfind", "-fast", "-qetype", qetype,
                             stdin=_vfind_answers(d, "p.cod"))
    qj, qp = _trial_qerrors(jerr), _trial_qerrors(perr)
    assert sorted(qj) == sorted(qp) == [1, 2, 3, 4]
    for t in qj:
        assert abs(qp[t] - qj[t]) <= 0.02 * qj[t], (t, qp[t], qj[t])
    best = lambda out: int(out.split("random seed")[1].split(":")[0])  # noqa: E731
    ranked = sorted(qj.values())
    if best(pout) != best(jout):
        assert ranked[1] - ranked[0] <= 0.01 * ranked[0], (qp, qj)
    data = read_data(d)
    codes, trial, _, _ = som.vfind_trials(
        data, data, 4, som.Topology.HEXA, som.Neighborhood.GAUSSIAN, 5, 4,
        [(600, 0.05, 3.0), (900, 0.02, 1.5)], qmode=qetype, device="cpu")
    assert trial == best(pout) and _file("p.cod") == _text(codes)


def test_vfind_fast_weights_takes_the_sequential_trials():
    """-fast with -weights runs the sequential parity trials, with the JAX
    CLI's message, and writes the parity run's bytes."""
    d = _gold("wmask.dat")
    answers = _vfind_answers(d, "f.cod", trials=2)
    _, jout, jerr = jax_run("vfind", "-fast", "-weights", 1, stdin=answers)
    _, pout, perr = port_run("vfind", "-fast", "-weights", 1, stdin=answers)
    assert (pout, perr) == (jout, jerr) and "vfind: -fast ignored" in perr
    os.rename("f.cod", "fast.cod")
    port_run("vfind", "-weights", 1, stdin=answers)
    assert _file("fast.cod") == _file("f.cod")


# -- the kNN tools with -fast ---------------------------------------------------

def _near_tie_rows(X, C, k, mask=None):
    """Rows whose k-NN lists (the two packages' device routes) differ; each
    must be a near-tie (1e-5 relative in float64)."""
    pi, _ = distance.pairwise_topk_mode(X, C, k, mask, mode="fast", device="cpu")
    ji, _ = jdistance.pairwise_topk_mode(X, C, k, mask, mode="fast")
    ji = np.asarray(ji)
    rows = np.nonzero((pi != ji).any(axis=1))[0]
    if rows.size:
        x64 = X[rows].astype(np.float64)[:, None, :]
        da = ((x64 - C[pi[rows]].astype(np.float64)) ** 2).sum(-1)
        db = ((x64 - C[ji[rows]].astype(np.float64)) ** 2).sum(-1)
        gap = np.abs(da - db) / np.maximum(np.maximum(da, db), 1e-30)
        assert gap.max() < 1e-5, gap.max()
    return rows.size


@pytest.mark.parametrize("tool,argv,out,lists", [
    ("eveninit", ["-din", "E", "-noc", 200], "o.cod", ("E", "E")),
    ("propinit", ["-din", "E", "-noc", 150, "-knn", 3], "o.cod", ("E", "E")),
    ("knntest", ["-din", "C", "-cin", "O"], None, ("C", "O")),
    ("knntest", ["-din", "C", "-cin", "O", "-buffer", 700, "-knn", 3], None, ("C", "O")),
    ("setlabel", ["-din", "E", "-cin", "L"], "o.cod", ("L", "E")),
    ("setlabel", ["-din", "E", "-cin", "L", "-buffer", 600], "o.cod", ("L", "E")),
    ("elimin", ["-din", "C"], "o.cod", ("C", "C")),
])
def test_knn_tools_fast_equal_jax(tool, argv, out, lists, monkeypatch):
    monkeypatch.setenv("SOMVQ_AUTO_TOPK_PAIRS", "0")
    names = {"E": _gold("elimin.dat"), "C": _gold("classify.dat"),
             "O": _gold("lvq_o.cod"), "L": _gold("lvq_e.cod")}
    argv = [names.get(a, a) for a in argv] + ([] if out is None else ["-cout", out])
    jres = jax_run(tool, "-fast", *argv)
    jtext = _file(out) if out else None
    pres = port_run(tool, "-fast", *argv)
    X, C = (read_data(names[n]) for n in lists)
    k = int(argv[argv.index("-knn") + 1]) if "-knn" in argv else 5
    if _near_tie_rows(X.points, C.points, k, X.mask) == 0:
        assert pres == jres
        if out:
            assert _file(out) == jtext


# -- sammon_fast -----------------------------------------------------------------

def test_sammon_fast_quality():
    codes = read_data(_gold("som_2.cod"))
    rng = CRandom()
    rng.init_random(3)
    proj_ref, dd = sammon.sammon(codes, length=50, rng=rng)
    proj, dd_fast = sammon.sammon_fast(codes, length=50, seed=3, device="cpu")
    assert np.isfinite(proj.points).all() and proj.points.shape == (dd.n, 2)
    assert _text(dd_fast) == _text(dd)
    dmat = exact.pairwise_dist_euc(dd.points, dd.points)
    e_ref, e_fast = sammon.mapping_error(proj_ref, dmat), sammon.mapping_error(proj, dmat)
    assert e_fast < 1.5 * e_ref
    # the same iteration as the JAX package's: its first two steps agree to
    # rounding; later, one-ulp differences of the sums grow to order one
    # (the JAX package's own two paths part by 5% at 50 steps), so the
    # 50-step errors are held to the 1.5x gate both ways
    from som_lvq_pak_tpu.data.io import read_data as jread_data

    jcodes = jread_data(_gold("som_2.cod"))
    for length in (1, 2):
        a = sammon.sammon_fast(codes, length=length, seed=3, device="cpu")[0].points
        b = np.asarray(jsammon_fast(jcodes, length=length, seed=3)[0].points)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    e_jax = sammon.mapping_error(jsammon_fast(jcodes, length=50, seed=3)[0], dmat)
    assert e_fast < 1.5 * e_jax and e_jax < 1.5 * e_fast, (e_fast, e_jax)


def test_sammon_fast_removes_identicals_as_the_parity_path():
    """The device distance matrix is exact.pairwise_dist_euc's bit for bit,
    and the identical entries go as remove_identicals drops them (masked
    rows too)."""
    codes = read_data(_gold("wmask.dat"))
    dup = codes.concat(codes.take([0, 5, 5, 17]))
    P = torch.from_numpy(dup.points)
    M = torch.from_numpy(dup.mask)
    got = sammon._pairwise_dist_euc_t(P, M).numpy()
    want = exact.pairwise_dist_euc(dup.points, dup.points, dup.mask, dup.mask)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    _, deduped = sammon.sammon_fast(dup, length=2, seed=1, device="cpu")
    assert _text(deduped) == _text(sammon.remove_identicals(dup))
    assert deduped.n <= codes.n
