"""The port's CLI (`som_lvq_pak_torch.cli`) against the JAX CLI, byte for
byte: every tool runs in-process through both drivers on the same inputs,
each in a directory of its own under tmp_path, and the return code, stdout,
stderr and every file the tool leaves are compared exactly.  The one text
that differs on purpose is `-version`'s: the port's `get_version()` names
its own package (`som_lvq_pak_torch` for `som_lvq_pak_tpu`).

Inputs are the repo's golden files: `wmask.dat` (120 x 7, masked, weight=)
and `fix.dat` (80 x 5, fixed=) for the SOM tools, `elimin.dat` (1,794 x 20,
labelled) and `classify.dat` (1,962 x 20) for the LVQ tools, and the
codebooks `som_2.cod`, `som_v.cod`, `lvq_e.cod`, `lvq_b.cod` + `lvq_b.lra`,
`lvq_o.cod`.  Where a golden's inputs are all in the repo it is held too:
`mcnemar.txt`, `lvq_mindist.txt`, `som_v_p1.ps` ... `som_v_p5.ps`,
`sammon.sam`, `sammon_map.sam`, `sammon_map_sa.ps`/`.eps`,
`vsom_help.txt` and `eveninit_help.txt`.

No tool here passes `-fast`, so the port runs on the host.  Each chain runs
twice: with `device="cpu"` and with `device` left at its "cuda" default on
this machine, which has no GPU: a tool that left a mode to the port's
device-first defaults would raise there (or, on the CPU, write other
bytes).  Tolerance: none; every comparison is exact."""

import io
import os
import shutil
import sys
import time

import pytest

from som_lvq_pak_tpu import cli as jcli
from som_lvq_pak_tpu.cli.params import verbose as jverbose
from som_lvq_pak_tpu.data.labels import GLOBAL_LABELS as JAX_LABELS
from som_lvq_pak_tpu.utils.snapshot import read_snapshots as jread_snapshots
from som_lvq_pak_torch import cli as pcli
from som_lvq_pak_torch import get_version
from som_lvq_pak_torch.cli import lvq_run as plvq_run
from som_lvq_pak_torch.cli.params import verbose as pverbose
from som_lvq_pak_torch.cli.usage import usage_text
from som_lvq_pak_torch.data.labels import GLOBAL_LABELS
from som_lvq_pak_torch.utils.snapshot import read_snapshots

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
DEVICES = ["cpu", "cuda"]  # "cuda": the default, left as it is


def _gold(name):
    return os.path.join(GOLDEN, name)


@pytest.fixture(autouse=True)
def reset_state():
    """Verbosity 1 and empty label tables in both packages around each
    test (tests/test_cli.py:15-19)."""
    jverbose(1)
    pverbose(1)
    GLOBAL_LABELS.reset()
    yield
    jverbose(1)
    pverbose(1)
    GLOBAL_LABELS.reset()


def _call(main, argv, stdin, **kw):
    """One tool in-process as a fresh process would run it (empty label
    table): (rc, stdout, stderr)."""
    JAX_LABELS.reset()
    GLOBAL_LABELS.reset()
    old = sys.stdout, sys.stderr, sys.stdin
    sys.stdout, sys.stderr = io.StringIO(), io.StringIO()
    sys.stdin = io.StringIO(stdin or "")
    try:
        rc = main([str(a) for a in argv], **kw)
        return rc, sys.stdout.getvalue(), sys.stderr.getvalue()
    finally:
        sys.stdout, sys.stderr, sys.stdin = old


def _reap(timeout=20.0):
    """Wait for the background snapshot writers a tool forked and left
    running (async_nowait): every child of this process, for at most
    `timeout` seconds."""
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            time.sleep(0.01)


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


class Both:
    """Runs each tool through the JAX CLI in `tmp/jax` and the port's in
    `tmp/port` (the port with `device`, None leaving its default) and
    asserts equal results and equal directories."""

    def __init__(self, tmp, device, monkeypatch):
        self.jdir, self.pdir = str(tmp / "jax"), str(tmp / "port")
        os.makedirs(self.jdir)
        os.makedirs(self.pdir)
        self.kw = {} if device == "cuda" else {"device": device}
        self.mp = monkeypatch

    def copy(self, *names):
        for name in names:
            src, _, dst = name.partition(":")
            for d in (self.jdir, self.pdir):
                shutil.copy(_gold(src), os.path.join(d, dst or src))

    def __call__(self, *argv, stdin=None, rc=0):
        self.mp.chdir(self.jdir)
        jout = _call(jcli.main, argv, stdin)
        _reap()
        self.mp.chdir(self.pdir)
        pout = _call(pcli.main, argv, stdin, **self.kw)
        _reap()
        assert pout == jout, argv
        assert pout[0] == rc, pout
        assert _files(self.pdir) == _files(self.jdir), argv
        return pout

    def read(self, name):
        with open(os.path.join(self.pdir, name)) as f:
            return f.read()


@pytest.fixture(params=DEVICES)
def both(request, tmp_path, monkeypatch):
    return Both(tmp_path, request.param, monkeypatch)


# -- the driver ------------------------------------------------------------------

def test_registry_names_equal_jax():
    assert pcli.tool_names() == jcli.tool_names()
    assert len(pcli.tool_names()) == 31


@pytest.mark.parametrize("tool", jcli.tool_names())
def test_help_equal_jax(tool, tmp_path, monkeypatch):
    """-help for every tool; mcnemar takes no flags (its usage on stderr,
    rc 1), vfind has no usage text."""
    b = Both(tmp_path, "cpu", monkeypatch)
    _, out, err = b(tool, "-help", rc=1 if tool == "mcnemar" else 0)
    if tool == "mcnemar":
        assert "Usage: mcnemar" in err
    elif tool == "vfind":
        assert "no usage text" in out
    else:
        assert out == usage_text(tool) and out
    if tool in ("vsom", "eveninit"):
        with open(_gold(f"{tool}_help.txt")) as f:
            assert out == f.read()


@pytest.mark.parametrize("argv,rc,text", [
    (["qerror", "-din", _gold("wmask.dat")], 255, "Can't find asked option -cin"),
    (["vsom", "-din", _gold("wmask.dat"), "-cin", "x.cod"], 255,
     "Can't find asked option -cout"),
    (["olvq1", "-din", _gold("elimin.dat"), "-cin", "x.cod", "-cout", "y.cod"], 255,
     "Can't find asked option -rlen"),
    (["nosuchtool"], 1, "somvq: unknown tool 'nosuchtool'"),
    ([], 1, "usage: somvq <tool>"),
    (["help"], 0, "lvq_run"),
    (["randinit", "-din", _gold("fix.dat"), "-cout", "r.cod", "-xdim", 4, "-ydim", 2,
      "-topol", "hexa", "-neigh", "bubble", "-bogus", 1], 0,
     "Extra parameters in command line ignored"),
    (["qerror", "-din", _gold("fix.dat"), "-cin", _gold("lvq_e.cod")], 1,
     "is not a map file"),
    (["accuracy", "-din", _gold("nothere.dat"), "-cin", _gold("lvq_e.cod")], 1,
     "Can't open data file"),
    (["mcnemar", "one"], 1, "Usage: mcnemar"),
])
def test_driver_errors_equal_jax(argv, rc, text, tmp_path, monkeypatch):
    b = Both(tmp_path, "cpu", monkeypatch)
    _, out, err = b(*argv, rc=rc)
    assert text in out + err


@pytest.mark.parametrize("name,warns", [("default", False), ("DEFAULT", False),
                                        ("fast", True), ("bogus", True)])
def test_selfuncs_equal_jax(name, warns, both):
    _, _, err = both("qerror", "-din", _gold("fix.dat"), "-cin", _gold("som_2.cod"),
                     "-selfuncs", name)
    assert ("functions for '%s' not found, using defaults" % name in err) == warns


def test_version_names_the_port(tmp_path, monkeypatch):
    """-version: the port's line names its package, the rest is the same."""
    b = Both(tmp_path, "cpu", monkeypatch)
    monkeypatch.chdir(b.pdir)
    argv = ["showlabs", "-cin", _gold("lvq_e.cod"), "-version"]
    jrc, jout, jerr = _call(jcli.main, argv, None)
    prc, pout, perr = _call(pcli.main, argv, None, device="cpu")
    assert (prc, pout) == (jrc, jout) == (0, jout)
    assert perr == "Version: %s\n" % get_version()
    assert perr == jerr.replace("som_lvq_pak_tpu", "som_lvq_pak_torch")
    assert get_version().startswith("som_lvq_pak_torch 0.1.0 (capability parity")


# -- the LVQ tools ---------------------------------------------------------------

def test_lvq_init_tools_equal_jax(both):
    """eveninit/propinit, balance (codebook, .lra, report), pick, extract,
    showlabs, stddev, mindist, setlabel and elimin on elimin.dat."""
    d = _gold("elimin.dat")
    both("eveninit", "-din", d, "-cout", "e.cod", "-noc", 200)
    both("propinit", "-din", d, "-cout", "p.cod", "-noc", 97, "-knn", 3)
    both("eveninit", "-din", d, "-cout", "t.cod", "-noc", 60, "-type", "propinit")
    _, out, _ = both("balance", "-din", d, "-cin", "e.cod", "-cout", "b.cod")
    assert "units, min dist.:" in out and os.path.exists(os.path.join(both.pdir, "b.lra"))
    both("pick", "-din", d, "-cout", "k.cod", "-noc", 50, "-v", 2)
    both("extract", "-din", d, "-cout", "x.cod", "-label", "A", "-v", 2)
    both("showlabs", "-cin", "b.cod")
    both("stddev", "-din", "x.cod")
    both("mindist", "-cin", "e.cod")
    _, out, _ = both("mindist", "-cin", _gold("lvq_e.cod"))
    with open(_gold("lvq_mindist.txt")) as f:
        assert out == f.read()
    both("mindist", "-cin", "b.cod", "-din", "b.cod")
    both("setlabel", "-din", d, "-cin", "b.cod", "-cout", "s.cod")
    both("setlabel", "-din", d, "-cin", "b.cod", "-cout", "s2.cod", "-knn", 3,
         "-buffer", 400)
    both("elimin", "-din", d, "-cout", "el.cod")
    both("elimin", "-din", "e.cod", "-cout", "el3.cod", "-knn", 12)


def test_lvq_train_tools_equal_jax(both):
    """olvq1 from lvq_b.cod + lvq_b.lra (in order, -rand 71, -buffer 500),
    lvq1/lvq2/lvq3 and lvqtrain -type, -alpha_type inverse_t, -v 2."""
    d = _gold("elimin.dat")
    both.copy("lvq_b.cod:b.cod", "lvq_b.lra:b.lra")
    _, out, _ = both("olvq1", "-din", d, "-cin", "b.cod", "-cout", "o.cod", "-rlen", 5000)
    assert "Removing the learning rate file" in out
    both("olvq1", "-din", d, "-cin", "b.cod", "-cout", "or.cod", "-rlen", 3000,
         "-rand", 71)
    both("olvq1", "-din", d, "-cin", "b.cod", "-cout", "ob.cod", "-rlen", 3000,
         "-buffer", 500)
    both("lvq1", "-din", d, "-cin", "o.cod", "-cout", "l1.cod", "-rlen", 3000,
         "-alpha", 0.05, "-v", 2)
    both("lvq2", "-din", d, "-cin", "o.cod", "-cout", "l2.cod", "-rlen", 3000,
         "-alpha", 0.05, "-win", 0.3)
    both("lvq3", "-din", d, "-cin", "o.cod", "-cout", "l3.cod", "-rlen", 3000,
         "-alpha", 0.05, "-win", 0.3, "-epsilon", 0.1, "-rand", 5)
    both("lvqtrain", "-type", "lvq1", "-din", d, "-cin", "o.cod", "-cout", "lt.cod",
         "-rlen", 2000, "-alpha", 0.05, "-alpha_type", "inverse_t", "-buffer", 300)
    both("lvqtrain", "-type", "lvq9", "-din", d, rc=1)


def test_lvq_eval_tools_equal_jax(both):
    """accuracy with -cfout (and -buffer), classify (also -buffer),
    knntest, cmatr, and mcnemar against the golden report."""
    c = _gold("classify.dat")
    both.copy("lvq_o.cod:o.cod", "lvq_b.cod:b.cod", "lvq_o.cfo:o.cfo", "lvq_b.cfo:b.cfo")
    _, out, _ = both("accuracy", "-din", c, "-cin", "o.cod", "-cfout", "o2.cfo", "-v", 2)
    assert "Total accuracy:" in out
    both("accuracy", "-din", c, "-cin", "b.cod", "-buffer", 500)
    both("classify", "-din", c, "-cin", "o.cod", "-dout", "c.dat", "-cfout", "c.cfo")
    both("classify", "-din", c, "-cin", "o.cod", "-dout", "cb.dat", "-cfout", "cb.cfo",
         "-buffer", 300, "-v", 2)
    both("knntest", "-din", c, "-cin", "o.cod")
    both("knntest", "-din", c, "-cin", "b.cod", "-knn", 3, "-buffer", 700)
    both("cmatr", "-din", c, "-cin", "o.cod", "-cfout", "m.cfo")
    both("cmatr", "-din", c, "-cin", "b.cod", "-buffer", 500)
    _, _, err = both("mcnemar", "o.cfo", "b.cfo")
    with open(_gold("mcnemar.txt")) as f:
        assert err == f.read()
    both("mcnemar", "o.cfo", "nothere.cfo", rc=1)


# -- the SOM tools ---------------------------------------------------------------

def test_som_tools_equal_jax(both):
    """randinit/lininit/mapinit, vsom (-weights, -fixed, -alpha_type
    inverse_t, -buffer, -rand), qerror and -qetype 1 (quiet and -v 1), vcal
    and visual (-noskip, -buffer) on wmask.dat and fix.dat."""
    w, x = _gold("wmask.dat"), _gold("fix.dat")
    both("randinit", "-din", w, "-cout", "r.cod", "-xdim", 6, "-ydim", 5, "-topol",
         "hexa", "-neigh", "gaussian", "-rand", 3, "-v", 2)
    both("lininit", "-din", x, "-cout", "l.cod", "-xdim", 4, "-ydim", 3, "-topol",
         "rect", "-neigh", "bubble")
    both("mapinit", "-init", "rand", "-din", x, "-cout", "f.cod", "-xdim", 4, "-ydim", 3,
         "-topol", "rect", "-neigh", "bubble", "-rand", 5)
    both("mapinit", "-din", x, "-cout", "n.cod", "-xdim", 4, "-ydim", 3, "-topol",
         "rect", "-neigh", "bubble", rc=1)
    both("vsom", "-din", w, "-cin", "r.cod", "-cout", "vw.cod", "-rlen", 1000, "-alpha",
         0.05, "-radius", 3, "-weights", "-rand", 3)
    both("vsom", "-din", w, "-cin", "r.cod", "-cout", "vi.cod", "-rlen", 600, "-alpha",
         0.05, "-radius", 3, "-alpha_type", "inverse_t", "-v", 2)
    both("vsom", "-din", w, "-cin", "r.cod", "-cout", "vb.cod", "-rlen", 500, "-alpha",
         0.05, "-radius", 2, "-buffer", 40, "-rand", 1)
    both("vsom", "-din", x, "-cin", "f.cod", "-cout", "ff.cod", "-rlen", 200, "-alpha",
         0.1, "-radius", 2, "-fixed")
    both("vsom", "-din", w, "-cin", "r.cod", "-cout", "vx.cod", "-rlen", 10, "-alpha",
         0.05, "-radius", 3, "-alpha_type", "bogus", rc=1)
    for cod, data in (("vw.cod", w), ("ff.cod", x)):
        _, out, _ = both("qerror", "-din", data, "-cin", cod)
        assert "Quantization error of" in out
        both("qerror", "-din", data, "-cin", cod, "-v", 0)
        both("qerror", "-din", data, "-cin", cod, "-qetype", 1)
        both("qerror", "-din", data, "-cin", cod, "-qetype", 1, "-radius", 2, "-v", 0)
        both("qerror", "-din", data, "-cin", cod, "-buffer", 30)
    both("vcal", "-din", w, "-cin", "vw.cod", "-cout", "c1.cod")
    both("vcal", "-din", w, "-cin", "vw.cod", "-cout", "c0.cod", "-numlabs", 0,
         "-buffer", 50)
    both("visual", "-din", w, "-cin", "vw.cod", "-dout", "v.vis")
    both("visual", "-din", w, "-cin", "vw.cod", "-dout", "vn.vis", "-noskip")
    both("visual", "-din", w, "-cin", "vw.cod", "-dout", "vb.vis", "-buffer", 25)


VFIND = [
    "3", "{d}", "{d}", "best.cod", "hexa", "gaussian", "4", "3",
    "200", "0.05", "3", "300", "0.02", "1.5",
]


@pytest.mark.parametrize("flags", [(), ("-qetype", 1), ("-v", 2), ("-weights", 1)])
def test_vfind_equal_jax(flags, both):
    """vfind's sequential trials on stdin (its description, prompts,
    per-trial qerrors and the best map)."""
    d = _gold("wmask.dat" if "-weights" in flags else "fix.dat")
    answers = "\n".join(a.format(d=d) for a in VFIND) + "\n"
    _, out, _ = both("vfind", *flags, stdin=answers)
    assert "Smallest error with random seed" in out


@pytest.mark.parametrize("stype", ["file", "keepopen", "async", "async_nowait"])
def test_snapshots_equal_jax(stype, both):
    """vsom and lvq1 snapshots of each type, read back by read_snapshots
    (keepopen) or as files."""
    w, e = _gold("wmask.dat"), _gold("elimin.dat")
    both.copy("wmask_r.cod:r.cod", "lvq_o.cod:o.cod")
    pattern = "snap.cod" if stype == "keepopen" else "snap_%d.cod"
    both("vsom", "-din", w, "-cin", "r.cod", "-cout", "s.cod", "-rlen", 1000, "-alpha",
         0.05, "-radius", 3, "-snapfile", pattern, "-snapinterval", 400,
         "-snaptype", stype)
    both("lvq1", "-din", e, "-cin", "o.cod", "-cout", "l.cod", "-rlen", 900, "-alpha",
         0.05, "-snapfile", "l" + pattern, "-snapinterval", 300, "-snaptype", stype)
    if stype == "keepopen":
        for name, n, count in (("snap.cod", 30, 2), ("lsnap.cod", 200, 2)):
            path = os.path.join(both.pdir, name)
            snaps, jsnaps = read_snapshots(path), jread_snapshots(path)
            assert len(snaps) == len(jsnaps) == count
            assert all(s.n == n for s in snaps)
            for s, j in zip(snaps, jsnaps):
                assert (s.points == j.points).all()
    else:
        for it in (400, 800):
            assert "#iterations: %d/1000" % it in both.read("snap_%d.cod" % it)
        assert "#SNAPSHOT FILE" in both.read("lsnap_600.cod")
    both("vsom", "-din", w, "-cin", "r.cod", "-cout", "u.cod", "-rlen", 10, "-alpha",
         0.05, "-radius", 3, "-snapinterval", 5, "-snaptype", "bogus", rc=1)


# -- the golden chains with the native engine on and off ---------------------------

def _same_as_golden(both, name, golden):
    with open(_gold(golden)) as f:
        assert both.read(name) == f.read(), name


@pytest.mark.parametrize("native", ["0", "1"])
@pytest.mark.parametrize("family", ["somexample", "lvqexample"])
def test_golden_chains_native_on_and_off(family, native, tmp_path, monkeypatch):
    """One golden chain of each family with the data-file engine off
    (SOMVQ_NATIVE=0: the Python parser and writer) and on (the native
    engine, as by default; both packages read the setting): every output
    byte-equal to the JAX CLI's and to the C package's goldens.  The SOM
    chain: vsom with -weights, with -buffer 37 -rand 3 (streamed chunk
    parses) and -buffer 120, and with -fixed, from wmask_r.cod/fix_r.cod,
    then qerror; the LVQ chain: mindist of lvq_e.cod, olvq1 from lvq_b.cod
    and its .lra on elimin.dat, accuracy and classify on classify.dat,
    sammon of lvq_o.cod."""
    monkeypatch.setenv("SOMVQ_NATIVE", native)
    b = Both(tmp_path, "cpu", monkeypatch)
    if family == "somexample":
        w, x = _gold("wmask.dat"), _gold("fix.dat")
        b.copy("wmask_r.cod:r.cod", "fix_r.cod:f.cod")
        som = ["-rlen", 300, "-alpha", 0.05, "-radius", 4]
        for out, flags in (("w.cod", ["-weights", 1]), ("br.cod", ["-buffer", 37, "-rand", 3]),
                           ("b120.cod", ["-buffer", 120, "-rand", 3])):
            b("vsom", "-din", w, "-cin", "r.cod", "-cout", out, *som, *flags)
        b("vsom", "-din", x, "-cin", "f.cod", "-cout", "fv.cod", "-rlen", 200, "-alpha", 0.1,
          "-radius", 2, "-fixed", 1)
        for name, golden in (("w.cod", "wmask_w.cod"), ("br.cod", "wmask_br.cod"),
                             ("b120.cod", "wmask_b120.cod"), ("fv.cod", "fix_fv.cod")):
            _same_as_golden(b, name, golden)
        _, out, _ = b("qerror", "-din", w, "-cin", "w.cod")
        assert "Quantization error of" in out
        b("qerror", "-din", w, "-cin", "br.cod", "-buffer", 30)
    else:
        b.copy("lvq_b.cod:b.cod", "lvq_b.lra:b.lra", "lvq_o.cod:o.cod")
        _, out, _ = b("mindist", "-cin", _gold("lvq_e.cod"))
        with open(_gold("lvq_mindist.txt")) as f:
            assert out == f.read()
        b("olvq1", "-din", _gold("elimin.dat"), "-cin", "b.cod", "-cout", "t.cod",
          "-rlen", 3000)
        c = _gold("classify.dat")
        _, out, _ = b("accuracy", "-din", c, "-cin", "t.cod", "-cfout", "t.cfo")
        assert "Total accuracy:" in out
        b("classify", "-din", c, "-cin", "t.cod", "-dout", "c.dat", "-cfout", "c.cfo")
        b("sammon", "-cin", "o.cod", "-cout", "s.sam", "-rlen", 100, "-rand", 3)
        _same_as_golden(b, "s.sam", "sammon.sam")


# -- the visualisation tools -----------------------------------------------------

def test_planes_equal_golden(both):
    both.copy("som_v.cod:v.cod")
    both("planes", "-cin", "v.cod", "-ps", 1, "-plane", 0)
    for p in range(1, 6):
        with open(_gold(f"som_v_p{p}.ps")) as f:
            assert both.read(f"v_p{p}.ps") == f.read()
    both("planes", "-cin", "v.cod", "-plane", 2, "-din", _gold("fix.dat"))
    both("planes", "-cin", "v.cod", "-plane", 9, rc=1)


def _strip_date(text):
    return [line for line in text.splitlines() if not line.startswith("%%CreationDate")]


@pytest.mark.parametrize("flags", [
    (), ("-average",), ("-median",), ("-ps",), ("-ps", "-swapx", "-average"),
    ("-eps", "-border", "-swapy", "-W", "0.8", "-B", "0.1"),
    ("-ps", "-paper", "A3", "-landscape", "-notitle", "-nolabs"),
])
def test_umat_equal_jax(flags, tmp_path, monkeypatch):
    """umat on som_v.cod and som_g.cod (rect gaussian), written to a file;
    equal to the JAX CLI's but for the %%CreationDate line."""
    b = Both(tmp_path, "cpu", monkeypatch)
    b.copy("som_v.cod:v.cod", "som_g.cod:g.cod")
    for cod in ("v.cod", "g.cod"):
        monkeypatch.chdir(b.jdir)
        jout = _call(jcli.main, ["umat", "-cin", cod, "-o", "u.ps", *flags], None)
        with open("u.ps") as f:
            jtext = f.read()
        monkeypatch.chdir(b.pdir)
        pout = _call(pcli.main, ["umat", "-cin", cod, "-o", "u.ps", *flags], None,
                     device="cpu")
        with open("u.ps") as f:
            ptext = f.read()
        assert pout == jout and pout[0] == 0
        assert _strip_date(ptext) == _strip_date(jtext) and len(ptext) > 1000


def test_sammon_equal_golden(both):
    both.copy("lvq_o.cod:o.cod", "som_2.cod:m.cod")
    both("sammon", "-cin", "o.cod", "-cout", "s.sam", "-rlen", 100, "-rand", 3)
    with open(_gold("sammon.sam")) as f:
        assert both.read("s.sam") == f.read()
    both("sammon", "-cin", "m.cod", "-cout", "sammon_map.sam", "-rlen", 50, "-rand", 3,
         "-ps")
    with open(_gold("sammon_map.sam")) as f:
        assert both.read("sammon_map.sam") == f.read()
    with open(_gold("sammon_map_sa.ps")) as f:
        assert both.read("sammon_map_sa.ps") == f.read()
    both("sammon", "-cin", "m.cod", "-cout", "sammon_map.sam", "-rlen", 50, "-rand", 3,
         "-eps")
    with open(_gold("sammon_map_sa.eps")) as f:
        assert both.read("sammon_map_sa.eps") == f.read()


# -- lvq_run ---------------------------------------------------------------------

def _session(d, t):
    return "\n".join([
        "",              # press enter to continue
        "1",             # create a new classifier
        d, "200", "", "3000", t,
        "c1",            # the classifier's base name
        "y", "n",        # one balance round
        "4", "2", "", "1500", "",   # fine-tune with lvq2.1
        "2", "c2",       # copy it
        "7",             # compare the two
        "6", "1",        # view classifier 1
        "0",             # quit and save
    ]) + "\n"


def test_lvq_run_session_equal_jax(both):
    """A scripted interactive session on elimin.dat/classify.dat: create
    (one balance round), fine-tune with lvq2.1, copy, compare, view, quit;
    the transcript and every state file equal to the JAX driver's."""
    _, out, _ = both("lvq_run", stdin=_session(_gold("elimin.dat"), _gold("classify.dat")))
    assert "Total accuracy:" in out and "c1" in out
    c = plvq_run.load_log(os.path.join(both.pdir, "c1"))
    assert c.noc == 200 and c.totrlen == 3000 and c.lvq_status == plvq_run.RETRAIN
    assert any("olvq1" in h for h in c.history)
    both("lvq_run", "c1", "c2", stdin="\n7\n0\n")


@pytest.mark.parametrize("device", DEVICES)
def test_lvq_run_pipeline_equal_jax(device, tmp_path, monkeypatch):
    """The scriptable Pipeline: init with one balance round, train, test,
    save_log/load_log; the echo and the files equal to the JAX Pipeline's."""
    from som_lvq_pak_tpu.cli import lvq_run as jlvq_run

    outs = {}
    for name, mod, kw in (("jax", jlvq_run, {}),
                          ("port", plvq_run, {} if device == "cuda" else {"device": device})):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        JAX_LABELS.reset()
        GLOBAL_LABELS.reset()
        buf = io.StringIO()
        old = sys.stdout
        sys.stdout = io.StringIO()
        try:
            pipe = mod.Pipeline(out=buf, **kw)
            c = mod.Classifier(din=_gold("elimin.dat"), tdin=_gold("classify.dat"),
                               cout="p1", noc=120, rlen=2400)
            pipe.init_classifier(c, balance_rounds=1)
            pipe.train_classifier(c)
            pipe.test_classifier(c)
            mod.save_log(c)
            back = mod.load_log("p1")
        finally:
            printed = sys.stdout.getvalue()
            sys.stdout = old
        outs[name] = (buf.getvalue(), printed, _files(str(d)), vars(back))
    assert outs["port"] == outs["jax"]
    assert outs["port"][3]["lvq_status"] == plvq_run.TRAIN
    assert outs["port"][3]["accuracy"] > 50.0
