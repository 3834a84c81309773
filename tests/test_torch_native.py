"""The port's native data-file engine (`som_lvq_pak_torch.data.native_io`,
built from native/somvq_io.cpp) against the port's Python parser and writer
and against the JAX package's reader and writer: the twin of
tests/test_native.py.

Every fixture is read with the engine on and off (SOMVQ_NATIVE) and by the
JAX package: the arrays (points, mask, labels by name, weight, fixed), the
header and the comments must be equal.  Every fixture is written by
`write_data` and `write_data_chunks` with the engine on and off and by the
JAX writers: the bytes must be equal.  StreamingReader's chunks, engine on
and off, equal a full read and the JAX reader's chunks over laps, gzip and
shards.  The build: into som_lvq_pak_torch/_build/ only, native/ untouched,
two processes building at once, a failing compiler raising, a missing one
falling back to Python, SOMVQ_NATIVE=0 never loading the library.
Tolerance: none; every comparison is exact."""

import gzip
import hashlib
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from som_lvq_pak_tpu.data import io as jio
from som_lvq_pak_tpu.data.labels import LabelTable as JLabelTable
from som_lvq_pak_tpu.data.streaming import StreamingReader as JStreamingReader
from som_lvq_pak_torch.data import io as pio
from som_lvq_pak_torch.data import native_io
from som_lvq_pak_torch.data.labels import LabelTable
from som_lvq_pak_torch.data.streaming import StreamingReader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
REFERENCE = ["ex.dat", "ex1.dat", "ex2.dat", "ex_fts.dat", "ex_ndy.dat"]
FIXTURES = REFERENCE + sorted(f for f in os.listdir(GOLDEN) if f.endswith((".cod", ".dat")))


@pytest.fixture
def fixture_path(request):
    """The path of fixture `request.param`: the reference package's example
    files from its data directory (skipped where it is absent), the rest
    from tests/golden."""
    name = request.param
    if name in REFERENCE:
        return os.path.join(request.getfixturevalue("ref_dir"), name)
    return os.path.join(GOLDEN, name)


@pytest.fixture
def fresh_engine():
    """Forget the loaded engine before and after the test, so a test that
    moves BUILD_DIR or PATH builds and loads its own."""
    native_io._load.cache_clear()
    yield
    native_io._load.cache_clear()


def _label_names(ds, table):
    if ds.labels is None:
        return None
    return [[table.to_label(int(i)) for i in row if i] for row in ds.labels]


def _same(a, ta, b, tb, what=""):
    """Datasets `a` and `b` (label tables `ta`, `tb`) equal field by field,
    labels by name."""
    for f in ("points", "mask", "weight", "fixed"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), (what, f)
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, (what, f)
            assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), (what, f)
    assert _label_names(a, ta) == _label_names(b, tb), what
    if a.labels is not None:
        assert a.labels.shape == b.labels.shape, what
    assert (int(a.topol), int(a.neigh), a.xdim, a.ydim, a.comments) == \
        (int(b.topol), int(b.neigh), b.xdim, b.ydim, b.comments), what


def _read(path, native, monkeypatch):
    monkeypatch.setenv("SOMVQ_NATIVE", native)
    table = LabelTable()
    return pio.read_data(path, labels=table), table


def test_engine_is_available_here():
    """With g++ on the PATH, as these tests require, the engine builds and
    loads, so the tests below compare it and not the Python fallback."""
    assert native_io.available()
    assert native_io._load()._name == native_io.library_path()


@pytest.mark.parametrize("fixture_path", FIXTURES, indirect=True)
def test_read_equal_engine_on_off_and_jax(fixture_path, monkeypatch):
    on, t_on = _read(fixture_path, "1", monkeypatch)
    off, t_off = _read(fixture_path, "0", monkeypatch)
    jt = JLabelTable()
    ref = jio.read_data(fixture_path, labels=jt)
    _same(on, t_on, off, t_off, "engine on/off")
    _same(on, t_on, ref, jt, "port/JAX")


def _chunks(ds, k=3):
    """`ds` as at most k row slices (none for an empty `ds`)."""
    cut = max(1, -(-ds.n // k))
    return [ds.take(np.arange(lo, min(ds.n, lo + cut))) for lo in range(0, ds.n, cut)]


@pytest.mark.parametrize("fixture_path", FIXTURES, indirect=True)
def test_write_equal_engine_on_off_and_jax(fixture_path, tmp_path, monkeypatch):
    """write_data and write_data_chunks, engine on and off, byte-equal to
    each other and to the JAX package's writers."""
    ds, table = _read(fixture_path, "1", monkeypatch)
    jt = JLabelTable()
    jds = jio.read_data(fixture_path, labels=jt)
    out = {}
    for native in ("1", "0"):
        monkeypatch.setenv("SOMVQ_NATIVE", native)
        whole, parts = str(tmp_path / f"w{native}"), str(tmp_path / f"c{native}")
        pio.write_data(ds, whole, labels=table, comments="# c")
        assert pio.write_data_chunks(iter(_chunks(ds)), parts, labels=table,
                                     comments="# c", meta=ds) == ds.n
        out[f"write_data {native}"], out[f"chunks {native}"] = whole, parts
    jio.write_data(jds, str(tmp_path / "jw"), labels=jt, comments="# c")
    jio.write_data_chunks(iter(_chunks(jds)), str(tmp_path / "jc"), labels=jt,
                          comments="# c", meta=jds)
    out["jax write_data"], out["jax chunks"] = str(tmp_path / "jw"), str(tmp_path / "jc")
    text = {}
    for key, path in out.items():
        with open(path, "rb") as f:
            text[key] = f.read()
    assert len(set(text.values())) == 1, {k: len(v) for k, v in text.items()}
    buf = io.StringIO()
    monkeypatch.setenv("SOMVQ_NATIVE", "1")
    pio.write_data(ds, None, labels=table, comments="# c", fileobj=buf)
    assert buf.getvalue().encode() == text["jax write_data"]


MWF = "3\n1 x 3 A weight=2 fixed=1,2\nx x x EMPTY\n4 5 6 B C\n# tail\n\n7 8 x\n"


@pytest.mark.parametrize("skip_empty", [True, False])
@pytest.mark.parametrize("native", ["1", "0"])
def test_masks_weight_fixed(native, skip_empty, tmp_path, monkeypatch):
    """A masked component, weight= and fixed= tokens, an all-masked entry
    (skipped unless skip_empty=False), two labels on a line, a comment and
    a blank line after the header: the engine's read is the Python read's
    and the JAX package's; the write is the JAX writer's."""
    path = str(tmp_path / "m.dat")
    with open(path, "w") as f:
        f.write(MWF)
    monkeypatch.setenv("SOMVQ_NATIVE", native)
    table, jt = LabelTable(), JLabelTable()
    ds = pio.read_data(path, labels=table, skip_empty=skip_empty)
    ref = jio.read_data(path, labels=jt, skip_empty=skip_empty)
    _same(ds, table, ref, jt)
    assert ds.n == (3 if skip_empty else 4)
    assert ds.mask[0].tolist() == [0, 1, 0] and ds.mask[-1].tolist() == [0, 0, 1]
    assert ds.weight[0] == 2.0 and ds.fixed[0].tolist() == [1, 2]
    assert ds.labels.shape[1] == 2
    assert _label_names(ds, table)[1 if skip_empty else 2] == ["B", "C"]
    direct = native_io.read_data_native(path, labels=LabelTable(), skip_empty=skip_empty)
    _same(ds, table, direct, table)
    a, b = io.StringIO(), io.StringIO()
    pio.write_data(ds, None, labels=table, fileobj=a)
    jio.write_data(ref, None, labels=jt, fileobj=b)
    assert a.getvalue() == b.getvalue()


def test_parse_errors_name_the_file(tmp_path, monkeypatch):
    """A short entry line is an error on both paths."""
    path = str(tmp_path / "short.dat")
    with open(path, "w") as f:
        f.write("3\n1 2 3\n4 5\n")
    for native in ("1", "0"):
        monkeypatch.setenv("SOMVQ_NATIVE", native)
        with pytest.raises(ValueError):
            pio.read_data(path, labels=LabelTable())


def _big_body(path):
    """A 5-column file with a body past the slab parser's 4 MB threshold:
    slab boundaries fall on labelled, weighted, fixed, masked, all-masked
    and comment lines (tests/test_native.py:74-101)."""
    rng = np.random.default_rng(3)
    rows = []
    for i in range(120_000):
        vals = " ".join("%g" % v for v in rng.normal(0, 1, 5))
        if i % 37 == 0:
            rows.append("# body comment %d" % i)
        if i % 23 == 0:
            rows.append("x x x x x SKIPME")
        if i % 11 == 0:
            rows.append("1 x 3 4 5 L%d weight=%d fixed=%d,%d"
                        % (i % 97, i % 5 + 1, i % 12, i % 8))
        else:
            rows.append("%s L%d" % (vals, i % 97))
    with open(path, "w") as f:
        f.write("5\n" + "\n".join(rows) + "\n")


def test_slab_parser_threads_identical(tmp_path, monkeypatch):
    """SOMVQ_PARSE_THREADS 1 and 4 (the C source's own setting) give the
    same arrays on a body above 4 MB, through read_data and through a
    buffer parse; formatting those entries (past the writer's 2^20-value
    threshold) gives the same text with 1 and 4 threads."""
    path = str(tmp_path / "big.dat")
    _big_body(path)
    assert os.path.getsize(path) > 4 << 20
    with open(path) as f:
        text = f.read()
    got = {}
    for threads in ("1", "4"):
        monkeypatch.setenv("SOMVQ_PARSE_THREADS", threads)
        table = LabelTable()
        got[threads] = (pio.read_data(path, labels=table), table,
                        native_io.parse_text_native(text, labels=LabelTable()))
    (a, ta, abuf), (b, tb, bbuf) = got["1"], got["4"]
    assert a.n == b.n > 100_000
    _same(a, ta, b, tb, "threads 1/4")
    _same(a, ta, abuf, ta, "file/buffer")
    _same(b, tb, bbuf, tb, "file/buffer")
    wide = a.like(np.tile(a.points, (1, 2))[:, :9])
    assert wide.n * wide.dim >= 1 << 20
    texts = []
    for threads in ("1", "4"):
        monkeypatch.setenv("SOMVQ_PARSE_THREADS", threads)
        texts.append(native_io.format_entries_native(wide, labels=ta))
    assert texts[0] == texts[1]
    head = wide.take(np.arange(2000))
    assert texts[0].startswith("".join(pio.format_entry(head, i, ta) + "\n"
                                       for i in range(head.n)))


# -- StreamingReader -------------------------------------------------------------

NATIVE = ["1", "0"]


@pytest.mark.parametrize("native", NATIVE)
@pytest.mark.parametrize("name,buffer", [("elimin.dat", 300), ("wmask.dat", 37),
                                         ("classify.dat", 1000)])
def test_streaming_reader_equals_full_read(name, buffer, native, monkeypatch):
    """One lap of chunks is the full read row for row: points, masks,
    labels by name, and weight= values (a chunk with no weight= token
    carries none; the full read's default there is 0)."""
    path = os.path.join(GOLDEN, name)
    full, table = _read(path, native, monkeypatch)
    chunks = list(StreamingReader(path, buffer=buffer, labels=table))
    assert len(chunks) > 1 and sum(c.n for c in chunks) == full.n
    lo = 0
    for c in chunks:
        part = full.take(np.arange(lo, lo + c.n))
        lo += c.n
        assert np.array_equal(c.points, part.points)
        assert np.array_equal(c.mask_or_zeros(), part.mask_or_zeros())
        assert _label_names(c, table) == _label_names(part, table)
        if c.weight is not None:
            assert np.array_equal(c.weight, part.weight)
        elif full.weight is not None:
            assert not part.weight.any()


@pytest.mark.parametrize("native", NATIVE)
def test_streaming_reader_laps_equal_jax(native, monkeypatch):
    """Two laps of 37-entry chunks over the masked, weighted file: each
    chunk the JAX reader's."""
    monkeypatch.setenv("SOMVQ_NATIVE", native)
    path = os.path.join(GOLDEN, "wmask.dat")
    pt, jt = LabelTable(), JLabelTable()
    mine = list(StreamingReader(path, buffer=37, labels=pt).chunks(laps=2))
    ref = list(JStreamingReader(path, buffer=37, labels=jt).chunks(laps=2))
    assert len(mine) == len(ref) > 4
    for a, b in zip(mine, ref):
        _same(a, pt, b, jt)


@pytest.mark.parametrize("native", NATIVE)
def test_streaming_reader_gzip_equal_jax(native, tmp_path, monkeypatch):
    """A gzip file streams (its chunks parse through the engine too) to
    the plain file's entries and the JAX reader's chunks."""
    src = os.path.join(GOLDEN, "elimin.dat")
    dst = str(tmp_path / "d.dat.gz")
    with open(src, "rb") as fi, gzip.open(dst, "wb") as fo:
        shutil.copyfileobj(fi, fo)
    full, table = _read(src, native, monkeypatch)
    jt = JLabelTable()
    mine = list(StreamingReader(dst, buffer=400, labels=table))
    ref = list(JStreamingReader(dst, buffer=400, labels=jt))
    assert len(mine) == len(ref) > 1
    for a, b in zip(mine, ref):
        _same(a, table, b, jt)
    pts = np.concatenate([c.points for c in mine])
    assert np.array_equal(pts, full.points)
    # a whole-file read of the gzip file takes the Python parser
    _same(pio.read_data(dst, labels=table), table, full, table)


@pytest.mark.parametrize("native", NATIVE)
def test_streaming_reader_shards_equal_jax(native, monkeypatch):
    """shard=(k, 3) splits entries round-robin with no overlap and full
    coverage, each shard's chunks the JAX reader's."""
    path = os.path.join(GOLDEN, "elimin.dat")
    full, table = _read(path, native, monkeypatch)
    parts = []
    for k in range(3):
        jt = JLabelTable()
        mine = list(StreamingReader(path, buffer=200, labels=table, shard=(k, 3)))
        ref = list(JStreamingReader(path, buffer=200, labels=jt, shard=(k, 3)))
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            _same(a, table, b, jt)
        parts.append(np.concatenate([c.points for c in mine]))
    assert sum(len(p) for p in parts) == full.n
    for k in range(3):
        assert np.array_equal(parts[k], full.points[k::3])


# -- the build -------------------------------------------------------------------

def _tree_digest(root):
    h = hashlib.sha256()
    for name in sorted(os.listdir(root)):
        h.update(name.encode())
        with open(os.path.join(root, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def test_build_lands_in_build_dir_and_leaves_native_alone(tmp_path, monkeypatch,
                                                          fresh_engine):
    """The library goes to som_lvq_pak_torch/_build/ under a name hashed from
    the source and flags, and is loaded from there; a fresh build changes
    nothing in native/ (no make, no prebuilt library loaded)."""
    path = native_io.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "som_lvq_pak_torch", "_build")
    assert os.path.basename(path).startswith("libsomvq_io_")
    assert native_io.available() and os.path.exists(path)
    assert native_io._load()._name == path
    native = os.path.join(REPO, "native")
    before = _tree_digest(native)
    monkeypatch.setattr(native_io, "BUILD_DIR", str(tmp_path / "b"))
    native_io._load.cache_clear()
    assert native_io.available()
    assert os.listdir(tmp_path / "b") == [os.path.basename(native_io.library_path())]
    assert _tree_digest(native) == before
    monkeypatch.setattr(native_io, "CXXFLAGS", native_io.CXXFLAGS + ["-DNDEBUG"])
    assert native_io.library_path() != os.path.join(str(tmp_path / "b"),
                                                    os.path.basename(path))


_BUILD_AND_PARSE = """
import sys
from som_lvq_pak_torch.data import native_io
native_io.BUILD_DIR = sys.argv[1]
ds = native_io.parse_text_native("2\\n1 2 A\\n3 x B\\n")
assert native_io._load()._name.startswith(sys.argv[1])
print(ds.n, ds.points.tolist(), ds.mask.tolist())
"""


def test_concurrent_builds_both_load_a_working_library(tmp_path):
    """Two processes building into one empty directory at once: both load
    a library that parses, one library is left and no temporary file."""
    env = dict(os.environ, PYTHONPATH=REPO)
    build = str(tmp_path / "b")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_PARSE, build], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "2 [[1.0, 2.0], [3.0, 0.0]] [[0, 0], [0, 1]]"
    assert os.listdir(build) == [os.path.basename(native_io.library_path())]


def test_failing_compiler_raises_with_its_output(tmp_path, monkeypatch, fresh_engine):
    """A g++ that exists but fails raises with its error output (a broken
    build must not pass for a missing compiler), and leaves nothing in
    the build directory."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / "g++"
    fake.write_text("#!/bin/sh\necho 'somvq_io.cpp:1: error: broken' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(bin_dir))
    monkeypatch.setattr(native_io, "BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="error: broken"):
        native_io.available()
    with pytest.raises(RuntimeError, match="error: broken"):
        pio.read_data(os.path.join(GOLDEN, "fix.dat"))
    assert os.listdir(tmp_path / "b") == []


def test_missing_compiler_falls_back_to_python(tmp_path, monkeypatch, fresh_engine):
    """No g++ on the PATH: available() is False and reads, writes and chunk
    parses take the Python path, with the same results."""
    path = os.path.join(GOLDEN, "wmask.dat")
    ref, ref_table = _read(path, "1", monkeypatch)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native_io, "BUILD_DIR", str(tmp_path / "b"))
    native_io._load.cache_clear()
    assert not native_io.available()
    assert native_io.read_data_native(path) is None
    assert native_io.format_entries_native(ref) is None
    ds, table = _read(path, "1", monkeypatch)
    _same(ds, table, ref, ref_table)
    chunks = list(StreamingReader(path, buffer=50, labels=table))
    assert np.array_equal(np.concatenate([c.points for c in chunks]), ref.points)
    buf = io.StringIO()
    pio.write_data(ds, None, labels=table, fileobj=buf)
    with open(os.path.join(GOLDEN, "wmask.dat")) as f:
        assert buf.getvalue().startswith(f.readline())
    assert not os.path.exists(tmp_path / "b")


_NATIVE_OFF = """
import io, os, sys
from som_lvq_pak_torch.data import io as pio, native_io
from som_lvq_pak_torch.data.streaming import StreamingReader
ds = pio.read_data(sys.argv[1])
pio.write_data(ds, None, fileobj=io.StringIO())
pio.write_data_chunks(iter([ds]), os.devnull)
n = sum(c.n for c in StreamingReader(sys.argv[1], buffer=40).chunks(laps=2))
with open("/proc/self/maps") as f:
    mapped = "libsomvq_io" in f.read()
print(ds.n, n, native_io._load.cache_info().misses, mapped)
"""


def test_native_off_never_loads_the_library():
    """SOMVQ_NATIVE=0: a read, both writes and two laps of chunks in a
    fresh process never build or load the engine."""
    env = dict(os.environ, PYTHONPATH=REPO, SOMVQ_NATIVE="0")
    out = subprocess.run([sys.executable, "-c", _NATIVE_OFF,
                          os.path.join(GOLDEN, "wmask.dat")],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["120", "240", "0", "False"]
