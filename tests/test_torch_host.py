"""The PyTorch port's host side: it imports nothing of JAX or of the JAX
package, its copies of the JAX package's host modules and functions are
bit-equal to the originals, codebooks and data sets convert both ways, the
entry points default to the GPU, and the kernel wrappers route only CPU
tensors to their plain versions."""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from som_lvq_pak_tpu import config as jconfig
from som_lvq_pak_tpu.data import io as jio
from som_lvq_pak_tpu.data.dataset import Dataset, Neighborhood, Topology
from som_lvq_pak_tpu.data.labels import LabelTable as JLabelTable
from som_lvq_pak_tpu.data.streaming import StreamingReader as JStreamingReader
from som_lvq_pak_tpu.models import common as jcommon
from som_lvq_pak_tpu.models import fast as jfast
from som_lvq_pak_tpu.models import som as jsom
from som_lvq_pak_tpu.utils import checkpoint as jcheckpoint
from som_lvq_pak_tpu.utils.rng import CRandom as JCRandom
from som_lvq_pak_torch import _build, config
from som_lvq_pak_torch.convert import (as_port_dataset, codebook_to_torch,
                                       labeled_samples_to_torch, lvq_codebook_to_torch,
                                       samples_to_torch, to_dataset)
from som_lvq_pak_torch.data import io
from som_lvq_pak_torch.data.dataset import Dataset as PDataset
from som_lvq_pak_torch.data.labels import GLOBAL_LABELS, LabelTable
from som_lvq_pak_torch.data.streaming import StreamingReader
from som_lvq_pak_torch.models import common, fast, som
from som_lvq_pak_torch.models import eval as peval
from som_lvq_pak_torch.models.trainer import LVQTrainer, OLVQ1Trainer, SOMTrainer
from som_lvq_pak_torch.utils import checkpoint
from som_lvq_pak_torch.utils.rng import CRandom
from som_lvq_pak_torch.ops.dist_argmin import (dist_argmin, dist_argmin_masked,
                                               dist_argmin_t)
from som_lvq_pak_torch.ops.dist_top2 import dist_top2, dist_top2_masked
from som_lvq_pak_torch.ops.som_step import som_fused_train_step
from som_lvq_pak_torch.ops.som_update import (som_neighborhood_update_idx,
                                              som_neighborhood_update_idx_masked)
from som_lvq_pak_torch.ops.som_vmem import som_vmem_train_steps
from som_lvq_pak_torch.tools import fused_step_ab, int8_probe, int8_step_ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "som_lvq_pak_torch")
GOLDEN = os.path.join(REPO, "tests", "golden")

_BLOCKED_IMPORT = """
import pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "som_lvq_pak_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import som_lvq_pak_torch
mods = [m.name for m in pkgutil.walk_packages(som_lvq_pak_torch.__path__,
                                              "som_lvq_pak_torch.")]
for m in mods:
    __import__(m)
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "som_lvq_pak_tpu")]
assert {"som_lvq_pak_torch.tools.int8_probe", "som_lvq_pak_torch.tools.int8_step_ab",
        "som_lvq_pak_torch.ops.winner_probe", "som_lvq_pak_torch.ops.skeleton",
        "som_lvq_pak_torch.ops.exact", "som_lvq_pak_torch.ops.neighborhood",
        "som_lvq_pak_torch.models.lvq", "som_lvq_pak_torch.models.tools",
        "som_lvq_pak_torch.models.eval", "som_lvq_pak_torch.ops.distance",
        "som_lvq_pak_torch.ops.dist_topk", "som_lvq_pak_torch.data.io",
        "som_lvq_pak_torch.cli", "som_lvq_pak_torch.cli.cmds_lvq",
        "som_lvq_pak_torch.cli.cmds_som", "som_lvq_pak_torch.cli.cmds_viz",
        "som_lvq_pak_torch.cli.lvq_run", "som_lvq_pak_torch.cli.common",
        "som_lvq_pak_torch.cli.params", "som_lvq_pak_torch.cli.usage",
        "som_lvq_pak_torch.viz.eps", "som_lvq_pak_torch.viz.planes",
        "som_lvq_pak_torch.viz.umat_ps", "som_lvq_pak_torch.models.umatrix",
        "som_lvq_pak_torch.models.sammon", "som_lvq_pak_torch.utils.snapshot",
        "som_lvq_pak_torch.data.native_io", "som_lvq_pak_torch.examples.large_som",
        "som_lvq_pak_torch.examples.streaming_som"} <= set(mods)
from som_lvq_pak_torch.models import eval, lvq, tools
from som_lvq_pak_torch.ops import distance
from som_lvq_pak_torch.data import io
assert all(callable(f) for f in (lvq.balance, lvq.lvq3_train, tools.setlabel, tools.vcal,
                                 eval.knn_accuracy, eval.confusion_matrix, eval.mcnemar,
                                 distance.chunked_topk, distance.auto_pairwise_topk,
                                 io.write_data_chunks, io.read_alpha_file))
from som_lvq_pak_torch import cli
from som_lvq_pak_torch.models import sammon, umatrix
from som_lvq_pak_torch.utils import snapshot
assert len(cli.tool_names()) == 31 and callable(sammon.sammon_fast)
assert callable(umatrix.calc_umatrix) and callable(snapshot.read_snapshots)
from som_lvq_pak_torch.data import native_io
from som_lvq_pak_torch.examples import large_som, streaming_som
from som_lvq_pak_torch.utils.progress import trace
assert native_io.available() and callable(trace)
assert callable(large_som.run_large_som) and callable(streaming_som.run_streaming_som)
print(len(mods))
"""

# the CLI's driver as `python -m som_lvq_pak_torch.cli help` runs it, with
# jax and the JAX package blocked
_BLOCKED_CLI = """
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "som_lvq_pak_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.argv = ["-m", "help"]
runpy.run_module("som_lvq_pak_torch.cli", run_name="__main__", alter_sys=True)
"""


def test_port_imports_without_jax():
    """Every module of the port, the tools/ subpackage's included, imports
    with jax and the JAX package both blocked: the LVQ pipeline's modules
    (models.lvq, models.tools, the kNN front end, the .lra files), the
    CLI's (cli/, viz/, models.umatrix, models.sammon, utils.snapshot), the
    native engine's binding (which builds and loads) and the examples
    too."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module was walked


def test_port_cli_runs_without_jax():
    """`python -m som_lvq_pak_torch.cli help` with jax and the JAX package
    blocked: exit 0 and the tool list (the 31 tools and lvq_run)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_CLI], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stderr.startswith("usage: somvq <tool>")
    assert "\n  vsom\n" in out.stderr and out.stderr.endswith("  lvq_run\n")


def test_port_sources_never_import_jax():
    """No source of the port (nor chip_smoke.py) has an import line naming
    jax or the JAX package."""
    offenders = []
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            for ln, line in enumerate(fh, 1):
                s = line.strip()
                if not s.startswith(("import ", "from ")):
                    continue
                if (s.startswith(("import jax", "from jax"))
                        or "som_lvq_pak_tpu" in s):
                    offenders.append(f"{path}:{ln}: {s}")
    assert not offenders, offenders


@pytest.mark.parametrize("kind", ["linear", "inverse_t"])
@pytest.mark.parametrize("length", [1, 7, 1000, 100_003])
def test_schedules_bit_equal(kind, length):
    a = common.alpha_schedule(length, 0.05, kind)
    np.testing.assert_array_equal(a, jcommon.alpha_schedule(length, 0.05, kind))
    assert a.dtype == np.float32
    r = common.radius_schedule(length, 32.0)
    np.testing.assert_array_equal(r, jcommon.radius_schedule(length, 32.0))


@pytest.mark.parametrize("masked", [False, True])
def test_randinit_bit_equal(masked):
    rng = np.random.default_rng(5)
    pts = (rng.normal(size=(300, 7)) * 3).astype(np.float32)
    mask = None
    if masked:
        mask = (rng.random((300, 7)) < 0.2).astype(np.uint8)
        mask[:, 4] = 1  # a component masked everywhere initialises to 0
        pts = np.where(mask != 0, 0.0, pts).astype(np.float32)
    a = som.randinit(PDataset(points=pts, mask=mask), Topology.HEXA,
                     Neighborhood.GAUSSIAN, 9, 5, CRandom(123))
    b = jsom.randinit(Dataset(points=pts, mask=mask), Topology.HEXA,
                      Neighborhood.GAUSSIAN, 9, 5, JCRandom(123))
    np.testing.assert_array_equal(a.points, b.points)
    assert (a.topol, a.neigh, a.xdim, a.ydim) == (b.topol, b.neigh, b.xdim, b.ydim)


@pytest.mark.parametrize("hexa", [True, False])
def test_grid_building_blocks_match_jax(hexa):
    xdim, ydim = 7, 5
    np.testing.assert_array_equal(fast.unit_coords(xdim, ydim, hexa, "cpu").numpy(),
                                  np.asarray(jfast.unit_coords(xdim, ydim, hexa)))
    bmu = np.array([0, 3, 6, 7, 18, 34, 20], np.int32)
    np.testing.assert_array_equal(
        fast.grid_sq_dists_idx(torch.from_numpy(bmu), xdim * ydim, xdim, hexa).numpy(),
        np.asarray(jfast.grid_sq_dists_idx(bmu, xdim * ydim, xdim, hexa)))
    rng = np.random.default_rng(1)
    c = rng.normal(size=(35, 4)).astype(np.float32)
    wx = rng.normal(size=(35, 4)).astype(np.float32)
    wsum = np.abs(rng.normal(size=(35, 1))).astype(np.float32) * 2
    wsum[:3] = 0.0
    np.testing.assert_allclose(
        fast.guarded_sum_update(*map(torch.from_numpy, (c, wx, wsum))).numpy(),
        np.asarray(jfast._guarded_sum_update(c, wx, wsum)), rtol=1e-6, atol=1e-6)


def test_codebook_conversion_round_trip():
    rng = np.random.default_rng(2)
    ds = PDataset(points=rng.normal(size=(12, 3)).astype(np.float32),
                  labels=np.arange(12, dtype=np.int32), topol=Topology.RECT,
                  neigh=Neighborhood.BUBBLE, xdim=4, ydim=3, comments=["# c"])
    host = ds.points.copy()
    codes, meta = codebook_to_torch(ds, "cpu")
    assert codes.dtype == torch.float32 and codes.shape == (12, 3)
    np.testing.assert_array_equal(codes.numpy(), host)
    codes.add_(1.0)  # a copy: the host Dataset is untouched
    np.testing.assert_array_equal(ds.points, host)
    back = to_dataset(codebook_to_torch(ds, "cpu")[0], meta)
    np.testing.assert_array_equal(back.points, ds.points)
    np.testing.assert_array_equal(back.labels, ds.labels)
    assert (back.topol, back.neigh, back.xdim, back.ydim, back.comments) == \
        (ds.topol, ds.neigh, ds.xdim, ds.ydim, ds.comments)
    with pytest.raises(ValueError):
        to_dataset(torch.zeros((12, 4)), meta)


def test_wrappers_route_cpu_to_plain_and_reject_other_devices():
    x = torch.randn(10, 3)
    c = torch.randn(6, 3)
    mask = torch.zeros(10, 3, dtype=torch.uint8)
    mask[2, 1] = 1
    bmu = torch.zeros(10, dtype=torch.int32)
    wrappers = (dist_argmin, dist_argmin_masked, dist_argmin_t,
                som_fused_train_step, som_neighborhood_update_idx,
                som_neighborhood_update_idx_masked, som_vmem_train_steps,
                dist_top2, dist_top2_masked)
    before = [w.launches for w in wrappers]
    dist_argmin(x, c)
    dist_argmin(x, c, mask=mask)
    dist_argmin_t(x, c)
    dist_top2(x, c)
    dist_top2(x, c, mask=mask)
    som_fused_train_step(c.clone(), x, bmu, x, 3, True, 0.1, 2.0)
    som_neighborhood_update_idx(c.clone(), x, bmu, 3, True, 0.1, 2.0)
    som_neighborhood_update_idx(c.clone(), x, bmu, 3, True, 0.1, 2.0, mask=mask)
    som_vmem_train_steps(c.clone(), x[None], bmu, [0.1], [2.0], 3, True)
    # plain versions are not kernel launches
    assert [w.launches for w in wrappers] == before
    xm, cm = x.to("meta"), c.to("meta")
    bm = bmu.to("meta")
    with pytest.raises(ValueError, match="device"):
        dist_argmin(xm, cm)
    with pytest.raises(ValueError, match="device"):
        dist_argmin(xm, cm, mask=mask.to("meta"))
    with pytest.raises(ValueError, match="device"):
        dist_argmin_t(xm, cm)
    with pytest.raises(ValueError, match="device"):
        dist_top2(xm, cm)
    with pytest.raises(ValueError, match="device"):
        dist_top2(xm, cm, mask=mask.to("meta"))
    with pytest.raises(ValueError, match="device"):
        som_fused_train_step(cm, xm, bm, xm, 3, True, 0.1, 2.0)
    with pytest.raises(ValueError, match="device"):
        som_neighborhood_update_idx(cm, xm, bm, 3, True, 0.1, 2.0)
    with pytest.raises(ValueError, match="device"):
        som_neighborhood_update_idx(cm, xm, bm, 3, True, 0.1, 2.0,
                                    mask=mask.to("meta"))
    with pytest.raises(ValueError, match="device"):
        som_vmem_train_steps(cm, xm[None], bm, torch.full((1,), 0.1, device="meta"),
                             torch.full((1,), 2.0, device="meta"), 3, True)


def test_samples_to_torch_carries_mask_weight_fixed():
    """Masks as uint8, weights as float32, fixed= points flattened to int32
    unit indices as the JAX trainer's fixed_flat does; each None where the
    data set has none or the caller leaves it out."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(6, 4)).astype(np.float32)
    mask = np.zeros((6, 4), np.uint8)
    mask[1, 2] = 1
    weight = np.array([0, 2, 0.5, 0, 1, 3], np.float32)
    fixed = np.array([[-1, -1], [2, 1], [0, 0], [-1, 3], [4, 2], [-1, -1]], np.int32)
    ds = PDataset(points=pts, mask=mask, weight=weight, fixed=fixed)
    x, m, w, f = samples_to_torch(ds, "cpu", xdim=5, use_weights=True, use_fixed=True)
    assert (x.dtype, m.dtype, w.dtype, f.dtype) == (
        torch.float32, torch.uint8, torch.float32, torch.int32)
    np.testing.assert_array_equal(x.numpy(), pts)
    np.testing.assert_array_equal(m.numpy(), mask)
    np.testing.assert_array_equal(w.numpy(), weight)
    np.testing.assert_array_equal(f.numpy(), [-1, 7, 0, -1, 14, -1])
    _, m, w, f = samples_to_torch(ds, "cpu", xdim=5)
    assert w is None and f is None and m is not None
    assert samples_to_torch(PDataset(points=pts), "cpu")[1] is None


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc means no kernels: the build raises, it never falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert _build.sources() and all(os.path.isfile(s) for s in _build.sources())


# -- the port's copies of the JAX package's host modules ---------------------

def _fields_equal(a, b):
    for f in ("points", "mask", "labels", "weight", "fixed"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert (int(a.topol), int(a.neigh), a.xdim, a.ydim, a.comments) == \
        (int(b.topol), int(b.neigh), b.xdim, b.ydim, b.comments)


@pytest.mark.parametrize("name", ["classify.dat", "fix.dat", "wmask.dat",
                                  "lvq_o.cod", "som_1.cod", "wmask_r.cod"])
def test_read_write_data_equal_to_jax(name, tmp_path):
    """The port's read_data and write_data give the JAX package's arrays and
    bytes on the golden files (labels, masks, weight= and fixed= tokens,
    lvq and map headers)."""
    path = os.path.join(GOLDEN, name)
    pt, jt = LabelTable(), JLabelTable()
    mine, ref = io.read_data(path, labels=pt), jio.read_data(path, labels=jt)
    _fields_equal(mine, ref)
    io.write_data(mine, str(tmp_path / "port"), labels=pt, comments="# c")
    jio.write_data(ref, str(tmp_path / "jax"), labels=jt, comments="# c")
    with open(tmp_path / "port", "rb") as a, open(tmp_path / "jax", "rb") as b:
        assert a.read() == b.read()


def test_streaming_reader_chunks_equal_to_jax():
    path = os.path.join(GOLDEN, "wmask.dat")
    pt, jt = LabelTable(), JLabelTable()
    mine = list(StreamingReader(path, buffer=37, labels=pt).chunks(laps=2))
    ref = list(JStreamingReader(path, buffer=37, labels=jt).chunks(laps=2))
    assert len(mine) == len(ref) > 2
    for a, b in zip(mine, ref):
        _fields_equal(a, b)


@pytest.mark.parametrize("seed", [1, 123, 2 ** 31 - 1, -5])
def test_crandom_streams_equal_to_jax(seed):
    a, b = CRandom(seed), JCRandom(seed)
    np.testing.assert_array_equal(a.orand_array(1000), b.orand_array(1000))
    np.testing.assert_array_equal(a.shuffle_order(257), b.shuffle_order(257))
    assert [a.orand() for _ in range(5)] == [b.orand() for _ in range(5)]
    assert a.uniform() == b.uniform() and a.state == b.state


def test_config_equal_to_jax():
    for name in ("DEFAULT_MASKED_VALUE", "SEPARATOR_CHARS", "DEFAULT_COMPRESS_COMMAND",
                 "DEFAULT_UNCOMPRESS_COMMAND", "INV_ALPHA_CONSTANT"):
        assert getattr(config, name) == getattr(jconfig, name)
    for fn in ("masked_string", "compress_command", "uncompress_command"):
        assert getattr(config, fn)() == getattr(jconfig, fn)()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_read_across_packages(writer, tmp_path):
    """A checkpoint either package writes, the other reads field for field."""
    rng = np.random.default_rng(6)
    kw = dict(codes=rng.normal(size=(12, 5)).astype(np.float32), step=17,
              alphas=rng.random(12).astype(np.float32), rng_state=123456789,
              prng_key=np.array([0, 42], np.uint32), extra={"alpha": 0.05})
    w, r = (checkpoint, jcheckpoint) if writer == "port" else (jcheckpoint, checkpoint)
    ck = w.Checkpointer(str(tmp_path), background=True)
    ck.save(w.TrainState(**kw))
    ck.wait()
    st = r.Checkpointer(str(tmp_path)).load()
    assert r.Checkpointer(str(tmp_path)).steps() == [17]
    for k, v in kw.items():
        got = getattr(st, k)
        if isinstance(v, np.ndarray):
            assert got.dtype == v.dtype
            np.testing.assert_array_equal(got, v)
        else:
            assert got == v


def test_as_port_dataset_carries_labels_by_name():
    """Labels cross as strings and are interned again in the port's table,
    whatever ids they had in the JAX package's table."""
    jt = JLabelTable()
    for lab in ("zero", "one", "two"):
        jt.to_index(lab)
    ids = np.array([[3, 1], [2, 0], [0, 0], [3, 3]], np.int32)
    src = Dataset(points=np.arange(8, dtype=np.float32).reshape(4, 2), labels=ids,
                  mask=np.array([[0, 1], [0, 0], [0, 0], [0, 0]], np.uint8),
                  weight=np.array([0, 2, 1, 0], np.float32),
                  fixed=np.array([[-1, -1], [1, 2], [0, 0], [-1, -1]], np.int32),
                  topol=Topology.HEXA, neigh=Neighborhood.GAUSSIAN, xdim=2, ydim=2,
                  comments=["# c"])
    pt = LabelTable()
    pt.to_index("two")  # the port's table has its own ids
    out = as_port_dataset(src, labels=pt, source_labels=jt)
    assert type(out) is PDataset and type(out.topol) is not type(src.topol)
    names = [[pt.to_label(int(i)) for i in row] for row in out.labels]
    assert names == [["two", "zero"], ["one", None], [None, None], ["two", "two"]]
    assert out.labels[0, 0] == 1  # "two" kept its port id
    _fields_equal(out, PDataset(points=src.points, mask=src.mask, labels=out.labels,
                                weight=src.weight, fixed=src.fixed, topol=Topology.HEXA,
                                neigh=Neighborhood.GAUSSIAN, xdim=2, ydim=2,
                                comments=["# c"]))
    out.points[0, 0] = 99.0  # copied, not shared
    assert src.points[0, 0] == 0.0
    with pytest.raises(ValueError, match="source_labels"):
        as_port_dataset(src)
    GLOBAL_LABELS.reset()
    plain = as_port_dataset(Dataset(points=src.points))
    assert plain.labels is None and plain.mask is None


@pytest.mark.parametrize("case", [c for c in fused_step_ab.CASES if c[0] * c[1] <= 256],
                         ids=lambda c: f"{c[0]}x{c[1]}_D{c[5]}")
def test_fused_step_ab_digests_repeat_on_the_cpu(case):
    """The K3/K13/K14 A/B tool on the CPU (the plain versions): every kernel
    of the case is timed and digested, and a second run on the same seed
    gives the same digests, so equal digests across trees mean equal
    floats."""
    one, two = (fused_step_ab.run_case(*case, dev=torch.device("cpu"), iters=1)
                for _ in range(2))
    names = [n for n, _ in fused_step_ab.kernels(case[4], case[-1])]
    assert names[0] == "k3" and ("k13" in names) == case[-1]
    assert ("k14" in names) == ("k14_bf16" in names) == (case[-1] and case[4] % 128 == 0)
    assert sorted(k[:-len("_digest")] for k in one if k.endswith("_digest")) == sorted(names)
    for name in names:
        assert len(one[f"{name}_digest"]) == 64 and one[f"{name}_ms"] > 0
        assert one[f"{name}_digest"] == two[f"{name}_digest"]


def test_entry_points_default_to_the_gpu():
    """SOMTrainer, LVQTrainer, OLVQ1Trainer, find_qerror, find_qerror2,
    som_train, vfind_trials, som_train_fast, accuracy, classify,
    codebook_to_torch, samples_to_torch, the LVQ conversions, unit_coords
    and the tools' functions run on "cuda" unless the caller asks for the
    CPU; without a GPU they raise and never fall back.  The models default
    to their fast paths (the JAX package's to parity); the parity paths
    need no device."""
    for fn in (som.find_qerror, som.find_qerror2, som.som_train):
        assert inspect.signature(fn).parameters["mode"].default == "fast"
    for fn in (peval.accuracy, peval.classify):
        assert inspect.signature(fn).parameters["parity"].default is False
    for fn in (codebook_to_torch, samples_to_torch, fast.unit_coords,
               som.find_qerror, som.find_qerror2, som.som_train, som.vfind_trials,
               som.vfind_codebooks, fast.som_train_fast,
               SOMTrainer.__init__, LVQTrainer.__init__,
               OLVQ1Trainer.__init__, peval.accuracy, peval.classify,
               labeled_samples_to_torch, lvq_codebook_to_torch,
               int8_probe.run, int8_probe.library_rates, int8_probe.winner_rates,
               int8_step_ab.run, fused_step_ab.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    X = np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32)
    data = PDataset(points=X)
    init = som.randinit(data, Topology.HEXA, Neighborhood.GAUSSIAN, 4, 3, CRandom(1))
    labels = (np.arange(64) % 2 + 1).astype(np.int32)
    ldata = PDataset(points=X, labels=labels)
    lcodes = PDataset(points=X[:6], labels=labels[:6], topol=Topology.LVQ)
    for tr in (SOMTrainer(init), LVQTrainer(lcodes), OLVQ1Trainer(lcodes)):
        assert tr.device.type == "cuda"
    if torch.cuda.is_available():
        return
    for call in (lambda: codebook_to_torch(init), lambda: samples_to_torch(data),
                 lambda: fast.unit_coords(4, 3, True), lambda: som.find_qerror(init, data),
                 lambda: SOMTrainer(init, batch_size=16).fit(data, rlen=64, alpha=0.05,
                                                             radius=2.0),
                 lambda: LVQTrainer(lcodes, "lvq3", batch_size=16).fit(ldata, rlen=64,
                                                                      alpha=0.05),
                 lambda: OLVQ1Trainer(lcodes, batch_size=16).fit(ldata, rlen=64),
                 lambda: peval.accuracy(ldata, lcodes), lambda: peval.classify(ldata, lcodes),
                 lambda: labeled_samples_to_torch(ldata), lambda: lvq_codebook_to_torch(lcodes),
                 lambda: int8_probe.library_rates(64), lambda: int8_probe.winner_rates(64, 8, 64),
                 lambda: int8_step_ab.run(16, 16, 256),
                 lambda: som.find_qerror2(init, data, 1.0),
                 lambda: som.som_train(init, data, 16, 0.05, 2.0),
                 lambda: fast.som_train_fast(init, data, 64, 0.05, 2.0, batch_size=16),
                 lambda: som.vfind_trials(data, data, 2, Topology.HEXA,
                                          Neighborhood.GAUSSIAN, 4, 3, [(64, 0.05, 2.0)])):
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call()
    assert som.find_qerror(init, data, device="cpu") > 0
    assert peval.accuracy(ldata, lcodes, device="cpu")[0] > 0
    # the parity paths run on the host whatever `device` says
    assert som.find_qerror(init, data, mode="parity") > 0
    assert som.find_qerror2(init, data, 1.0, mode="parity") > 0
    assert som.som_train(init, data, 16, 0.05, 2.0, mode="parity").points.shape == (12, 3)
    assert peval.accuracy(ldata, lcodes, parity=True)[0] > 0


@pytest.mark.parametrize("world", ["no GPU", "gloo", "nccl"])
def test_make_mesh_defaults_to_the_gpu_in_a_world_started_by_hand(world, monkeypatch,
                                                                  tmp_path):
    """A one-rank world started with init_process_group, not
    initialize_distributed (as under torchrun): make_mesh() puts the mesh
    on the card of the backend rule (cuda:0 under gloo, cuda:LOCAL_RANK
    under NCCL) and raises without a GPU; it is on the CPU only when the
    caller passes device="cpu"."""
    import torch.distributed as dist

    from som_lvq_pak_torch.parallel import mesh as pmesh
    monkeypatch.setattr(pmesh, "_device", None)
    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "rdv"),
                            world_size=1, rank=0)
    try:
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_available", lambda: world != "no GPU")
            if world == "nccl":
                m.setattr(dist, "get_backend", lambda *a, **k: "nccl")
                m.setenv("LOCAL_RANK", "3")
            if world == "no GPU":
                with pytest.raises(RuntimeError, match="no GPU"):
                    pmesh.make_mesh()
            else:
                mesh = pmesh.make_mesh()
                assert mesh.device == torch.device("cuda", 3 if world == "nccl" else 0)
                assert mesh.shape == {"data": 1, "model": 1}
            assert pmesh.make_mesh(device="cpu").device == torch.device("cpu")
    finally:
        dist.destroy_process_group()
