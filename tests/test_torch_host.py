"""The PyTorch port's host side: it imports without JAX, its copies of the
JAX package's host functions are bit-equal to the originals, codebooks
convert both ways, and the kernel wrappers route only CPU tensors to their
plain versions."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.data.dataset import Dataset, Neighborhood, Topology
from som_lvq_pak_tpu.models import common as jcommon
from som_lvq_pak_tpu.models import fast as jfast
from som_lvq_pak_tpu.models import som as jsom
from som_lvq_pak_tpu.utils.rng import CRandom
from som_lvq_pak_torch import _build
from som_lvq_pak_torch.convert import codebook_to_torch, samples_to_torch, to_dataset
from som_lvq_pak_torch.models import common, fast, som
from som_lvq_pak_torch.ops.dist_argmin import (dist_argmin, dist_argmin_masked,
                                               dist_argmin_t)
from som_lvq_pak_torch.ops.som_step import som_fused_train_step
from som_lvq_pak_torch.ops.som_update import (som_neighborhood_update_idx,
                                              som_neighborhood_update_idx_masked)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "som_lvq_pak_torch")

_BLOCK_JAX = """
import sys
class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax is blocked: " + name)
sys.meta_path.insert(0, BlockJax())
import som_lvq_pak_torch
import som_lvq_pak_torch.convert
import som_lvq_pak_torch.models.fast
import som_lvq_pak_torch.models.som
import som_lvq_pak_torch.models.trainer
import som_lvq_pak_torch.ops.dist_argmin
import som_lvq_pak_torch.ops.som_step
import som_lvq_pak_torch.ops.som_update
assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
print("ok")
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _BLOCK_JAX], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    offenders = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    for ln, line in enumerate(fh, 1):
                        s = line.strip()
                        if not s.startswith(("import ", "from ")):
                            continue
                        if (s.startswith(("import jax", "from jax"))
                                or "som_lvq_pak_tpu.models" in s
                                or "som_lvq_pak_tpu.ops" in s
                                or "som_lvq_pak_tpu.parallel" in s):
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
    data = Dataset(points=pts, mask=mask)
    a = som.randinit(data, Topology.HEXA, Neighborhood.GAUSSIAN, 9, 5, CRandom(123))
    b = jsom.randinit(data, Topology.HEXA, Neighborhood.GAUSSIAN, 9, 5, CRandom(123))
    np.testing.assert_array_equal(a.points, b.points)
    assert (a.topol, a.neigh, a.xdim, a.ydim) == (b.topol, b.neigh, b.xdim, b.ydim)


@pytest.mark.parametrize("hexa", [True, False])
def test_grid_building_blocks_match_jax(hexa):
    xdim, ydim = 7, 5
    np.testing.assert_array_equal(fast.unit_coords(xdim, ydim, hexa).numpy(),
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
    ds = Dataset(points=rng.normal(size=(12, 3)).astype(np.float32),
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
                som_neighborhood_update_idx_masked)
    before = [w.launches for w in wrappers]
    dist_argmin(x, c)
    dist_argmin(x, c, mask=mask)
    dist_argmin_t(x, c)
    som_fused_train_step(c.clone(), x, bmu, x, 3, True, 0.1, 2.0)
    som_neighborhood_update_idx(c.clone(), x, bmu, 3, True, 0.1, 2.0)
    som_neighborhood_update_idx(c.clone(), x, bmu, 3, True, 0.1, 2.0, mask=mask)
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
        som_fused_train_step(cm, xm, bm, xm, 3, True, 0.1, 2.0)
    with pytest.raises(ValueError, match="device"):
        som_neighborhood_update_idx(cm, xm, bm, 3, True, 0.1, 2.0)
    with pytest.raises(ValueError, match="device"):
        som_neighborhood_update_idx(cm, xm, bm, 3, True, 0.1, 2.0,
                                    mask=mask.to("meta"))


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
    ds = Dataset(points=pts, mask=mask, weight=weight, fixed=fixed)
    x, m, w, f = samples_to_torch(ds, "cpu", xdim=5, use_weights=True, use_fixed=True)
    assert (x.dtype, m.dtype, w.dtype, f.dtype) == (
        torch.float32, torch.uint8, torch.float32, torch.int32)
    np.testing.assert_array_equal(x.numpy(), pts)
    np.testing.assert_array_equal(m.numpy(), mask)
    np.testing.assert_array_equal(w.numpy(), weight)
    np.testing.assert_array_equal(f.numpy(), [-1, 7, 0, -1, 14, -1])
    _, m, w, f = samples_to_torch(ds, "cpu", xdim=5)
    assert w is None and f is None and m is not None
    assert samples_to_torch(Dataset(points=pts), "cpu")[1] is None


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc means no kernels: the build raises, it never falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert _build.sources() and all(os.path.isfile(s) for s in _build.sources())
