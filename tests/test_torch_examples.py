"""The port's examples (`som_lvq_pak_torch.examples.large_som`,
`.streaming_som`) with `device="cpu"` (the plain PyTorch versions) beside
the JAX package's examples/ on the same arguments, and the port's
`utils.progress.trace`.

Tolerances: each point of large_som's qerror curve within 5% of the JAX
example's (the Dataset-fit tolerance of tests/test_torch_trainer.py: the
two packages shuffle a Dataset with different generators); the streamed
example's qerror pair within 2% (the stream-fit tolerance there: both
packages see the same chunks in the same order); `generate_file` byte for
byte."""

import glob
import inspect
import json
import os

import numpy as np
import pytest
import torch

from examples import large_som as jlarge
from examples import streaming_som as jstream
from som_lvq_pak_torch.examples import large_som, streaming_som
from som_lvq_pak_torch.utils.progress import trace

# tests/test_trainer_quality.py:116-130's size
LARGE = dict(n=1500, dim=32, side=12, batch=256, rlen=20000, sammon_sub=128)
STREAM = dict(n=4096, dim=16, side=8, batch=256, buffer=1024, laps=1)


def test_synthetic_data_equal_jax():
    assert np.array_equal(large_som.synthetic_data(700, 9), jlarge.synthetic_data(700, 9))


def test_run_large_som_matches_jax():
    mine = large_som.run_large_som(**LARGE, device="cpu")
    ref = jlarge.run_large_som(**LARGE)
    assert set(mine) == set(ref)
    large_som.check_summary(mine)
    jlarge.check_summary(mine)
    for key in ("n", "dim", "map", "rlen_per_phase", "sammon_requested"):
        assert mine[key] == ref[key], key
    assert mine["map"] == [12, 12]
    for q, q_ref in zip(mine["qerror_curve"], ref["qerror_curve"]):
        assert abs(q - q_ref) <= 0.05 * q_ref, (mine["qerror_curve"], ref["qerror_curve"])
    # the random-init point: the same codebook and data, one fast qerror each
    assert abs(mine["qerror_curve"][0] - ref["qerror_curve"][0]) <= 1e-4 * ref["qerror_curve"][0]


def test_check_summary_rejects_what_the_jax_one_rejects():
    good = dict(qerror_curve=[10.0, 7.0, 6.0], sammon_points=40, sammon_requested=128)
    large_som.check_summary(good)
    for bad in (dict(good, qerror_curve=[10.0, 9.0, 8.0]),
                dict(good, qerror_curve=[10.0, 11.0, 10.5]),
                dict(good, sammon_points=31)):
        with pytest.raises(AssertionError):
            jlarge.check_summary(bad)
        with pytest.raises(AssertionError):
            large_som.check_summary(bad)


def test_generate_file_writes_the_jax_bytes(tmp_path):
    mine, ref = str(tmp_path / "p.dat"), str(tmp_path / "j.dat")
    assert streaming_som.generate_file(mine, 1234, 7, chunk=500) >= 0
    jstream.generate_file(ref, 1234, 7, chunk=500)
    with open(mine, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_run_streaming_som_matches_jax(tmp_path):
    """Both packages stream one file that each package's generate_file
    wrote (the same bytes) through their trainer: qerror before and after
    within 2% of the JAX example's, and training lowers it."""
    path, jpath = str(tmp_path / "s.dat"), str(tmp_path / "js.dat")
    mine = streaming_som.run_streaming_som(path, **STREAM, device="cpu")
    ref = jstream.run_streaming_som(jpath, **STREAM)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    assert set(mine) == set(ref)
    for key in ("n", "dim", "map", "rlen", "file_mb"):
        assert mine[key] == ref[key], key
    assert mine["gen_wall_s"] >= 0 and mine["samples_per_s"] > 0
    for q, q_ref in zip(mine["qerror_subsample"], ref["qerror_subsample"]):
        assert abs(q - q_ref) <= 0.02 * q_ref, (mine["qerror_subsample"],
                                                ref["qerror_subsample"])
    assert mine["qerror_subsample"][1] < mine["qerror_subsample"][0]
    # a second run finds the file and does not write it again
    again = streaming_som.run_streaming_som(path, **STREAM, device="cpu")
    assert again["gen_wall_s"] == 0.0


@pytest.mark.parametrize("module,argv", [
    (large_som, ["--n", "2000", "--dim", "16", "--map", "16", "--batch", "256",
                 "--sammon-sub", "64"]),
    (streaming_som, ["--n", "2000", "--dim", "16", "--map", "16", "--batch", "256",
                     "--buffer", "500"]),
])
def test_main_prints_the_summary(module, argv, tmp_path, capsys):
    if module is streaming_som:
        argv = argv + ["--file", str(tmp_path / "s.dat")]
    assert module.main(argv + ["--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["map"] == [16, 16]


def test_examples_default_to_the_gpu(tmp_path):
    """The entry points run on "cuda" unless asked for the CPU; without a
    GPU they raise and never fall back."""
    for fn in (large_som.run_large_som, streaming_som.run_streaming_som):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        large_som.run_large_som(300, 4, 4, 32, sammon_sub=8)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        streaming_som.run_streaming_som(str(tmp_path / "s.dat"), 300, 4, 4, 32, buffer=100)


def test_trace_without_a_directory_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with trace(None):
        x = torch.ones(8, 8)
        y = x @ x
    assert float(y.sum()) == 512.0
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace(tmp_path):
    """trace(dir) exports one Chrome trace of the region into dir, with the
    region's operations in it."""
    from som_lvq_pak_torch.data.dataset import Dataset, Neighborhood, Topology
    from som_lvq_pak_torch.models.som import randinit
    from som_lvq_pak_torch.models.trainer import SOMTrainer
    from som_lvq_pak_torch.utils.rng import CRandom

    X = large_som.synthetic_data(512, 8)
    codes = randinit(Dataset(X), Topology.HEXA, Neighborhood.GAUSSIAN, 6, 6, CRandom(1))
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        SOMTrainer(codes, batch_size=64, device="cpu").fit(Dataset(X), rlen=512,
                                                           alpha=0.05, radius=3.0)
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert any(str(n).startswith("aten::") for n in names)
