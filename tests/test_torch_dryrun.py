"""som_lvq_pak_torch/dryrun.py, the counterpart of __graft_entry__.py, on the
CPU.

`dryrun_multichip(n, device="cpu")` runs every sharded path in gloo worlds
of 4 (data 2 x model 2) and 8 (2 x 4) processes and raises on any failed
check: the JAX dryrun's sections in its order, at its tolerances
(tests/test_mesh16.py runs the JAX one at 16 and 32 virtual devices in one
process; the port's ranks are processes, so it runs at 4 and 8 here).
`entry(device="cpu")`'s step against the JAX package's `som_batch_step` on
the same NumPy inputs, to 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_torch import dryrun
from som_lvq_pak_tpu.models.fast import som_batch_step, unit_coords


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run torch on one CPU thread in this module, as the port's other
    test modules do (see tests/test_torch_trainer.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,layout", [(4, (2, 2)), (8, (2, 4))])
def test_dryrun_multichip(n, layout, capsys):
    ranks = dryrun.dryrun_multichip(n, device="cpu", timeout_s=120.0)
    assert len(ranks) == n
    for r in ranks:
        assert (r["data"], r["model"], r["backend"], r["device"]) == layout + ("gloo", "cpu")
        assert r["q_end"] < r["q_start"]
        assert not any(r["launches"].values())  # the CPU runs the plain versions
    out = capsys.readouterr().out
    assert out.startswith(f"dryrun_multichip OK (gloo, cpu): mesh data={layout[0]} "
                          f"x model={layout[1]};") and "all executed" in out


def test_entry_matches_jax():
    fn, args = dryrun.entry(device="cpu")
    codes, xb, alpha, radius = args
    before = codes.clone()
    got = fn(*args)
    assert torch.equal(codes, before)  # the step leaves its inputs as they are
    ref = som_batch_step(jnp.asarray(codes.numpy()), jnp.asarray(xb.numpy()),
                         unit_coords(32, 16, hexa=True), jnp.float32(alpha),
                         jnp.float32(radius), gaussian=False, update="sum",
                         use_pallas=False, xdim=32, hexa=True)
    assert got.shape == (512, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
