"""The port's probes of the fused step: K17's plain version
(`ops.skeleton.fused_step_skeleton`) against bench.py's `_skeleton_kernel`
run through its own pallas_call in interpret mode, K15/K16's plain versions
(`ops.winner_probe`) against a NumPy int64 reference and against
tools/int8_probe.py's Pallas kernels, the int8_probe tool at a small size,
and the wrappers' device and argument checks.

tools/int8_probe.py's kernels `kern` and `kern32` are closures inside its
`main`: a test takes them from a spy on pallas_call while `main` runs with
its 4096^3 matmul inputs cut to 8x8, then runs them in interpret mode at a
small shape.  The int64 reference and the kernels are exact, as both the
int8 dot and the float32 sums of integer values below 2^24 are, so the plain
versions must equal them bit for bit.  The skeleton's vmax sums 64 float32
products in another order than the Pallas kernel: within 1e-5 relative."""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import bench
from som_lvq_pak_torch.ops.skeleton import fused_step_skeleton, fused_step_skeleton_plain
from som_lvq_pak_torch.ops.winner_probe import (f32_winner_probe, f32_winner_probe_plain,
                                                int8_winner_probe, int8_winner_probe_plain)
from som_lvq_pak_torch.tools import int8_probe

WRAPPERS = (int8_winner_probe, f32_winner_probe, fused_step_skeleton)


def _bench_skeleton(codes, w, x, tile_n, batch_chunk, d_real):
    """bench.py:_skeleton_kernel through prep_skeleton's pallas_call
    (bench.py:556-581), in interpret mode: codes (N, DP), w (tile_n, B),
    x (B, DP) as both X and X'."""
    N, DP = codes.shape
    B = x.shape[0]
    return pl.pallas_call(
        functools.partial(bench._skeleton_kernel, tile_n=tile_n,
                          batch_chunk=batch_chunk, d_real=d_real),
        grid=(N // tile_n,),
        in_specs=[pl.BlockSpec((tile_n, B), lambda i: (0, 0)),
                  pl.BlockSpec((B, DP), lambda i: (0, 0)),
                  pl.BlockSpec((B, DP), lambda i: (0, 0)),
                  pl.BlockSpec((tile_n, DP), lambda i: (i, 0))],
        out_specs=[pl.BlockSpec((tile_n, DP), lambda i: (i, 0)),
                   pl.BlockSpec((1, B), lambda i: (0, 0))],
        out_shape=[jax.ShapeDtypeStruct((N, DP), jnp.float32),
                   jax.ShapeDtypeStruct((1, B), jnp.float32)],
        interpret=True,
    )(w, x, x, codes)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_skeleton_plain_matches_bench_kernel(bf16):
    """K17's plain version against bench.py's skeleton at a small shape
    (four 256-row tiles, B 512 in chunks of 256, D 64 inside 128 lanes):
    W uniform * 0.001 and X normal as prep_skeleton makes them, bf16 W and X
    for the bf16 twin.  At the bench's scale 1e-30 the rows come back as
    the codes; vmax within 1e-5 relative."""
    N, T, B, D, DP = 1024, 256, 512, 64, 128
    rng = np.random.default_rng(5 + bf16)
    codes = rng.normal(size=(N, D)).astype(np.float32)
    w = (rng.uniform(size=(T, B)) * 0.001).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    pad = lambda a: np.pad(a, ((0, 0), (0, DP - D)))  # noqa: E731
    j_out, j_vmax = _bench_skeleton(jnp.asarray(pad(codes)), jnp.asarray(w).astype(jdt),
                                    jnp.asarray(pad(x)).astype(jdt), T, 256, D)
    tdt = torch.bfloat16 if bf16 else torch.float32
    tx = torch.from_numpy(x).to(tdt)
    out, vmax = fused_step_skeleton(torch.from_numpy(codes), torch.from_numpy(w).to(tdt),
                                    tx, tx)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out)[:, :D])
    np.testing.assert_allclose(vmax.numpy(), np.asarray(j_vmax)[0], rtol=1e-5, atol=0)


def test_skeleton_plain_accumulates_one_w_block_per_tile():
    """At scale 1 the accumulation shows: row u gets codes[u] + W[u % T].X
    (one W block for every tile, bench.py:561), and vmax is the maximum of
    the rows' products with x', the rows rounded to x''s type first; against
    float64 NumPy, within 1e-5."""
    rng = np.random.default_rng(9)
    N, T, B, D = 96, 32, 70, 5
    codes = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.uniform(size=(T, B)).astype(np.float32)
    x = rng.normal(size=(B, D)).astype(np.float32)
    xn = rng.normal(size=(33, D)).astype(np.float32)
    out, vmax = fused_step_skeleton_plain(*map(torch.from_numpy, (codes, w, x, xn)), 1.0)
    want = codes + (w.astype(np.float64) @ x)[np.arange(N) % T]
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vmax.numpy(), (want @ xn.T).max(0), rtol=1e-5, atol=1e-5)
    # bf16: out rounded to bf16 before the product with bf16 x'
    b = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    _, v16 = fused_step_skeleton_plain(torch.from_numpy(codes), b(w), b(x), b(xn), 1.0)
    o16 = torch.from_numpy(codes) + (b(w).float() @ b(x).float())[torch.arange(N) % T]
    want16 = (o16.to(torch.bfloat16).double() @ b(xn).double().T).amax(0)
    np.testing.assert_allclose(v16.numpy(), want16.numpy(), rtol=1e-5, atol=1e-5)


def _int64_max(m, x):
    return (np.asarray(m, np.int64) @ np.asarray(x, np.int64)).max(0)


@pytest.mark.parametrize("shape,dup", [((999, 5, 1000), False), ((300, 64, 257), False),
                                       ((1000, 5, 999), True)])
def test_probe_plain_versions_match_int64(shape, dup):
    """K15's plain version (int8) and K16's (float32 on the same integer
    values) against the NumPy int64 maximum over rows, bit for bit; with
    every row twice too."""
    N, D, B = shape
    rng = np.random.default_rng(N + D)
    m = rng.integers(-127, 128, size=(N // 2 if dup else N, D)).astype(np.int8)
    if dup:
        m = np.concatenate([m, m])
    x = rng.integers(-127, 128, size=(D, B)).astype(np.int8)
    want = _int64_max(m, x)
    got8 = int8_winner_probe(torch.from_numpy(m), torch.from_numpy(x))
    assert got8.dtype == torch.int32
    np.testing.assert_array_equal(got8.numpy(), want)
    got32 = f32_winner_probe(torch.from_numpy(m).float(), torch.from_numpy(x).float())
    assert got32.dtype == torch.float32
    np.testing.assert_array_equal(got32.numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(int8_winner_probe_plain(torch.from_numpy(m),
                                                          torch.from_numpy(x)).numpy(), want)
    np.testing.assert_array_equal(
        f32_winner_probe_plain(torch.from_numpy(m).float(), torch.from_numpy(x).float()).numpy(),
        want.astype(np.float32))


def _probe_kernels(monkeypatch):
    """tools/int8_probe.py's `kern` and `kern32`, captured by a spy on
    pallas_call that keeps each kernel and returns zeros of its output while
    the tool's `main` runs (its jax.config updates skipped, its 4096 x 4096
    matmul inputs cut to 8 x 8)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "int8_probe.py"
    spec = importlib.util.spec_from_file_location("jax_int8_probe", path)
    tool = importlib.util.module_from_spec(spec)
    got = []

    def spy(kernel, **kw):
        got.append(kernel)
        shape = kw["out_shape"]
        return lambda *args: jnp.zeros(shape.shape, shape.dtype)

    def small(fn):
        return lambda k, shape, *a, **kw: fn(k, (8, 8) if shape == (4096, 4096) else shape,
                                             *a, **kw)

    with monkeypatch.context() as mp:
        mp.setattr(jax.config, "update", lambda *_: None)
        spec.loader.exec_module(tool)
        mp.setattr(jax.random, "normal", small(jax.random.normal))
        mp.setattr(jax.random, "randint", small(jax.random.randint))
        mp.setattr(pl, "pallas_call", spy)
        tool.main()
    assert [k.__name__ for k in got] == ["kern", "kern32"]
    return got


def test_probe_plain_versions_match_int8_probe_kernels(monkeypatch):
    """K15's plain version against tools/int8_probe.py's `kern` and K16's
    against `kern32`, both in interpret mode on its grid (one 256-row tile
    per step, the (1, B) maximum carried across steps), bit for bit: three
    tiles of 64-wide int8 rows against B 384, with every row twice."""
    kern, kern32 = _probe_kernels(monkeypatch)
    rng = np.random.default_rng(13)
    half = rng.integers(-127, 128, size=(384, 64)).astype(np.int8)
    m = np.concatenate([half, half])
    x = rng.integers(-127, 128, size=(64, 384)).astype(np.int8)

    def run(kernel, m, x, out):
        return np.asarray(pl.pallas_call(
            kernel, grid=(m.shape[0] // 256,),
            in_specs=[pl.BlockSpec((256, 64), lambda i: (i, 0)),
                      pl.BlockSpec((64, 384), lambda i: (0, 0))],
            out_specs=pl.BlockSpec((1, 384), lambda i: (0, 0)),
            out_shape=jax.ShapeDtypeStruct((1, 384), out),
            interpret=True)(jnp.asarray(m), jnp.asarray(x)))[0]

    want8 = run(kern, m, x, jnp.int32)
    want32 = run(kern32, m.astype(np.float32), x.astype(np.float32), jnp.float32)
    np.testing.assert_array_equal(want8, _int64_max(m, x))
    np.testing.assert_array_equal(
        int8_winner_probe_plain(torch.from_numpy(m), torch.from_numpy(x)).numpy(), want8)
    np.testing.assert_array_equal(
        f32_winner_probe_plain(torch.from_numpy(m).float(), torch.from_numpy(x).float()).numpy(),
        want32)


def test_int8_probe_on_cpu():
    """tools.int8_probe at a small size on the CPU: every rate present and
    positive, K15 and K16 agreeing (the tool raises otherwise)."""
    out = int8_probe.run(n=64, rows=999, dim=5, batch=1000, device="cpu", iters=1)
    assert out["device"] == "cpu" and out["shape"] == [999, 5, 1000]
    for key in ("bf16_mm_tflops", "int8_mm_tops", "int8_winner_tops", "f32_winner_tflops",
                "int8_speedup", "int8_over_bf16"):
        assert np.isfinite(out[key]) and out[key] > 0, key
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            int8_probe.run()


def test_wrappers_route_cpu_to_plain_and_check_arguments():
    """CPU tensors take the plain versions and count no launch; another
    device, a mismatched type or shape raises."""
    before = [w.launches for w in WRAPPERS]
    m = torch.randint(-127, 128, (40, 8), dtype=torch.int8)
    x = torch.randint(-127, 128, (8, 30), dtype=torch.int8)
    int8_winner_probe(m, x)
    f32_winner_probe(m.float(), x.float())
    c, w, xb = torch.randn(64, 8), torch.rand(32, 30), torch.randn(30, 8)
    fused_step_skeleton(c, w, xb, xb)
    assert [w.launches for w in WRAPPERS] == before
    with pytest.raises(ValueError, match="device"):
        int8_winner_probe(m.to("meta"), x.to("meta"))
    with pytest.raises(ValueError, match="device"):
        f32_winner_probe(m.float().to("meta"), x.float().to("meta"))
    with pytest.raises(ValueError, match="device"):
        fused_step_skeleton(c.to("meta"), w.to("meta"), xb.to("meta"), xb.to("meta"))
    with pytest.raises(TypeError):
        int8_winner_probe(m.float(), x.float())
    with pytest.raises(TypeError):
        f32_winner_probe(m, x)
    with pytest.raises(TypeError):
        fused_step_skeleton(c, w.to(torch.bfloat16), xb, xb)
    with pytest.raises(ValueError, match="shape"):
        fused_step_skeleton(c, w[:, :29], xb, xb)
    with pytest.raises(ValueError):
        int8_winner_probe(m, x[:7])
