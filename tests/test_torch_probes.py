"""The port's probes of the fused step: K17's plain version
(`ops.skeleton.fused_step_skeleton`) against bench.py's `_skeleton_kernel`
run through its own pallas_call in interpret mode, K15/K16's plain versions
(`ops.winner_probe`) against a NumPy int64 reference and against
tools/int8_probe.py's Pallas kernels (K15's at ragged shapes and
extreme values too), K15's host helpers (the padded copy of m, the
codebook splits, the shared-memory layout), the build's per-source compile
times, the int8_probe tool at a small size, and the wrappers' device and
argument checks.

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
from som_lvq_pak_torch import _build
from som_lvq_pak_torch.ops import winner_probe
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


def _k15_inputs(N, D, B, kind, seed):
    """int8 m (N, D) and x (D, B): "random" in [-127, 127]; "negative" m in
    [1, 127] and x in [-127, -1], so that every maximum is negative (a zero
    code past N would win it); "min" in [-128, 127] with every 7th row of m
    and every 5th column of x at -128."""
    rng = np.random.default_rng(seed)
    if kind == "negative":
        return (rng.integers(1, 128, size=(N, D)).astype(np.int8),
                rng.integers(-127, 0, size=(D, B)).astype(np.int8))
    lo = -128 if kind == "min" else -127
    m = rng.integers(lo, 128, size=(N, D)).astype(np.int8)
    x = rng.integers(lo, 128, size=(D, B)).astype(np.int8)
    if kind == "min":
        m[::7] = -128
        x[:, ::5] = -128
    return m, x


# chip_smoke.py's K15 cases at a CPU's size: the ragged all-negative case,
# the int8 extreme, N below one 256-code tile with B not a multiple of 64,
# D 256 (two chunks of 128 bytes) and D 37 (the padded copy of m)
K15_CASES = [((1000, 64, 999), "negative"), ((1000, 37, 999), "negative"),
             ((1000, 64, 999), "min"), ((200, 64, 100), "random"), ((1, 1, 1), "min"),
             ((300, 256, 257), "random"), ((1000, 37, 999), "random"),
             ((513, 200, 130), "min"), ((260, 512, 70), "random")]


@pytest.mark.parametrize("shape,kind", K15_CASES,
                         ids=[f"{n}x{d}x{b}-{k}" for (n, d, b), k in K15_CASES])
def test_k15_plain_matches_int64(shape, kind):
    """K15's plain version against the NumPy int64 maximum over rows, bit
    for bit, at the kernel's edge cases: every maximum negative, -128
    operands (the products stay exact in int32), ragged N, B and D."""
    m, x = _k15_inputs(*shape, kind, seed=sum(shape))
    got = int8_winner_probe(torch.from_numpy(m), torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (shape[2],)
    want = _int64_max(m, x)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "negative":
        assert (want < 0).all()


@pytest.mark.parametrize("D", [5, 37, 130])
def test_k15_padded_codes_keep_the_maximum(D):
    """`k15_codes` pads m's rows with zeros to a multiple of 16 bytes (TMA's
    global stride); against x padded with zero rows the int64 maximum is the
    original's.  A 16-byte multiple at an aligned address is m itself; a
    view at an unaligned address is copied."""
    m, x = _k15_inputs(300, D, 77, "min", seed=D)
    mp = winner_probe.k15_codes(torch.from_numpy(m))
    Dp = -(-D // 16) * 16
    assert mp.shape == (300, Dp) and mp.dtype == torch.int8
    assert (mp[:, D:] == 0).all()
    xp = np.zeros((Dp, 77), np.int8)
    xp[:D] = x
    np.testing.assert_array_equal(_int64_max(mp.numpy(), xp), _int64_max(m, x))
    aligned = torch.from_numpy(np.zeros((8, 32), np.int8))
    assert winner_probe.k15_codes(aligned) is aligned
    view = torch.zeros(65, 32, dtype=torch.int8)[1:]  # 32 bytes in: aligned
    assert winner_probe.k15_codes(view) is view
    odd = torch.arange(8 * 32 + 1, dtype=torch.int8)[1:].view(8, 32)  # 1 byte in
    assert odd.data_ptr() % 16 != 0
    copy = winner_probe.k15_codes(odd)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, odd)


@pytest.mark.parametrize("sms", [132, 114, 1])
def test_k15_splits_and_shared_memory(monkeypatch, sms):
    """`k15_splits` gives at least one split and at most the 256-code tiles,
    and fills no more than one CTA per SM where there are tiles to spare;
    `k15_layout` fits the shared memory limit at every D up to K15_MAX_D
    with a ring of two to eight slots that holds a whole tile (its chunks
    of D), and raises past it."""
    monkeypatch.setattr(winner_probe, "_sm_count", lambda device: sms)
    for B in (1, 64, 999, 4096, 8192, 65536):
        for N in (1, 255, 256, 1000, 65536):
            s = winner_probe.k15_splits(B, N, "cuda")
            tiles = -(-N // winner_probe.K15_TILE)
            assert 1 <= s <= tiles
            blocks = -(-B // winner_probe.K15_SAMPLES)
            assert blocks * s <= max(sms, blocks)
    assert winner_probe.k15_splits(4096, 65536, "cuda") == max(1, sms // 32)
    for D in range(1, winner_probe.K15_MAX_D + 1):
        lay = winner_probe.k15_layout(D)
        assert lay["bytes"] <= winner_probe.K15_SMEM_MAX, D
        assert max(2, lay["KC"]) <= lay["stages"] <= 8 and lay["KC"] * lay["W"] >= D
    with pytest.raises(ValueError, match="D up to"):
        winner_probe.k15_layout(winner_probe.K15_MAX_D + 1)


def test_build_times_each_nvcc_process(tmp_path):
    """`_build._wait` runs its processes together and returns their output
    and the seconds each ran; `compile_seconds` reads those seconds back
    from a build log; a failed process raises with its output."""
    import sys
    procs = [_build._start([sys.executable, "-c", f"import time; time.sleep({t}); print({t})"],
                           str(tmp_path / f"{j}.log")) for j, t in enumerate((0.3, 0.0))]
    out, seconds = _build._wait(procs)
    assert out.split() == ["0.3", "0.0"]
    assert seconds[0] >= 0.3 and seconds[1] < seconds[0]
    log = "ptxas info\nnvcc seconds winner_probe.cu: 3.5\nnvcc seconds link: 0.7\n"
    assert _build.compile_seconds(log) == {"winner_probe.cu": 3.5, "link": 0.7}
    with pytest.raises(RuntimeError, match="boom"):
        _build._wait([_build._start([sys.executable, "-c", "import sys; print('boom'); "
                                     "sys.exit(3)"], str(tmp_path / "f.log"))])


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


@pytest.mark.parametrize("N,kind", [(600, "negative"), (1000, "random"), (200, "negative")])
def test_k15_plain_matches_kern_on_ragged_rows(monkeypatch, N, kind):
    """K15's plain version against tools/int8_probe.py's `kern` in interpret
    mode at D 64 with N not a multiple of 256.  The TPU tool's grid takes
    whole 256-row tiles, so m's last tile is filled out with copies of its
    last row, which leave every maximum as it is; K15 takes m as it is."""
    kern, _ = _probe_kernels(monkeypatch)
    m, x = _k15_inputs(N, 64, 384, kind, seed=N)
    tiles = -(-N // 256)
    mt = np.concatenate([m, np.repeat(m[-1:], tiles * 256 - N, axis=0)])
    want = np.asarray(pl.pallas_call(
        kern, grid=(tiles,),
        in_specs=[pl.BlockSpec((256, 64), lambda i: (i, 0)),
                  pl.BlockSpec((64, 384), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, 384), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, 384), jnp.int32),
        interpret=True)(jnp.asarray(mt), jnp.asarray(x)))[0]
    np.testing.assert_array_equal(want, _int64_max(m, x))
    np.testing.assert_array_equal(
        int8_winner_probe_plain(torch.from_numpy(m), torch.from_numpy(x)).numpy(), want)


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
