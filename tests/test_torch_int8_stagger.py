"""K14's `stagger` and `int8_win` options in the port (the plain versions,
which the CPU runs) against the JAX package's batch-chunked kernel in
interpret mode, the int8 prologue against the JAX wrapper's, the routing of
both options, and the int8_step_ab tool at a small size.

Tolerances: codebooks within 1e-5 and values within 1e-4 (float32 sums of a
few hundred terms in another order), winners equal except at near-ties (the
two candidates' float64 distances within 1e-5 relative).  Under int8_win the
winners are held against the plain int8 scoring of each package's own rows
(equal except where the two rows' scores differ by less than 1e-6 relative,
the float32 rounding of ||m||^2; values within 1e-5 relative), and the two
packages' winners against each other except where the port's two int8 scores
lie within q1 * sum_k |x'_k|: codebooks equal to 1e-5 may quantize one entry
a step apart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_torch.ops import som_step
from som_lvq_pak_torch.ops.som_step import (CHUNKED_INT8_WIN, CHUNKED_STAGGER,
                                            INT8_WIN_CHUNK,
                                            fused_step_winners_int8, int8_win_inputs,
                                            int8_win_scores, int8_win_staged, k14_rows,
                                            k14_walk_smem_bytes,
                                            som_fused_factored_chunked_step,
                                            som_fused_train_step)
from som_lvq_pak_torch.tools import int8_step_ab

TOL = 1e-5
# shared memory one CTA of an H100 can take (cudaDevAttrMaxSharedMemoryPerBlockOptin)
SMEM_PER_CTA = 232448


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run torch on one CPU thread in this module: the first vectorized
    transcendental torch spreads over several OpenMP threads came back up
    to 1.5e-4 relative off in one thread's share in about 0.5% of processes
    (ROADMAP Queue C), and the gaussian step makes such a call."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad128(a):
    """Lane-pad features to 128 for the JAX kernels only."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(np.pad(a, ((0, 0), (0, -a.shape[1] % 128))))


def assert_winners_agree(x, codes, i_port, i_ref, tol=TOL):
    """Winners equal except where the two rows' float64 distances differ by
    less than `tol` relative."""
    i_port = np.asarray(i_port, np.int64)
    i_ref = np.asarray(i_ref, np.int64)
    bad = np.nonzero(i_port != i_ref)[0]
    if bad.size:
        xb = np.asarray(x, np.float64)[bad]
        c = np.asarray(codes, np.float64)
        da = ((xb - c[i_port[bad]]) ** 2).sum(1)
        db = ((xb - c[i_ref[bad]]) ** 2).sum(1)
        gap = np.abs(da - db) / np.maximum(np.maximum(da, db), 1e-30)
        assert gap.max() < tol, (bad, gap)
    return bad.size


def _port(codes, xb, bmu, xn, xdim, hexa, alpha, radius, gaussian, **kw):
    c = torch.from_numpy(np.array(codes, np.float32))
    out, i, v = som_fused_train_step(
        c, torch.from_numpy(xb), torch.from_numpy(bmu), torch.from_numpy(xn),
        xdim, hexa, torch.as_tensor(alpha), radius, gaussian, **kw)
    assert out.data_ptr() == c.data_ptr()  # updated in place
    return out.numpy(), i.numpy(), v.numpy()


def _jax(codes, xb, bmu, xn, xdim, hexa, alpha, radius, gaussian, **kw):
    jc, ji, jv = jps.som_fused_train_step(
        _pad128(codes), _pad128(xb), jnp.asarray(bmu), _pad128(xn), xdim, hexa,
        jnp.asarray(alpha), radius, gaussian=gaussian, **kw)
    return np.asarray(jc)[:, :codes.shape[1]], np.asarray(ji), np.asarray(jv)


def _scores(codes, rows, xq, q):
    """`int8_win_scores` of `rows` of float32 `codes`, as numpy."""
    return int8_win_scores(torch.from_numpy(np.array(codes, np.float32)),
                           torch.as_tensor(rows), xq, q).numpy()


def assert_own_int8_scoring(codes, xq, q, idx, val):
    """A step's int8_win winners and values against the plain int8 scoring
    of its own updated rows `codes`."""
    i_own, v_own = fused_step_winners_int8(torch.from_numpy(np.array(codes, np.float32)), xq, q)
    i_own, v_own = i_own.numpy(), v_own.numpy()
    bad = np.nonzero(np.asarray(idx) != i_own)[0]
    if bad.size:
        sa = _scores(codes, np.asarray(idx)[bad], xq[bad], q)
        sb = _scores(codes, i_own[bad], xq[bad], q)
        assert (np.abs(sa - sb) / np.maximum(np.abs(sa), np.abs(sb)) < 1e-6).all(), bad
    assert (np.abs(val - v_own) <= 1e-5 * np.abs(v_own) + 1e-6).all(), \
        np.abs(val - v_own).max()


# test_trainer_quality.py:467-474: (xdim, ydim, hexa, gaussian, tile rows,
# batch chunk); the JAX test's d_real only slices the zero padding
GEOMETRIES = [(16, 8, True, True, 2, 128), (16, 8, True, True, 2, 256),
              (16, 8, True, True, 1, 128), (16, 12, False, True, 2, 128),
              (16, 8, True, False, 1, 128), (16, 8, True, False, 2, 128)]


@pytest.mark.parametrize("xdim,ydim,hexa,gaussian,tn_mult,bc", GEOMETRIES)
def test_stagger_matches_jax(xdim, ydim, hexa, gaussian, tn_mult, bc):
    """Plain K14 with stagger=True against `_som_fused_factored_chunked_kernel`
    with stagger=True (B = B' = 256), and bit-equal to the port without it:
    stagger changes the schedule, not the result."""
    rng = np.random.default_rng(xdim * ydim + bc + tn_mult)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    noc = xdim * ydim
    codes, xb, xn = f(noc, 64), f(256, 64), f(256, 64)
    bmu = rng.integers(0, noc, size=256).astype(np.int32)
    kw = dict(tile_n=tn_mult * xdim, factored=True, batch_chunk=bc)
    c, i, v = _port(codes, xb, bmu, xn, xdim, hexa, 0.05, 3.0, gaussian, stagger=True, **kw)
    jc, ji, jv = _jax(codes, xb, bmu, xn, xdim, hexa, 0.05, 3.0, gaussian, stagger=True,
                      **kw)
    np.testing.assert_allclose(c, jc, rtol=TOL, atol=TOL)
    assert_winners_agree(xn, c, i, ji)
    np.testing.assert_allclose(v, jv, rtol=1e-4, atol=1e-4)
    c0, i0, v0 = _port(codes, xb, bmu, xn, xdim, hexa, 0.05, 3.0, gaussian, **kw)
    np.testing.assert_array_equal(c, c0)
    np.testing.assert_array_equal(i, i0)
    np.testing.assert_array_equal(v, v0)


def _clustered():
    """test_trainer_quality.py:357's data: a 16x16 codebook, batches of 256
    around 16 centres at N(0, 4)."""
    rng = np.random.default_rng(3)
    centers = rng.normal(0, 4.0, size=(16, 64)).astype(np.float32)
    pts = lambda n: (centers[rng.integers(0, 16, size=n)]  # noqa: E731
                     + rng.normal(0, 1.0, size=(n, 64))).astype(np.float32)
    codes, xb, xn = pts(256), pts(256), pts(256)
    d = ((xb[:, None, :].astype(np.float64) - codes[None]) ** 2).sum(-1)
    return codes, xb, d.argmin(1).astype(np.int32), xn


def _jax_prologue(codes, xb, bmu, xn, monkeypatch, **kw):
    """The JAX wrapper's int8_win inputs: som_fused_train_step run eagerly
    with pallas_call replaced by a spy that keeps the kernel's arguments and
    stops; returns (xq (B', D) int8, q (2,) float32) as numpy."""
    class Stop(Exception):
        pass

    got = []

    def spy(*_, **__):
        def call(*args):
            got.append(args)
            raise Stop
        return call

    monkeypatch.setattr(jps.pl, "pallas_call", spy)
    with jax.disable_jit(), pytest.raises(Stop):
        _jax(codes, xb, bmu, xn, 16, True, 0.05, 3.0, True, tile_n=32, factored=True,
             batch_chunk=128, int8_win=True, **kw)
    monkeypatch.undo()
    xq, q = np.asarray(got[0][3]), np.asarray(got[0][6])
    assert xq.dtype == np.int8 and not xq[:, 64:].any()
    return xq[:, :64], q.reshape(2)


@pytest.mark.parametrize("batch_bf16", [False, True])
def test_int8_prologue_bit_equal_to_jax(batch_bf16, monkeypatch):
    """`int8_win_inputs` gives the JAX wrapper's quantized x' and its scale
    pair (pallas_som.py:1180-1194) bit for bit, from the bf16-rounded batches
    under batch_bf16."""
    codes, xb, bmu, xn = _clustered()
    xq_j, q_j = _jax_prologue(codes, xb, bmu, xn, monkeypatch, batch_bf16=batch_bf16)
    xq, q = int8_win_inputs(torch.from_numpy(codes), torch.from_numpy(xb),
                            torch.from_numpy(xn), batch_bf16)
    assert xq.dtype == torch.int8 and q.dtype == torch.float32
    np.testing.assert_array_equal(xq.numpy(), xq_j)
    np.testing.assert_array_equal(q.numpy(), q_j)
    # ties at half a step round to even, as jnp.round (sx = 127: one step 1)
    xh = torch.tensor([[1.5, 2.5, -0.5, 127.0]])
    xq_h, _ = int8_win_inputs(torch.zeros((1, 4)), torch.zeros((1, 4)), xh)
    np.testing.assert_array_equal(xq_h.numpy(), [[2, 2, 0, 127]])


INT8_FLAGS = {"f32": dict(gaussian=True), "wxa_bf16": dict(gaussian=True, wxa_bf16=True),
              "batch_bf16": dict(gaussian=True, batch_bf16=True),
              "bubble": dict(gaussian=False)}


@pytest.mark.parametrize("case", list(INT8_FLAGS))
def test_int8_win_matches_jax(case, monkeypatch):
    """Plain K14 with int8_win=True against the JAX kernel on
    test_trainer_quality.py:357's clustered data: codebooks within 1e-5 of
    JAX and bit-equal to the port without int8_win (the quantization touches
    only the winners); each package's winners and values against the plain
    int8 scoring of its own rows; the port's winners against JAX's except
    within one quantization step."""
    flags = dict(INT8_FLAGS[case])
    gaussian = flags.pop("gaussian")
    codes, xb, bmu, xn = _clustered()
    kw = dict(tile_n=32, factored=True, batch_chunk=128, **flags)
    args = (codes, xb, bmu, xn, 16, True, 0.05, 3.0, gaussian)
    c, i, v = _port(*args, int8_win=True, **kw)
    c0, i0, _ = _port(*args, **kw)
    np.testing.assert_array_equal(c, c0)
    jc, ji, jv = _jax(*args, int8_win=True, d_real=64, **kw)
    np.testing.assert_allclose(c, jc, rtol=TOL, atol=TOL)
    xq, q = int8_win_inputs(torch.from_numpy(codes), torch.from_numpy(xb),
                            torch.from_numpy(xn), bool(flags.get("batch_bf16")))
    assert_own_int8_scoring(c, xq, q, i, v)
    assert_own_int8_scoring(jc, xq, q, ji, jv)
    bad = np.nonzero(i != ji)[0]
    if bad.size:
        window = (q[1].double() * xq[bad].double().abs().sum(-1)).numpy()
        s_port = _scores(c, i[bad], xq[bad], q)
        s_jax = _scores(c, ji[bad], xq[bad], q)
        assert (np.abs(s_port - s_jax) <= window).all(), bad
    # most winners are the float32 step's: clustered data, real margins
    assert (i == i0).mean() >= 0.6


@pytest.mark.parametrize("batch_bf16", [False, True])
def test_int8_win_bf16_codebook_quantizes_the_float32_blend(batch_bf16):
    """On a bf16 codebook the int8 rows and ||m||^2 come from the float32
    blend, not the rows rounded for storage (pallas_som.py:1087-1094): the
    port's plain K14 and the JAX kernel give the winners and values of the
    same step on the codebook widened to float32 bit for bit, and that
    step's rows rounded to bf16."""
    codes, xb, bmu, xn = _clustered()
    c16 = torch.from_numpy(codes).to(torch.bfloat16)
    T = torch.from_numpy
    kw = dict(tile_n=32, factored=True, batch_chunk=128, int8_win=True,
              batch_bf16=batch_bf16)
    args = (T(xb), T(bmu), T(xn), 16, True, 0.05, 3.0, True)
    c, i, v = som_fused_train_step(c16.clone(), *args, **kw)
    c32, i32, v32 = som_fused_train_step(c16.float(), *args, **kw)
    assert c.dtype == torch.bfloat16
    np.testing.assert_array_equal(c.float().numpy(), c32.to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(i.numpy(), i32.numpy())
    np.testing.assert_array_equal(v.numpy(), v32.numpy())

    def jax_step(jc):
        out = jps.som_fused_train_step(
            jnp.pad(jc, ((0, 0), (0, 64))), _pad128(xb), jnp.asarray(bmu), _pad128(xn), 16,
            True, jnp.asarray(0.05), 3.0, gaussian=True, d_real=64, **kw)
        return [np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
                for a in out]

    j16 = jnp.asarray(c16.float().numpy()).astype(jnp.bfloat16)
    jc, ji, jv = jax_step(j16)
    jc32, ji32, jv32 = jax_step(j16.astype(jnp.float32))
    np.testing.assert_array_equal(
        jc, np.asarray(jnp.asarray(jc32).astype(jnp.bfloat16).astype(jnp.float32)))
    np.testing.assert_array_equal(ji, ji32)
    np.testing.assert_array_equal(jv, jv32)


def test_options_route_as_the_jax_wrapper():
    """stagger and int8_win take K14 where the separable geometry holds
    (factored None or True), and are ignored with factored=False and on a
    geometry that takes K3, as in the JAX wrapper (pallas_som.py:1320-1349,
    1389-1419); a plain version on the CPU counts no launch."""
    codes, xb, bmu, xn = _clustered()
    T = torch.from_numpy
    args = (T(xb), T(bmu), T(xn), 16, True, 0.05, 3.0, True)
    before = (CHUNKED_INT8_WIN.launches, CHUNKED_STAGGER.launches,
              som_fused_factored_chunked_step.launches)

    def step(c=codes, a=args, **kw):
        return som_fused_train_step(T(c.copy()), *a, tile_n=32, **kw)

    for opt in (dict(stagger=True), dict(int8_win=True),
                dict(stagger=True, int8_win=True)):
        for factored in (None, True):
            got = step(factored=factored, **opt)
            want = som_fused_factored_chunked_step(T(codes.copy()), *args, **opt)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        k3 = step(factored=False)
        for a, b in zip(step(factored=False, **opt), k3):
            np.testing.assert_array_equal(a, b)
    # int8_win moves the winners, stagger nothing
    assert not np.array_equal(step(int8_win=True)[1], step(batch_chunk=128)[1])
    for a, b in zip(step(stagger=True, batch_chunk=128), step(batch_chunk=128)):
        np.testing.assert_array_equal(a, b)
    # a geometry the separable kernels reject (xdim 10) takes K3 and ignores both
    c6 = np.random.default_rng(4).normal(size=(60, 64)).astype(np.float32)
    a6 = (T(xb[:128]), T(bmu[:128] % 60), T(xn[:128]), 10, True, 0.05, 3.0, True)
    want = som_step.som_fused_train_step_plain(T(c6.copy()), *a6)
    for a, b in zip(som_fused_train_step(T(c6.copy()), *a6, stagger=True, int8_win=True),
                    want):
        np.testing.assert_array_equal(a, b)
    assert (CHUNKED_INT8_WIN.launches, CHUNKED_STAGGER.launches,
            som_fused_factored_chunked_step.launches) == before
    # the JAX wrapper ignores both on its plain kernel too
    jc, ji, _ = _jax(codes, xb, bmu, xn, 16, True, 0.05, 3.0, True, tile_n=32,
                     factored=False, stagger=True, int8_win=True)
    c, i, _ = step(factored=False, stagger=True, int8_win=True)
    np.testing.assert_allclose(c, jc, rtol=TOL, atol=TOL)
    assert_winners_agree(xn, c, i, ji)


def test_int8_step_ab_chain_on_cpu():
    """tools.int8_step_ab at 16x16 (B 256, 8 steps, 4096 evaluation
    samples) on the CPU: every record present and finite, the int8 chain's
    qerror within 1% of float32's, the stagger chain bit-equal; the data
    are the JAX tool's (`clustered`)."""
    out = int8_step_ab.run(16, 16, 256, steps=8, n_eval=4096, time_steps=1, rounds=1,
                           device="cpu")
    assert out["device"] == "cpu" and out["stagger_codes_equal"]
    assert out["int8_rel_delta"] <= 0.01
    for name in int8_step_ab.CHAINS:
        for key in ("step_ms", "attainable_pct", "train_s", "qerror"):
            assert np.isfinite(out[f"{name}_{key}"]) and out[f"{name}_{key}"] > 0
    assert out["f32_qerror"] == out["stagger_qerror"]
    rng = np.random.default_rng(7)
    centers = rng.normal(0, 4.0, size=(16, 64)).astype(np.float32)
    r = np.random.default_rng(999)
    want = centers[r.integers(0, 16, size=5)] + r.normal(0, 1.0, size=(5, 64)).astype(np.float32)
    np.testing.assert_array_equal(int8_step_ab.clustered_source()(5, 999), want)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            int8_step_ab.run(16, 16, 256)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_value_identity(seed):
    """The value K14's int8 winners report, d = ||m||^2 - 2 fl(dot q1) (the
    float32 norm, the exact int32 dot scaled by one float32 product), equals
    the JAX form -2 fl(fl(dot q1) - ||m||^2 / 2) in float32: halving and
    doubling are exact, so they commute with rounding.  Over 4096 (dot, q1,
    m2) triples from int8_win_inputs' ranges: the dots of quantized rows and
    samples, and dots drawn up to +-127^2 * 256."""
    rng = np.random.default_rng(seed)
    D = 64
    codes = (rng.normal(0, 4, size=(2048, D)) * rng.uniform(0.1, 3, size=(2048, 1)))
    codes = codes.astype(np.float32)
    xb = rng.normal(0, 4, size=(256, D)).astype(np.float32)
    xn = rng.normal(0, 4, size=(2048, D)).astype(np.float32)
    T = torch.from_numpy
    xq, q = int8_win_inputs(T(codes), T(xb), T(xn))
    rows = torch.clamp(torch.round(T(codes) * q[0]), -127.0, 127.0).to(torch.int64)
    dot = (rows * xq.to(torch.int64)).sum(1).numpy()  # row i against sample i
    dot = np.concatenate([dot, rng.integers(-127 ** 2 * 256, 127 ** 2 * 256, size=2048)])
    m2 = (codes * codes).sum(1, dtype=np.float32)
    m2 = np.concatenate([m2, rng.permutation(m2)])
    q1 = np.float32(q[1].item())
    s = dot.astype(np.float32) * q1  # exact int to float32 (|dot| < 2^24), one rounding
    kernel = m2 - np.float32(2) * s
    jax_form = np.float32(-2) * (s - m2 * np.float32(0.5))
    assert kernel.dtype == jax_form.dtype == np.float32
    np.testing.assert_array_equal(kernel, jax_form)


@pytest.mark.parametrize("D", [5, 37, 64, 130])
def test_int8_win_staged_xq_keeps_winners(D):
    """The wrapper's padded x' (`int8_win_staged`: zeros to D32 features and
    to a multiple of the 64-sample winner chunk, the rows K14's int8 winners
    stage) gives fused_step_winners_int8 the winners and values of the
    unpadded one, bit for bit, on its first B' rows."""
    rng = np.random.default_rng(D)
    T = torch.from_numpy
    codes = T(rng.normal(size=(300, D)).astype(np.float32))
    xb = T(rng.normal(size=(200, D)).astype(np.float32))
    xn = T(rng.normal(size=(200, D)).astype(np.float32))
    xq, q = int8_win_inputs(codes, xb, xn)
    st = int8_win_staged(xq)
    assert st.dtype == torch.int8
    assert st.shape == (-(-200 // INT8_WIN_CHUNK) * INT8_WIN_CHUNK, -(-D // 32) * 32)
    assert torch.equal(st[:200, :D], xq) and not st[200:].any() and not st[:, D:].any()
    i0, v0 = fused_step_winners_int8(codes, xq, q)
    i1, v1 = fused_step_winners_int8(codes, st, q)
    assert torch.equal(i1[:200], i0) and torch.equal(v1[:200], v0)


@pytest.mark.parametrize("int8_win", [False, True])
@pytest.mark.parametrize("batch_bf16", [False, True])
def test_k14_walk_rows_fit(int8_win, batch_bf16):
    """K14's rows per CTA: 64 for the main form past D 128 and int8_win at
    every D, and for stagger up to D 128, 32 above; the walk's shared memory
    (k14_walk_smem_bytes, the C layout's mirror) at those rows fits one CTA
    at every D from 1 to 256 with the most grid rows a CTA can span (xdim >=
    8), and the float32 stagger walk with split batches at 64 rows past D
    128 does not."""
    for D in range(1, 257):
        assert k14_rows(D) == 64
        assert k14_rows(D, stagger=True) == (64 if D <= 128 else 32)
        for stagger in (True, False) if int8_win else (True,):
            rows = k14_rows(D, stagger)
            nbytes = k14_walk_smem_bytes(D, rows, int8_win, batch_bf16, (rows - 1) // 8 + 2)
            assert 0 < nbytes <= SMEM_PER_CTA, (D, rows, stagger, nbytes)
    if not (int8_win or batch_bf16):
        assert k14_walk_smem_bytes(129, 64, False, False, 9) > SMEM_PER_CTA
    # D 64 at 64 rows on a 256-wide map (2 grid rows): the ring's two slots of
    # 2 x 32 x 72 floats, the previous tile 2 x 64 x 68, m2s, the reduction
    # 2 x 4 x 32 and the tables 2 ((64 + 2) 36 + 32) + 64 floats
    if not (int8_win or batch_bf16):
        assert k14_walk_smem_bytes(64, 64, False, False, 2) == 4 * (
            2 * 4608 + 8704 + 64 + 256 + 4880)
