"""The numeric design of K12 (the mixed mesh step's blend and winners) and
K10 (the sharded lvq2.1/lvq3 top-k) on the tensor cores, on the CPU (the
kernels run only on a card): `ops.tf32x3`'s emulations of their routes
against the JAX package's kernels in interpret mode and the port's plain
versions.

K12 runs K3's blend-and-winner half: its emulation (`som_blend_winner_tf32x3`)
is the guarded blend, then K3's emulation's winners (distance form, scores
through `tf32x3_mm`), so K11's emulation then K12's is K3's emulation bit for
bit (codebook, winners, values), at unit offset 0 and on a model shard.  It
is held to the JAX `som_blend_winner` at tests/test_torch_mesh.py's
tolerances (the blended shard to 1e-5, values to 1e-4, winners equal; with
every row twice, the first copy of each tied pair) and to the plain K12
(winners equal except where the two rows' float64 distances differ by less
than 1e-5 relative).  K10 runs K1's walk with a top-k fold, and K8 is its
kernel at k = 2: its emulation (`dist_topk_tf32x3`) scores as K1's, so its
column 0 is `dist_argmin_tf32x3`'s bit for bit, and K8's
(`dist_top2_tf32x3`) is its first two columns; held to the JAX `dist_topk` at tests/test_torch_mesh_lvq.py's
tolerances (values to 1e-5, indices equal on exact ties, every code twice)
and to the plain K10 with every code two or three times (each index
exactly, neighbours as a code and its copies)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.ops import pallas_distance as jpd
from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_torch.ops.dist_topk import dist_topk_plain
from som_lvq_pak_torch.ops.som_blend import som_blend_winner_plain
from som_lvq_pak_torch.ops.tf32x3 import (dist_argmin_tf32x3, dist_top2_tf32x3,
                                          dist_topk_tf32x3,
                                          som_blend_winner_tf32x3,
                                          som_fused_train_step_tf32x3,
                                          som_neighborhood_accumulate_tf32x3)

TOL = 1e-5
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread, as tests/test_torch_tf32x3.py runs the gaussian
    step (a first-parallel-transcendental fault of torch on the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_gap(x, codes, i_got, i_want, rel=TOL):
    """Winners equal except where the two rows' float64 distances differ by
    less than `rel` relative."""
    i_got, i_want = np.asarray(i_got, np.int64), np.asarray(i_want, np.int64)
    bad = np.nonzero(i_got != i_want)[0]
    if bad.size:
        x64 = np.asarray(x, np.float64)[bad]
        c64 = np.asarray(codes, np.float64)
        da = ((x64 - c64[i_got[bad]]) ** 2).sum(-1)
        db = ((x64 - c64[i_want[bad]]) ** 2).sum(-1)
        gap = np.abs(da - db) / np.maximum(np.maximum(da, db), 1e-30)
        assert gap.max() < rel, (bad, gap)


def bits(t):
    return t.numpy().view(np.int32)


# -- K12 ------------------------------------------------------------------

def _blend_case(n_local, D, Bn, dup, seed):
    """A shard, its summed accumulators (wsum in [0, 2): both sides of the
    guard) and a next batch; with `dup` every row and its accumulators twice
    (the same blend for both copies)."""
    rng = np.random.default_rng(seed)
    rows = n_local // 2 if dup else n_local
    codes = rng.normal(size=(rows, D)).astype(np.float32)
    wsum = rng.uniform(0, 2, size=(rows, 1)).astype(np.float32)
    acc = (wsum * rng.normal(size=(rows, D))).astype(np.float32)
    if dup:
        codes, acc, wsum = (np.concatenate([a, a]) for a in (codes, acc, wsum))
    xn = rng.normal(size=(Bn, D)).astype(np.float32)
    return codes, acc, wsum, xn


def _blend_tf32x3(codes, acc, wsum, xn):
    c = T(codes.copy())
    out = som_blend_winner_tf32x3(c, T(acc), T(wsum), T(xn))
    np.testing.assert_array_equal(c.numpy(), codes)  # the input is not changed
    assert [t.dtype for t in out] == [torch.float32, torch.float32, torch.int32]
    return out


@pytest.mark.parametrize("dup", [False, True])
def test_blend_winner_tf32x3_matches_jax(dup):
    """tests/test_torch_mesh.py's K12 case (a 32-row shard at D 128, B' 64)
    against the JAX `som_blend_winner` in interpret mode: the blended shard
    to 1e-5, values to 1e-4, winners equal; with every row twice the JAX
    kernel and the emulation both pick the first copy."""
    D = 128
    codes, acc, wsum, xn = _blend_case(32, D, 64, dup, seed=40 + dup)
    c, val, idx = _blend_tf32x3(codes, acc, wsum, xn)
    jc, jv, ji = jps.som_blend_winner(jnp.asarray(codes), jnp.asarray(acc),
                                      jnp.asarray(wsum), jnp.asarray(xn), tile_n=16,
                                      d_real=D, interpret=True)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(val.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    if dup:
        assert int(idx.max()) < 16


@pytest.mark.parametrize("n_local,D,Bn,dup", [(300, 5, 257, False),
                                              (129, 37, 100, False),
                                              (256, 64, 200, False),
                                              (50, 130, 70, False),
                                              (70, 200, 33, False),
                                              (128, 64, 150, True),
                                              (96, 37, 64, True)])
def test_blend_winner_tf32x3_matches_plain(n_local, D, Bn, dup):
    """Against the plain K12 at D 5, ragged D 37, D 64, D 130 and D 200, any
    n_local and B': the blended rows to 1e-5 (bit-equal: one blend formula),
    values to 1e-4, winners equal except at near-ties; with every row twice
    the first copy wins and the plain version picks the same row."""
    codes, acc, wsum, xn = _blend_case(n_local, D, Bn, dup, seed=n_local + D + Bn)
    c, val, idx = _blend_tf32x3(codes, acc, wsum, xn)
    pc, pv, pi = som_blend_winner_plain(T(codes.copy()), T(acc), T(wsum), T(xn))
    np.testing.assert_array_equal(bits(c), bits(pc))
    np.testing.assert_allclose(val.numpy(), pv.numpy(), rtol=1e-4, atol=1e-4)
    assert_gap(xn, c.numpy(), idx.numpy(), pi.numpy())
    if dup:
        assert int(idx.max()) < n_local // 2
        np.testing.assert_array_equal(idx.numpy(), pi.numpy())


SHARD_CASES = [(hexa, gaussian, per_sample, offset)
               for hexa in (True, False)
               for gaussian in (True, False)
               for per_sample in (False, True)
               for offset in (0, 64)]


@pytest.mark.parametrize("hexa,gaussian,per_sample,offset", SHARD_CASES)
def test_accumulate_then_blend_is_fused_step(hexa, gaussian, per_sample, offset):
    """K11's emulation then K12's on the rows offset .. offset + 63 of a
    16 x 8 map equal K3's emulation with that unit offset bit for bit: the
    codebook, the winners and their values.  B 100 (three whole 32-sample
    chunks and a partial one) at D 37, a few samples without a BMU."""
    xdim, noc, n_local, B, D = 16, 128, 64, 100, 37
    rng = np.random.default_rng(50 + 8 * hexa + 4 * gaussian + 2 * per_sample + offset)
    codes = rng.normal(size=(n_local, D)).astype(np.float32)
    xb = rng.normal(size=(B, D)).astype(np.float32)
    xn = rng.normal(size=(B, D)).astype(np.float32)
    bmu = rng.integers(0, noc, size=B).astype(np.int32)
    bmu[:5] = -1
    alpha = (T(rng.uniform(0.01, 0.08, size=B).astype(np.float32)) if per_sample
             else 0.05)
    acc, wsum = som_neighborhood_accumulate_tf32x3(T(xb), T(bmu), n_local, xdim, hexa,
                                                   alpha, 3.0, gaussian,
                                                   unit_offset=offset)
    c12, v12, i12 = _blend_tf32x3(codes, acc.numpy(), wsum.numpy(), xn)
    c3, i3, v3 = som_fused_train_step_tf32x3(T(codes), T(xb), T(bmu), T(xn), xdim, hexa,
                                             alpha, 3.0, gaussian, unit_offset=offset)
    np.testing.assert_array_equal(bits(c12), bits(c3))
    np.testing.assert_array_equal(i12.numpy(), i3.numpy())
    np.testing.assert_array_equal(bits(v12), bits(v3))
    assert not np.allclose(c12.numpy(), codes, atol=1e-3)  # the step did something


# -- K10 ------------------------------------------------------------------

def _topk_case(B, N, D, copies, seed):
    """x (B, D) and codes (N, D); with copies > 1 every code `copies` times
    (N // copies rows, stacked)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D)).astype(np.float32)
    if copies > 1:
        base = rng.normal(size=(N // copies, D)).astype(np.float32)
        codes = np.concatenate([base] * copies)
    else:
        codes = rng.normal(size=(N, D)).astype(np.float32)
    return x, codes


def _topk_tf32x3(x, codes, k):
    val, idx = dist_topk_tf32x3(T(x), T(codes), k)
    assert val.shape == (x.shape[0], k) and idx.shape == (x.shape[0], k)
    assert val.dtype == torch.float32 and idx.dtype == torch.int32
    assert (val[:, 1:] >= val[:, :-1]).all()  # ascending
    return val, idx


def _assert_copies(idx, N, copies):
    """Every code `copies` times: the neighbours come as a code (a first
    copy) and then its copies, in order."""
    n = N // copies
    i = idx.numpy().astype(np.int64)
    whole = i.shape[1] // copies * copies
    for c in range(whole):
        first = i[:, c - c % copies]
        assert (first < n).all()
        np.testing.assert_array_equal(i[:, c], first + n * (c % copies))


@pytest.mark.parametrize("k", [1, 2, 5, 16])
def test_dist_topk_tf32x3_matches_jax(k):
    """tests/test_torch_mesh_lvq.py's K10 case: every code twice (20 codes
    at D 8, 48 samples) against the JAX `dist_topk` in interpret mode:
    indices equal (the copies lowest index first), values to 1e-5."""
    x, codes = _topk_case(48, 40, 8, 2, seed=30 + k)
    val, idx = _topk_tf32x3(x, codes, k)
    jval, jidx = jpd.dist_topk(jnp.asarray(x), jnp.asarray(codes), k, tile_b=16,
                               tile_n=128, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=TOL, atol=TOL)
    _assert_copies(idx, 40, 2)


@pytest.mark.parametrize("k", [2, 7, 16])
def test_dist_topk_tf32x3_matches_jax_distinct(k):
    """Distinct codes (N 300 not a multiple of the JAX tile, D 37) against
    the JAX `dist_topk`: each column's winners equal except at near-ties,
    values to 1e-5."""
    x, codes = _topk_case(70, 300, 37, 1, seed=60 + k)
    val, idx = _topk_tf32x3(x, codes, k)
    jval, jidx = jpd.dist_topk(jnp.asarray(x), jnp.asarray(codes), k, tile_b=16,
                               tile_n=128, interpret=True)
    for c in range(k):
        assert_gap(x, codes, idx.numpy()[:, c], np.asarray(jidx)[:, c])
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,N,D,k,copies", [(300, 999, 5, 4, 1), (256, 777, 37, 8, 1),
                                            (128, 1000, 64, 2, 1), (100, 301, 130, 16, 1),
                                            (90, 17, 5, 16, 1), (300, 998, 5, 6, 2),
                                            (129, 999, 64, 9, 3), (70, 300, 130, 5, 2)])
def test_dist_topk_tf32x3_matches_plain(B, N, D, k, copies):
    """Against the plain K10 at D 5, ragged D 37, D 64 and D 130 (K10's
    64-feature slabs), N = 17 at k = 16, and every code two or three times:
    there every index equals the plain version's, a code and then its
    copies; values to 1e-5."""
    x, codes = _topk_case(B, N, D, copies, seed=5 * B + N + D + k)
    val, idx = _topk_tf32x3(x, codes, k)
    pv, pi = dist_topk_plain(T(x), T(codes), k)
    for c in range(k):
        assert_gap(x, codes, idx.numpy()[:, c], pi.numpy()[:, c])
    np.testing.assert_allclose(val.numpy(), pv.numpy(), rtol=TOL, atol=TOL)
    if copies > 1:
        np.testing.assert_array_equal(idx.numpy(), pi.numpy())
        _assert_copies(idx, N, copies)


@pytest.mark.parametrize("B,N,D,copies", [(37, 53, 5, 1), (70, 600, 37, 1),
                                          (200, 130, 64, 1), (90, 300, 130, 1),
                                          (70, 99, 5, 3), (129, 130, 37, 2),
                                          (20, 2, 5, 1)])
def test_dist_topk_tf32x3_k2_is_top2(B, N, D, copies):
    """At k = 2 the columns are `dist_top2_tf32x3`'s pairs bit for bit (K8
    is K10's kernel at k = 2: its wrapper splits the (B, 2) columns into
    (d1, i1, d2, i2)), at tests/test_torch_tc_top2_vmem.py's K8 shapes,
    exact ties and N = 2 included."""
    x, codes = _topk_case(B, N, D, copies, seed=B * N + D)
    val, idx = _topk_tf32x3(x, codes, 2)
    d1, i1, d2, i2 = dist_top2_tf32x3(T(x), T(codes))
    np.testing.assert_array_equal(idx.numpy()[:, 0], i1.numpy())
    np.testing.assert_array_equal(idx.numpy()[:, 1], i2.numpy())
    np.testing.assert_array_equal(bits(val[:, 0].contiguous()), bits(d1))
    np.testing.assert_array_equal(bits(val[:, 1].contiguous()), bits(d2))


@pytest.mark.parametrize("k", [1, 3, 8, 16])
@pytest.mark.parametrize("copies", [1, 2, 3])
def test_dist_topk_tf32x3_column0_is_k1(k, copies):
    """At every k column 0 is `dist_argmin_tf32x3`'s (value, index) bit for
    bit, after the same ||x||^2 add and clamp; with every code two or three
    times the lowest copy."""
    x, codes = _topk_case(150, 96, 37, copies, seed=70 + 4 * k + copies)
    val, idx = _topk_tf32x3(x, codes, k)
    v, i = dist_argmin_tf32x3(T(x), T(codes))
    np.testing.assert_array_equal(idx.numpy()[:, 0], i.numpy())
    np.testing.assert_array_equal(bits(val[:, 0].contiguous()), bits(v))
    if copies > 1:
        assert int(idx[:, 0].max()) < 96 // copies


# -- the SASS comparison the shared body's changes are checked with --------

_DUMP = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_121som_fused_step_kernelILi8EfEEvPT0_iiPKfPKiS4_iiiiifiPy
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;   /* 0x0000000c0804723c */
\t\tFunction : _ZN12_GLOBAL__N_116som_accum_kernelILi8EEEviiPKfPKiS2_iiiiifiPfS5_
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
"""


def test_sass_diff_compares_instruction_text():
    """tools.sass_diff keeps each instruction's text (no address, no
    encoding) per function, and compares the functions both dumps hold."""
    from som_lvq_pak_torch.tools import sass_diff

    a = sass_diff.parse(_DUMP)
    k3 = "_ZN_GLOBAL__N_21som_fused_step_kernelILi8EfEEvPT0_iiPKfPKiS4_iiiiifiPy"
    assert a[k3] == ["LDC R1, c[0x0][0x28]", "HMMA.1688.F32.TF32 R4, R8, R12, R4"]
    moved = sass_diff.parse(_DUMP.replace("/*0010*/", "/*0020*/").replace(
        "0x0000000c0804723c", "0x0000000c0804723d"))
    assert sass_diff.compare(a, moved)["all_equal"]
    b = sass_diff.parse(_DUMP.replace("R12, R4", "R16, R4"))
    got = sass_diff.compare(a, b, ("som_fused_step_kernel",))
    assert not got["all_equal"] and list(got["functions"]) == [k3]
    assert got["functions"][k3] == dict(a=2, b=2, equal=False)
    del b[k3]
    assert sass_diff.compare(a, b)["only_a"] == [k3]


def test_sass_diff_names_one_kernel_alike_in_two_checkouts():
    """The anonymous namespace's mangling carries a hash of the file's path:
    two checkouts' builds name one kernel alike once it is written as
    `_GLOBAL__N_`, and the rest of the name is kept."""
    from som_lvq_pak_torch.tools import sass_diff

    a = ("_ZN45_GLOBAL__N__25811785_12_dist_top2_cu_96c563cc16dist_top2_kernel"
         "ILi8EEEvPKfS2_iiiiPfPi")
    b = ("_ZN45_GLOBAL__N__fcdee0fc_12_dist_top2_cu_96c563cc16dist_top2_kernel"
         "ILi8EEEvPKfS2_iiiiPfPi")
    want = "_ZN_GLOBAL__N_16dist_top2_kernelILi8EEEvPKfS2_iiiiPfPi"
    assert sass_diff.unanonymize(a) == sass_diff.unanonymize(b) == want
    assert sass_diff.unanonymize(want) == want
    dump = _DUMP.replace("12_GLOBAL__N_1", "45_GLOBAL__N__25811785_12_dist_top2_cu_96c563cc")
    assert sorted(sass_diff.parse(dump)) == sorted(sass_diff.parse(_DUMP))
