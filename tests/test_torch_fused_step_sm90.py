"""K3's and K17's Hopper walk (csrc/fused_step_sm90.cuh) on the CPU, where
only its layout and arithmetic can be held (the kernels run only on a card):

* the prologue's plain version (`ops.tf32x3.split_sm90_plain`): its planes
  are `tf32_split` of the batches, the update batch transposed, bit for bit,
  and the mma.sync steps' split planes (`split_batches_plain`) transposed, with
  zeros past D and past each batch; K17's positions are the k index its
  mma.sync walk gives each sample; K3's per-sample table is the closed form's
  BMU grid x, BMU row and alpha;
* the route by shape: K3 and K17 on the walk for D <= 128, on the mma.sync
  kernels past it;
* the plain K3 (`som_fused_train_step_tf32x3`) against
  pallas_som.py:_som_fused_step_kernel in interpret mode and the plain K17
  (`fused_step_skeleton_tf32x3`) against bench.py:_skeleton_kernel, at small
  maps and D 5, 37 and 64, at the gates of tests/test_torch_tf32x3.py (K3:
  codebooks within 1e-4, values (1e-4, 1e-3), winners to a 1e-5 gap) and
  tests/test_torch_skeleton.py (K17: out within 1e-5, vmax within 1e-5
  relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_torch.ops.skeleton import k17_route
from som_lvq_pak_torch.ops.som_step import (PASS_D, SM90_MAX_D, k3_route, sm90_scratch,
                                            sm90_width, split_width)
from som_lvq_pak_torch.ops.tf32x3 import (fused_step_skeleton_tf32x3,
                                          som_fused_train_step_tf32x3, sm90_positions,
                                          split_batches_plain, split_sm90_plain, tf32_split)
from test_torch_skeleton import _skeleton_inputs
from test_torch_probes import _bench_skeleton
from test_torch_tf32x3 import _assert_k3_gates, _pad128, _step_inputs

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch CPU thread, as tests/test_torch_tf32x3.py runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unpack(flat, B, Bn, DP, planes, table):
    """split_sm90_plain's scratch as (xT planes (DP, Bp), xn planes (Bnp, DP),
    table (Bp, 4) or None)."""
    Bp, Bnp = -(-B // 64) * 64, -(-Bn // 64) * 64
    o, xt, xr = 0, [], []
    for _ in range(planes):
        xt.append(flat[o:o + DP * Bp].reshape(DP, Bp))
        o += DP * Bp
    for _ in range(planes):
        xr.append(flat[o:o + Bnp * DP].reshape(Bnp, DP))
        o += Bnp * DP
    tab = flat[o:o + 4 * Bp].reshape(Bp, 4) if table else None
    assert flat.numel() == o + (4 * Bp if table else 0)
    return xt, xr, tab


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("B,Bn,D", [(100, 77, 5), (256, 256, 64), (1000, 999, 37),
                                    (33, 130, 100), (64, 1, 128), (1, 64, 32)])
def test_prologue_planes_are_tf32_split_transposed(B, Bn, D):
    """The walk's planes are tf32_split of the zero-padded batches, the update
    batch transposed (samples contiguous), bit for bit; zeros past D and past
    each batch; the scratch is the size sm90_scratch allocates."""
    rng = np.random.default_rng(B + D)
    xb = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32))
    xn = torch.from_numpy(rng.normal(size=(Bn, D)).astype(np.float32))
    DP = sm90_width(D)
    flat = split_sm90_plain(xb, xn, DP)
    assert flat.numel() + 4 * (-(-B // 64) * 64) == sm90_scratch(B, Bn, D, "cpu").numel()
    (thi, tlo), (nhi, nlo), _ = _unpack(flat, B, Bn, DP, 2, False)
    hi, lo = tf32_split(xb)
    assert torch.equal(_bits(thi[:D, :B]), _bits(hi.T))
    assert torch.equal(_bits(tlo[:D, :B]), _bits(lo.T))
    hi, lo = tf32_split(xn)
    assert torch.equal(_bits(nhi[:Bn, :D]), _bits(hi))
    assert torch.equal(_bits(nlo[:Bn, :D]), _bits(lo))
    for p in (thi, tlo):
        assert not p[D:].any() and not p[:, B:].any()
    for p in (nhi, nlo):
        assert not p[Bn:].any() and not p[:, D:].any()


@pytest.mark.parametrize("B,Bn,D", [(100, 77, 5), (1000, 999, 37), (4096, 64, 64)])
def test_prologue_is_the_mma_sync_split_transposed(B, Bn, D):
    """The walk's planes hold the floats the mma.sync steps' prologue
    (split_batches_kernel) wrote, the update batch transposed; the walk's
    wider rows (DP 32 from D 5, where that prologue takes 8) add zeros only."""
    rng = np.random.default_rng(3 * B + D)
    xb = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32))
    xn = torch.from_numpy(rng.normal(size=(Bn, D)).astype(np.float32))
    DP, DO = sm90_width(D), split_width(D)
    assert DP >= DO
    Bp, Bnp = -(-B // 64) * 64, -(-Bn // 64) * 64
    old = split_batches_plain(xb, xn, DO)
    ohi, olo = old[:Bp * DO].reshape(Bp, DO), old[Bp * DO:2 * Bp * DO].reshape(Bp, DO)
    nh = old[2 * Bp * DO:2 * Bp * DO + Bnp * DO].reshape(Bnp, DO)
    nl = old[2 * Bp * DO + Bnp * DO:].reshape(Bnp, DO)
    (thi, tlo), (nhi, nlo), _ = _unpack(split_sm90_plain(xb, xn, DP), B, Bn, DP, 2, False)
    assert torch.equal(_bits(thi[:DO]), _bits(ohi.T))
    assert torch.equal(_bits(tlo[:DO]), _bits(olo.T))
    assert torch.equal(_bits(nhi[:, :DO]), _bits(nh))
    assert torch.equal(_bits(nlo[:, :DO]), _bits(nl))
    assert not thi[DO:].any() and not nhi[:, DO:].any()


def test_k17_positions_are_its_mma_sync_k_index():
    """K17's transposed batch (kPerm): within each 32-sample chunk, k step ks
    holds lane t's A columns t and t + 4, the samples 8 t + 2 ks and 8 t + 2
    ks + 1 that fused_skeleton.cu's mma.sync walk gives them; a permutation
    of each chunk."""
    pos = sm90_positions(128)
    for c in range(4):
        chunk = pos[32 * c:32 * (c + 1)] - 32 * c
        assert sorted(chunk.tolist()) == list(range(32))
        for ks in range(4):
            for t in range(4):
                assert chunk[8 * ks + t] == 8 * t + 2 * ks
                assert chunk[8 * ks + t + 4] == 8 * t + 2 * ks + 1


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_k17_prologue_permuted_and_one_plane_for_bf16(bf16):
    """K17's prologue: the transposed batch in `sm90_positions` order; one
    plane of the values for bf16 operands (exact in TF32), two split ones for
    float32."""
    rng = np.random.default_rng(17)
    dt = torch.bfloat16 if bf16 else torch.float32
    B, Bn, D = 333, 257, 37
    xb = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32)).to(dt)
    xn = torch.from_numpy(rng.normal(size=(Bn, D)).astype(np.float32)).to(dt)
    DP, planes = sm90_width(D), 1 if bf16 else 2
    flat = split_sm90_plain(xb, xn, DP, planes=planes, perm=True)
    assert flat.numel() == sm90_scratch(B, Bn, D, "cpu", planes, table=False).numel()
    xt, xr, _ = _unpack(flat, B, Bn, DP, planes, False)
    Bp = xt[0].shape[1]
    pos = sm90_positions(Bp)
    full = torch.zeros((Bp, DP))
    full[:B, :D] = xb.float()
    want = [full[pos].T] if bf16 else [p.T for p in tf32_split(full[pos])]
    for got, w in zip(xt, want):
        assert torch.equal(_bits(got), _bits(w))
    wn = [xn.float()] if bf16 else list(tf32_split(xn.float()))
    for got, w in zip(xr, wn):
        assert torch.equal(_bits(got[:Bn, :D]), _bits(w))


@pytest.mark.parametrize("hexa", [False, True], ids=["rect", "hexa"])
def test_k3_table_is_the_closed_forms_bmu_data(hexa):
    """K3's per-sample table: (BMU grid x, BMU row, alpha, 0), x at column +
    0.5 on odd hexa rows, zeros for a sample without a BMU and past B."""
    rng = np.random.default_rng(hexa)
    B, xdim = 100, 12
    bmu = torch.from_numpy(rng.integers(0, 96, size=B).astype(np.int32))
    bmu[[3, 50]] = -1
    alpha = torch.from_numpy(rng.uniform(0.02, 0.08, size=B).astype(np.float32))
    xb = torch.zeros((B, 5))
    flat = split_sm90_plain(xb, xb[:1], 32, bmu=bmu, alpha=alpha, xdim=xdim, hexa=hexa)
    _, _, tab = _unpack(flat, B, 1, 32, 2, True)
    for b in range(128):
        bm = int(bmu[b]) if b < B else -1
        if bm < 0:
            assert not tab[b].any()
            continue
        col, row = bm % xdim, bm // xdim
        gx = col + (0.5 * (row % 2) if hexa else 0.0)
        assert tab[b].tolist() == [gx, float(row), float(alpha[b]), 0.0]


def test_route_by_shape():
    """K3 and K17 run the walk up to SM90_MAX_D (128) and the mma.sync kernels
    past it, at any D (in feature passes of PASS_D past 256); the walk's
    width is 32, 64 or 128; D 0 raises, and the walk past 128."""
    assert SM90_MAX_D == 128 and PASS_D == 256
    for D in (1, 5, 32, 33, 64, 65, 100, 128):
        assert k3_route(D) == k17_route(D) == "sm90"
    for D in (129, 130, 200, 256, 257, 300, 1024):
        assert k3_route(D) == k17_route(D) == "mma_sync"
    assert [sm90_width(D) for D in (1, 32, 33, 64, 65, 128)] == [32, 32, 64, 64, 128, 128]
    for route in (k3_route, k17_route):
        with pytest.raises(ValueError):
            route(0)
    with pytest.raises(ValueError):
        sm90_width(129)


@pytest.mark.parametrize("xdim,ydim,hexa,gaussian,D,radius",
                         [(12, 8, True, True, 5, 3.0), (10, 6, False, True, 37, 2.5),
                          (16, 8, True, False, 37, 4.0), (16, 16, True, True, 64, 5.0),
                          (20, 10, False, False, 64, 3.0)])
def test_plain_k3_against_jax_kernel(xdim, ydim, hexa, gaussian, D, radius):
    """The plain K3 (ops.tf32x3.som_fused_train_step_tf32x3, the sums the walk
    takes) against pallas_som.py:_som_fused_step_kernel in interpret mode at
    K3's gates."""
    codes, xb, xn, bmu, alpha = _step_inputs(xdim, ydim, D, 64, 50, seed=7 * xdim + D)
    c, i, v = som_fused_train_step_tf32x3(
        torch.from_numpy(codes), torch.from_numpy(xb), torch.from_numpy(bmu),
        torch.from_numpy(xn), xdim, hexa, torch.from_numpy(alpha), radius, gaussian)
    jc, ji, jv = jps.som_fused_train_step(
        _pad128(codes), _pad128(xb), jnp.asarray(bmu), _pad128(xn), xdim, hexa,
        jnp.asarray(alpha), radius, gaussian=gaussian, factored=False)
    _assert_k3_gates(xn, c.numpy(), i.numpy(), v.numpy(), np.asarray(jc)[:, :D],
                     np.asarray(ji), np.asarray(jv))


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("shape", [(512, 256, 256, 5, 128), (512, 256, 384, 37, 128),
                                   (768, 256, 256, 64, 256)],
                         ids=["2x256_B256_D5", "2x256_B384_D37", "3x256_B256_D64"])
def test_plain_k17_against_bench_kernel(shape, bf16):
    """The plain K17 (ops.tf32x3.fused_step_skeleton_tf32x3) against
    bench.py's _skeleton_kernel in interpret mode (batch chunks of BC,
    features lane-padded to 128) at the bench's scale 1e-30: the rows come
    back as the codes, vmax within 1e-5 relative."""
    N, T, B, D, BC = shape
    codes, w, x, _ = _skeleton_inputs(29 + D + bf16, N, T, B, D, bf16=bf16)
    pad = lambda a: np.pad(a, ((0, 0), (0, 128 - D)))  # noqa: E731
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jx = jnp.asarray(pad(x.float().numpy())).astype(jdt)
    j_out, j_vmax = _bench_skeleton(jnp.asarray(pad(codes.numpy())),
                                    jnp.asarray(w.float().numpy()).astype(jdt), jx, T, BC, D)
    out, vmax = fused_step_skeleton_tf32x3(codes, w, x, x)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out)[:, :D])
    np.testing.assert_allclose(vmax.numpy(), np.asarray(j_vmax)[0], rtol=TOL, atol=0)


def test_walk_variants_edit_the_walks_lines():
    """tools.fused_step_ab's walk variants (no_w, no_feed, no_fold,
    no_turns) find the lines they edit in the walk's sources, and each edits
    only its own: the A/B cannot silently time the walk under another name.
    K3's, K5's, K6's and K11's W construction (ClosedFormW90) is the
    header's, so no_w edits the header; no_feed edits both producers there,
    K3's and the slab walks' (K5, K6, K11); slab64 edits only K5's and K11's
    slab rule."""
    from som_lvq_pak_torch import _build
    from som_lvq_pak_torch.tools.fused_step_ab import (WALK_VARIANTS, slab_variant_source,
                                                       walk_variant_sources)

    read = lambda f: open(f"{_build.CSRC}/{f}").read()  # noqa: E731
    step, walk = read("fused_step_sm90.cu"), read("fused_step_sm90.cuh")
    texts = walk_variant_sources(step, walk)
    assert tuple(texts) == WALK_VARIANTS
    assert texts["walk"] == (step, walk)
    changed = {name: (a != step, b != walk) for name, (a, b) in texts.items()}
    assert changed == {"walk": (False, False), "no_w": (False, True), "no_feed": (False, True),
                       "no_fold": (True, False), "no_turns": (False, True)}
    body = texts["no_w"][1].split("struct ClosedFormW90")[1].split("};")[0]
    assert "expf(" not in body and "weight_of_d2(" not in body
    with pytest.raises(ValueError):
        walk_variant_sources(step, walk.replace("d2 <= r2 ? sm.z", "d2 < r2 ? sm.z"))
    assert texts["no_feed"][1].count("if (c >= L::STAGES)") == 2
    assert "produce_slab" in read("som_update_masked_sm90.cu")
    slab = slab_variant_source(walk)
    changed = [(a, b) for a, b in zip(walk.splitlines(), slab.splitlines()) if a != b]
    assert len(changed) == 1 and "update_slab" in changed[0][0]
    assert changed[0][1].endswith("{ return D <= 32 ? 32 : 64; }")
    with pytest.raises(ValueError):
        slab_variant_source(walk.replace("D <= 64 ? 64 : 128", "D <= 64 ? 64 : 256"))


def test_fused_step_ab_skeleton_cases_on_the_cpu():
    """tools.fused_step_ab's K17 cases run the plain version on the CPU at a
    small size: a digest and a host-clock time."""
    from som_lvq_pak_torch.tools.fused_step_ab import run_skeleton

    rec = run_skeleton(300, 37, 7, 70, 33, True, torch.device("cpu"), iters=1)
    assert len(rec["k17_digest"]) == 64 and rec["k17_ms"] > 0
