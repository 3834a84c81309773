"""K7 (the grouped SOM steps) on K3's Hopper walk with each tile's work split
across a thread-block cluster, and K12 (the mixed mesh step's blend and
winners) on K3's winner walk: the parts the CPU can hold.

* The plain K7 (`som_vmem_train_steps` on the CPU: K chained plain K3 steps)
  against the JAX `som_vmem_train_steps` in interpret mode, and the plain K12
  (`som_blend_winner`) against the JAX `som_blend_winner`, on the same
  NumPy-seeded inputs at D 5, 37, 64, 100, 128 and 129 on a 16 x 12 map (the
  JAX kernels take D padded to a multiple of 128 with zero columns): codes
  within 1e-5, winners equal except at near-ties (relative gap below 1e-5 in
  float64: the two packages sum in different orders), K12's values within
  1e-4.
* A re-enactment of K7's split (csrc/som_vmem_steps_sm90.cu) on the
  split-TF32 emulation (`ops.tf32x3`): at every cluster size c of the walk
  at D, rank r sums the update over the whole batch for its slab of DP / c
  features (32-sample chunks, W from the same table) and blends it, the
  tile's rows are assembled from the ranks' slabs, and rank r scores its
  contiguous share of the next batch's 64-sample chunks against all rows;
  K such steps chained give `som_vmem_train_steps_tf32x3`'s codebook and
  winners (K chained K3 emulations) bit for bit, as the kernel gives the K3
  chain's on the card.
* The routes at D 128 / 129, the cluster choice `k7_cluster` and `k7_rows`'s
  pick as pure functions, and the walk's shared memory
  (`k7_walk_smem_bytes`, the C layout's mirror) within the card's opt-in at
  every D and cluster size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from som_lvq_pak_tpu.ops import pallas_som as jps
from som_lvq_pak_torch.ops import som_vmem
from som_lvq_pak_torch.ops.som_blend import k12_route, som_blend_winner
from som_lvq_pak_torch.ops.som_step import (_alpha_r, guarded_blend, neighborhood_w,
                                            sm90_width)
from som_lvq_pak_torch.ops.som_vmem import (chain_steps, k7_cluster, k7_clusters, k7_route,
                                            k7_walk_smem_bytes, som_vmem_train_steps)
from som_lvq_pak_torch.ops.tf32x3 import (_winners, chunk_sums,
                                          som_vmem_train_steps_tf32x3)

T = torch.from_numpy
TOL = 1e-5
XDIM, YDIM = 16, 12
DS = [5, 37, 64, 100, 128, 129]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run torch on one CPU thread in this module, as
    tests/test_torch_vmem.py does for the gaussian step."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad(a, D):
    """a (..., D) zero-padded to the JAX kernels' multiple of 128."""
    w = -(-D // 128) * 128
    return jnp.zeros(a.shape[:-1] + (w,), jnp.float32).at[..., :D].set(a)


def _gap_ok(x, codes, i_got, i_want):
    """Winners equal, or apart only where the two rows' float64 distances
    from the sample differ by less than TOL relative."""
    bad = np.nonzero(np.asarray(i_got) != np.asarray(i_want))[0]
    if bad.size:
        x64 = np.asarray(x, np.float64)[bad]
        c64 = np.asarray(codes, np.float64)
        da = ((x64 - c64[np.asarray(i_got)[bad]]) ** 2).sum(-1)
        db = ((x64 - c64[np.asarray(i_want)[bad]]) ** 2).sum(-1)
        gap = np.abs(da - db) / np.maximum(np.maximum(da, db), 1e-30)
        assert gap.max() < TOL, (bad, gap)


def _k7_inputs(D, K, B, seed, per_sample=True):
    """A group: codes, K batches, the next group's first batch, bmu0 (float64
    argmin), alphas small enough that no unit's weight mass passes 1, and a
    decaying radius."""
    rng = np.random.default_rng(seed)
    noc = XDIM * YDIM
    codes = rng.normal(size=(noc, D)).astype(np.float32)
    xs = rng.normal(size=(K, B, D)).astype(np.float32)
    nf = rng.normal(size=(B, D)).astype(np.float32)
    d0 = ((xs[0][:, None, :].astype(np.float64) - codes[None]) ** 2).sum(-1)
    bmu0 = np.argmin(d0, axis=1).astype(np.int32)
    alphas = (rng.uniform(0.001, 0.01, size=(K, B)) if per_sample
              else np.linspace(0.01, 0.004, K)).astype(np.float32)
    radii = np.linspace(3.0, 1.5, K).astype(np.float32)
    return codes, xs, nf, bmu0, alphas, radii


# -- the plain K7 and K12 against JAX -----------------------------------------

@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("hexa,gaussian", [(True, True), (False, False)])
def test_k7_plain_matches_jax(D, hexa, gaussian):
    """K 4 steps of B 96 (three 32-sample chunks, a ragged 64-sample winner
    chunk) with per-sample alphas, next_first given."""
    K, B = 4, 96
    codes, xs, nf, bmu0, alphas, radii = _k7_inputs(D, K, B, seed=D + 2 * hexa)
    c = T(codes.copy())
    out, bmu = som_vmem_train_steps(c, T(xs), T(bmu0), T(alphas), T(radii), XDIM, hexa,
                                    gaussian, next_first=T(nf))
    assert out.data_ptr() == c.data_ptr() and bmu.dtype == torch.int32
    ref, jbmu = jps.som_vmem_train_steps(
        _pad(codes, D), _pad(xs, D), jnp.asarray(bmu0), jnp.asarray(alphas),
        jnp.asarray(radii), XDIM, hexa, gaussian=gaussian, next_first=_pad(nf, D),
        interpret=True)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(ref[:, D:], 0.0)
    np.testing.assert_allclose(out.numpy(), ref[:, :D], rtol=TOL, atol=TOL)
    assert not np.allclose(out.numpy(), codes, atol=1e-3)  # the steps did something
    _gap_ok(nf, out.numpy(), bmu.numpy(), np.asarray(jbmu))


@pytest.mark.parametrize("D", DS)
def test_k12_plain_matches_jax(D):
    """A 64-row shard (wsum in [0, 2): both sides of the guard), B' 100: the
    blended shard within 1e-5, winners (local rows) equal except at
    near-ties, values (-2 x the best score) within 1e-4."""
    rng = np.random.default_rng(70 + D)
    n_local, Bn = 64, 100
    codes = rng.normal(size=(n_local, D)).astype(np.float32)
    wsum = rng.uniform(0, 2, size=(n_local, 1)).astype(np.float32)
    acc = (wsum * rng.normal(size=(n_local, D))).astype(np.float32)
    xn = rng.normal(size=(Bn, D)).astype(np.float32)
    c, val, idx = som_blend_winner(T(codes.copy()), T(acc), T(wsum), T(xn))
    jc, jv, ji = jps.som_blend_winner(_pad(codes, D), _pad(acc, D), jnp.asarray(wsum),
                                      _pad(xn, D), tile_n=32, d_real=D, interpret=True)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc)[:, :D], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(val.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-4)
    _gap_ok(xn, c.numpy(), idx.numpy(), np.asarray(ji))


# -- K7's split, re-enacted on the split-TF32 emulation --------------------------

def _walk_step(cluster):
    """One step of K7's walk at `cluster` CTAs a tile, as
    `som_fused_train_step_tf32x3`'s arguments and returns: rank r's update
    over its DP / cluster features in slabs of F = min(64, DP / cluster)
    through `chunk_sums`, each slab blended, the rows assembled from the
    slabs, then rank r's winners over its contiguous share of the next
    batch's 64-sample chunks."""
    def step(codes, xb, bmu, xn, xdim, hexa, alpha, radius, gaussian=False):
        noc, D = codes.shape
        DP = sm90_width(D)
        F = min(64, DP // cluster)
        aw, r = _alpha_r(alpha, radius, xb.shape[0], codes.device)
        units = torch.arange(noc, dtype=torch.int32)
        w = neighborhood_w(bmu.to(torch.int32), aw, r, units, xdim, hexa, gaussian)
        wsum = w.sum(1, keepdim=True)
        xp = torch.zeros((xb.shape[0], DP), dtype=torch.float32)
        xp[:, :D] = xb
        slabs = [guarded_blend(torch.nn.functional.pad(codes, (0, DP - D))[:, k:k + F],
                               chunk_sums(w, xp[:, k:k + F]), wsum)
                 for k in range(0, DP, F)]
        newc = torch.cat(slabs, 1)[:, :D].contiguous()
        nw = -(-xn.shape[0] // 64)
        idx, val = [], []
        for rank in range(cluster):
            lo, hi = (min(xn.shape[0], 64 * (j * nw // cluster)) for j in (rank, rank + 1))
            i, v = _winners(newc, xn[lo:hi])
            idx.append(i)
            val.append(v)
        return newc, torch.cat(idx), torch.cat(val)
    return step


@pytest.mark.parametrize("D", [5, 37, 64, 100, 128])
@pytest.mark.parametrize("hexa,gaussian", [(True, True), (True, False), (False, True)])
def test_k7_split_reenacted_is_the_k3_chain(D, hexa, gaussian):
    """At every cluster size of the walk at D, K 3 steps of B 200 (ragged
    update and winner chunks, four winner chunks over up to four ranks)
    give the unsplit chain's codebook and winners bit for bit."""
    K, B = 3, 200
    codes, xs, nf, bmu0, alphas, radii = _k7_inputs(D, K, B, seed=100 + D + hexa)
    args = (T(bmu0), T(alphas), T(radii), XDIM, hexa, gaussian, T(nf))
    want_c, want_i = som_vmem_train_steps_tf32x3(T(codes), T(xs), *args)
    assert not torch.equal(want_c, T(codes))
    for cluster in k7_clusters(D):
        got_c, got_i = chain_steps(_walk_step(cluster), T(codes), T(xs), *args)
        assert torch.equal(got_c.view(torch.int32), want_c.view(torch.int32)), cluster
        assert torch.equal(got_i, want_i), cluster


# -- routes, the cluster choice and the shared memory ----------------------------

def test_k7_and_k12_routes_at_their_boundary():
    for route in (k7_route, k12_route):
        assert route(1) == route(128) == "sm90"
        assert route(129) == route(1024) == "mma_sync"
        with pytest.raises(ValueError):
            route(0)


@pytest.mark.parametrize("D,want", [(1, (1,)), (32, (1,)), (33, (1, 2)), (64, (1, 2)),
                                    (65, (1, 2, 4)), (128, (1, 2, 4))])
def test_k7_clusters_keep_slabs_of_32_features(D, want):
    assert k7_clusters(D) == want
    assert all(sm90_width(D) // c in (32, 64, 128) for c in want)


@pytest.mark.parametrize("tiles,D,sms,want", [
    (32, 64, 132, 2), (32, 128, 132, 4), (32, 5, 132, 1), (8, 128, 132, 4),
    (33, 128, 132, 4), (34, 128, 132, 2), (66, 64, 132, 2), (67, 64, 132, 1),
    (64, 128, 132, 2), (128, 128, 132, 1), (132, 64, 132, 1), (200, 64, 132, 1),
    (29, 128, 114, 2)])
def test_k7_cluster_choice(tiles, D, sms, want):
    """The largest size built at D whose tiles x size CTAs fill at most one
    wave of one CTA an SM: 4096 rows (32 tiles) take 2 at D 64 and 4 at D
    128 on an H100's 132 SMs, 16384 rows (128 tiles) one."""
    got = k7_cluster(tiles, D, sms)
    assert got == want and got in k7_clusters(D)
    assert got == 1 or tiles * got <= sms


@pytest.mark.parametrize("noc,D,sms,resident,want", [
    (4096, 64, 132, {1: 132, 2: 66}, (128, 2)),
    (4096, 128, 132, {1: 132, 2: 66, 4: 32}, (128, 4)),
    (4096, 128, 132, {1: 132, 2: 66, 4: 31}, (128, 2)),
    (16384, 128, 132, {1: 132, 2: 66, 4: 33}, (128, 1)),
    (1024, 37, 132, {1: 132, 2: 66}, (128, 2))])
def test_k7_rows_pick_is_checked_against_the_card(monkeypatch, noc, D, sms, resident,
                                                  want):
    """k7_rows on the walk: (128, c), c `k7_cluster` halved while fewer
    clusters of c fit at once than there are tiles; K7_CLUSTER forces c."""
    class Props:
        multi_processor_count = sms
        shared_memory_per_block_optin = 232448
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda _: Props())
    monkeypatch.setattr(som_vmem, "_k7_resident", lambda d, c: resident[c])
    assert som_vmem.k7_rows(noc, D, torch.device("cuda"), 512) == want
    monkeypatch.setattr(som_vmem, "K7_CLUSTER", 1)
    assert som_vmem.k7_rows(noc, D, torch.device("cuda"), 512) == (128, 1)


@pytest.mark.parametrize("D", range(1, 129))
def test_k7_walk_shared_memory_fits(D):
    """At every D and cluster size: the tile's 128 rows split (2 planes of
    DP floats), at least two ring slots each holding an update chunk (the
    slab of F = min(64, DP / c) features of 32 samples, 2 planes, K3's
    table) and a winner item,
    within the 232,448 bytes a block may opt into; the count does not
    depend on B."""
    for c in k7_clusters(D):
        dp, f = sm90_width(D), min(64, sm90_width(D) // c)
        got = k7_walk_smem_bytes(D, c)
        slot = max(2 * f * 128 + 512, 2 * min(dp, 64) * 256)
        assert 1024 + 2 * dp * 128 * 4 + 2 * slot <= got <= 232448


# -- tools.fused_step_ab's K7 and K12 cases ---------------------------------------

def test_k7_k12_walk_variants_edit_their_lines():
    """tools.fused_step_ab's K7 and K12 variants find the lines they edit in
    the walks' sources and edit only those: K7's no_fold its fold call, its
    no_barrier the grid barrier's block and the producer's wait for it;
    K12's no_fold K3's fold call; every other variant is the source itself
    (their edits are the header's)."""
    from som_lvq_pak_torch import _build
    from som_lvq_pak_torch.tools.fused_step_ab import (WALK_VARIANTS, k7_variant_sources,
                                                       k12_variant_sources)

    read = lambda f: open(f"{_build.CSRC}/{f}").read()  # noqa: E731
    for src, variants, extra in ((read("som_vmem_steps_sm90.cu"), k7_variant_sources,
                                  ("no_barrier",)),
                                 (read("som_blend_winner_sm90.cu"), k12_variant_sources, ())):
        texts = variants(src)
        assert tuple(texts) == WALK_VARIANTS + extra
        assert [n for n, t in texts.items() if t != src] == ["no_fold", *extra]
        assert "argmin_fold(" not in texts["no_fold"] and "argmin_fold(" in src
        with pytest.raises(ValueError):
            variants(src.replace("argmin_fold(S", "argmin_fold (S"))
    no_barrier = k7_variant_sources(read("som_vmem_steps_sm90.cu"))["no_barrier"]
    assert no_barrier.count("if (false)") == 2


def test_fused_step_ab_vmem_case_on_the_cpu():
    """tools.fused_step_ab's K7 case runs the plain versions on the CPU at a
    small size: the plain K7 at every cluster size (the size moves nothing on
    the CPU) and the K3 chain give one digest, and a host-clock time each."""
    from som_lvq_pak_torch.tools.fused_step_ab import run_vmem

    rec = run_vmem(6, 5, True, True, 40, 37, 3, 2.0, torch.device("cpu"), iters=1)
    digests = {v for k, v in rec.items() if k.endswith("_digest")}
    assert len(digests) == 1 and len(digests.pop()) == 64
    assert all(rec[k] > 0 for k in rec if k.endswith("_ms"))
