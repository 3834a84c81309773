"""Sharded winner search and training steps over a (data, model) mesh — the
counterpart of som_lvq_pak_tpu/parallel/sharded.py on torch.distributed
(parallel.mesh).

The codebook rows are sharded on the `model` axis and the batch on the
`data` axis.  Each rank finds its batch rows' winners in its codebook rows;
the global winner is the smallest of the S (value, global index)
candidates gathered over `model`, the lowest global index on equal values
(the C scan's first-index rule, lvq_pak.c:79).  Update accumulators are
summed over `data`, and each rank updates only its own rows.

Two layers:

* per-rank functions, the bodies the JAX package runs inside shard_map:
  `sharded_winner_search` (`chunked_winner_search`, its pieces with their
  gathers in flight), `sharded_som_step`, `sharded_olvq1_step`,
  `sharded_top2`, `sharded_lvq_step`, `ring_winner_search`,
  `dim_sharded_winner_search`.  They take this rank's shards and call the
  mesh's collectives, so every rank of the world must call them together.
  `n_local` is the height of a codebook block, ceil(noc / S): rank m's rows
  start at global row m * n_local (the last shard may be shorter).
* `make_*` builders: step functions with the JAX builders' view, whole
  arrays in and whole arrays out on every rank (each rank slices its part,
  runs the per-rank function and gathers the result).  The fused steps'
  per-rank function is their `.local` attribute, which the trainers run on
  the shards they keep.

On a CUDA device the winner searches run K1 `dist_argmin` (K4 given a
mask), the lvq2.1/lvq3 top-2 K10 `dist_topk`, the pure-TP fused step K3
`som_fused_train_step` with the shard's unit offset, and the mixed fused
step K11 `som_neighborhood_accumulate` and K12 `som_blend_winner`; a CPU
tensor runs their plain versions.  The ring and dim-sharded winner searches
use the plain ops on either device, as the JAX package computes them with
XLA, not Pallas.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.fast import _f32, effective_alpha, guarded_sum_update
from ..ops.dist_argmin import dist_argmin
from ..ops.dist_topk import dist_topk
from ..ops.distance import find_winners, fp32_matmul, keep_of
from ..ops.som_accum import som_neighborhood_accumulate
from ..ops.som_blend import som_blend_winner
from ..ops.segment_sum import segment_sum
from ..ops.som_step import som_fused_train_step
from .mesh import Mesh, class_blocked_order

INT_MAX = torch.iinfo(torch.int32).max


def _pick_min(vals, gidxs):
    """Of (S, Bl) gathered candidates: each sample's smallest value and,
    among equal ones, the lowest global index."""
    best = vals.min(0).values
    cand = torch.where(vals == best[None, :], gidxs, INT_MAX)
    return best, cand.min(0).values


def _gather_min(mesh: Mesh, val_l, gidx_l):
    """Over `model`: the smallest of the S candidate values of each sample
    and, among equal ones, the lowest global index."""
    return _pick_min(mesh.all_gather(val_l, "model"),
                     mesh.all_gather(gidx_l.to(torch.int32), "model"))


def sharded_winner_search(mesh: Mesh, xb, codes_local, n_local: int, mask=None):
    """Global (val (Bl,), global_idx (Bl,) int32) winners of this rank's
    batch rows `xb` against the model-sharded codebook; `mask` (Bl, D)
    nonzero = component masked off (lvq_pak.c:63-72)."""
    val_l, idx_l = dist_argmin(xb, codes_local, mask=mask)
    return _gather_min(mesh, val_l, idx_l + mesh.coords["model"] * n_local)


def chunked_winner_search(mesh: Mesh, xb, codes_local, n_local: int, chunks: int):
    """sharded_winner_search's global winner indices (Bl,) int32, the batch
    rows split into `chunks` pieces (at most Bl; ceil(Bl / chunks) rows
    each): each piece's K1 search, then its two gathers over `model`
    (values, global indices) issued asynchronously, so the next piece's
    search runs while they travel; the pieces are waited on in order.  A
    sample's winner does not depend on its piece."""
    Bl = xb.shape[0]
    csize = -(-Bl // max(1, min(chunks, Bl)))
    off = mesh.coords["model"] * n_local
    pending = []
    for s in range(0, Bl, csize):
        val_l, idx_l = dist_argmin(xb[s:s + csize], codes_local)
        pending.append((mesh.all_gather(val_l, "model", async_op=True),
                        mesh.all_gather((idx_l + off).to(torch.int32), "model",
                                        async_op=True)))
    return torch.cat([_pick_min(v.wait(), g.wait())[1] for v, g in pending])


def sharded_som_step(
    mesh: Mesh, codes_local, xb_local, coords_local, coords_full, alpha, radius,
    gaussian: bool, mask_local=None, weights_local=None, fixed_local=None,
    n_local: Optional[int] = None, overlap_chunks: int = 1,
):
    """One two-pass sharded minibatch SOM step; returns this rank's new
    codebook rows.

    codes_local: this rank's codebook rows; xb_local: its batch rows;
    coords_local / coords_full: unit coordinates of its rows / of the whole
    map (models.fast.unit_coords); mask_local (Bl, D) nonzero = masked,
    weights_local (Bl,) scale alpha as 1-(1-a)^w, fixed_local (Bl,) >= 0
    replaces the winner (som_rout.c:612-640 on the batch path).  The
    neighbourhood weights W (Bl, rows) come from the coordinates, as in the
    JAX step; W^T X and the weight mass are summed over `data`, then the
    guarded update (models.fast.guarded_sum_update).

    `overlap_chunks > 1` without a mask splits the winner search into
    min(overlap_chunks, Bl) pieces whose gathers overlap the next piece's
    search (chunked_winner_search); the winners, and so the step, are
    those of overlap_chunks=1.  Under a mask it is ignored, as in the JAX
    step."""
    fp32_matmul()
    nl = codes_local.shape[0] if n_local is None else n_local
    dev = codes_local.device
    if mask_local is not None:
        keep = keep_of(mask_local)
        xb_use = xb_local * keep
        _, bmu = sharded_winner_search(mesh, xb_use, codes_local, nl,
                                       mask=mask_local)
    else:
        keep = None
        xb_use = xb_local
        if overlap_chunks > 1:
            bmu = chunked_winner_search(mesh, xb_local, codes_local, nl,
                                        overlap_chunks)
        else:
            _, bmu = sharded_winner_search(mesh, xb_local, codes_local, nl)
    if fixed_local is not None:
        bmu = torch.where(fixed_local >= 0, fixed_local.to(torch.int32), bmu)
    a = effective_alpha(alpha, xb_local.shape[0], dev, weights_local, mask_local)
    r = _f32(radius, dev)
    c = coords_full[bmu.long()]                      # (Bl, 2)
    d = c[:, None, :] - coords_local[None, :, :]
    d2 = (d * d).sum(-1)                             # (Bl, rows)
    if gaussian:
        W = a[:, None] * torch.exp(-d2 / (2.0 * r * r))
    else:
        W = torch.where(d2 <= r * r, a[:, None], 0.0)
    wx = W.T @ xb_use                                # (rows, D)
    wsum = W.T @ keep if keep is not None else W.sum(0)[:, None]
    wx = mesh.all_reduce(wx, "data")
    wsum = mesh.all_reduce(wsum, "data")
    return guarded_sum_update(codes_local, wx, wsum)


def shard_arrays(mesh: Mesh, codes, xb, coords):
    """This rank's (codebook rows (a copy), batch rows, coordinates of its
    rows, whole coordinates): the training step's slicing."""
    rows = mesh.rows(codes.shape[0])
    return (codes[rows].clone(), xb[mesh.batch_rows(xb.shape[0])],
            coords[rows], coords)


def make_sharded_som_train_step(
    mesh: Mesh, gaussian: bool, masked: bool = False, weighted: bool = False,
    fixed: bool = False, overlap_chunks: int = 1,
):
    """step(codes (noc, D), xb (B, D), coords (noc, 2), alpha, radius,
    [mask (B, D)], [weights (B,)], [fixed_bmu (B,)]) -> codes (noc, D): the
    trailing arguments appear in that order for whichever of
    masked/weighted/fixed are True; `overlap_chunks` as in
    sharded_som_step."""
    names = [n for n, on in (("mask_local", masked), ("weights_local", weighted),
                             ("fixed_local", fixed)) if on]

    def step(codes, xb, coords, alpha, radius, *extras):
        cl, xl, crd_l, crd = shard_arrays(mesh, codes, xb, coords)
        bs = mesh.batch_rows(xb.shape[0])
        kw = {n: e[bs] for n, e in zip(names, extras)}
        out = sharded_som_step(mesh, cl, xl, crd_l, crd, alpha, radius, gaussian,
                               n_local=mesh.block(codes.shape[0]),
                               overlap_chunks=overlap_chunks, **kw)
        return mesh.gather_rows(out, codes.shape[0])

    return step


# ---------------------------------------------------------------------------
# Fused SOM steps: one pass over each codebook shard per training step
# ---------------------------------------------------------------------------

def make_sharded_fused_som_train_step(mesh: Mesh, gaussian: bool, xdim: int,
                                      hexa: bool):
    """The pure-TP fused step (data axis 1): per model shard, K3 applies
    batch t's update to the shard's rows and finds batch t+1's winner
    candidates against the updated rows, with the shard's global unit
    offset; the global winner is the gather-min over `model`.  The batch is
    replicated (the in-kernel blend is per whole batch), so a data axis
    larger than 1 raises.

    step(codes (noc, D), xb (B, D), bmu (B,), xb_next (B', D), alpha,
    radius) -> (codes, bmu_next (B',)); `.local(codes_l, xb, bmu, xn,
    alpha, radius, offset)` updates the shard `codes_l` (global row
    `offset` first) in place and returns (codes_l, bmu_next)."""
    if mesh.shape["data"] != 1:
        raise ValueError(
            "make_sharded_fused_som_train_step: needs data-axis size 1 "
            "(batch replicated; the in-kernel blend is per whole batch) "
            f"— got data={mesh.shape['data']}")

    def local(codes_l, xb, bmu, xn, alpha, radius, offset):
        _, idx, val = som_fused_train_step(codes_l, xb, bmu, xn, xdim, hexa,
                                           alpha, radius, gaussian,
                                           unit_offset=offset)
        return codes_l, _gather_min(mesh, val, idx + offset)[1]

    def step(codes, xb, bmu, xn, alpha, radius):
        rows = mesh.rows(codes.shape[0])
        c, b = local(codes[rows].clone(), xb, bmu, xn, alpha, radius, rows.start)
        return mesh.gather_rows(c, codes.shape[0]), b

    step.local = local
    return step


def make_mixed_fused_som_train_step(
    mesh: Mesh, gaussian: bool, xdim: int, hexa: bool, overlap_segments: int = 1,
):
    """The fused SOM step for mixed data x model meshes: each rank computes
    its batch rows' accumulators W^T X, W^T 1 for its codebook rows (K11, no
    codebook read), the accumulators are summed over `data`, and K12 blends
    the sums into the rows and finds the next batch rows' winners against
    them in one pass; the global winner is the gather-min over `model`.

    step(codes (noc, D), xb (B, D), bmu (B,), xb_next (B', D), alpha
    (scalar or (B,)), radius) -> (codes, bmu_next (B',)); `.local(codes_l,
    xb_l, bmu_l, xn_l, alpha, radius, offset)` takes this rank's batch rows
    (a (B,) alpha is sliced to them here) and updates `codes_l` in place.

    `overlap_segments > 1` (with a data axis > 1) splits the shard's rows
    into segments: segment k's sum over `data` is issued asynchronously
    before segment k+1's K11 and waited on before the blend.  A row's sums
    do not depend on its segment, so the result equals overlap_segments=1
    exactly.  Segments must be 8-row-aligned, else one segment is used; a
    shard height that is not a multiple of 8 raises ValueError (the JAX
    step's tile rule, `_pick_tile`, kept so both packages accept the same
    meshes; the port's kernels need no tile to divide the shard).  The JAX
    builder's `tile_n` has no counterpart."""
    dp = mesh.shape["data"]

    def local(codes_l, xb_l, bmu_l, xn_l, alpha, radius, offset):
        n_local, D = codes_l.shape
        a = _f32(alpha, codes_l.device)
        if a.dim() == 1:
            # replicated full-batch per-sample alpha: this data shard's window
            Bl = xb_l.shape[0]
            a = a[mesh.coords["data"] * Bl:(mesh.coords["data"] + 1) * Bl]
        if n_local % 8:
            raise ValueError(f"make_mixed_fused_som_train_step: shard height "
                             f"{n_local} must be a multiple of 8")
        segs = overlap_segments
        if segs > 1 and (n_local % segs or (n_local // segs) % 8):
            segs = 1
        if segs > 1 and dp > 1:
            H = n_local // segs
            pending = []
            for k in range(segs):
                a_k, w_k = som_neighborhood_accumulate(
                    xb_l, bmu_l, H, xdim, hexa, a, radius, gaussian,
                    unit_offset=offset + k * H)
                pending.append(mesh.all_reduce(torch.cat([a_k, w_k], 1), "data",
                                               async_op=True))
            summed = torch.cat([p.wait() for p in pending])
        else:
            acc, wsum = som_neighborhood_accumulate(
                xb_l, bmu_l, n_local, xdim, hexa, a, radius, gaussian,
                unit_offset=offset)
            summed = mesh.all_reduce(torch.cat([acc, wsum], 1), "data")
        _, val_l, idx_l = som_blend_winner(codes_l, summed[:, :D].contiguous(),
                                           summed[:, D:].contiguous(), xn_l)
        return codes_l, _gather_min(mesh, val_l, idx_l + offset)[1]

    def step(codes, xb, bmu, xn, alpha, radius):
        rows = mesh.rows(codes.shape[0])
        bs = mesh.batch_rows(xb.shape[0])
        c, b = local(codes[rows].clone(), xb[bs], bmu[bs],
                     xn[mesh.batch_rows(xn.shape[0])], alpha, radius, rows.start)
        return (mesh.gather_rows(c, codes.shape[0]),
                mesh.all_gather(b, "data").reshape(-1))

    step.local = local
    return step


# ---------------------------------------------------------------------------
# Sharded LVQ steps (olvq1, lvq1 / lvq2.1 / lvq3)
# ---------------------------------------------------------------------------

def _local_delta(mesh: Mesh, codes_local, xb_local, gidx, coef, n_local):
    """Segment-sum coef * (x - codes[gidx]) into this rank's rows (the
    samples whose row lives elsewhere add 0)."""
    rows = codes_local.shape[0]
    lidx = gidx.long() - mesh.coords["model"] * n_local
    in_local = (lidx >= 0) & (lidx < rows)
    lidx_c = lidx.clamp(0, rows - 1)
    contrib = torch.where(in_local, coef, 0.0)[:, None] * (
        xb_local - codes_local[lidx_c])
    return segment_sum(contrib, lidx_c, rows)


def sharded_olvq1_step(mesh: Mesh, codes_local, labels_full, alphas_full,
                       xb_local, xlab_local, clip: float,
                       n_local: Optional[int] = None):
    """One sharded minibatch olvq1 step; returns (this rank's new rows, the
    new (noc,) alphas).  labels_full and alphas_full are replicated: the hit
    counts over the whole index space are the same on every model shard, so
    they are summed over `data` only and the alphas stay consistent.  The
    update math is models.fast.olvq1_batch_step's."""
    nl = codes_local.shape[0] if n_local is None else n_local
    noc = labels_full.shape[0]
    _, gidx = sharded_winner_search(mesh, xb_local, codes_local, nl)
    g = gidx.long()
    correct = labels_full[g] == xlab_local
    a = alphas_full[g]
    sign = torch.where(correct, a, -a)
    delta = mesh.all_reduce(
        _local_delta(mesh, codes_local, xb_local, g, sign, nl), "data")
    # the two hit counts as the columns of one segment sum
    counts = mesh.all_reduce(segment_sum(torch.stack(
        [correct, ~correct], 1).to(torch.float32), g, noc), "data")
    ncorrect, nwrong = counts[:, 0], counts[:, 1]
    # saturating alpha growth (models.fast.olvq1_batch_step)
    clip32 = _f32(clip, codes_local.device)
    new_a = alphas_full / (1.0 + ncorrect * alphas_full)
    denom = 1.0 - nwrong * new_a
    ok = denom > 1e-6
    grown = torch.where(ok, new_a / torch.where(ok, denom, 1.0), clip32)
    new_a = torch.where(nwrong > 0, torch.minimum(grown, clip32), new_a)
    return codes_local + delta, new_a


def make_sharded_olvq1_train_step(mesh: Mesh, clip: float = 0.3):
    """step(codes (noc, D), labels (noc,), alphas (noc,), xb (B, D),
    xlabels (B,)) -> (codes, alphas)."""

    def step(codes, labels, alphas, xb, xlabels):
        rows, bs = mesh.rows(codes.shape[0]), mesh.batch_rows(xb.shape[0])
        c, a = sharded_olvq1_step(mesh, codes[rows], labels, alphas, xb[bs],
                                  xlabels[bs], clip,
                                  n_local=mesh.block(codes.shape[0]))
        return mesh.gather_rows(c, codes.shape[0]), a

    return step


def sharded_top2(mesh: Mesh, xb_local, codes_local, n_local: int):
    """Global top-2 (d1, i1, d2, i2), each (Bl,), of this rank's batch rows:
    a local top-2 per shard (K10 `dist_topk`, k = 2), then the 2S gathered
    candidates picked twice (smallest distance, lowest global index on
    ties; the winner dropped for the second pick), lax.top_k's order."""
    vals, idx = dist_topk(xb_local, codes_local, 2)
    gidx = idx + mesh.coords["model"] * n_local
    Bl = vals.shape[0]
    vs = mesh.all_gather(vals, "model").permute(1, 0, 2).reshape(Bl, -1)
    gs = mesh.all_gather(gidx, "model").permute(1, 0, 2).reshape(Bl, -1)

    def pick(vs):
        best = vs.min(1).values
        cand = torch.where(vs == best[:, None], gs, INT_MAX)
        return best, cand.min(1).values

    d1, i1 = pick(vs)
    d2, i2 = pick(torch.where(gs == i1[:, None], float("inf"), vs))
    return d1, i1, d2, i2


def sharded_lvq_step(mesh: Mesh, codes_local, labels_full, xb_local, xlab_local,
                     alpha, algorithm: str, winlen: float, epsilon: float,
                     n_local: Optional[int] = None):
    """One sharded minibatch lvq1/lvq2.1/lvq3 step; returns this rank's new
    rows.  The update math is models.fast.lvq1_batch_step /
    lvq23_batch_step's; each shard sums into its own rows (ops.segment_sum,
    in sample order) and the deltas are summed over `data`."""
    nl = codes_local.shape[0] if n_local is None else n_local
    a = _f32(alpha, codes_local.device)

    def delta_of(gidx, coef):
        return _local_delta(mesh, codes_local, xb_local, gidx, coef, nl)

    if algorithm == "lvq1":
        _, gidx = sharded_winner_search(mesh, xb_local, codes_local, nl)
        correct = labels_full[gidx.long()] == xlab_local
        delta = delta_of(gidx, torch.where(correct, a, -a))
    else:
        d1, i1, d2, i2 = sharded_top2(mesh, xb_local, codes_local, nl)
        l1, l2 = labels_full[i1.long()], labels_full[i2.long()]
        wl = (1.0 - winlen) / (1.0 + winlen)
        in_window = d1 / torch.clamp(d2, min=1e-30) > wl
        differ = l1 != l2
        one_matches = (l1 == xlab_local) | (l2 == xlab_local)
        window_rule = differ & one_matches & in_window
        swap = l2 == xlab_local
        b_idx = torch.where(swap, i2, i1)
        nb_idx = torch.where(swap, i1, i2)
        a_b = torch.where(window_rule, a, 0.0)
        delta = delta_of(b_idx, a_b) + delta_of(nb_idx, -a_b)
        if algorithm == "lvq3":
            same = (l1 == l2) & (l1 == xlab_local)
            ae = torch.where(same, a * epsilon, 0.0)
            delta = delta + delta_of(i1, ae) + delta_of(i2, ae)
    return codes_local + mesh.all_reduce(delta, "data")


def check_lvq_mesh(mesh: Mesh, noc: int, algorithm: str) -> None:
    """lvq2/lvq3 run a per-shard local top-2: every model shard needs at
    least 2 codebook rows, or ValueError."""
    if algorithm not in ("lvq1", "lvq2", "lvq3"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    S = mesh.shape["model"]
    if algorithm != "lvq1" and min(
            noc - m * mesh.block(noc) for m in range(S)) < 2:
        raise ValueError(
            f"sharded {algorithm}: every model shard needs >= 2 codebook rows "
            f"for the local top-2 — got noc={noc} over {S} model shards")


def make_sharded_lvq_train_step(mesh: Mesh, algorithm: str = "lvq1",
                                winlen: float = 0.3, epsilon: float = 0.1):
    """step(codes (noc, D), labels (noc,), xb (B, D), xlabels (B,), alpha)
    -> codes: the olvq1 step's layout for the fixed-alpha LVQ family
    (lvqtrain.c:214-237)."""
    if algorithm not in ("lvq1", "lvq2", "lvq3"):
        raise ValueError(f"unknown algorithm {algorithm!r}")

    def step(codes, labels, xb, xlabels, alpha):
        check_lvq_mesh(mesh, codes.shape[0], algorithm)
        rows, bs = mesh.rows(codes.shape[0]), mesh.batch_rows(xb.shape[0])
        c = sharded_lvq_step(mesh, codes[rows], labels, xb[bs], xlabels[bs],
                             alpha, algorithm, winlen, epsilon,
                             n_local=mesh.block(codes.shape[0]))
        return mesh.gather_rows(c, codes.shape[0])

    return step


# ---------------------------------------------------------------------------
# Expert parallelism: class-blocked codebook layout (SURVEY.md §2.6 EP row)
# ---------------------------------------------------------------------------

class ClassBlockedOLVQ1:
    """olvq1 training with the expert-parallel codebook layout: rows are
    permuted so same-class codes sit in contiguous blocks
    (parallel.mesh.class_blocked_order) before sharding over `model`,
    landing each class on as few shards as possible.  Training is exactly
    the sharded olvq1 step over the permuted layout; `codes()` and
    `alphas()` undo the permutation.  Every rank builds it with the same
    arguments; `step` takes the whole batch and uses its rows."""

    def __init__(self, mesh: Mesh, codes, code_labels, alphas=None,
                 clip: float = 0.3):
        self.mesh = mesh
        dev = mesh.device
        labels = np.asarray(torch.as_tensor(code_labels).cpu())
        self.order = class_blocked_order(labels)
        self.inv = np.argsort(self.order)
        self.clip = float(clip)
        self.n = labels.shape[0]
        order = torch.from_numpy(self.order).to(dev)
        codes = _f32(codes, dev)
        alphas = (torch.full((self.n,), self.clip, dtype=torch.float32, device=dev)
                  if alphas is None else _f32(alphas, dev))
        self._codes = codes[order][mesh.rows(self.n)].clone()
        self._labels = torch.as_tensor(labels[self.order], dtype=torch.int32,
                                       device=dev)
        self._alphas = alphas[order]

    def step(self, xb, xlabels):
        """One sharded minibatch olvq1 step over the blocked layout."""
        bs = self.mesh.batch_rows(xb.shape[0])
        self._codes, self._alphas = sharded_olvq1_step(
            self.mesh, self._codes, self._labels, self._alphas,
            _f32(xb, self.mesh.device)[bs],
            torch.as_tensor(xlabels, device=self.mesh.device)[bs], self.clip,
            n_local=self.mesh.block(self.n))
        return self

    def codes(self):
        """Trained codebook in the ORIGINAL row order."""
        full = self.mesh.gather_rows(self._codes, self.n)
        return full[torch.from_numpy(self.inv).to(full.device)]

    def alphas(self):
        return self._alphas[torch.from_numpy(self.inv).to(self._alphas.device)]

    def shards_per_class(self):
        """Diagnostic: {class label: number of model shards its rows span}
        under the blocked layout — the quantity EP minimizes."""
        per = self.mesh.block(self.n)
        lab = self._labels.cpu().numpy()
        return {int(c): len(np.unique(np.nonzero(lab == c)[0] // per))
                for c in np.unique(lab)}


# ---------------------------------------------------------------------------
# Ring-pass and feature-sharded winner searches (plain ops on either device)
# ---------------------------------------------------------------------------

def ring_winner_search(mesh: Mesh, xb_local, codes_local, axis: str = "model"):
    """Winner search where both the batch and the codebook stay sharded:
    the codebook shards rotate around `axis`'s ring (Mesh.ring_pass) and
    each rank folds its batch rows' (min, global argmin) over the S shards
    with (strict <) | (== and lower global index).  Returns (val (Bl,),
    global_idx (Bl,)), true squared distances (ops.distance.find_winners).
    Shards must have one height."""
    S, me = mesh.shape[axis], mesh.coords[axis]
    n_local = codes_local.shape[0]
    Bl = xb_local.shape[0]
    dev = xb_local.device
    bestv = torch.full((Bl,), float("inf"), dtype=torch.float32, device=dev)
    besti = torch.full((Bl,), INT_MAX, dtype=torch.int32, device=dev)
    block = codes_local
    for r in range(S):
        idx, val = find_winners(xb_local, block)
        gidx = ((me + r) % S) * n_local + idx.to(torch.int32)
        better = (val < bestv) | ((val == bestv) & (gidx < besti))
        bestv = torch.where(better, val, bestv)
        besti = torch.where(better, gidx, besti)
        if r + 1 < S:
            block = mesh.ring_pass(block, axis)
    return bestv, besti


def make_ring_winner(mesh: Mesh):
    """winner(xb (B, D), codes (noc, D)) -> (val (B,), idx (B,)): the batch
    sharded over both axes (rank d S + m holds rows block d S + m), the
    codebook rows over `model` (noc divisible by S); ring_winner_search."""

    def winner(xb, codes):
        S, world = mesh.shape["model"], mesh.shape["model"] * mesh.shape["data"]
        if codes.shape[0] % S or xb.shape[0] % world:
            raise ValueError(f"make_ring_winner: noc {codes.shape[0]} and B "
                             f"{xb.shape[0]} must split over model {S} and the "
                             f"{world} ranks")
        Bl = xb.shape[0] // world
        xl = xb[mesh.rank * Bl:(mesh.rank + 1) * Bl]
        v, i = ring_winner_search(mesh, xl, codes[mesh.rows(codes.shape[0])])
        gather = lambda t: mesh.all_gather(  # noqa: E731
            mesh.all_gather(t, "model"), "data").reshape(-1)
        return gather(v), gather(i)

    return winner


def dim_sharded_winner_search(mesh: Mesh, xb_d, codes_d, axis: str = "model",
                              chunk: int = 2048):
    """Feature-sharded winner search: xb_d and codes_d hold this rank's
    feature columns; per `chunk` codebook rows the partial distances
    ||m_d||^2 - 2 x_d.m_d are summed over `axis` and folded into the running
    (min, argmin) (strict < across chunks, argmin's first index inside one:
    the lowest global index).  Returns (sq_dist_without_x2 (B,), idx
    (B,)), like the C scan without the ||x||^2 constant."""
    fp32_matmul()
    N, B = codes_d.shape[0], xb_d.shape[0]
    dev = xb_d.device
    chunk = min(chunk, N)
    bestv = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
    besti = torch.zeros((B,), dtype=torch.int32, device=dev)
    for base in range(0, N, chunk):
        m_c = codes_d[base:base + chunk]
        partial = (m_c * m_c).sum(-1)[None, :] - 2.0 * (xb_d @ m_c.T)
        d = mesh.all_reduce(partial, axis)
        v, i = d.min(-1)
        better = v < bestv
        bestv = torch.where(better, v, bestv)
        besti = torch.where(better, i.to(torch.int32) + base, besti)
    return bestv, besti


def make_dim_sharded_winner(mesh: Mesh, chunk: int = 2048):
    """winner(xb (B, D), codes (N, D)) -> (val (B,), idx (B,)): the feature
    axis sharded over `model` (D divisible by S), the batch over `data`."""

    def winner(xb, codes):
        S, D = mesh.shape["model"], codes.shape[1]
        if D % S:
            raise ValueError(f"make_dim_sharded_winner: D {D} does not split "
                             f"over model {S}")
        cols = slice(mesh.coords["model"] * (D // S),
                     (mesh.coords["model"] + 1) * (D // S))
        xl = xb[mesh.batch_rows(xb.shape[0])][:, cols].contiguous()
        v, i = dim_sharded_winner_search(mesh, xl, codes[:, cols].contiguous(),
                                         chunk=chunk)
        return (mesh.all_gather(v, "data").reshape(-1),
                mesh.all_gather(i, "data").reshape(-1))

    return winner

