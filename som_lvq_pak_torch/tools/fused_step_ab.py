"""The tensor-core fused steps and their skeleton, timed side by side on one
tree, with a digest of every output so that two trees can be held bit for
bit against each other: K3 (csrc/fused_step_sm90.cu, the Hopper walk, for D
<= 128; csrc/som_fused_step.cu past it), K13 (csrc/som_fused_factored_sm90.cu,
K3's walk, for D <= 128; csrc/som_fused_factored.cu past it), K14's main form
(csrc/separable_sm90.cuh, K13's walk with the batch split across a
cluster, for D <= 128; csrc/fused_step_tc.cuh past it; past 256 features
every fused-step kernel runs in feature passes), K17
(csrc/fused_skeleton_sm90.cu, K3's walk; csrc/fused_skeleton.cu past D 128),
the winner walks K4 and K9 (masked, csrc/argmin_masked_sm90.cu), K8 and K10
(csrc/argmin_sm90.cu; K10 at k 1, 2, 5, 8 and 16, and at every k from 1 to
16 of the list widths on small codebooks, every code twice or not, in file
and reversed order), the two-kernel step's updates K5
(csrc/som_update_sm90.cu) and K6 (masked, csrc/som_update_masked_sm90.cu),
the mixed mesh step's halves K11 (csrc/som_accum_sm90.cu) then K12
(csrc/som_blend_winner_sm90.cu, K3's walk without the update, for D <= 128;
csrc/som_blend_winner.cu past it), and the grouped steps K7
(csrc/som_vmem_steps_sm90.cu, K3's walk on resident rows, each tile's work
split across a cluster, for D <= 128; csrc/som_vmem_steps.cu past it).

    python -m som_lvq_pak_torch.tools.fused_step_ab [--iters 10] [--device cuda]
    python -m som_lvq_pak_torch.tools.fused_step_ab --walk-variants [--iters 10]

For each case (map, topology, neighbourhood, B, D, radius): K3
(`som_fused_train_step(factored=False)`) and, where the case names it, K13
(`som_fused_factored_step`) and, where B is also a multiple of 128, K14's
main form (`som_fused_factored_chunked_step`, "k14") and its bf16-batch form
(`batch_bf16=True`, "k14_bf16") on the same inputs, at the tree's own
cluster choice and at each cluster size c of K14's Hopper walk ("k14_c1",
"k14_bf16_c4", ...: `ops.som_step.K14_CLUSTER`; "not runnable" on a tree
without it, whose "k14" digests are its c 1 ones), made on the device from
seed 4 (codes, both batches and the per-sample alphas from `randn`/`rand`,
the BMUs from `dist_argmin_plain`, seven samples without one).  For each
kernel: the mean milliseconds per step over `iters` steps after a warm-up
(CUDA events), and the SHA-256 of its updated codebook, winners and values
from one step on fresh inputs; for K3 (and K13) also the digests of a step on
the codebook rounded to bf16 ("k3_digest_bf16", "k13_digest_bf16") and for K3
of one taking the rows as a model-axis shard from unit 64
("k3_digest_offset").  A kernel a tree refuses
(a tree whose kernels stop at D 256, at the D 300 and 512 cases) gets "not
runnable: " and the refusal in place of its digest and ms.  For each skeleton case (N, D, T, B, B',
float32 or bf16): K17 (`fused_step_skeleton`) on bench.py:prep_skeleton's
inputs from seed 6, the SHA-256 of its out and vmax at scale 1.0 (where the
accumulation shows) and its ms at the bench's 1e-30.  For each winner case
(B, N, D): K4 (`dist_argmin` with a mask, p 0.1 and every 97th row masked),
K9 (`dist_top2` with the same mask), K8 (`dist_top2`) and K10 (`dist_topk`
at k 1, 2, 5, 8 and 16) on inputs from seed 5, their ms and the SHA-256 of
their values and indices.  For each top-k case (B, N, D, every code twice
or not: D 5, 37, 64, 130 and 300, N not a multiple of 128): K10 at k 1, 2,
3, 5, 8 and 16 in file order and in the reference tie order
(`dist_topk_reference` on the reversed codebook), their SHA-256.  For each update case (map, topology, neighbourhood, B,
D, radius: chip_smoke.py's K5 and K6 cases, then D 300, 512 and 1024): K5
(`som_neighborhood_update_idx`) and K6 (the same with a mask, p 0.1 and
every 97th row masked) on inputs made as for the step cases, their ms and
the SHA-256 of the updated codebook.  For each accumulator case (map,
topology, neighbourhood, shard rows, unit offset, B, D, radius: the mixed
mesh step's shard, rows 32768.. of the 256x256 map at B 2048, then smaller
shards at D 5, 37, 200, 300 and 512): K11 (`som_neighborhood_accumulate`)
on inputs from seed 8, its ms and the SHA-256 of acc and wsum, and K11 then
K12 (`som_blend_winner` on the shard's rows, the next batch B' = B) as the
mixed step runs them, the SHA-256 of the codebook, values and winners
("k11_k12_digest").  For each group case (map, topology, neighbourhood, B,
D, K, radius: e2e_64x64_1M's group, chip_smoke.py's 32x32 and 128x64 at D
128, D 5, a ragged D 37 with 99 rows and D 129): K7 (`som_vmem_train_steps`,
K steps, per-sample alphas and a decaying radius, next_first given) on
inputs from seed 7, the SHA-256 of its codebook and bmu_next at the tree's
pick ("k7_digest") and at each cluster size of K7's walk ("k7_c1", ...:
`ops.som_vmem.K7_CLUSTER`; "not runnable" on a tree without it, whose "k7"
digests are the mma.sync kernel's, and at a size whose grid the card cannot
hold), its ms, and beside it the K chained K3 steps' digest and ms
("k3_chain"): one K7 launch against K chained launches of K3's walk.  Run
it in two checkouts in one call
(parent, change, change, parent) and compare: equal digests mean the same
floats.  Prints one JSON line.  `device="cpu"` runs the plain versions,
timed by the host clock (a CPU time, never a device number).

`--walk-variants` (a card and nvcc): where the Hopper walk of K3, K13, K6,
K5, K11, K17 and K14's main form spends its time.  Copies of csrc/ with the walk's sources
edited (`walk_variant_sources`, `k13_variant_sources`) are built by nvcc
into `som_lvq_pak_torch/_build/step_ab/` (git-ignored) and timed in turns,
K3 at 256x256, B 4096, D 64 (gaussian, hexa, radius 64), whole and with
each contraction nearly alone (B' 64: the update; B 32: the winners), K13
at its main-path shape, 128x128, B 1024, D 64 (gaussian, hexa, radius 32),
K6 at the masked 1M cell's step (K3's shape, p 0.1), K5 at K3's shape, K11
at the mixed mesh step's shard (rows 32768.. of the 256x256 map, B 2048, D
64) and K17 at its bench shape:

* `walk`: the source as it is;
* `no_w`: K3's, K5's, K6's and K11's W value replaced by the sample's alpha
  (no grid distance, no division, no expf; the table read and every
  product stay); K13's table entries replaced by 1 (no table read from L2;
  the products stay);
* `no_feed`: the producer loads each phase's first ring-full of chunks and
  only arms the barriers after, so the products read stale slots: the L2
  feed alone removed (K5's, K6's and K11's producer, `produce_slab`, takes
  the same edit as K3's);
* `no_fold`: K3's and K13's winner fold (their call of fused_step_sm90.cuh's
  argmin_fold) cut to a sum of the scores folded once a chunk (a product
  whose sums nothing reads would be dropped by ptxas, so the sums stay
  read);
* `no_turns`: the two consumer warpgroups issue their products without
  taking turns.

K7's walk (`som_vmem_steps_sm90.cu`, at e2e_64x64_1M's group: 4096 rows, B
512, D 64, K 32, at its pick and at cluster 1) and K12's (`som_blend_winner_sm90.cu`, at
the mixed mesh step's shard: 32768 rows, B' 2048, D 64) take the same
header edits (`no_w`: K7's W; `no_feed`: K12's producer, the header's
`produce`; `no_turns`: both) and their own fold edits (`no_fold`); K7 one
more copy, `no_barrier` (`k7_variant_sources`): no grid barrier between
steps and no wait for one in its producer, so each CTA runs its K steps on
stale tables and keys.  K7's `no_feed` is its walk (its producer is its
own), not timed.

K5, K6 and K11 have no fold: their `no_fold` is their walk, not timed.
Beside them one more copy, `slab64` (`slab_variant_source`): K5 and K11 with
the slab of 64 features past D 64 instead of 128, timed against `walk` on K5
at 256x256, B 4096, D 300 (five slabs of 64 against three of 128) and held
to it bit for bit: the sums do not depend on the slab width.

K14's main form (`k14_variant_sources`, edits of csrc/separable_sm90.cuh
built with K14's two sources alone) at the trainer's 64x64 step (hexa
gaussian, B 4096, both bf16 options), 32x32 and 128x128, each at cluster
sizes 1 and the wrapper's pick: `walk`, `no_w` (its table reads replaced by
1, K13's no_w) and `no_exchange` (no cluster barrier and no distributed
shared-memory read: each rank blends its own partial sums).  Then the
cluster sweep (`K14_SWEEP`, `cluster_sweep`): K14's walk kernel alone at
every cluster size, its device time per launch under torch.profiler (the
table launch, the prologue and the host's floor left out), at the trainer's
K14 maps 32x32, 64x32 and 64x64 and at 128x128 (hexa gaussian, B 4096, D
64), each with both bf16 options, with neither, and with both on a bf16
codebook, beside the wrapper's pick: the readings `ops.som_step.k14_cluster`
is set from.

Wrong results on purpose, except `walk`'s, which must equal the wrapper's
(checked).  Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys

import torch

from .. import _build
from ..ops.dist_argmin import dist_argmin, dist_argmin_plain
from ..ops.dist_top2 import dist_top2
from ..ops import som_step
from ..ops.dist_topk import dist_topk, dist_topk_reference
from ..ops.skeleton import fused_step_skeleton
from ..ops.som_accum import som_neighborhood_accumulate
from ..ops.som_blend import som_blend_winner
from ..ops.som_step import (som_fused_factored_chunked_step, som_fused_factored_step,
                            som_fused_train_step)
from ..ops import som_vmem
from ..ops.som_update import som_neighborhood_update_idx
from ..ops.som_vmem import som_vmem_train_steps
from .timing import mean_ms, resolve

# (xdim, ydim, hexa, gaussian, B, D, radius, K13 too): the 1M cell's step,
# K13's main-path shapes, and K3's D 5, ragged D 37 and D 200 cases, then D
# 300 and 512 (the feature passes: a full slab and a ragged one, two full
# ones); K14 runs where K13 does and B is a multiple of 128 (its batch chunk)
CASES = ((256, 256, True, True, 4096, 64, 64.0, False),
         (128, 128, True, True, 1024, 64, 32.0, True),
         (64, 64, True, True, 512, 64, 16.0, True),
         (256, 256, True, True, 1024, 64, 64.0, True),
         (64, 64, True, False, 4096, 64, 16.0, True),
         (12, 8, True, False, 1000, 5, 3.0, True),
         (10, 6, True, True, 100, 37, 3.0, True),
         (16, 16, False, True, 256, 200, 4.0, True),
         (16, 16, True, True, 256, 300, 4.0, True),
         (16, 16, True, False, 256, 512, 4.0, True))


# (B, N, D) of the winner walks: the LVQ step, the masked 1M cell's step,
# the sharded lvq3 rank's step, the masked LVQ cell's step, a ragged D 37 and
# D 130 (64-feature slabs)
WINNER_CASES = ((1024, 65536, 64), (4096, 65536, 64), (512, 32768, 64), (1024, 4096, 64),
                (777, 3001, 37), (1000, 2999, 130))


# (xdim, ydim, hexa, gaussian, B, D, radius) of K5 and K6: chip_smoke.py's
# update cases (the masked 1M cell's step, the 128x128 step, a rect bubble
# map, D 5, a ragged map at D 37, D 200), then D 300, 512 and 1024
UPDATE_CASES = ((256, 256, True, True, 4096, 64, 64.0),
                (128, 128, True, True, 1024, 64, 32.0),
                (12, 8, False, False, 1024, 64, 3.0),
                (12, 8, True, False, 1000, 5, 3.0),
                (10, 6, True, True, 100, 37, 3.0),
                (16, 16, False, True, 256, 200, 4.0),
                (16, 16, True, True, 256, 300, 4.0),
                (16, 16, True, True, 256, 512, 4.0),
                (16, 16, True, False, 256, 1024, 4.0))


# (xdim, ydim, hexa, gaussian, n_local, unit offset, B, D, radius) of K11
# and K11 then K12: the mixed mesh step's shard (rows 32768.. of the
# 256x256 map, B 4096 over a data axis of 2), chip_smoke.py's other
# geometries at a small shard (a rect bubble map, hexa bubble), a ragged
# shard at D 5 and 37, then D 200, 300 and 512 (chip_smoke.py's wide cases)
ACCUM_CASES = ((256, 256, True, True, 32768, 32768, 2048, 64, 64.0),
               (16, 16, False, False, 128, 128, 1024, 64, 3.0),
               (16, 16, True, False, 96, 64, 1000, 64, 3.0),
               (12, 8, True, False, 40, 48, 1000, 5, 3.0),
               (10, 6, True, True, 24, 32, 100, 37, 3.0),
               (32, 32, True, True, 512, 512, 512, 200, 8.0),
               (32, 32, True, True, 512, 512, 512, 300, 8.0),
               (32, 32, True, True, 512, 512, 512, 512, 8.0))


# (xdim, ydim, hexa, gaussian, B, D, K, radius) of K7: e2e_64x64_1M's
# group, chip_smoke.py's 32x32 and 128x64 at D 128, D 5, a ragged D 37 with
# 99 rows, and D 129 (the mma.sync kernel)
VMEM_CASES = ((64, 64, True, True, 512, 64, 32, 16.0),
              (32, 32, True, True, 256, 128, 8, 4.0),
              (128, 64, True, True, 512, 128, 8, 6.0),
              (12, 8, True, False, 128, 5, 16, 3.0),
              (11, 9, False, True, 100, 37, 9, 2.5),
              (32, 32, True, True, 256, 129, 4, 4.0))
K7_CLUSTERS = (1, 2, 4)


# (N, D, T, B, B' or None for x' = x, bf16) of K17: bench.py's twins of the
# headline steps (B 4096 float32, B 8192 bf16), then ragged shapes with an x'
# of their own at D 37 and 5, both types
SKELETON_CASES = ((65536, 64, 256, 4096, None, False), (65536, 64, 256, 8192, None, True),
                  (1000, 37, 100, 333, 257, False), (1000, 37, 100, 333, 257, True),
                  (777, 5, 64, 1000, 999, False), (777, 5, 64, 1000, 999, True))


def _k3(*a, **kw):
    return som_fused_train_step(*a, factored=False, **kw)


def _k14_bf16(*a):
    return som_fused_factored_chunked_step(*a, batch_bf16=True)


def _k14_at(c, **kw):
    """K14's main form with each tile's batch split across `c` CTAs; a tree
    without the split refuses it (ValueError)."""
    def step(*a):
        if not hasattr(som_step, "K14_CLUSTER"):
            raise ValueError("this tree's K14 takes no cluster")
        saved, som_step.K14_CLUSTER = som_step.K14_CLUSTER, c
        try:
            return som_fused_factored_chunked_step(*a, **kw)
        finally:
            som_step.K14_CLUSTER = saved
    return step


K14_CLUSTERS = (1, 2, 4, 8)


def kernels(B, k13) -> tuple:
    """The (name, step) pairs a case runs."""
    out = (("k3", _k3),)
    if k13:
        out += (("k13", som_fused_factored_step),)
    if k13 and B % 128 == 0:
        out += (("k14", som_fused_factored_chunked_step), ("k14_bf16", _k14_bf16))
        out += tuple((f"{name}_c{c}", _k14_at(c, batch_bf16=bb))
                     for name, bb in (("k14", False), ("k14_bf16", True))
                     for c in K14_CLUSTERS)
    return out


def _digest(ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        t = t.detach().contiguous().cpu()
        h.update((t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes())
    return h.hexdigest()


def run_case(xdim, ydim, hexa, gaussian, B, D, radius, k13, dev, iters=10) -> dict:
    """One case: ms and digest for each of `kernels(B, k13)`."""
    g = torch.Generator(device=dev).manual_seed(4)
    codes = torch.randn((xdim * ydim, D), generator=g, device=dev)
    xb = torch.randn((B, D), generator=g, device=dev)
    xn = torch.randn((B, D), generator=g, device=dev)
    bmu = dist_argmin_plain(xb, codes)[1]
    bmu[:7] = -1
    alpha = 0.02 + 0.06 * torch.rand((B,), generator=g, device=dev)
    out = dict(case=f"{xdim}x{ydim} {'hexa' if hexa else 'rect'} "
                    f"{'gaussian' if gaussian else 'bubble'} B {B} D {D}")
    args = (xb, bmu, xn, xdim, hexa, alpha, radius, gaussian)

    def digest(key, fn, *a, **kw):
        try:
            out[key] = _digest(fn(*a, **kw))
        except ValueError as e:  # a tree that refuses the shape
            out[key] = f"not runnable: {e}"
        return not out[key].startswith("not runnable")

    for name, fn in kernels(B, k13):
        if digest(f"{name}_digest", fn, codes.clone(), *args):
            work = codes.clone()
            out[f"{name}_ms"] = mean_ms(lambda: fn(work, *args), dev, iters)
        else:
            out[f"{name}_ms"] = out[f"{name}_digest"]
    # K3 (and K13) on a bf16 codebook, K3 as a model-axis shard (rows from
    # unit 64)
    digest("k3_digest_bf16", _k3, codes.to(torch.bfloat16), *args)
    if k13:
        digest("k13_digest_bf16", som_fused_factored_step, codes.to(torch.bfloat16), *args)
    digest("k3_digest_offset", _k3, codes.clone(), *args, unit_offset=64)
    return out


def _mask(g, B, D, dev):
    """Components masked with probability 0.1, every 97th row (the first
    included) masked whole."""
    mask = (torch.rand((B, D), generator=g, device=dev) < 0.1).to(torch.uint8)
    mask[::97] = 1
    return mask


def run_winners(B, N, D, dev, iters=10) -> dict:
    """One winner case: ms and digest of K4, K9, K8 and K10 at k 1, 2, 5, 8
    and 16."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((B, D), generator=g, device=dev)
    codes = torch.randn((N, D), generator=g, device=dev)
    mask = _mask(g, B, D, dev)
    out = dict(case=f"B {B} N {N} D {D}")
    for name, fn in (("k4", lambda: dist_argmin(x, codes, mask)),
                     ("k9", lambda: dist_top2(x, codes, mask)),
                     ("k8", lambda: dist_top2(x, codes)),
                     *((f"k10_k{k}", lambda k=k: dist_topk(x, codes, k))
                       for k in (1, 2, 5, 8, 16))):
        out[f"{name}_digest"] = _digest(fn())
        out[f"{name}_ms"] = mean_ms(fn, dev, iters)
    return out


# (B, N, D, every code twice) of K10 alone: D 5, 37, 64, 130 and 300 (its
# slabs past 64), N not a multiple of the walk's 128-code tile, exact ties
TOPK_CASES = ((1000, 999, 5, False), (1000, 998, 5, True), (777, 3002, 37, True),
              (512, 4001, 64, True), (1000, 2999, 130, False), (600, 1202, 300, True))


def run_topk(B, N, D, dup, dev) -> dict:
    """One top-k case: the digest of K10 at k 1, 2, 3, 5, 8 and 16 in file
    order ("k10_k3") and in the reference tie order ("k10_ref_k3")."""
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((B, D), generator=g, device=dev)
    if dup:
        base = torch.randn((N // 2, D), generator=g, device=dev)
        codes = torch.cat([base, base]).contiguous()
    else:
        codes = torch.randn((N, D), generator=g, device=dev)
    rev = codes.flip(0).contiguous()
    out = dict(case=f"topk B {B} N {codes.shape[0]} D {D}" + (" every code twice" if dup
                                                              else ""))
    for k in (1, 2, 3, 5, 8, 16):
        out[f"k10_k{k}_digest"] = _digest(dist_topk(x, codes, k))
        out[f"k10_ref_k{k}_digest"] = _digest(dist_topk_reference(x, rev, k))
    return out


def _update_inputs(xdim, ydim, B, D, dev):
    """An update case's inputs from seed 4, made as run_case makes its
    step's: (codes, xb, bmu, alpha, mask)."""
    g = torch.Generator(device=dev).manual_seed(4)
    codes = torch.randn((xdim * ydim, D), generator=g, device=dev)
    xb = torch.randn((B, D), generator=g, device=dev)
    bmu = dist_argmin_plain(xb, codes)[1]
    bmu[:7] = -1
    alpha = 0.02 + 0.06 * torch.rand((B,), generator=g, device=dev)
    return codes, xb, bmu, alpha, _mask(g, B, D, dev)


def run_update(xdim, ydim, hexa, gaussian, B, D, radius, dev, iters=10) -> dict:
    """One update case: ms and digest of K5 and K6 (K5's call with a
    mask)."""
    codes, xb, bmu, alpha, mask = _update_inputs(xdim, ydim, B, D, dev)
    out = dict(case=f"update {xdim}x{ydim} {'hexa' if hexa else 'rect'} "
                    f"{'gaussian' if gaussian else 'bubble'} B {B} D {D}")
    for name, m in (("k5", None), ("k6", mask)):
        def step(c):
            return som_neighborhood_update_idx(c, xb, bmu, xdim, hexa, alpha, radius,
                                               gaussian, mask=m)

        out[f"{name}_digest"] = _digest([step(codes.clone())])
        work = codes.clone()
        out[f"{name}_ms"] = mean_ms(lambda: step(work), dev, iters)
    return out


def _accum_inputs(xdim, ydim, n_local, offset, B, D, dev):
    """An accumulator case's inputs from seed 8: the shard's rows of the
    codebook, the batch, its global BMUs over the whole map (seven samples
    without one), per-sample alphas and the next batch."""
    g = torch.Generator(device=dev).manual_seed(8)
    codes = torch.randn((n_local, D), generator=g, device=dev)
    xb = torch.randn((B, D), generator=g, device=dev)
    bmu = torch.randint(0, xdim * ydim, (B,), generator=g, device=dev, dtype=torch.int32)
    bmu[:7] = -1
    alpha = 0.02 + 0.06 * torch.rand((B,), generator=g, device=dev)
    xn = torch.randn((B, D), generator=g, device=dev)
    return codes, xb, bmu, alpha, xn


def run_accum(xdim, ydim, hexa, gaussian, n_local, offset, B, D, radius, dev,
              iters=10) -> dict:
    """One accumulator case: ms and digest of K11, and the digest of K11
    then K12 on the shard (the mixed step's two halves on one data
    shard)."""
    codes, xb, bmu, alpha, xn = _accum_inputs(xdim, ydim, n_local, offset, B, D, dev)

    def k11():
        return som_neighborhood_accumulate(xb, bmu, n_local, xdim, hexa, alpha, radius,
                                           gaussian, unit_offset=offset)

    acc, wsum = k11()
    return dict(case=f"accum {xdim}x{ydim}[{offset}:{offset + n_local}] "
                     f"{'hexa' if hexa else 'rect'} {'gaussian' if gaussian else 'bubble'} "
                     f"B {B} D {D}",
                k11_digest=_digest([acc, wsum]), k11_ms=mean_ms(k11, dev, iters),
                k11_k12_digest=_digest(som_blend_winner(codes.clone(), acc, wsum, xn)))


def _vmem_inputs(xdim, ydim, B, D, K, radius, dev):
    """A group case's inputs from seed 7: (codes, batches, next_first, bmu0,
    per-sample alphas, a decaying radius)."""
    g = torch.Generator(device=dev).manual_seed(7)
    codes = torch.randn((xdim * ydim, D), generator=g, device=dev)
    xs = torch.randn((K, B, D), generator=g, device=dev)
    nf = torch.randn((B, D), generator=g, device=dev)
    bmu0 = dist_argmin_plain(xs[0], codes)[1]
    alphas = 0.005 * (0.5 + torch.rand((K, B), generator=g, device=dev))
    radii = torch.linspace(radius, max(1.0, radius / 2), K, device=dev)
    return codes, xs, nf, bmu0, alphas, radii


def _k7_at(c):
    """K7 with its walk's tiles split across `c` CTAs; a tree without the
    walk refuses it (ValueError)."""
    def run(*a, **kw):
        if not hasattr(som_vmem, "K7_CLUSTER"):
            raise ValueError("this tree's K7 takes no cluster")
        saved, som_vmem.K7_CLUSTER = som_vmem.K7_CLUSTER, c
        try:
            return som_vmem_train_steps(*a, **kw)
        except RuntimeError as e:  # a grid the card cannot hold at this size
            raise ValueError(str(e)) from e
        finally:
            som_vmem.K7_CLUSTER = saved
    return run


def run_vmem(xdim, ydim, hexa, gaussian, B, D, K, radius, dev, iters=10) -> dict:
    """One group case: digest and ms of K7 at the tree's pick and at each
    cluster size, and of K chained K3 steps."""
    codes, xs, nf, bmu0, alphas, radii = _vmem_inputs(xdim, ydim, B, D, K, radius, dev)
    rl = radii.tolist()
    out = dict(case=f"vmem {xdim}x{ydim} {'hexa' if hexa else 'rect'} "
                    f"{'gaussian' if gaussian else 'bubble'} B {B} D {D} K {K}")

    def k3_chain(c):
        bmu = bmu0
        for t in range(K):
            _, bmu, _ = _k3(c, xs[t], bmu, xs[t + 1] if t + 1 < K else nf, xdim, hexa,
                            alphas[t], rl[t], gaussian)
        return c, bmu

    steps = [("k7", som_vmem_train_steps)] + [(f"k7_c{c}", _k7_at(c)) for c in K7_CLUSTERS]
    for name, fn in steps:
        def k7(c, fn=fn):
            return fn(c, xs, bmu0, alphas, radii, xdim, hexa, gaussian, next_first=nf)
        try:
            out[f"{name}_digest"] = _digest(k7(codes.clone()))
        except ValueError as e:
            out[f"{name}_digest"] = out[f"{name}_ms"] = f"not runnable: {e}"
            continue
        work = codes.clone()
        out[f"{name}_ms"] = mean_ms(lambda: k7(work), dev, iters)
    out["k3_chain_digest"] = _digest(k3_chain(codes.clone()))
    work = codes.clone()
    out["k3_chain_ms"] = mean_ms(lambda: k3_chain(work), dev, max(1, iters // 2))
    return out


def _skeleton_inputs(N, D, T, B, Bn, bf16, dev):
    """bench.py:prep_skeleton's inputs: codes normal, W uniform * 0.001, X
    normal (all bf16 W and X for the bf16 twin); x' = X unless Bn is given."""
    g = torch.Generator(device=dev).manual_seed(6)
    dt = torch.bfloat16 if bf16 else torch.float32
    codes = torch.randn((N, D), generator=g, device=dev)
    w = (torch.rand((T, B), generator=g, device=dev) * 0.001).to(dt)
    x = torch.randn((B, D), generator=g, device=dev).to(dt)
    xn = x if Bn is None else torch.randn((Bn, D), generator=g, device=dev).to(dt)
    return codes, w, x, xn


def run_skeleton(N, D, T, B, Bn, bf16, dev, iters=10) -> dict:
    """One K17 case: the digest of (out, vmax) at scale 1.0 and the ms at
    1e-30."""
    codes, w, x, xn = _skeleton_inputs(N, D, T, B, Bn, bf16, dev)
    return dict(case=f"K17 {N}x{D} T {T} B {B} B' {xn.shape[0]} "
                     f"{'bf16' if bf16 else 'float32'}",
                k17_digest=_digest(fused_step_skeleton(codes, w, x, xn, 1.0)),
                k17_ms=mean_ms(lambda: fused_step_skeleton(codes, w, x, xn), dev, iters))


def run(iters: int = 10, device="cuda") -> dict:
    dev = resolve(device)
    return dict(device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                cases=[run_case(*c, dev=dev, iters=iters) for c in CASES],
                skeleton=[run_skeleton(*c, dev=dev, iters=iters) for c in SKELETON_CASES],
                winners=[run_winners(*c, dev=dev, iters=iters) for c in WINNER_CASES],
                topk=[run_topk(*c, dev=dev) for c in TOPK_CASES],
                updates=[run_update(*c, dev=dev, iters=iters) for c in UPDATE_CASES],
                accums=[run_accum(*c, dev=dev, iters=iters) for c in ACCUM_CASES],
                vmem=[run_vmem(*c, dev=dev, iters=iters) for c in VMEM_CASES])


# ---- --walk-variants: where K3's Hopper walk spends its time ------------------

VARIANT_OUT = os.path.join(_build.BUILD_DIR, "step_ab")
WALK_VARIANTS = ("walk", "no_w", "no_feed", "no_fold", "no_turns")
_W_LINES = ("          w[ks][q] = d2 <= r2 ? sm.z : 0.f;\n",
            "          w[ks][q] = sm.z * expf(__fmaf_rn(r1, rem, q0));\n",
            "          w[ks][q] = weight_of_d2(d2, sm.z, true, r2, den);\n")
_FEED_LINES = (("    sm90::mbar_arrive_expect_tx(&r.full[r.s], L::UPD);\n",
                "    if (c >= L::STAGES) {\n      sm90::mbar_arrive(&r.full[r.s]);\n"
                "      r.advance();\n      continue;\n    }\n"),
               ("      sm90::mbar_arrive_expect_tx(&r.full[r.s], L::WIN);\n",
                "      if (n * L::NSLAB + sl >= L::STAGES) {\n"
                "        sm90::mbar_arrive(&r.full[r.s]);\n        r.advance();\n"
                "        continue;\n      }\n"))
_TURN_LINES = (("__device__ __forceinline__ void await_turn(int wg) "
                "{ sm90::bar_sync(TURN + wg, ALL); }\n",
                "__device__ __forceinline__ void await_turn(int) {}\n"),
               ("__device__ __forceinline__ void pass_turn(int wg) "
                "{ sm90::bar_arrive(TURN + (wg ^ 1), ALL); }\n",
                "__device__ __forceinline__ void pass_turn(int) {}\n"))
_FOLD_START = "    argmin_fold(S, n0, m2s, keys, Bn, r0, warp, lane);\n"
_FOLD_END = "  });\n}\n"
_NO_FOLD = """    float v = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) v += S[i];
    fold_min_u64(keys + min(n0, Bn - 1), pack_key(v, r0), ~0ull, t == 0);
"""


def _no_fold(src: str, start: str = _FOLD_START, body: str = _NO_FOLD,
             end: str = _FOLD_END) -> str:
    """`src` with the fold call at `start` (through the end of its winner
    walk's lambda, `end`) cut to `body`."""
    i = src.index(start)
    return src[:i] + body + src[src.index(end, i):]


def walk_variant_sources(step_src: str, walk_src: str) -> dict:
    """{variant: (text of fused_step_sm90.cu, text of fused_step_sm90.cuh)}
    from the walk's two sources; raises ValueError if they no longer hold
    the lines edited here.  K3's, K5's, K6's and K11's W construction
    (ClosedFormW90) is the header's, so no_w edits the header; so are K3's
    producer and the slab walks' (produce_slab), which no_feed edits alike."""
    missing = [s for s in (_FOLD_START, _FOLD_END) if s not in step_src]
    missing += [a for a in _W_LINES if a not in walk_src]
    missing += [a for a, _ in _FEED_LINES + _TURN_LINES if a not in walk_src]
    if missing:
        raise ValueError(f"the walk lacks the lines the variants edit: {missing}")
    no_w = walk_src
    for line in _W_LINES:
        no_w = no_w.replace(line, "          w[ks][q] = sm.z;\n")
    no_feed = walk_src
    for a, guard in _FEED_LINES:
        no_feed = no_feed.replace(a, guard + a)
    no_turns = walk_src
    for a, b in _TURN_LINES:
        no_turns = no_turns.replace(a, b)
    no_fold = _no_fold(step_src)
    return {"walk": (step_src, walk_src), "no_w": (step_src, no_w),
            "no_feed": (step_src, no_feed), "no_fold": (no_fold, walk_src),
            "no_turns": (step_src, no_turns)}


_K13_W_LINE = ("        const float wx = __ldg(pat + po[h] + s), "
               "wy = __ldg(ytab + yo[h] + s);\n")
# the separable walk's fold (K13's and K14's: a rank's share starts at chunk w0)
_K13_FOLD = "    argmin_fold(S, w0 * WC + n0, m2s, keys, Bn, r0, warp, lane);\n"


def k13_variant_sources(k13_src: str, walk_texts: dict) -> dict:
    """{variant: text of separable_sm90.cuh, K13's and K14's walk} for each
    of WALK_VARIANTS, beside `walk_variant_sources`'s texts (whose header
    edits, no_feed and no_turns, K13's walk shares): no_w reads no table,
    no_fold folds as K3's no_fold; raises ValueError if the source no longer
    holds the lines edited here."""
    missing = [s for s in (_K13_W_LINE, _K13_FOLD) if s not in k13_src]
    if missing:
        raise ValueError(f"K13's walk lacks the lines the variants edit: {missing}")
    assert tuple(walk_texts) == WALK_VARIANTS
    i = k13_src.index(_K13_FOLD)
    no_fold = k13_src[:i] + _NO_FOLD + k13_src[i + len(_K13_FOLD):]
    return {name: {"no_w": k13_src.replace(_K13_W_LINE,
                                           "        const float wx = 1.f, wy = 1.f;\n"),
                   "no_fold": no_fold}.get(name, k13_src) for name in WALK_VARIANTS}


# K14's main form's variants: edits of csrc/separable_sm90.cuh, its
# W from the same table reads as K13's (no_w takes K13's edit), and the
# cluster exchange (no_exchange: no cluster barrier, in the consumers or the
# producer, and no partial read from another rank)
K14_VARIANTS = ("walk", "no_w", "no_exchange")
_EXCHANGE_LINES = (("  sm90::cluster_sync();\n", ""),
                   ("      sm90::cluster_sync_thread();\n", ""),
                   ("    sm90::cluster_sync_thread();\n", ""),
                   ("  for (int r = 0; r < nc; ++r) {\n", "  for (int r = 0; r < 0; ++r) {\n"))


def k14_variant_sources(k14_src: str) -> dict:
    """{variant: text of separable_sm90.cuh} for each of
    K14_VARIANTS; raises ValueError if the header no longer holds the lines
    edited here."""
    missing = [a for a in (_K13_W_LINE,) + tuple(a for a, _ in _EXCHANGE_LINES)
               if a not in k14_src]
    if missing:
        raise ValueError(f"K14's walk lacks the lines the variants edit: {missing}")
    no_exchange = k14_src
    for a, b in _EXCHANGE_LINES:
        no_exchange = no_exchange.replace(a, b)
    return {"walk": k14_src,
            "no_w": k14_src.replace(_K13_W_LINE, "        const float wx = 1.f, wy = 1.f;\n"),
            "no_exchange": no_exchange}


# K7's walk: its fold (a rank's share starts at chunk w0, into the step's
# key buffer kn), its grid barrier's thread-0 block and its producer's wait
# for the barrier's generation
_K7_FOLD = "      argmin_fold(S, w0 * WC + n0, m2s, kn, B, r0, warp, lane);\n"
_K7_FOLD_END = "    });\n"
_K7_NO_FOLD = """      float v = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) v += S[i];
      fold_min_u64(kn + min(w0 * WC + n0, B - 1), pack_key(v, r0), ~0ull, t == 0);
"""
_K7_BARRIER_LINES = (("  if (threadIdx.x == 0) {\n    volatile unsigned int* vgen = bar + 1;\n",
                      "  if (false) {\n    volatile unsigned int* vgen = bar + 1;\n"),
                     ("    if (s > 0) {  // the grid barrier of step s - 1 passed\n",
                      "    if (false) {  // the grid barrier of step s - 1 passed\n"))


def k7_variant_sources(k7_src: str) -> dict:
    """{variant: text of som_vmem_steps_sm90.cu} for each of WALK_VARIANTS
    (the header's edits are `walk_variant_sources`'s; no_fold cuts K7's
    fold as K3's) and `no_barrier`; raises ValueError if the source no
    longer holds the lines edited here."""
    missing = [a for a in (_K7_FOLD, _K7_FOLD_END)
               + tuple(a for a, _ in _K7_BARRIER_LINES) if a not in k7_src]
    if missing:
        raise ValueError(f"K7's walk lacks the lines the variants edit: {missing}")
    no_barrier = k7_src
    for a, b in _K7_BARRIER_LINES:
        no_barrier = no_barrier.replace(a, b)
    out = {name: k7_src for name in WALK_VARIANTS}
    out["no_fold"] = _no_fold(k7_src, _K7_FOLD, _K7_NO_FOLD, _K7_FOLD_END)
    out["no_barrier"] = no_barrier
    return out


def k12_variant_sources(k12_src: str) -> dict:
    """{variant: text of som_blend_winner_sm90.cu} for each of WALK_VARIANTS:
    no_fold cuts its fold as K3's (the same call); the header's edits are
    `walk_variant_sources`'s; raises ValueError if the source no longer
    holds the lines edited here."""
    if _FOLD_START not in k12_src or _FOLD_END not in k12_src:
        raise ValueError("K12's walk lacks the fold the no_fold variant edits")
    out = {name: k12_src for name in WALK_VARIANTS}
    out["no_fold"] = _no_fold(k12_src)
    return out


_SLAB_LINE = ("__host__ __device__ constexpr int update_slab(int D) "
              "{ return D <= 32 ? 32 : D <= 64 ? 64 : 128; }\n")


def slab_variant_source(walk_src: str) -> str:
    """The text of fused_step_sm90.cuh with K5's and K11's slab of 64
    features past D 64 (`slab64`) instead of 128; raises ValueError if the
    header no longer holds the line edited here."""
    if _SLAB_LINE not in walk_src:
        raise ValueError("the walk lacks the slab rule the slab64 variant edits")
    return walk_src.replace(_SLAB_LINE, _SLAB_LINE.replace("D <= 64 ? 64 : 128", "64"))


_WALK_ENTRIES = ("somvq_som_fused_step_sm90", "somvq_fused_skeleton_sm90",
                 "somvq_som_fused_factored_sm90", "somvq_som_update_masked",
                 "somvq_som_update", "somvq_som_accum", "somvq_som_vmem_steps_sm90",
                 "somvq_vmem_sm90_clusters", "somvq_som_blend_winner_sm90")
# (som_vmem_steps.cu: the mma.sync K7, whose shared-memory count the walk's
# source calls)
_WALK_SOURCES = ("fused_step_sm90.cu", "fused_skeleton_sm90.cu", "som_fused_factored_sm90.cu",
                 "som_update_masked_sm90.cu", "som_update_sm90.cu", "som_accum_sm90.cu",
                 "som_vmem_steps_sm90.cu", "som_vmem_steps.cu", "som_blend_winner_sm90.cu")
# K7's no_barrier library: its walk alone
_K7_SOURCES = ("som_vmem_steps_sm90.cu", "som_vmem_steps.cu")
# slab64's library: K5 and K11 alone
_SLAB_SOURCES = ("som_update_sm90.cu", "som_accum_sm90.cu")
# K14's variants' library: its two sources, which hold its C entry
_K14_SOURCES = ("som_fused_chunked_sm90_f32.cu", "som_fused_chunked_sm90_bf16.cu")
_ENTRIES = {_WALK_SOURCES: _WALK_ENTRIES, _SLAB_SOURCES: ("somvq_som_update", "somvq_som_accum"),
            _K14_SOURCES: ("somvq_som_fused_chunked_sm90",),
            _K7_SOURCES: ("somvq_som_vmem_steps_sm90", "somvq_vmem_sm90_clusters")}


def build_variants(out: str = VARIANT_OUT) -> dict:
    """Each variant's copy of csrc/ built into a library of K3's, K13's,
    K17's, K6's, K5's, K11's, K7's and K12's walks, K7's no_barrier
    ("k7_no_barrier") of K7's alone, slab64's of K5's and K11's, and
    K14's ("k14_walk", "k14_no_w", "k14_no_exchange") of K14's main form, by
    one nvcc each, all started together; {variant: library}."""
    read = lambda f: open(os.path.join(_build.CSRC, f)).read()  # noqa: E731
    walk = read("fused_step_sm90.cuh")
    texts = walk_variant_sources(read("fused_step_sm90.cu"), walk)
    separable = read("separable_sm90.cuh")
    k13 = k13_variant_sources(separable, texts)
    k7 = k7_variant_sources(read("som_vmem_steps_sm90.cu"))
    k12 = k12_variant_sources(read("som_blend_winner_sm90.cu"))
    copies = {name: ({"fused_step_sm90.cu": step_src, "fused_step_sm90.cuh": walk_src,
                      "separable_sm90.cuh": k13[name], "som_vmem_steps_sm90.cu": k7[name],
                      "som_blend_winner_sm90.cu": k12[name]}, _WALK_SOURCES)
              for name, (step_src, walk_src) in texts.items()}
    copies["k7_no_barrier"] = ({"som_vmem_steps_sm90.cu": k7["no_barrier"]}, _K7_SOURCES)
    copies["slab64"] = ({"fused_step_sm90.cuh": slab_variant_source(walk)}, _SLAB_SOURCES)
    for name, text in k14_variant_sources(separable).items():
        copies[f"k14_{name}"] = ({"separable_sm90.cuh": text}, _K14_SOURCES)
    nvcc, procs = _build._nvcc(), []
    for name, (edits, sources) in copies.items():
        d = os.path.join(out, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        for f, text in edits.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        procs.append(_build._start([nvcc, *_build.NVCC_FLAGS, "-shared", "-o",
                                    os.path.join(d, "lib.so"),
                                    *(os.path.join(d, f) for f in sources)],
                                   os.path.join(d, "nvcc.log")))
    _build._wait(procs)
    libs = {}
    for name, (_, sources) in copies.items():
        lib = ctypes.CDLL(os.path.join(out, name, "lib.so"))
        for entry in _ENTRIES[sources]:
            fn = getattr(lib, entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _k3_call(lib, codes, xb, bmu, xn, xdim, hexa, alpha, radius, gaussian):
    """K3's C call on a variant's library, as ops.som_step's wrapper makes
    it: (codes, idx, val)."""
    from ..ops.som_step import sm90_scratch

    dev = codes.device
    B, Bn, D = xb.shape[0], xn.shape[0], codes.shape[1]
    xs = sm90_scratch(B, Bn, D, dev)
    keys = torch.empty((Bn,), dtype=torch.int64, device=dev)
    val = torch.empty((Bn,), dtype=torch.float32, device=dev)
    idx = torch.empty((Bn,), dtype=torch.int32, device=dev)
    rc = lib.somvq_som_fused_step_sm90(
        codes.data_ptr(), int(codes.dtype == torch.bfloat16), codes.shape[0], D,
        xb.data_ptr(), bmu.data_ptr(), alpha.data_ptr(), B, xn.data_ptr(), Bn, xdim,
        int(hexa), int(gaussian), float(radius), 0, xs.data_ptr(), keys.data_ptr(),
        val.data_ptr(), idx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"somvq_som_fused_step_sm90: CUDA error {rc}")
    return codes, idx, val


def _k13_call(lib, codes, xb, bmu, xn, xdim, hexa, alpha, radius, gaussian):
    """K13's C call on a variant's library, as ops.som_step's wrapper makes
    it for D <= 128 (the walk): (codes, idx, val)."""
    from ..ops.som_step import sm90_scratch

    dev = codes.device
    noc, D = codes.shape
    B, Bn = xb.shape[0], xn.shape[0]
    n_pat, ld = (2 * xdim if hexa else xdim), -(-B // 64) * 64  # the walk's padded rows
    words = [2 * Bn, ld, -(-noc // xdim) * ld]  # keys, alpha, y-factor; then the pattern
    scratch = torch.empty((sum(words) + n_pat * ld,), dtype=torch.float32, device=dev)
    keys, aw, ytab, pat = (scratch.data_ptr() + 4 * sum(words[:k]) for k in range(4))
    xs = sm90_scratch(B, Bn, D, dev, table=False)
    val = torch.empty((Bn,), dtype=torch.float32, device=dev)
    idx = torch.empty((Bn,), dtype=torch.int32, device=dev)
    rc = lib.somvq_som_fused_factored_sm90(
        codes.data_ptr(), int(codes.dtype == torch.bfloat16), noc, D, xb.data_ptr(),
        bmu.data_ptr(), alpha.data_ptr(), B, xn.data_ptr(), Bn, xdim, int(hexa),
        int(gaussian), float(radius), xs.data_ptr(), pat, ytab, aw, keys, val.data_ptr(),
        idx.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"somvq_som_fused_factored_sm90: CUDA error {rc}")
    return codes, idx, val


def _k14_call(lib, codes, xb, bmu, xn, xdim, hexa, alpha, radius, gaussian, cluster,
              wxa_bf16=True, batch_bf16=True):
    """K14's main form's C call on a variant's library, as ops.som_step's
    wrapper makes it for D <= 128 (the walk, both bf16 options by default):
    (codes, idx, val)."""
    from ..ops.som_step import sm90_scratch

    dev = codes.device
    noc, D = codes.shape
    B, Bn = xb.shape[0], xn.shape[0]
    n_pat, ld = (2 * xdim if hexa else xdim), -(-B // 64) * 64
    words = [2 * Bn, ld, -(-noc // xdim) * ld]
    scratch = torch.empty((sum(words) + n_pat * ld,), dtype=torch.float32, device=dev)
    keys, aw, ytab, pat = (scratch.data_ptr() + 4 * sum(words[:k]) for k in range(4))
    xs = sm90_scratch(B, Bn, D, dev, 1 if batch_bf16 else 2, table=False)
    val = torch.empty((Bn,), dtype=torch.float32, device=dev)
    idx = torch.empty((Bn,), dtype=torch.int32, device=dev)
    rc = lib.somvq_som_fused_chunked_sm90(
        codes.data_ptr(), int(codes.dtype == torch.bfloat16), noc, D, xb.data_ptr(),
        bmu.data_ptr(), alpha.data_ptr(), B, xn.data_ptr(), Bn, xdim, int(hexa),
        int(gaussian), float(radius), int(wxa_bf16), int(batch_bf16), cluster, xs.data_ptr(),
        pat, ytab, aw, keys, val.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"somvq_som_fused_chunked_sm90: CUDA error {rc}")
    return codes, idx, val


def _k6_call(lib, codes, xb, bmu, mask, xdim, hexa, alpha, radius, gaussian):
    """K6's C call on a variant's library, as ops.som_update's wrapper makes
    it: the codebook, updated in place."""
    from ..ops.som_update import k6_scratch

    dev = codes.device
    B, D = xb.shape
    xs = k6_scratch(B, D, dev)
    rc = lib.somvq_som_update_masked(
        codes.data_ptr(), codes.shape[0], D, xb.data_ptr(), mask.data_ptr(), bmu.data_ptr(),
        alpha.data_ptr(), B, xdim, int(hexa), int(gaussian), float(radius), xs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"somvq_som_update_masked: CUDA error {rc}")
    return codes


def _k5_call(lib, codes, xb, bmu, xdim, hexa, alpha, radius, gaussian):
    """K5's C call on a variant's library, as ops.som_update's wrapper makes
    it: the codebook, updated in place."""
    from ..ops.som_update import update_scratch

    dev = codes.device
    B, D = xb.shape
    xs = update_scratch(B, D, dev)
    rc = lib.somvq_som_update(
        codes.data_ptr(), codes.shape[0], D, xb.data_ptr(), bmu.data_ptr(), alpha.data_ptr(),
        B, xdim, int(hexa), int(gaussian), float(radius), xs.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"somvq_som_update: CUDA error {rc}")
    return codes


def _k11_call(lib, xb, bmu, n_local, xdim, hexa, alpha, radius, gaussian, unit_offset):
    """K11's C call on a variant's library, as ops.som_accum's wrapper makes
    it: (acc, wsum)."""
    from ..ops.som_update import update_scratch

    dev = xb.device
    B, D = xb.shape
    xs = update_scratch(B, D, dev)
    acc = torch.empty((n_local, D), dtype=torch.float32, device=dev)
    wsum = torch.empty((n_local, 1), dtype=torch.float32, device=dev)
    rc = lib.somvq_som_accum(
        n_local, D, xb.data_ptr(), bmu.data_ptr(), alpha.data_ptr(), B, xdim, int(hexa),
        int(gaussian), float(radius), unit_offset, xs.data_ptr(), acc.data_ptr(),
        wsum.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"somvq_som_accum: CUDA error {rc}")
    return acc, wsum


def _k7_call(lib, codes, xs, nf, bmu0, alphas, radii, xdim, hexa, gaussian, cluster):
    """K7's walk's C call on a variant's library, as ops.som_vmem's wrapper
    makes it for D <= 128: (codes, bmu_next)."""
    from ..ops.som_step import sm90_width

    dev = codes.device
    (noc, D), (K, B) = codes.shape, xs.shape[:2]
    scratch = torch.empty((4 * K * -(-B // 64) * 64 * sm90_width(D),), dtype=torch.float32,
                          device=dev)
    keys = torch.empty((3 * B,), dtype=torch.int64, device=dev)
    bar = torch.zeros((2,), dtype=torch.int32, device=dev)
    bmu = torch.empty((B,), dtype=torch.int32, device=dev)
    rc = lib.somvq_som_vmem_steps_sm90(
        codes.data_ptr(), noc, D, xs.data_ptr(), K, B, bmu0.data_ptr(), alphas.data_ptr(),
        radii.data_ptr(), nf.data_ptr(), xdim, int(hexa), int(gaussian), cluster,
        scratch.data_ptr(), keys.data_ptr(), bar.data_ptr(), bmu.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"somvq_som_vmem_steps_sm90: CUDA error {rc}")
    return codes, bmu


def _k12_call(lib, codes, acc, wsum, xn):
    """K12's walk's C call on a variant's library, as ops.som_blend's
    wrapper makes it for D <= 128: (codes, val, idx)."""
    from ..ops.som_step import sm90_scratch

    dev = codes.device
    (n_local, D), Bn = codes.shape, xn.shape[0]
    xs = sm90_scratch(0, Bn, D, dev, table=False)
    keys = torch.empty((Bn,), dtype=torch.int64, device=dev)
    val = torch.empty((Bn,), dtype=torch.float32, device=dev)
    idx = torch.empty((Bn,), dtype=torch.int32, device=dev)
    rc = lib.somvq_som_blend_winner_sm90(
        codes.data_ptr(), n_local, D, acc.data_ptr(), wsum.data_ptr(), xn.data_ptr(), Bn,
        xs.data_ptr(), keys.data_ptr(), val.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"somvq_som_blend_winner_sm90: CUDA error {rc}")
    return codes, val, idx


def _k17_call(lib, codes, w, x, xn):
    """K17's C call on a variant's library at the bench's scale: (out, vmax)."""
    from ..ops.som_step import sm90_scratch

    dev = codes.device
    (N, D), Bn = codes.shape, xn.shape[0]
    bf16 = w.dtype == torch.bfloat16
    out = torch.empty_like(codes)
    vkeys = torch.zeros((Bn,), dtype=torch.int32, device=dev)
    vmax = torch.empty((Bn,), dtype=torch.float32, device=dev)
    xs = sm90_scratch(x.shape[0], Bn, D, dev, 1 if bf16 else 2, table=False)
    rc = lib.somvq_fused_skeleton_sm90(
        codes.data_ptr(), N, D, w.data_ptr(), w.shape[0], x.data_ptr(), x.shape[0],
        xn.data_ptr(), Bn, int(bf16), 1e-30, out.data_ptr(), vkeys.data_ptr(),
        vmax.data_ptr(), xs.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"somvq_fused_skeleton_sm90: CUDA error {rc}")
    return out, vmax


def run_variants(iters: int = 10, out: str = VARIANT_OUT) -> dict:
    """Build the walk's variants, hold `walk` to the wrapper, time them all
    in turns (walk, no_w, no_feed, no_fold, no_turns, and back); the
    record."""
    dev = resolve("cuda")
    libs = build_variants(out)
    g = torch.Generator(device=dev).manual_seed(4)
    xdim, hexa, radius, gaussian, B, D = 256, True, 64.0, True, 4096, 64
    codes = torch.randn((xdim * xdim, D), generator=g, device=dev)
    xb = torch.randn((B, D), generator=g, device=dev)
    xn = torch.randn((B, D), generator=g, device=dev)
    bmu = dist_argmin_plain(xb, codes)[1]
    bmu[:7] = -1
    alpha = 0.02 + 0.06 * torch.rand((B,), generator=g, device=dev)
    args = (xb, bmu, xn, xdim, hexa, alpha, radius, gaussian)
    matched = _digest(_k3_call(libs["walk"], codes.clone(), *args)) == _digest(
        _k3(codes.clone(), *args))
    order = list(WALK_VARIANTS) + list(WALK_VARIANTS)[::-1]
    ms = {}
    for label, b, bn in (("k3 256x256 B 4096 D 64", B, B), ("k3 update (B' 64)", B, 64),
                         ("k3 winners (B 32)", 32, B)):
        a = (xb[:b], bmu[:b], xn[:bn], xdim, hexa, alpha[:b], radius, gaussian)
        work = codes.clone()
        rec = {name: [] for name in WALK_VARIANTS}
        for name in order:
            rec[name].append(mean_ms(lambda: _k3_call(libs[name], work, *a), dev, iters))
        ms[label] = rec
    g = torch.Generator(device=dev).manual_seed(4)
    c13 = torch.randn((128 * 128, D), generator=g, device=dev)
    x13 = torch.randn((1024, D), generator=g, device=dev)
    n13 = torch.randn((1024, D), generator=g, device=dev)
    b13 = dist_argmin_plain(x13, c13)[1]
    a13 = (x13, b13, n13, 128, True, alpha[:1024], 32.0, True)
    matched13 = _digest(_k13_call(libs["walk"], c13.clone(), *a13)) == _digest(
        som_fused_factored_step(c13.clone(), *a13))
    work = c13.clone()
    rec = {name: [] for name in WALK_VARIANTS}
    for name in order:
        rec[name].append(mean_ms(lambda: _k13_call(libs[name], work, *a13), dev, iters))
    ms["k13 128x128 B 1024 D 64"] = rec
    # K6 at the masked 1M cell's step: K3's shape with a mask
    mask = _mask(g, B, D, dev)
    a6 = (xb, bmu, mask, xdim, hexa, alpha, radius, gaussian)
    matched6 = _digest([_k6_call(libs["walk"], codes.clone(), *a6)]) == _digest(
        [som_neighborhood_update_idx(codes.clone(), xb, bmu, xdim, hexa, alpha, radius,
                                     gaussian, mask=mask)])
    upd_names = ("walk", "no_w", "no_feed", "no_turns")
    rec = {name: [] for name in upd_names}
    work = codes.clone()
    for name in upd_names + upd_names[::-1]:
        rec[name].append(mean_ms(lambda: _k6_call(libs[name], work, *a6), dev, iters))
    ms["k6 256x256 B 4096 D 64 p 0.1"] = rec
    # K5 at K3's shape; K11 at the mixed mesh step's shard
    a5 = (xb, bmu, xdim, hexa, alpha, radius, gaussian)
    matched5 = _digest([_k5_call(libs["walk"], codes.clone(), *a5)]) == _digest(
        [som_neighborhood_update_idx(codes.clone(), *a5)])
    rec = {name: [] for name in upd_names}
    for name in upd_names + upd_names[::-1]:
        rec[name].append(mean_ms(lambda: _k5_call(libs[name], work, *a5), dev, iters))
    ms["k5 256x256 B 4096 D 64"] = rec
    a11 = (xb[:2048], bmu[:2048], 32768, xdim, hexa, alpha[:2048], radius, gaussian, 32768)
    matched11 = _digest(_k11_call(libs["walk"], *a11)) == _digest(
        som_neighborhood_accumulate(*a11[:-1], unit_offset=a11[-1]))
    rec = {name: [] for name in upd_names}
    for name in upd_names + upd_names[::-1]:
        rec[name].append(mean_ms(lambda: _k11_call(libs[name], *a11), dev, iters))
    ms["k11 256x256[32768:65536] B 2048 D 64"] = rec
    # K5's slab width past D 64: 128 (walk) against 64 (slab64), bit for bit
    c300 = torch.randn((xdim * xdim, 300), generator=g, device=dev)
    x300 = torch.randn((B, 300), generator=g, device=dev)
    a300 = (x300, bmu, xdim, hexa, alpha, radius, gaussian)
    slab_equal = _digest([_k5_call(libs["walk"], c300.clone(), *a300)]) == _digest(
        [_k5_call(libs["slab64"], c300.clone(), *a300)])
    rec = {name: [] for name in ("walk", "slab64")}
    for name in ("walk", "slab64", "slab64", "walk"):
        rec[name].append(mean_ms(lambda: _k5_call(libs[name], c300, *a300), dev, iters))
    ms["k5 256x256 B 4096 D 300 (slab 128 vs 64)"] = rec
    # K7's walk at e2e_64x64_1M's group (4096 rows, B 512, D 64, K 32) at its
    # pick and at cluster 1; K12's at the mixed mesh step's shard
    v = _vmem_inputs(64, 64, 512, 64, 32, 16.0, dev)
    a7 = (v[1], v[2], v[3], v[4].contiguous(), v[5], 64, True, True)
    pick7 = som_vmem.k7_rows(4096, 64, dev, 512)[1]
    matched7 = all(_digest(_k7_call(libs["walk"], v[0].clone(), *a7, c)) == _digest(
        _k7_at(c)(v[0].clone(), v[1], v[3], v[4], v[5], 64, True, True, next_first=v[2]))
        for c in sorted({1, pick7}))
    k7_names = ("walk", "no_w", "no_fold", "no_turns", "k7_no_barrier")
    for c in sorted({1, pick7}):
        rec = {name: [] for name in k7_names}
        work = v[0].clone()
        for name in k7_names + k7_names[::-1]:
            rec[name].append(mean_ms(lambda: _k7_call(libs[name], work, *a7, c), dev, iters))
        ms[f"k7 64x64 B 512 D 64 K 32, cluster {c}"] = rec
    c12, xb12, bmu12, al12, xn12 = _accum_inputs(256, 256, 32768, 32768, 2048, 64, dev)
    acc12, wsum12 = som_neighborhood_accumulate(xb12, bmu12, 32768, 256, True, al12, 64.0,
                                                True, unit_offset=32768)
    matched12 = _digest(_k12_call(libs["walk"], c12.clone(), acc12, wsum12, xn12)) == _digest(
        som_blend_winner(c12.clone(), acc12, wsum12, xn12))
    k12_names = ("walk", "no_feed", "no_fold", "no_turns")
    rec = {name: [] for name in k12_names}
    for name in k12_names + k12_names[::-1]:
        work = c12.clone()
        rec[name].append(mean_ms(lambda: _k12_call(libs[name], work, acc12, wsum12, xn12),
                                 dev, iters))
    ms["k12 32768 rows B' 2048 D 64"] = rec
    sk = _skeleton_inputs(65536, 64, 256, 4096, None, False, dev)
    rec = {name: [] for name in ("walk", "no_feed", "no_turns")}
    for name in ("walk", "no_feed", "no_turns", "no_turns", "no_feed", "walk"):
        rec[name].append(mean_ms(lambda: _k17_call(libs[name], *sk), dev, iters))
    ms["k17 65536x64 B 4096 float32"] = rec
    # K14's main form at the trainer's maps (both bf16 options), at cluster 1
    # and at the wrapper's pick
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k14_names = tuple(f"k14_{name}" for name in K14_VARIANTS)
    matched14 = True
    for side, radius14 in ((64, 16.0), (32, 8.0), (128, 32.0)):
        g = torch.Generator(device=dev).manual_seed(4)
        c14 = torch.randn((side * side, D), generator=g, device=dev)
        x14 = torch.randn((B, D), generator=g, device=dev)
        n14 = torch.randn((B, D), generator=g, device=dev)
        b14 = dist_argmin_plain(x14, c14)[1]
        a14 = (x14, b14, n14, side, True, alpha, radius14, True)
        pick = som_step._k14_cluster_on(side * side, D, True, sms)
        matched14 = matched14 and _digest(
            _k14_call(libs["k14_walk"], c14.clone(), *a14, pick)) == _digest(
            _k14_at(pick, batch_chunk=1024, wxa_bf16=True, batch_bf16=True)(c14.clone(), *a14))
        for c in sorted({1, pick}):
            rec = {name: [] for name in k14_names}
            work = c14.clone()
            for name in k14_names + k14_names[::-1]:
                rec[name].append(mean_ms(lambda: _k14_call(libs[name], work, *a14, c), dev,
                                         iters))
            ms[f"k14 {side}x{side} B 4096 D 64 both bf16 options, cluster {c}"] = rec
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    return dict(card=card, walk_bit_equal_to_wrapper=(matched and matched13 and matched6
                                                       and matched5 and matched11
                                                       and matched14 and matched7
                                                       and matched12),
                slab64_bit_equal_to_walk=slab_equal, ms=ms,
                cluster_sweep=cluster_sweep(libs["k14_walk"], iters))


# (xdim, ydim, radius) of the cluster sweep: the trainer's K14 maps at B 4096
# (models.trainer's fused-step choice: 32x32, 64x32, 64x64), then 128x128;
# and its option sets (name, wxa_bf16, batch_bf16, bf16 codebook)
K14_SWEEP = ((32, 32, 8.0), (64, 32, 16.0), (64, 64, 16.0), (128, 128, 32.0))
K14_SWEEP_OPTIONS = (("both", True, True, False), ("neither", False, False, False),
                     ("both, bf16 codebook", True, True, True))


def cluster_sweep(lib, iters: int = 20) -> list:
    """K14's walk kernel (som_chunked_sm90_kernel) at each cluster size of
    K14_CLUSTERS, for each map of K14_SWEEP and option set of
    K14_SWEEP_OPTIONS: its mean device milliseconds per launch under
    torch.profiler, `iters` steps at each size in turns (1, 2, 4, 8, 8, 4, 2,
    1: two readings each), beside `ops.som_step.k14_cluster`'s and the
    wrapper's (occupancy-checked) pick; one record per map and option set."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = resolve("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B, D, out = 4096, 64, []
    order = list(K14_CLUSTERS) + list(K14_CLUSTERS)[::-1]
    for xdim, ydim, radius in K14_SWEEP:
        g = torch.Generator(device=dev).manual_seed(4)
        codes = torch.randn((xdim * ydim, D), generator=g, device=dev)
        xb = torch.randn((B, D), generator=g, device=dev)
        xn = torch.randn((B, D), generator=g, device=dev)
        bmu = dist_argmin_plain(xb, codes)[1]
        alpha = 0.02 + 0.06 * torch.rand((B,), generator=g, device=dev)
        a = (xb, bmu, xn, xdim, True, alpha, radius, True)
        for label, wxa, bb, bf16 in K14_SWEEP_OPTIONS:
            work = codes.to(torch.bfloat16) if bf16 else codes.clone()
            step = lambda c: _k14_call(lib, work, *a, c, wxa_bf16=wxa,  # noqa: E731
                                       batch_bf16=bb)
            for c in K14_CLUSTERS:  # warm-up
                step(c)
            torch.cuda.synchronize(dev)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for c in order:
                    for _ in range(iters):
                        step(c)
                torch.cuda.synchronize(dev)
            spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                           if e.device_type == DeviceType.CUDA
                           and "som_chunked_sm90_kernel" in e.name)
            if len(spans) != len(order) * iters:
                raise RuntimeError(f"cluster sweep: {len(spans)} walk launches traced, "
                                   f"{len(order) * iters} made")
            ms = {c: [] for c in K14_CLUSTERS}
            for i, c in enumerate(order):
                run = spans[i * iters:(i + 1) * iters]
                ms[c].append(sum(t1 - t0 for t0, t1 in run) / iters * 1e-3)
            out.append(dict(map=f"{xdim}x{ydim}", options=label, device_ms=ms,
                            rule=som_step.k14_cluster(-(-xdim * ydim // 128), sms),
                            pick=som_step._k14_cluster_on(xdim * ydim, D, bb, sms)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--walk-variants", action="store_true",
                    help="time the Hopper walks of K3, K13, K6, K5, K11, K17, K14's "
                         "main form, K7 and K12 against their variants instead")
    a = ap.parse_args(argv)
    if a.walk_variants:
        rec = run_variants(a.iters)
        print(json.dumps(rec), flush=True)
        return 0 if rec["walk_bit_equal_to_wrapper"] and rec["slab64_bit_equal_to_walk"] else 1
    print(json.dumps(run(a.iters, a.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
