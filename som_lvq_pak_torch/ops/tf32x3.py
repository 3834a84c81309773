"""A plain emulation of the split-TF32 ("3xTF32") products that K1-K13,
K14's main form, K16 and K17 run on the tensor cores
(csrc/tf32x3.cuh), for the tests and chip_smoke.py.  No main-path code calls
it.

A float32 operand a is split as hi = tf32(a), lo = tf32(a - hi), where
tf32() rounds to the nearest value with 10 mantissa bits, ties away from
zero, as `cvt.rna.tf32.f32` does; a product is lo*hi + hi*lo + hi*hi with
float32 accumulation, the small terms first.  The kernels accumulate in
their own order (k-steps of 8 inside the mma), so this emulation matches
them to float32 rounding, not bit for bit.

`som_fused_train_step_tf32x3`, `dist_argmin_t_tf32x3`, `dist_argmin_tf32x3`,
`dist_argmin_masked_tf32x3`, `som_update_masked_tf32x3`,
`som_neighborhood_accumulate_tf32x3`, `som_fused_factored_step_tf32x3`,
`som_fused_factored_chunked_step_tc`, `fused_step_skeleton_tf32x3`,
`f32_winner_probe_tf32x3`, `dist_top2_tf32x3`,
`som_vmem_train_steps_tf32x3`, `som_blend_winner_tf32x3`,
`dist_topk_tf32x3`, `dist_top2_masked_tf32x3` and `som_update_tf32x3` are
the plain K3, K2, K1, K4, K6, K11, K13, K14's main form, K17, K16, K8, K7,
K12, K10, K9 and K5 with their contractions through `tf32x3_mm` (K4's and
K9's keep.(m o m) and K6's weight mass through two products, the lo part
then the hi part, keep being exact in TF32; K14's under batch_bf16 and K17's
bf16 operands through one `tf32_mm` pass, a bf16 value being exact in TF32),
summed as the kernels sum: the numeric design the kernels implement, held to
the port's gates on the CPU.  K11 is K3's update half and K12 its blend and
winners: K11's sums of a row are the ones K3's emulation blends into that
row, and K12's emulation blending them gives K3's rows, winners and values,
bit for bit; K5 is K11 with the blend, so its rows are K3's too.  K8 and
K10 score as K1, K9 as K4, and K7 steps as K3, so their emulations are K1's
or K4's scoring with a second winner or k of them, and K chained K3 steps.

`split_batches_plain`, `split_sm90_plain` and `split_k6_plain` are the plain
versions of the prologues, the mma.sync steps' split batches, the Hopper
walk's (the update batch transposed, K3's per-sample table, `k3_table`; K5's
and K11's with no next batch) and K6's on the same walk (X o K split and K,
transposed, and K3's table), as they fill their scratch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .dist_argmin import split_codes_dp
from .distance import fp32_matmul, keep_of
from .som_step import _alpha_r, _bf16, guarded_blend, neighborhood_w, separable_w
from .som_vmem import chain_steps

# the batch chunk over which K3's and K6's updates sum in the mma before
# adding into float32 registers
CHUNK = 32


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 `t` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, on the float32 bits: add half of the 13 dropped bits'
    unit to the magnitude and clear them."""
    if t.dtype != torch.float32:
        raise TypeError("tf32_round takes float32")
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(t), lo = tf32(t - hi)."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One TF32 pass: tf32(a) @ tf32(b) in float32 (what a plain TF32
    matmul computes)."""
    fp32_matmul()
    return tf32_round(a) @ tf32_round(b)


def tf32x3_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) @ b (K, N) as the kernels take it: lo*hi + hi*lo + hi*hi,
    each TF32 x TF32 product exact in float32, float32 sums."""
    fp32_matmul()
    ahi, alo = tf32_split(a)
    bhi, blo = tf32_split(b)
    return (alo @ bhi + ahi @ blo) + ahi @ bhi


def chunk_sums(w: torch.Tensor, x: torch.Tensor, mm=tf32x3_mm) -> torch.Tensor:
    """W.X as the tensor-core updates sum it: per CHUNK-sample chunk through
    `mm`, each chunk's sums added into float32 totals in batch order."""
    acc = torch.zeros((w.shape[0], x.shape[1]), dtype=torch.float32, device=w.device)
    for s in range(0, x.shape[0], CHUNK):
        acc += mm(w[:, s:s + CHUNK], x[s:s + CHUNK])
    return acc


def _winners(newc, xn, mm=tf32x3_mm, rows=None):
    """The fused steps' winners in distance form: ||m||^2 - 2 x'.m with x'.m
    through `mm` (on `rows`, the rows as scored, if given), the first row on
    ties: (bmu_next int32, val_next)."""
    d_t = ((newc * newc).sum(1, keepdim=True)
           - 2.0 * mm(newc if rows is None else rows, xn.T))
    idx = torch.argmin(d_t, dim=0)
    return idx.to(torch.int32), d_t.gather(0, idx[None, :])[0]


def som_neighborhood_accumulate_tf32x3(xb, bmu, n_local, xdim, hexa, alpha,
                                       radius, gaussian=False, unit_offset=0):
    """The plain K11 (`som_neighborhood_accumulate_plain`) as the kernel sums:
    K3's update half, W at the global units unit_offset.., W.X by
    `chunk_sums`, the weight mass a float32 sum of the same W.  Returns (acc
    (n_local, D), wsum (n_local, 1))."""
    fp32_matmul()
    dev = xb.device
    aw, r = _alpha_r(alpha, radius, xb.shape[0], dev)
    units = unit_offset + torch.arange(n_local, dtype=torch.int32, device=dev)
    w = neighborhood_w(bmu.to(torch.int32), aw, r, units, xdim, hexa, gaussian)
    return chunk_sums(w, xb), w.sum(1, keepdim=True)


def som_update_tf32x3(codes, xb, bmu, xdim, hexa, alpha, radius, gaussian=False):
    """The plain K5 (`som_neighborhood_update_idx_plain` without a mask) as
    the kernel sums: K3's update half (`som_neighborhood_accumulate_tf32x3`
    on the whole map) then the guarded blend.  Returns the new float32
    codebook, K3's emulation's rows on the same winners bit for bit;
    `codes` is not changed."""
    acc, wsum = som_neighborhood_accumulate_tf32x3(xb, bmu, codes.shape[0], xdim,
                                                   hexa, alpha, radius, gaussian)
    return guarded_blend(codes.to(torch.float32), acc, wsum)


def som_fused_train_step_tf32x3(codes, xb, bmu, xb_next, xdim, hexa, alpha,
                                radius, gaussian=False, unit_offset=0):
    """The plain K3 (`som_fused_train_step_plain`) as the kernel sums: W.X by
    `chunk_sums`, the scores through `tf32x3_mm`; the weight mass stays a
    float32 sum of the same W.  Returns (the new float32 codebook, bmu_next
    int32, val_next); `codes` is not changed."""
    fp32_matmul()
    dev = codes.device
    aw, r = _alpha_r(alpha, radius, xb.shape[0], dev)
    units = (unit_offset or 0) + torch.arange(codes.shape[0], dtype=torch.int32,
                                              device=dev)
    w = neighborhood_w(bmu.to(torch.int32), aw, r, units, xdim, hexa, gaussian)
    newc = guarded_blend(codes.to(torch.float32), chunk_sums(w, xb),
                         w.sum(1, keepdim=True))
    return (newc, *_winners(newc, xb_next))


def som_blend_winner_tf32x3(codes, acc, wsum, xn):
    """The plain K12 (`som_blend_winner_plain`) as the kernel runs it: K3's
    emulation's second half, the guarded blend, then the winners in distance
    form with the scores through `tf32x3_mm` (`_winners`).  Returns (the new
    float32 rows, val (B',), local idx (B',) int32) in the wrapper's order;
    `codes` is not changed."""
    fp32_matmul()
    newc = guarded_blend(codes.to(torch.float32), acc, wsum)
    idx, val = _winners(newc, xn)
    return newc, val, idx


def dist_argmin_t_tf32x3(x: torch.Tensor, codes: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain K2 (`dist_argmin_t_plain`) with its scores x.m through
    `tf32x3_mm`: (sq_dists, int32 idx)."""
    m2h = 0.5 * (codes * codes).sum(-1)
    sc = tf32x3_mm(x, codes.T) - m2h[None, :]
    i = torch.argmax(sc, dim=1)
    x2 = (x * x).sum(-1)
    val = torch.clamp(-2.0 * sc.gather(1, i[:, None])[:, 0] + x2, min=0.0)
    return val, i.to(torch.int32)


def dist_argmin_tf32x3(x: torch.Tensor, codes: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain K1 (`dist_argmin_plain`) with its scores x.m through
    `tf32x3_mm`: (sq_dists, int32 idx).  Bit-equal to `dist_argmin_t_tf32x3`
    (halving and doubling are exact), as K1 is to K2 on the card."""
    m2 = (codes * codes).sum(-1)
    d = m2[None, :] - 2.0 * tf32x3_mm(x, codes.T)
    i = torch.argmin(d, dim=1)
    x2 = (x * x).sum(-1)
    val = torch.clamp(d.gather(1, i[:, None])[:, 0] + x2, min=0.0)
    return val, i.to(torch.int32)


def dist_top2_tf32x3(x: torch.Tensor, codes: torch.Tensor):
    """The plain K8 (`dist_top2_plain`) as the kernel scores: K8 is K10's
    kernel at k = 2, so this is `dist_topk_tf32x3` at k = 2 as (d1, i1, d2,
    i2), the two first minima of the partial distance (the lower index on
    ties).  Its first pair is `dist_argmin_tf32x3`'s bit for bit, as K8's is
    K1's on the card."""
    v, i = dist_topk_tf32x3(x, codes, 2)
    return v[:, 0], i[:, 0], v[:, 1], i[:, 1]


def dist_topk_tf32x3(x: torch.Tensor, codes: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain K10 (`dist_topk_plain`) with its scores x.m through
    `tf32x3_mm`, scored as `dist_argmin_tf32x3` scores: (sq_dists (B, k),
    int32 idx (B, k)), the k first minima of the partial distance in turn
    (the lower index on ties), each masked out by +inf once taken, then
    ||x||^2 added and clamped at 0.  Its column 0 is `dist_argmin_tf32x3`'s
    bit for bit, as K10's is K1's on the card."""
    m2 = (codes * codes).sum(-1)
    d = m2[None, :] - 2.0 * tf32x3_mm(x, codes.T)
    vals, idx = [], []
    for _ in range(k):
        i = torch.argmin(d, dim=1, keepdim=True)
        vals.append(d.gather(1, i))
        idx.append(i)
        d.scatter_(1, i, float("inf"))
    x2 = (x * x).sum(-1)[:, None]
    return (torch.clamp(torch.cat(vals, 1) + x2, min=0.0),
            torch.cat(idx, 1).to(torch.int32))


def _masked_scores(x, codes, mask):
    """K4's partial distances as its walk scores them: (x keep).m through
    `tf32x3_mm`, keep.(m o m) as keep.(m o m)_lo + keep.(m o m)_hi (keep is
    exact in TF32), d = keep.(m o m) - 2 (x keep).m (B, N); and ||x keep||^2
    (B,)."""
    fp32_matmul()
    keep = keep_of(mask)
    xk = x * keep
    qhi, qlo = tf32_split(codes * codes)
    d = (keep @ qlo.T + keep @ qhi.T) - 2.0 * tf32x3_mm(xk, codes.T)
    return d, (xk * xk).sum(-1)


def dist_argmin_masked_tf32x3(x: torch.Tensor, codes: torch.Tensor,
                              mask: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain K4 (`dist_argmin_masked_plain`) as the kernel scores
    (`_masked_scores`); first index on ties; ||x keep||^2 added back:
    (sq_dists, int32 idx)."""
    d, x2 = _masked_scores(x, codes, mask)
    i = torch.argmin(d, dim=1)
    val = torch.clamp(d.gather(1, i[:, None])[:, 0] + x2, min=0.0)
    return val, i.to(torch.int32)


def dist_top2_masked_tf32x3(x: torch.Tensor, codes: torch.Tensor,
                            mask: torch.Tensor):
    """The plain K9 (`dist_top2_plain` with a mask) as the kernel scores: K9
    is K4's walk with a top-2 fold, so this is K4's scores
    (`_masked_scores`) with the two first minima in turn (the lower index on
    ties), the first masked out by +inf once taken, then ||x keep||^2 added
    and clamped at 0: (d1, i1, d2, i2).  Its first pair is
    `dist_argmin_masked_tf32x3`'s bit for bit, as K9's is K4's on the
    card."""
    d, x2 = _masked_scores(x, codes, mask)
    out = []
    for _ in range(2):
        i = torch.argmin(d, dim=1, keepdim=True)
        out += [torch.clamp(d.gather(1, i)[:, 0] + x2, min=0.0),
                i[:, 0].to(torch.int32)]
        d.scatter_(1, i, float("inf"))
    return tuple(out)


def som_vmem_train_steps_tf32x3(codes, batches, bmu0, alphas, radii, xdim, hexa,
                                gaussian=False, next_first=None):
    """The plain K7 (`som_vmem_train_steps_plain`) as the kernel sums: K
    chained `som_fused_train_step_tf32x3` steps.  Returns (the new float32
    codebook, bmu_next int32); `codes` is not changed."""
    return chain_steps(som_fused_train_step_tf32x3, codes, batches, bmu0, alphas,
                       radii, xdim, hexa, gaussian, next_first)


def som_fused_factored_chunked_step_tc(codes, xb, bmu, xb_next, xdim, hexa,
                                       alpha, radius, gaussian=False,
                                       wxa_bf16=False, batch_bf16=False):
    """K14's main form (the plain K14 without stagger and int8_win) as the
    kernel sums: W from the separable factors (`separable_w`, the x-pattern
    rounded to bf16 under `wxa_bf16` on a gaussian map), W.X by `chunk_sums`,
    the weight mass a float32 sum of the unrounded W; then the winners in
    distance form.  Under `batch_bf16` W, X, x' and the blended rows are
    rounded to bf16 for their products and each contraction is one
    `tf32_mm` pass (exact products), ||m||^2 from the float32 rows; otherwise
    K13's three products (`tf32x3_mm`).  A bf16 codebook is read upcast.
    Returns (the new float32 rows, bmu_next int32, val_next); `codes` is not
    changed."""
    fp32_matmul()
    dev = codes.device
    aw, r = _alpha_r(alpha, radius, xb.shape[0], dev)
    w = separable_w(bmu.to(torch.int32), aw, r, codes.shape[0], xdim, hexa,
                    gaussian, bool(wxa_bf16 and gaussian))
    if batch_bf16:
        acc = chunk_sums(_bf16(w), _bf16(xb), tf32_mm)
    else:
        acc = chunk_sums(w, xb)
    newc = guarded_blend(codes.to(torch.float32), acc, w.sum(1, keepdim=True))
    if batch_bf16:
        return (newc, *_winners(newc, _bf16(xb_next), tf32_mm, _bf16(newc)))
    return (newc, *_winners(newc, xb_next))


def som_fused_factored_step_tf32x3(codes, xb, bmu, xb_next, xdim, hexa, alpha,
                                   radius, gaussian=False):
    """The plain K13 (`som_fused_factored_step_plain`) as the kernel sums:
    `som_fused_factored_chunked_step_tc` without options (W from the
    separable factors, W.X by `chunk_sums`, the winners' scores through
    `tf32x3_mm`; distance form, the max-score form's -2 * score)."""
    return som_fused_factored_chunked_step_tc(codes, xb, bmu, xb_next, xdim, hexa,
                                              alpha, radius, gaussian)


def som_update_masked_tf32x3(codes, xb, bmu, mask, xdim, hexa, alpha, radius,
                             gaussian=False):
    """The plain K6 (`som_neighborhood_update_idx_plain` with a mask) as the
    kernel sums: per CHUNK-sample chunk, W.(X o K) by `tf32x3_mm` and the
    mass W.K as W_lo.K + W_hi.K, each chunk's sums added into the float32
    totals in batch order; then the guarded blend.  Returns the new float32
    codebook; `codes` is not changed."""
    fp32_matmul()
    dev = codes.device
    aw, r = _alpha_r(alpha, radius, xb.shape[0], dev)
    units = torch.arange(codes.shape[0], dtype=torch.int32, device=dev)
    w = neighborhood_w(bmu.to(torch.int32), aw, r, units, xdim, hexa, gaussian)
    keep = keep_of(mask)
    xk = xb * keep
    whi, wlo = tf32_split(w)
    acc = torch.zeros_like(codes, dtype=torch.float32)
    mass = torch.zeros_like(acc)
    for s in range(0, xb.shape[0], CHUNK):
        acc += tf32x3_mm(w[:, s:s + CHUNK], xk[s:s + CHUNK])
        kc = keep[s:s + CHUNK]
        mass += wlo[:, s:s + CHUNK] @ kc + whi[:, s:s + CHUNK] @ kc
    return guarded_blend(codes.to(torch.float32), acc, mass)


def fused_step_skeleton_tf32x3(codes, w, x, xn, scale: float = 1e-30
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain K17 (`fused_step_skeleton_plain`) as the kernel sums: W.X
    per CHUNK-sample chunk, each chunk's sums added into the float32 totals
    in batch order, then the rows (rounded to x''s type) scored against x';
    float32 operands through `tf32x3_mm`, bf16 ones through one `tf32_mm`
    pass.  Returns (out, vmax)."""
    fp32_matmul()
    mm = tf32_mm if w.dtype == torch.bfloat16 else tf32x3_mm
    acc = chunk_sums(w.to(torch.float32), x.to(torch.float32), mm)
    rows = torch.arange(codes.shape[0], device=codes.device) % w.shape[0]
    out = codes + acc[rows] * scale
    cw = out.to(xn.dtype).to(torch.float32)
    xw = xn.to(torch.float32).T
    step = max(1, (1 << 28) // xn.shape[0])
    vmax = torch.stack([mm(cw[lo:lo + step], xw).amax(0)
                        for lo in range(0, cw.shape[0], step)]).amax(0)
    return out, vmax


def f32_winner_probe_tf32x3(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain K16 (`f32_winner_probe_plain`) with m.x through
    `tf32x3_mm`: (B,) max over rows, in row blocks of about 1 GiB.  On
    integers of at most 127 in magnitude it is exact (lo is zero, every sum
    an integer below 2^24)."""
    step = max(1, (1 << 28) // x.shape[1])
    return torch.stack([tf32x3_mm(m[lo:lo + step], x).amax(0)
                        for lo in range(0, m.shape[0], step)]).amax(0)


def _pad_rows(x: torch.Tensor, rows: int, width: int) -> torch.Tensor:
    """x (n, D) as float32, zeros to (rows, width)."""
    out = torch.zeros((rows, width), dtype=torch.float32, device=x.device)
    out[:x.shape[0], :x.shape[1]] = x.to(torch.float32)
    return out


def split_batches_plain(xb: torch.Tensor, xn: torch.Tensor, DP: int,
                        planes: int = 2) -> torch.Tensor:
    """The mma.sync steps' prologue (csrc/fused_step_tc.cuh:
    split_batches_kernel) as it fills its scratch: xb hi, xb lo as (Bp, DP),
    then xn hi, xn lo as (Bnp, DP), B and Bn rounded up to 64, zeros past D
    and past each batch; planes 1 (K14's batch_bf16): each value rounded to
    bf16, one plane.  Past DP features (the feature passes) each batch is its
    slabs of DP features in turn, each slab's planes together."""
    Bp, Bnp = -(-xb.shape[0] // 64) * 64, -(-xn.shape[0] // 64) * 64
    D = xb.shape[1]
    slabs = max(1, -(-D // DP))
    parts = []
    for x, rows in ((xb, Bp), (xn, Bnp)):
        full = _pad_rows(x, rows, slabs * DP)
        for s in range(slabs):
            slab = full[:, s * DP:(s + 1) * DP]
            parts += ([slab.to(torch.bfloat16).to(torch.float32)] if planes == 1
                      else list(tf32_split(slab)))
    return torch.cat([p.reshape(-1) for p in parts])


def sm90_positions(Bp: int) -> torch.Tensor:
    """The sample at each position of K17's transposed batch
    (split_sm90_kernel's kPerm): within each 32-sample chunk, position 8 ks +
    c + 4 e holds sample 8 c + 2 ks + e, the sample the mma.sync walk gives
    the k index (ks, column c + 4 e)."""
    p = torch.arange(Bp)
    q = p % 32
    return p - q + 8 * (q % 4) + 2 * (q // 8) + (q // 4) % 2


def split_sm90_plain(xb: torch.Tensor, xn: torch.Tensor, DP: int, planes: int = 2,
                     perm: bool = False, bmu=None, alpha=None, xdim: int = 1,
                     hexa: bool = False) -> torch.Tensor:
    """The Hopper walk's prologue (csrc/fused_step_sm90.cuh:
    split_sm90_kernel) as it fills its scratch: `planes` planes of the batch
    transposed, (DP, Bp) each (positions in `sm90_positions` order with
    `perm`), then of the next batch, (Bnp, DP); planes 2: tf32_split's hi
    then lo, 1: the values as float32.  With `bmu`, K3's table follows: for
    each of the Bp samples the float4 (BMU grid x, BMU row, alpha, 0), zeros
    where bmu < 0 or past B."""
    Bp, Bnp = -(-xb.shape[0] // 64) * 64, -(-xn.shape[0] // 64) * 64
    xt = _pad_rows(xb, Bp, DP)
    if perm:
        xt = xt[sm90_positions(Bp)]
    xr = _pad_rows(xn, Bnp, DP)
    if planes == 2:
        parts = [*tf32_split(xt.T.contiguous()), *tf32_split(xr)]
    else:
        parts = [xt.T.contiguous(), xr]
    if bmu is not None:
        parts.append(k3_table(bmu, alpha, Bp, xdim, hexa))
    return torch.cat([p.reshape(-1) for p in parts])


def k3_table(bmu, alpha, Bp: int, xdim: int, hexa: bool) -> torch.Tensor:
    """K3's per-sample table on the Hopper walk (K6's too), (Bp, 4): for each
    sample the float4 (BMU grid x, BMU row, alpha, 0), zeros where bmu < 0
    or past B."""
    B = bmu.shape[0]
    table = torch.zeros((Bp, 4), dtype=torch.float32, device=bmu.device)
    bm = bmu.to(torch.int64)
    col, row = (bm % xdim).to(torch.float32), bm // xdim
    gx = col + 0.5 * (row % 2).to(torch.float32) if hexa else col
    on = bm >= 0
    table[:B, 0] = torch.where(on, gx, 0.0)
    table[:B, 1] = torch.where(on, row.to(torch.float32), 0.0)
    table[:B, 2] = torch.where(on, alpha.to(torch.float32), 0.0)
    return table


def split_k6_plain(xb: torch.Tensor, mask: torch.Tensor, bmu, alpha, xdim: int,
                   hexa: bool) -> torch.Tensor:
    """K6's prologue on the Hopper walk (csrc/som_update_masked_sm90.cu:
    split_masked_batch_kernel) as it fills its scratch
    (`ops.som_update.k6_scratch`): X o K transposed, (Dp, Bp), split by
    `tf32_split` into its hi and lo planes, then K transposed as 1.0 or 0.0,
    zeros past D and past B (Dp = `split_codes_dp(D)`, Bp = B rounded up to
    64); then `k3_table`.  `alpha` is (B,)."""
    B, D = xb.shape
    Bp = -(-B // 64) * 64
    on = mask == 0
    xk = _pad_rows(torch.where(on, xb, 0.0), Bp, split_codes_dp(D)).T.contiguous()
    kt = _pad_rows(on.to(torch.float32), Bp, split_codes_dp(D)).T.contiguous()
    parts = [*tf32_split(xk), kt, k3_table(bmu, alpha, Bp, xdim, hexa)]
    return torch.cat([p.reshape(-1) for p in parts])
