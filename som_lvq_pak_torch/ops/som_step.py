"""One fused SOM training step: the counterpart of
som_lvq_pak_tpu/ops/pallas_som.py:som_fused_train_step and its three TPU
kernels, each a hand-written CUDA kernel here:

- K3 `som_fused_step` (csrc/fused_step_sm90.cu for D <= 128, the Hopper
  walk: a TMA ring fed by a producer warpgroup, wgmma TF32, W built in the
  consumers' registers; csrc/som_fused_step.cu's mma.sync kernel past it,
  `k3_route`): the plain kernel (`_som_fused_step_kernel`), W from the
  closed form, winners in distance form; both contractions on the tensor
  cores as split-TF32 products (float32 accuracy, csrc/tf32x3.cuh), the
  two kernels bit-equal;
- K13 `som_fused_factored_step` (csrc/som_fused_factored_sm90.cu for D <=
  128, K3's Hopper walk with W built from the tables, csrc/separable_sm90.cuh; csrc/som_fused_factored.cu
  past it, `k13_route`): the separable kernel (`_som_fused_factored_kernel`),
  W = Wx(column, row parity) * Wy(row) from tables, winners in max-score
  form; past D 128 K3's tensor-core body (csrc/fused_step_tc.cuh) with W read
  from the tables; the two bit-equal;
- K14 `som_fused_factored_chunked_step` (csrc/separable_sm90.cuh
  for its main form up to D 128, `k14_route`; csrc/som_fused_chunked_tc.cuh
  past it and for its options): the batch-chunked kernel
  (`_som_fused_factored_chunked_kernel`) with its bf16 x-pattern
  (`wxa_bf16`, gaussian only), bf16 batches (`batch_bf16`), int8 winners
  (`int8_win`) and staggered schedule (`stagger`).  Its main form (no
  `stagger`, no `int8_win`) is K13's Hopper walk with the x-pattern rounded
  to bf16 by the table launch and, under `batch_bf16`, one TF32 product per
  contraction on the bf16 operands, each tile's batch split across a
  thread-block cluster of `k14_cluster` CTAs (past D 128 K13's
  tensor-core body with the same roundings); `stagger` and `int8_win` run the same
  body's chunk functions in a walk of their own (a persistent grid that
  interleaves each tile's update with the previous tile's winners under
  `stagger`; the winners on int8 `mma.sync` under `int8_win`), bit-equal to
  the main form at a cluster of one CTA (`int8_win`: its codebook).

One call applies batch t's neighbourhood update to the codebook and finds
batch t+1's winners against the UPDATED codebook (the software-pipelined
form the trainer runs):

    codes, bmu_next, val_next = som_fused_train_step(
        codes, x[t], bmu, x[t + 1], xdim, hexa, alpha, radius, gaussian)

`som_fused_train_step` routes as the JAX wrapper does (pallas_som.py:
1320-1349): `factored=None` takes the separable kernel where
`factored_geometry_ok(noc, xdim, tile_n, hexa)` and no `unit_offset` is
given; `factored` with a `unit_offset` raises; on the separable path any of
`batch_chunk`, `stagger`, `wxa_bf16`, `batch_bf16` or `int8_win` takes the
batch-chunked kernel (pallas_som.py:1339-1349); K3 ignores all five, as the
JAX wrapper's plain path does.
`tile_n` decides the geometry only: the CUDA kernels tile by 128 rows (K3;
64 for D > 128), by `k13_rows` (K13: 128, or 64 up to 128x128) or by
`k14_rows` (K14 past D 128 and its options: 64, or 32 under `stagger` past
D 128; its main form up to D 128: 128, the batch split across `k14_cluster`
CTAs), and the result depends on it only through the float32 order of
additions.  The
port keeps D unpadded, so the JAX `d_real` has no counterpart.  The kernels
take any D >= 1: past PASS_D (256) features, the widest they instantiate,
they run in `feature_passes(D)` passes of 256 within one launch (the update
and blend slab by slab, the winners' scores summed over the slabs in a fixed
order), so a bf16 codebook there needs a float32 copy of its blended rows
(`_rows32`).

The codebook is updated IN PLACE (the caller owns the resident codebook;
this saves a second codebook-sized buffer per step) and returned.  It is
float32 or bfloat16 (read upcast, blended in float32, written back rounded
to nearest even; winners against the float32 blended rows).  `val_next` is
the partial distance ||m||^2 - 2 m.x without ||x||^2 (the separable kernels
report -2 * the max score), as in the JAX package.  `unit_offset` is the
global unit of row 0 when `codes` is a model-axis shard of a larger map
(K3 only): the neighbourhood weights are taken at the global units, while
`bmu_next` stays local rows, as the JAX wrapper returns them
(parallel.sharded adds the offset).

A CUDA tensor launches the kernel; a CPU tensor runs the plain version
below, built from the plain counterparts of `_grid_xy`, `_neighborhood_w`
and `_guarded_blend` (pallas_som.py:48-113).  Each kernel's wrapper counts
its launches in its `launches` attribute; `som_fused_train_step` counts K3's.
K14's wrapper counts its main form; a launch of its walk counts on
`CHUNKED_INT8_WIN` or `CHUNKED_STAGGER` under those options (on both with
both).

`int8_win` (pallas_som.py:1180-1194, 1087-1094): the step's global scales
are taken from the batches (`int8_win_inputs`), the next batch is quantized
to int8 on the device (and padded with zeros as the kernel stages it,
`int8_win_staged`), and the winners' contraction runs int8 x int8 ->
int32 against the updated rows quantized with the codebook scale; scores
dequantize to float32 and ||m||^2 / 2 stays the float32 rows', so only
winners within the quantization noise of a tie move (`val_next` is
approximate).  The codebook is the same as without it.  `stagger` changes
the kernel's schedule, not its result, so its plain version is K14's.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple, Union

import torch

from .. import _build
from .distance import fp32_matmul

# features per pass of the SOM step kernels (K3, K5-K7, K11-K14, K17): their
# widest instantiation; a wider D runs in feature_passes(D) passes of PASS_D
PASS_D = 256
_SQRT075 = math.sqrt(0.75)


def grid_xy(idx: torch.Tensor, xdim: int, hexa: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid coordinates of flat unit indices (`_grid_xy`): hexa odd rows
    at x + 0.5, y scaled by sqrt(0.75).  For display and coordinate
    tables only: the neighbourhood weights use `grid_sq_dists`, whose terms
    are exact in float32."""
    col = (idx % xdim).to(torch.float32)
    row = idx // xdim
    if hexa:
        return (col + 0.5 * (row % 2).to(torch.float32),
                row.to(torch.float32) * _SQRT075)
    return col, row.to(torch.float32)


def grid_sq_dists(units: torch.Tensor, bmu: torch.Tensor, xdim: int,
                  hexa: bool) -> torch.Tensor:
    """Squared grid distance between unit and BMU flat indices (broadcast
    against each other), computed EXACTLY in float32 as `_neighborhood_w`
    does: dx from columns and 0.5 offsets, hexa dy^2 = rowdiff^2 * 0.75.
    Bubble inclusion at exact-boundary distances depends on this form."""
    ucol = (units % xdim).to(torch.float32)
    urow = units // xdim
    bcol = (bmu % xdim).to(torch.float32)
    brow = bmu // xdim
    rd = (urow - brow).to(torch.float32)
    if hexa:
        dx = ((ucol + 0.5 * (urow % 2).to(torch.float32))
              - (bcol + 0.5 * (brow % 2).to(torch.float32)))
        return dx * dx + (rd * rd) * 0.75
    dx = ucol - bcol
    return dx * dx + rd * rd


def neighborhood_w(bmu: torch.Tensor, alpha: torch.Tensor,
                   radius: torch.Tensor, units: torch.Tensor, xdim: int,
                   hexa: bool, gaussian: bool) -> torch.Tensor:
    """(len(units), B) adaptation weights (`_neighborhood_w`): bubble
    alpha where d2 <= r^2, gaussian alpha * exp(-d2 / (2 r r)); 0 where
    bmu < 0.  `alpha` is the (B,) per-sample effective alpha, `radius` a
    float32 scalar tensor."""
    d2 = grid_sq_dists(units[:, None], bmu[None, :], xdim, hexa)
    a = alpha[None, :]
    if gaussian:
        w = a * torch.exp(-d2 / (2.0 * radius * radius))
    else:
        w = torch.where(d2 <= radius * radius, a, torch.zeros_like(a))
    return torch.where(bmu[None, :] < 0, torch.zeros_like(w), w)


def guarded_blend(c: torch.Tensor, acc: torch.Tensor, wsum: torch.Tensor
                  ) -> torch.Tensor:
    """Saturating update (`_guarded_blend`): exact c + acc - wsum * c while
    wsum <= 1, full blend to the weighted mean acc / wsum beyond."""
    safe = torch.clamp(wsum, min=1e-30)
    blend = torch.clamp(wsum, max=1.0)
    return c + blend * (acc / safe - c)




class LaunchCount:
    """A launch counter of one option of a kernel, counted beside the
    kernel's own `launches`."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


CHUNKED_INT8_WIN = LaunchCount("som_fused_factored_chunked_step[int8_win]")
CHUNKED_STAGGER = LaunchCount("som_fused_factored_chunked_step[stagger]")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to bfloat16 (nearest even) and read back as float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def factored_geometry_ok(noc: int, xdim: int, tile_n: int, hexa: bool) -> bool:
    """Whether the separable kernels apply (a copy of pallas_som.py:
    _factored_geometry_ok): tiles cover whole grid rows, the codebook has
    no padded rows, xdim % 8 == 0, and a hexa map has an even number of
    grid rows per tile or one row per tile."""
    if noc % tile_n != 0 or tile_n % xdim != 0 or xdim % 8 != 0:
        return False
    rows_per_tile = tile_n // xdim
    if hexa and rows_per_tile % 2 != 0 and rows_per_tile != 1:
        return False
    return True


def _alpha_r(alpha, radius, B: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    aw = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    return (aw.expand(B) if aw.dim() == 0 else aw,
            torch.tensor(radius, dtype=torch.float32, device=dev))


def som_fused_train_step_plain(codes, xb, bmu, xb_next, xdim, hexa, alpha,
                               radius, gaussian=False, unit_offset=0):
    """Plain K3; same arguments and contract as `som_fused_train_step`
    with factored=False."""
    fp32_matmul()
    dev = codes.device
    aw, r = _alpha_r(alpha, radius, xb.shape[0], dev)
    units = (unit_offset or 0) + torch.arange(codes.shape[0], dtype=torch.int32,
                                              device=dev)
    w = neighborhood_w(bmu.to(torch.int32), aw, r, units, xdim, hexa, gaussian)
    newc = guarded_blend(codes.to(torch.float32), w @ xb, w.sum(1, keepdim=True))
    d_t = (newc * newc).sum(1, keepdim=True) - 2.0 * (newc @ xb_next.T)
    idx = torch.argmin(d_t, dim=0)  # first (lowest) row on ties
    val = d_t.gather(0, idx[None, :])[0]
    codes.copy_(newc)
    return codes, idx.to(torch.int32), val


def separable_tables(bmu: torch.Tensor, alpha: torch.Tensor, radius: torch.Tensor,
                      noc: int, xdim: int, hexa: bool, gaussian: bool,
                      wxa_bf16: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The separable kernels' tables (csrc/separable_w.cuh:
    factored_tables_kernel): the x-pattern (2 xdim rows, hexa, or xdim; row
    parity * xdim + column, B), the y-factor (grid rows, B) and alpha (0
    where bmu < 0); gaussian alpha exp(-dx^2 s) (bf16-rounded with
    `wxa_bf16`) and exp(-dy^2 s), bubble dx^2 and dy^2, s = 1 / (2 r r)."""
    dev = bmu.device
    ok = bmu >= 0
    bm = torch.where(ok, bmu, torch.zeros_like(bmu))
    a = torch.where(ok, alpha, torch.zeros_like(alpha))
    s = 1.0 / (2.0 * radius * radius)
    colb = (bm % xdim).to(torch.float32)
    rowb = bm // xdim
    l = torch.arange(2 * xdim if hexa else xdim, device=dev)
    xq = (l % xdim).to(torch.float32)
    if hexa:
        colb = colb + 0.5 * (rowb % 2).to(torch.float32)
        xq = xq + 0.5 * (l // xdim).to(torch.float32)
    dx = xq[:, None] - colb[None, :]
    dx2 = dx * dx
    rd = (torch.arange(-(-noc // xdim), device=dev)[:, None]
          - rowb[None, :]).to(torch.float32)
    dy2 = (rd * rd) * 0.75 if hexa else rd * rd
    if gaussian:
        pat = a[None, :] * torch.exp(-dx2 * s)
        return (_bf16(pat) if wxa_bf16 else pat), torch.exp(-dy2 * s), a
    return dx2, dy2, a


def separable_rows(noc: int, xdim: int, hexa: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each unit's x-pattern row (row parity * xdim + column on a hexa map,
    the column on a rect one) and y-factor row (its grid row): the rows of
    `separable_tables` the kernels read for it (csrc/separable_w.cuh:
    SeparableW::init, csrc/separable_sm90.cuh's walk)."""
    u = torch.arange(noc)
    row = u // xdim
    return ((row % 2) * xdim + u % xdim if hexa else u % xdim), row


def separable_w(bmu: torch.Tensor, alpha: torch.Tensor, radius: torch.Tensor,
                noc: int, xdim: int, hexa: bool, gaussian: bool,
                wxa_bf16: bool = False) -> torch.Tensor:
    """(noc, B) weights of the separable kernels (pallas_som.py:791-858):
    the x-pattern over (row parity, column) and the per-grid-row y-factor,
    with s = 1 / (2 r r); gaussian (alpha exp(-dx^2 s)) * exp(-dy^2 s), the
    x-pattern rounded to bf16 with `wxa_bf16`; bubble alpha where dx^2 +
    dy^2 <= r^2.  0 where bmu < 0 (the TPU kernels are never given one)."""
    pat, ytab, a = separable_tables(bmu, alpha, radius, noc, xdim, hexa, gaussian,
                                    wxa_bf16)
    prow, yrow = (r.to(bmu.device) for r in separable_rows(noc, xdim, hexa))
    wx, wy = pat[prow], ytab[yrow]
    if gaussian:
        return wx * wy
    return torch.where(wx + wy <= radius * radius, a[None, :],
                       torch.zeros_like(wx))


def fused_step_winners(newc, xn, batch_bf16=False, chunk_n=None):
    """The separable kernels' winner half on the updated float32 rows
    `newc`: argmax of x.m - ||m||^2 / 2, the first (lowest) row on ties, over
    samples `chunk_n` at a time; under batch_bf16 the score of bf16-rounded
    x and rows (pallas_som.py:1087-1094), the norm from the float32 rows.
    Returns (bmu (B',) int32, -2 * the best score)."""
    fp32_matmul()
    m2h = 0.5 * (newc * newc).sum(1, keepdim=True)
    cw = _bf16(newc) if batch_bf16 else newc
    xw = _bf16(xn) if batch_bf16 else xn
    step = chunk_n or xn.shape[0]
    idx, best = [], []
    for lo in range(0, xn.shape[0], step):
        s_t = cw @ xw[lo:lo + step].T - m2h
        i = torch.argmax(s_t, dim=0)
        idx.append(i)
        best.append(s_t.gather(0, i[None, :])[0])
    return torch.cat(idx).to(torch.int32), -2.0 * torch.cat(best)


def int8_win_inputs(codes: torch.Tensor, xb: torch.Tensor, xb_next: torch.Tensor,
                    batch_bf16: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8_win prologue of `_fused_factored_chunked_call`
    (pallas_som.py:1180-1194), in float32 as written there, on the batches'
    device: sm = max(max|codes|, max|xb|) + 1e-30 bounds every updated row
    (a blend is convex), sx = max|x'| + 1e-30; returns (xq (B', D) int8 =
    clip(round(x' 127 / sx), +-127), round half to even, and q (2,) float32 =
    (127 / sm, (sm sx) / 127^2)).  Under batch_bf16 the batches are rounded
    to bf16 first (pallas_som.py:1341-1343)."""
    if batch_bf16:
        xb, xb_next = _bf16(xb), _bf16(xb_next)
    sm = torch.maximum(codes.to(torch.float32).abs().max(), xb.abs().max()) + 1e-30
    sx = xb_next.abs().max() + 1e-30
    # IEEE divisions of device tensors: torch takes `scalar / t` as
    # reciprocal(t) * scalar, and on CUDA `t / scalar` as t * (1 / scalar),
    # each up to one ulp off the quotient the JAX wrapper takes.  The
    # constants are filled on the device: a tensor made from a Python number
    # is copied from pageable host memory, which waits for the stream
    c127, c16129 = (torch.full((), v, dtype=torch.float32, device=sm.device)
                    for v in (127.0, 16129.0))
    xq = torch.clamp(torch.round(xb_next * (c127 / sx)), -127.0, 127.0)
    return xq.to(torch.int8), torch.stack([c127 / sm, (sm * sx) / c16129])


# samples per winner chunk of K14's int8 winners (csrc/som_fused_chunked_tc.cuh:
# WalkSmem::BW): the staged x' is padded to a multiple of it
INT8_WIN_CHUNK = 64


def int8_win_staged(xq: torch.Tensor) -> torch.Tensor:
    """`xq` (B', D) int8 as K14's int8 winners stage it: zeros to D32
    features (D rounded up to 32, the depth of one int8 mma.sync product)
    and to a multiple of INT8_WIN_CHUNK samples, so every chunk is whole rows
    of 16-byte pieces.  Zeros add nothing to an integer dot."""
    Bn, D = xq.shape
    out = xq.new_zeros((-(-Bn // INT8_WIN_CHUNK) * INT8_WIN_CHUNK, -(-D // 32) * 32))
    out[:Bn, :D] = xq
    return out


def fused_step_winners_int8(newc, xq, q, chunk_n=None):
    """The int8_win winner half on the updated float32 rows `newc`
    (pallas_som.py:1056-1061, 1087-1094): rows quantized to clip(round(m q0),
    +-127), the exact integer dot with `xq` (float64; `xq` may carry zero
    features past D, as `int8_win_staged` pads it), times q1 minus
    ||m||^2 / 2 of the float32 rows, argmax with the first (lowest) row on
    ties, over samples `chunk_n` at a time.  Returns (bmu (B',) int32,
    -2 * the best score), one per row of `xq`."""
    m2h = 0.5 * (newc * newc).sum(1, keepdim=True)
    cw = torch.clamp(torch.round(newc * q[0]), -127.0, 127.0).to(torch.float64)
    cw = torch.nn.functional.pad(cw, (0, xq.shape[1] - cw.shape[1]))
    xw = xq.to(torch.float64)
    step = chunk_n or xq.shape[0]
    idx, best = [], []
    for lo in range(0, xq.shape[0], step):
        s_t = (cw @ xw[lo:lo + step].T).to(torch.float32) * q[1] - m2h
        i = torch.argmax(s_t, dim=0)
        idx.append(i)
        best.append(s_t.gather(0, i[None, :])[0])
    return torch.cat(idx).to(torch.int32), -2.0 * torch.cat(best)


def int8_win_scores(newc, rows, xq, q):
    """The int8_win score of row `rows[b]` of the float32 rows `newc` for
    sample b of `xq`: fused_step_winners_int8's arithmetic, one row per
    sample, as float64 (to hold a winner against another row's score)."""
    m = newc[rows.long()]
    cw = torch.clamp(torch.round(m * q[0]), -127.0, 127.0).to(torch.float64)
    dot = (cw * xq.to(torch.float64)).sum(-1).to(torch.float32)
    return (dot * q[1] - 0.5 * (m * m).sum(-1)).to(torch.float64)


def _separable_plain(codes, xb, bmu, xb_next, xdim, hexa, alpha, radius,
                     gaussian, chunked=False, batch_chunk=None, wxa_bf16=False,
                     batch_bf16=False, stagger=False, int8_win=False, cluster=None):
    """Plain K13 (`chunked` False: the whole batch at once) or K14: the
    batch in `batch_chunk` slices with the batch-chunked kernel's bf16
    roundings (pallas_som.py:1012-1094) and, with `int8_win`, its int8
    winners.  `stagger` changes the kernel's schedule, not the function: it
    is taken and has no effect here.  With `cluster` (K14) the update sums
    the batch in the `cluster_ranges` of a cluster of that many CTAs, each
    range's partial added in rank order, as K14's Hopper walk splits it."""
    fp32_matmul()
    dev = codes.device
    B, D = xb.shape
    chunk = _batch_chunk(B, xb_next.shape[0], batch_chunk) if chunked else None
    ranges = (cluster_ranges(B, cluster) if cluster else
              [(lo, min(B, lo + (chunk or B))) for lo in range(0, B, chunk or B)])
    wxa_bf16 = bool(wxa_bf16 and gaussian)
    aw, r = _alpha_r(alpha, radius, B, dev)
    bmu = bmu.to(torch.int32)
    quant = int8_win_inputs(codes, xb, xb_next, batch_bf16) if int8_win else None
    x = _bf16(xb) if batch_bf16 else xb
    noc = codes.shape[0]
    acc = torch.zeros((noc, D), dtype=torch.float32, device=dev)
    wsum = torch.zeros((noc, 1), dtype=torch.float32, device=dev)
    for lo, hi in ranges:
        sl = slice(lo, hi)
        w = separable_w(bmu[sl], aw[sl], r, noc, xdim, hexa, gaussian, wxa_bf16)
        acc = acc + (_bf16(w) if batch_bf16 else w) @ x[sl]
        wsum = wsum + w.sum(1, keepdim=True)
    newc = guarded_blend(codes.to(torch.float32), acc, wsum)
    if int8_win:
        idx, val = fused_step_winners_int8(newc, *quant, chunk)
    else:
        idx, val = fused_step_winners(newc, xb_next, batch_bf16, chunk)
    codes.copy_(newc)
    return codes, idx, val


def som_fused_factored_step_plain(codes, xb, bmu, xb_next, xdim, hexa, alpha,
                                  radius, gaussian=False):
    """Plain K13 (`_som_fused_factored_kernel`); arguments and contract as
    `som_fused_factored_step`."""
    return _separable_plain(codes, xb, bmu, xb_next, xdim, hexa, alpha, radius,
                            gaussian)


def som_fused_factored_chunked_step_plain(codes, xb, bmu, xb_next, xdim, hexa,
                                          alpha, radius, gaussian=False,
                                          batch_chunk=None, wxa_bf16=False,
                                          batch_bf16=False, stagger=False,
                                          int8_win=False, cluster=None):
    """Plain K14 (`_som_fused_factored_chunked_kernel`): the separable step
    with the batch in `batch_chunk` slices (default gcd(B, B')), the
    x-pattern rounded to bf16 with `wxa_bf16` (gaussian only), the batches
    and W's product operands with `batch_bf16`, and the int8 winners of
    `fused_step_winners_int8` with `int8_win`; `stagger` leaves the result
    as it is.  `cluster`: the update summed in `cluster_ranges(B, cluster)`,
    the partials added in rank order (K14's Hopper walk's batch split)."""
    return _separable_plain(codes, xb, bmu, xb_next, xdim, hexa, alpha, radius,
                            gaussian, True, batch_chunk, wxa_bf16, batch_bf16,
                            stagger, int8_win, cluster)


def _batch_chunk(B: int, Bn: int, batch_chunk: Optional[int]) -> int:
    """The batch-chunked kernel's chunk (pallas_som.py:1159-1163)."""
    bc = batch_chunk if batch_chunk is not None else math.gcd(B, Bn)
    if B % bc or Bn % bc or bc % 128:
        raise ValueError(f"som_fused_train_step: batch_chunk={bc} must divide "
                         f"B={B} and B'={Bn} and be a multiple of 128")
    return bc


def _step_args(codes, xb, bmu, xb_next, alpha):
    """Check one step's arguments; returns (bmu int32, alpha (B,) float32),
    both contiguous."""
    dev = codes.device
    if codes.dim() != 2 or xb.dim() != 2 or xb_next.dim() != 2:
        raise ValueError("codes, xb and xb_next must be 2-D")
    D = codes.shape[1]
    B = xb.shape[0]
    if xb.shape[1] != D or xb_next.shape[1] != D or bmu.shape != (B,):
        raise ValueError(f"shape mismatch: codes {tuple(codes.shape)}, xb "
                         f"{tuple(xb.shape)}, bmu {tuple(bmu.shape)}, xb_next "
                         f"{tuple(xb_next.shape)}")
    if codes.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("codes must be float32 or bfloat16")
    if xb.dtype != torch.float32 or xb_next.dtype != torch.float32:
        raise TypeError("xb and xb_next must be float32")
    if any(t.device != dev for t in (xb, bmu, xb_next)):
        raise ValueError("codes, xb, bmu and xb_next must share one device")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous (updated in place)")
    if B == 0 or xb_next.shape[0] == 0:
        raise ValueError("empty batch")
    aw = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    aw = aw.expand(B).contiguous() if aw.dim() == 0 else aw.contiguous()
    if aw.shape != (B,):
        raise ValueError(f"alpha must be a scalar or ({B},)")
    if dev.type == "cuda" and D < 1:
        raise ValueError(f"som_fused_train_step: D={D}, the kernels take D >= 1")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return bmu.to(torch.int32).contiguous(), aw


def som_fused_factored_step(codes, xb, bmu, xb_next, xdim, hexa, alpha,
                            radius, gaussian=False):
    """K13: the separable step (`_som_fused_factored_kernel`) on `codes`
    (noc, D), float32 or bfloat16, updated in place; returns (codes,
    bmu_next (B',) int32, val_next (B',) = -2 * the best score)."""
    bmu, aw = _step_args(codes, xb, bmu, xb_next, alpha)
    return _fused_step_separable(codes, xb, bmu, xb_next, xdim, hexa, aw,
                                 radius, gaussian)


def som_fused_factored_chunked_step(codes, xb, bmu, xb_next, xdim, hexa,
                                    alpha, radius, gaussian=False,
                                    batch_chunk=None, wxa_bf16=False,
                                    batch_bf16=False, stagger=False,
                                    int8_win=False):
    """K14: the batch-chunked separable step
    (`_som_fused_factored_chunked_kernel`) with its bf16 x-pattern
    (`wxa_bf16`, gaussian only), bf16 batches (`batch_bf16`), int8 winners
    (`int8_win`) and staggered schedule (`stagger`: a persistent grid whose
    CTAs interleave each tile's update with the previous tile's winners;
    bit-equal to the plain schedule); as `som_fused_factored_step`
    otherwise.  `batch_chunk` (default gcd(B, B')) must divide both batches
    and be a multiple of 128, as in JAX; the kernel walks the batch in its
    own chunks, so only the plain version's order of additions depends on
    it."""
    bmu, aw = _step_args(codes, xb, bmu, xb_next, alpha)
    _batch_chunk(xb.shape[0], xb_next.shape[0], batch_chunk)
    return _fused_step_separable(codes, xb, bmu, xb_next, xdim, hexa, aw,
                                 radius, gaussian, True, batch_chunk, wxa_bf16,
                                 batch_bf16, stagger, int8_win)


def _split_scratch(B: int, Bn: int, D: int, dev, planes: int = 2) -> torch.Tensor:
    """Scratch for the tensor-core steps' batches split once per step
    (csrc/fused_step_tc.cuh:split_batches_kernel): the hi and lo parts
    (`planes` 2; one plane of bf16 values under K14's batch_bf16) of (B, W)
    and (Bn, W), rows rounded up to a multiple of 64, W = split_width(D)
    (past PASS_D the passes' slabs side by side: `split_scratch_floats`)."""
    return torch.empty((split_scratch_floats(B, Bn, D, planes),),
                       dtype=torch.float32, device=dev)


def split_scratch_floats(B: int, Bn: int, D: int, planes: int = 2) -> int:
    """The floats of `_split_scratch`: `planes` planes of each batch, rows
    rounded up to 64, split_width(D) features each (each pass's slab of
    DP features in turn, the planes of one slab together)."""
    rows = (-(-B // 64) + -(-Bn // 64)) * 64
    return planes * rows * split_width(D)


def feature_passes(D: int) -> Tuple[int, int]:
    """(passes, DP) of the SOM step kernels for D features: one pass of DP =
    8 times the power of two of 8-feature steps that covers D, up to PASS_D;
    past it ceil(D / PASS_D) passes of PASS_D features, the last padded with
    zeros (csrc/som_grid.cuh: n_passes)."""
    if D < 1:
        raise ValueError(f"the SOM step kernels take D >= 1, got {D}")
    if D <= PASS_D:
        return 1, 8 * (1 << (-(-D // 8) - 1).bit_length())
    return -(-D // PASS_D), PASS_D


def split_width(D: int) -> int:
    """The width of the tensor-core steps' split rows: DP, 8 times the power
    of two of 8-feature steps that covers D, or past PASS_D the passes' slabs
    together (passes x PASS_D)."""
    passes, dp = feature_passes(D)
    return passes * dp


def _rows32(codes: torch.Tensor) -> Optional[torch.Tensor]:
    """The float32 copy of a bf16 codebook's blended rows that the step
    kernels' winners read past PASS_D features (their feature passes read the
    rows back slab by slab, and a bf16 codebook holds only the rounded rows);
    None where the kernel does not read it."""
    if codes.dtype == torch.bfloat16 and codes.shape[1] > PASS_D:
        return torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    return None


def k13_rows(noc: int, D: int, device: torch.device) -> int:
    """K13's codebook rows per CTA: 128 where that still gives every SM two
    CTAs (their shared memory allows two), else 64, so that one CTA's copies
    overlap the other's mma on maps of up to 128x128 (16,384 rows: 256 CTAs
    of 64 rows on an H100's 132 SMs); 64 past D 128, where 128 rows do not
    fit in shared memory.  The batch is never split across CTAs: each row's
    sums keep one order."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 128 if D <= 128 and -(-noc // 128) >= 2 * sms else 64


# The most CTAs of K14's staggered persistent grid; the card's resident count
# caps it first (chip_smoke.py forces a few, so that each CTA walks several
# tiles)
K14_STAGGER_CTAS = 2 ** 31 - 1

def k14_rows(D: int, stagger: bool = False) -> int:
    """K14's rows per CTA off its Hopper walk (csrc/som_fused_chunked_tc.cuh:
    its main form past D 128, its stagger and int8_win): 64, but 32 under
    `stagger` past D 128, where the walk's ring and previous float32 tile do
    not fit in shared memory beside 64 rows (`k14_walk_smem_bytes`).  The
    kernel refuses a height that does not fit; it never shrinks one.  Each
    row's batch stays in one CTA: its sums keep one order."""
    return 32 if stagger and D > 128 else 64


# K14's main form up to SM90_MAX_D: the cluster sizes its Hopper walk is
# launched with (csrc/separable_sm90.cuh), the samples of an update
# chunk (a rank takes whole chunks), and a forced cluster size (None: the
# wrapper's choice, `k14_cluster`; chip_smoke.py forces each size)
K14_CLUSTERS = (1, 2, 4, 8)
K14_UPDATE_CHUNK = 32
K14_CLUSTER = None


def cluster_ranges(B: int, cluster: int) -> list:
    """The sample ranges [lo, hi) of the `cluster` CTAs that split a tile's
    batch of B samples in K14's Hopper walk: rank r takes the update chunks
    [r n / c, (r + 1) n / c) of the n = ceil(B / 32), whole 32-sample chunks
    (the last cut at B); a rank with no chunk gets an empty range."""
    if cluster not in K14_CLUSTERS:
        raise ValueError(f"cluster={cluster} not in {K14_CLUSTERS}")
    n = -(-B // K14_UPDATE_CHUNK)
    edges = [min(B, (r * n // cluster) * K14_UPDATE_CHUNK) for r in range(cluster + 1)]
    return list(zip(edges[:-1], edges[1:]))


def k14_cluster(tiles: int, sms: int) -> int:
    """The CTAs of the cluster that splits each 128-row tile's batch in K14's
    Hopper walk, for a map of `tiles` tiles on a card of `sms` SMs: the
    largest size in K14_CLUSTERS with tiles x size <= sms, so that the
    step's clusters fill at most one wave of one CTA an SM (its shared
    memory takes about 227 KB); 1 where the tiles alone fill the card.
    `_k14_cluster_on` then halves it while the card holds fewer such
    clusters at once than the map has tiles.  On an H100 (132 SMs) the two
    pick 8, 4, 2 and 1 at 32x32, 64x32, 64x64 and 128x128 (B 4096), the
    fastest size of the walk kernel's device time at each of those maps
    and option sets (tools/fused_step_ab.py --walk-variants, its cluster
    sweep; PERF.md).  The pick depends on the card's SM count and cluster
    placement, and at c > 1 the batch sum is reassociated at c - 1 points:
    two card models may pick different sizes and then give codebooks that
    differ by float32 rounding; one card's reruns are bit-equal."""
    for c in reversed(K14_CLUSTERS):
        if tiles * c <= sms:
            return c
    return 1


def _k14_max_clusters(D: int, batch_bf16: bool, cluster: int) -> int:
    """cudaOccupancyMaxActiveClusters of K14's walk at D for `cluster`."""
    out = ctypes.c_int(0)
    _build.call("somvq_som_fused_chunked_sm90_clusters", D, int(batch_bf16), cluster,
                ctypes.byref(out))
    return out.value


@functools.lru_cache(maxsize=None)
def _k14_cluster_on(noc: int, D: int, batch_bf16: bool, sms: int) -> int:
    """`k14_cluster` checked against the card: halved while fewer clusters
    fit at once than the map has tiles (a GPC may not place clusters of 8
    CTAs of one SM each in every one of its SMs)."""
    tiles = -(-noc // 128)
    c = k14_cluster(tiles, sms)
    while c > 1 and _k14_max_clusters(D, batch_bf16, c) < tiles:
        c //= 2
    return c


def k14_route(D: int) -> str:
    """K14's main form's kernel for D features, K3's rule (`k3_route`):
    "sm90", K13's Hopper walk with K14's roundings and the batch split
    across a cluster (csrc/separable_sm90.cuh), up to SM90_MAX_D;
    "mma_sync" (csrc/som_fused_chunked_tc.cuh) past it.  K14's stagger and
    int8_win run their own walk at any D."""
    return k3_route(D)


def k14_walk_smem_bytes(D: int, rows: int, int8_win: bool, batch_bf16: bool,
                        ny: int) -> int:
    """The shared memory of K14's walk (its stagger and int8_win) for a CTA
    of `rows` rows spanning `ny` grid rows, as csrc/som_fused_chunked_tc.cuh:
    WalkSmem::bytes and SeparableW::floats count it (floats, 4 bytes each):
    the ring's two slots, each the larger of an update chunk and a winner
    chunk, the previous tile, ||m||^2, the winner reduction and the tables'
    staging.  A mirror of the C layout, to check that every D fits."""
    def c32(n):
        return -(-n // 32) * 32
    planes, dp, bc = (1 if batch_bf16 else 2), feature_passes(D)[1], 32
    dsu, dt, xw = c32(dp) + 8, c32(dp) + 4, max(dp, 32) // 4 + 4
    bw = INT8_WIN_CHUNK if int8_win else 32
    slot = max(planes * bc * dsu, bw * xw if int8_win else planes * bw * dt)
    prev = rows * xw if int8_win else planes * rows * dt
    ring = 2 * slot + prev + rows + 2 * (rows // 16) * bw
    staging = 2 * ((rows + ny) * (bc + 4) + bc) + rows
    return 4 * (ring + staging)


def _fused_step_separable(codes, xb, bmu, xb_next, xdim, hexa, aw, radius,
                          gaussian, chunked=False, batch_chunk=None,
                          wxa_bf16=False, batch_bf16=False, stagger=False,
                          int8_win=False):
    """K13 (`chunked` False) or K14 on checked arguments (its plain version
    on the CPU): K14's main form, or its walk under `stagger` or `int8_win`,
    counted as the module docstring says.  One scratch buffer holds the
    winner keys (Bn u64), alpha (B), the y-factor table (ceil(noc / xdim), B)
    and the x-pattern (2 xdim or xdim, B; bf16 under wxa_bf16 off the Hopper
    walk), their rows B padded to a multiple of 64 for K13's and K14's
    walk, whose K14 cluster is K14_CLUSTER or `k14_cluster` checked on the
    card; another the
    split batches (x' not split under int8_win); under int8_win the quantized
    next batch, padded by `int8_win_staged`, and its scales come from
    `int8_win_inputs`, on the device."""
    dev = codes.device
    if dev.type == "cpu":
        return _separable_plain(codes, xb, bmu, xb_next, xdim, hexa, aw,
                                radius, gaussian, chunked, batch_chunk,
                                wxa_bf16, batch_bf16, stagger, int8_win)
    wxa_bf16 = bool(wxa_bf16 and gaussian)
    xq, q = (int8_win_inputs(codes, xb, xb_next, batch_bf16) if int8_win
             else (None, None))
    if int8_win:
        xq = int8_win_staged(xq)
    noc, D = codes.shape
    B, Bn = xb.shape[0], xb_next.shape[0]
    n_pat = 2 * xdim if hexa else xdim
    walk = chunked and bool(stagger or int8_win)
    # K13's or K14's main form on the Hopper walk (tables' rows padded to 64,
    # a float32 x-pattern: K14's wxa_bf16 rounds its values)
    sm90 = not walk and (k14_route(D) if chunked else k13_route(D)) == "sm90"
    ld = -(-B // 64) * 64 if sm90 else B
    words = [2 * Bn, ld, -(-noc // xdim) * ld]  # float32 words before the pattern
    offs = [4 * sum(words[:k]) for k in range(4)]
    pat_words = -(-n_pat * ld // 2) if wxa_bf16 and not sm90 else n_pat * ld
    scratch = torch.empty((sum(words) + pat_words,), dtype=torch.float32,
                          device=dev)
    keys, aw_eff, ytab, pat = (scratch.data_ptr() + o for o in offs)
    val = torch.empty((Bn,), dtype=torch.float32, device=dev)
    idx = torch.empty((Bn,), dtype=torch.int32, device=dev)
    rows32 = _rows32(codes)
    xb, xn = xb.contiguous(), xb_next.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if sm90 and chunked:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        cluster = K14_CLUSTER or _k14_cluster_on(noc, D, bool(batch_bf16), sms)
        xs = sm90_scratch(B, Bn, D, dev, 1 if batch_bf16 else 2, table=False)
        _build.call("somvq_som_fused_chunked_sm90", codes.data_ptr(),
                    int(codes.dtype == torch.bfloat16), noc, D, xb.data_ptr(),
                    bmu.data_ptr(), aw.data_ptr(), B, xn.data_ptr(), Bn, int(xdim),
                    int(bool(hexa)), int(bool(gaussian)), float(radius), int(wxa_bf16),
                    int(bool(batch_bf16)), int(cluster), xs.data_ptr(), pat, ytab, aw_eff,
                    keys, val.data_ptr(), idx.data_ptr(), stream)
        som_fused_factored_chunked_step.launches += 1
        return codes, idx, val
    if sm90:
        xs = sm90_scratch(B, Bn, D, dev, table=False)
        _build.call("somvq_som_fused_factored_sm90", codes.data_ptr(),
                    int(codes.dtype == torch.bfloat16), noc, D, xb.data_ptr(),
                    bmu.data_ptr(), aw.data_ptr(), B, xn.data_ptr(), Bn, int(xdim),
                    int(bool(hexa)), int(bool(gaussian)), float(radius), xs.data_ptr(),
                    pat, ytab, aw_eff, keys, val.data_ptr(), idx.data_ptr(), stream)
        som_fused_factored_step.launches += 1
        return codes, idx, val
    if chunked:
        xs = _split_scratch(B, 0 if int8_win else Bn, D, dev, 1 if batch_bf16 else 2)
        rows = k14_rows(D, bool(stagger))
    else:
        xs, rows = _split_scratch(B, Bn, D, dev), k13_rows(noc, D, dev)
    _build.call("somvq_som_fused_factored", codes.data_ptr(),
                int(codes.dtype == torch.bfloat16), noc, D, xb.data_ptr(),
                bmu.data_ptr(), aw.data_ptr(), B, xn.data_ptr(), Bn, int(xdim),
                int(bool(hexa)), int(bool(gaussian)), float(radius),
                int(chunked), int(wxa_bf16), int(bool(batch_bf16)),
                K14_STAGGER_CTAS if stagger else 0, int(bool(int8_win)), rows,
                xs.data_ptr(), xq.data_ptr() if int8_win else None,
                q.data_ptr() if int8_win else None, pat, ytab, aw_eff, keys,
                val.data_ptr(), idx.data_ptr(),
                rows32.data_ptr() if rows32 is not None else None, stream)
    if not walk:
        wrapper = som_fused_factored_chunked_step if chunked else som_fused_factored_step
        wrapper.launches += 1
    CHUNKED_INT8_WIN.launches += bool(int8_win)
    CHUNKED_STAGGER.launches += bool(stagger)
    return codes, idx, val


def som_fused_train_step(
    codes: torch.Tensor,
    xb: torch.Tensor,
    bmu: torch.Tensor,
    xb_next: torch.Tensor,
    xdim: int,
    hexa: bool,
    alpha: Union[float, torch.Tensor],
    radius: float,
    gaussian: bool = False,
    unit_offset: Optional[int] = None,
    *,
    tile_n: int = 1024,
    factored: Optional[bool] = None,
    batch_chunk: Optional[int] = None,
    wxa_bf16: bool = False,
    batch_bf16: bool = False,
    stagger: bool = False,
    int8_win: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Update `codes` (noc, D) in place with batch `xb` (B, D) whose BMUs
    are `bmu` (B,); return (codes, bmu_next (B',) int32, val_next (B',))
    for `xb_next` (B', D).  `alpha` is a scalar or (B,) per-sample alpha.
    Routes to K3, K13 or K14 as the module docstring says; K3 launches are
    counted here."""
    bmu, aw = _step_args(codes, xb, bmu, xb_next, alpha)
    noc = codes.shape[0]
    tile_n = min(tile_n, -(-noc // 8) * 8)
    if factored is None:
        factored = unit_offset is None and factored_geometry_ok(
            noc, xdim, tile_n, hexa)
    if factored and unit_offset is not None:
        raise ValueError("som_fused_train_step: unit_offset needs "
                         "factored=False (the separable x-pattern assumes the "
                         "map starts at unit 0)")
    if factored:
        if not factored_geometry_ok(noc, xdim, tile_n, hexa):
            raise ValueError(
                f"som_fused_train_step: the separable path needs noc % tile_n "
                f"== 0, tile_n % xdim == 0, xdim % 8 == 0 (and an even number "
                f"of grid rows per tile, or one, for hexa); got noc={noc} "
                f"xdim={xdim} tile_n={tile_n} hexa={hexa}")
        if (batch_chunk is not None or stagger or wxa_bf16 or batch_bf16
                or int8_win):
            _batch_chunk(xb.shape[0], xb_next.shape[0], batch_chunk)
            return _fused_step_separable(codes, xb, bmu, xb_next, xdim, hexa,
                                         aw, radius, gaussian, True,
                                         batch_chunk, wxa_bf16, batch_bf16,
                                         stagger, int8_win)
        return _fused_step_separable(codes, xb, bmu, xb_next, xdim, hexa, aw,
                                     radius, gaussian)
    offset = unit_offset or 0
    if offset < 0:
        raise ValueError(f"unit_offset {offset} < 0")
    return _fused_step_k3(codes, xb, bmu, xb_next, xdim, hexa, aw, radius,
                          gaussian, offset)


# The widest D K3 and K17 run on their Hopper walk (csrc/fused_step_sm90.cuh):
# past it a thread's two float32 accumulators of the update (D / 2 values
# each) and W's two fragment sets would not fit in a consumer's 232 registers
SM90_MAX_D = 128


def k3_route(D: int) -> str:
    """K3's kernel for D features, a route by shape: "sm90", the Hopper walk
    (csrc/fused_step_sm90.cu: TMA ring, wgmma TF32), up to SM90_MAX_D;
    "mma_sync" (csrc/som_fused_step.cu) past it, at any D (in feature passes
    past PASS_D).  Both give the same floats; K17 (ops.skeleton) routes by the
    same rule."""
    if D < 1:
        raise ValueError(f"K3 takes D >= 1, got {D}")
    return "sm90" if D <= SM90_MAX_D else "mma_sync"


def k13_route(D: int) -> str:
    """K13's kernel for D features, K3's rule (`k3_route`): "sm90", K3's
    Hopper walk with the separable W (csrc/separable_sm90.cuh, entry in
    csrc/som_fused_factored_sm90.cu), up to
    SM90_MAX_D; "mma_sync" (csrc/som_fused_factored.cu) past it, at any D.
    Both give the same floats."""
    return k3_route(D)


def sm90_width(D: int) -> int:
    """DP, the Hopper walk's feature width: 32, 64 or 128, the smallest that
    covers D (one, two or four 128-byte rows of 32 TF32 values)."""
    if not 1 <= D <= SM90_MAX_D:
        raise ValueError(f"the Hopper walk takes 1 <= D <= {SM90_MAX_D}, got {D}")
    return 32 if D <= 32 else 64 if D <= 64 else 128


def sm90_scratch(B: int, Bn: int, D: int, dev, planes: int = 2,
                 table: bool = True) -> torch.Tensor:
    """Scratch of the Hopper walk's prologue (csrc/fused_step_sm90.cuh:
    split_sm90_kernel): `planes` planes of the batch transposed, (DP, Bp),
    and of the next batch, (Bnp, DP), then with `table` K3's per-sample
    float4 table (Bp,); Bp and Bnp are B and Bn rounded up to 64.  K13 on
    the walk takes no table (its W comes from the step's tables), K17 none
    either."""
    Bp, Bnp = -(-B // 64) * 64, -(-Bn // 64) * 64
    n = planes * sm90_width(D) * (Bp + Bnp) + (4 * Bp if table else 0)
    return torch.empty((n,), dtype=torch.float32, device=dev)


def _fused_step_k3(codes, xb, bmu, xb_next, xdim, hexa, aw, radius, gaussian,
                   unit_offset):
    """K3 on `som_fused_train_step`'s checked arguments (its plain version on
    the CPU), on the kernel `k3_route` names; counts its launches on
    `som_fused_train_step`."""
    dev = codes.device
    if dev.type == "cpu":
        return som_fused_train_step_plain(codes, xb, bmu, xb_next, xdim, hexa,
                                          aw, radius, gaussian, unit_offset)
    xb = xb.contiguous()
    xn = xb_next.contiguous()
    B, Bn = xb.shape[0], xn.shape[0]
    D = codes.shape[1]
    sm90 = k3_route(D) == "sm90"
    xs = sm90_scratch(B, Bn, D, dev) if sm90 else _split_scratch(B, Bn, D, dev)
    keys = torch.empty((Bn,), dtype=torch.int64, device=dev)
    val = torch.empty((Bn,), dtype=torch.float32, device=dev)
    idx = torch.empty((Bn,), dtype=torch.int32, device=dev)
    args = [codes.data_ptr(), int(codes.dtype == torch.bfloat16), codes.shape[0],
            codes.shape[1], xb.data_ptr(), bmu.data_ptr(), aw.data_ptr(), B,
            xn.data_ptr(), Bn, int(xdim), int(bool(hexa)), int(bool(gaussian)),
            float(radius), int(unit_offset), xs.data_ptr(), keys.data_ptr(),
            val.data_ptr(), idx.data_ptr()]
    if not sm90:
        rows32 = _rows32(codes)
        args.append(rows32.data_ptr() if rows32 is not None else None)
    _build.call("somvq_som_fused_step_sm90" if sm90 else "somvq_som_fused_step",
                *args, torch.cuda.current_stream(dev).cuda_stream)
    som_fused_train_step.launches += 1
    return codes, idx, val


som_fused_train_step.launches = 0
som_fused_factored_step.launches = 0
som_fused_factored_chunked_step.launches = 0
