"""Fused 1-NN winner search: kernels K1 (`dist_argmin`), K2
(`dist_argmin_t`) and K4 (`dist_argmin_masked`), counterparts of
som_lvq_pak_tpu/ops/pallas_distance.py.

All return (sq_dists (B,) float32, indices (B,) int32): the kernel's
partial distance plus ||x||^2, clamped at 0.  Ties go to the lowest index.

* `dist_argmin` scores ||m||^2 - 2 x.m with a strict-< running min
  (replaces `_dist_argmin_kernel`); the trainer's prologue winner, the LVQ
  steps' and every sharded winner search's.  Given a `mask` it runs
  `dist_argmin_masked`.
* `dist_argmin_t` scores x.m - ||m||^2 / 2 with a strict-> running max and
  reports -2 * best (replaces `_dist_argmin_t_kernel`); the fast qerror's
  winner search.
* K1 and K2 run one walk on the tensor cores (`csrc/argmin_sm90.cu`):
  a prologue (`split_codes_kernel`, counted on `split_codes.launches`) splits
  the codebook once per call into TF32 hi and lo rows and sums ||m||^2; the
  walk streams them by TMA into a shared-memory ring and takes split-TF32
  products (float32 accuracy) on warpgroup `wgmma`, the codebook split
  across CTAs by `k1_sm90_splits`.  Halving and doubling are exact, so
  -2 fl(x.m - ||m||^2 / 2) = fl(||m||^2 - 2 x.m): the two return the same
  values and winners bit for bit, on the card and in their plain versions
  alike.  The JAX package's two forms differ (its K1 takes an XLA-computed
  ||m||^2), so near-tie winners may differ from its `dist_argmin`.
* `dist_argmin_masked` scores keep.(m o m) - 2 (x keep).m, where `mask`
  (B, D) is nonzero on masked components (replaces
  `_dist_argmin_masked_kernel`); ||x keep||^2 is added back, so a sample
  with every component masked gets index 0 and value 0.  The masked
  training step's and the masked qerror's winner search.  Its kernel (K4,
  `csrc/argmin_masked_sm90.cu`) is K1's walk with the keep contraction
  beside it: a prologue (`split_masked_codes_kernel`) splits the codebook
  and q = m o m once per call into TF32 hi and lo rows, the walk streams
  them by TMA and takes (x keep).m by three TF32 products and keep.q by two
  (keep is exact in TF32) on warpgroup `wgmma`, into two sums, the codebook
  split across CTAs by `k4_sm90_splits`.  Two runs are bit-equal.  The
  masked top-2 search (`ops.dist_top2.dist_top2_masked`, K9) is the same
  walk with a top-2 fold.

A CUDA tensor launches the kernel; a CPU tensor runs the plain version
beside it.  Any other device raises.  Each wrapper counts its kernel
launches in its `launches` attribute (`split_codes` K1's and K2's
prologue's, which K8 launches too; `split_masked_codes` the calls of K4's
prologue alone, which K4's and K9's own calls launch in their C call).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from .distance import fp32_matmul, keep_of, mask_bytes


def _rows_per_chunk(n: int) -> int:
    # keep each (rows, N) score block of the plain versions near 1 GiB
    return max(1, (1 << 28) // max(1, n))


def _check(x: torch.Tensor, codes: torch.Tensor) -> str:
    if x.dim() != 2 or codes.dim() != 2 or x.shape[1] != codes.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and codes {tuple(codes.shape)} "
                         "must be (B, D) and (N, D)")
    if x.dtype != torch.float32 or codes.dtype != torch.float32:
        raise TypeError("x and codes must be float32")
    if x.device != codes.device:
        raise ValueError(f"x on {x.device}, codes on {codes.device}")
    if codes.shape[0] == 0:
        raise ValueError("empty codebook")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def _check_mask(x: torch.Tensor, mask: torch.Tensor) -> None:
    if mask.shape != x.shape:
        raise ValueError(f"mask {tuple(mask.shape)} must match x {tuple(x.shape)}")
    if mask.device != x.device:
        raise ValueError(f"x on {x.device}, mask on {mask.device}")


def dist_argmin_masked_plain(x: torch.Tensor, codes: torch.Tensor,
                             mask: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K4: argmin of keep.(m o m) - 2 (x keep).m, first index on
    ties."""
    fp32_matmul()
    keep = keep_of(mask)
    xk = x * keep
    mm = codes * codes
    vals, idxs = [], []
    step = _rows_per_chunk(codes.shape[0])
    for s in range(0, x.shape[0], step):
        xc, kc = xk[s:s + step], keep[s:s + step]
        d = kc @ mm.T - 2.0 * (xc @ codes.T)
        i = torch.argmin(d, dim=1)
        x2 = (xc * xc).sum(-1)
        vals.append(torch.clamp(d.gather(1, i[:, None])[:, 0] + x2, min=0.0))
        idxs.append(i.to(torch.int32))
    return torch.cat(vals), torch.cat(idxs)


def dist_argmin_plain(x: torch.Tensor, codes: torch.Tensor,
                      mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K1 (K4 given a mask): argmin of ||m||^2 - 2 x.m, first index
    on ties."""
    if mask is not None:
        return dist_argmin_masked_plain(x, codes, mask)
    fp32_matmul()
    m2 = (codes * codes).sum(-1)
    vals, idxs = [], []
    step = _rows_per_chunk(codes.shape[0])
    for s in range(0, x.shape[0], step):
        xc = x[s:s + step]
        d = m2[None, :] - 2.0 * (xc @ codes.T)
        i = torch.argmin(d, dim=1)
        x2 = (xc * xc).sum(-1)
        vals.append(torch.clamp(d.gather(1, i[:, None])[:, 0] + x2, min=0.0))
        idxs.append(i.to(torch.int32))
    return torch.cat(vals), torch.cat(idxs)


def dist_argmin_t_plain(x: torch.Tensor, codes: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K2: argmax of x.m - ||m||^2 / 2, first index on ties."""
    fp32_matmul()
    m2h = 0.5 * (codes * codes).sum(-1)
    vals, idxs = [], []
    step = _rows_per_chunk(codes.shape[0])
    for s in range(0, x.shape[0], step):
        xc = x[s:s + step]
        sc = (xc @ codes.T) - m2h[None, :]
        i = torch.argmax(sc, dim=1)
        x2 = (xc * xc).sum(-1)
        vals.append(torch.clamp(-2.0 * sc.gather(1, i[:, None])[:, 0] + x2,
                                min=0.0))
        idxs.append(i.to(torch.int32))
    return torch.cat(vals), torch.cat(idxs)


def k2_splits(B: int, N: int, device: torch.device) -> int:
    """The codebook splits of the mma.sync walk of K16: enough
    spans of whole 64-row tiles for about two CTAs of 128 samples per SM,
    rounded down to whole waves: exactly two of them fit on an SM (their
    registers), so a count that leaves a partial second wave costs a whole
    one (at B 4096, 9 splits would be 288 CTAs on 264 slots of an H100)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    b_tiles, n_tiles = -(-B // 128), -(-N // 64)
    return max(1, min(n_tiles, 2 * sms // b_tiles))


# K1's and K2's walk (csrc/argmin_sm90.cu): codes per tile (the wgmma's N),
# samples per CTA, and the fewest tiles a split takes
K1_TILE = 128
K1_SAMPLES = 128
K1_MIN_SPAN = 4


def k1_sm90_splits(B: int, N: int, sms: int) -> int:
    """K1's, K2's, K8's and K10's codebook splits on a card of `sms` SMs: spans of whole
    128-code tiles, as many as fill one wave of CTAs of 128 samples, one CTA
    an SM (its ring takes about 196 KB of shared memory), rounded down to
    whole waves, and at least K1_MIN_SPAN tiles each, so that a CTA's ring
    has tiles to overlap: at B 4096 four splits (128 CTAs on an H100's 132
    SMs), at B 1024 sixteen, at the eval's 1M one, at the scans' B 1 x 4096
    eight.  Measured on one H100 (PR 23): at B 4096 x 65536 x 64 the walk
    took 1.84, 0.90, 0.46, 0.46, 0.47 ms at 1, 2, 4, 8, 16 splits; at B 1 x
    4096, 0.022 ms at 8 splits and 0.034 at 32."""
    b_tiles, n_tiles = -(-B // K1_SAMPLES), -(-N // K1_TILE)
    return max(1, min(n_tiles // K1_MIN_SPAN, sms // b_tiles))


def _spans(N: int, splits: int, tile: int) -> list:
    tiles = -(-N // tile)
    span = -(-tiles // splits)
    return [(t * tile, min(N, (t + span) * tile)) for t in range(0, tiles, span)]


def k1_sm90_spans(N: int, splits: int) -> list:
    """The code ranges [lo, hi) the walk's CTAs take for `splits`
    (csrc/argmin_sm90.cu's launch): spans of ceil(tiles / splits) whole
    tiles, the last cut at N; only non-empty spans get CTAs."""
    return _spans(N, splits, K1_TILE)


# K4's walk (csrc/argmin_masked_sm90.cu): codes per tile (the wgmma's N; a
# slot holds four arrays, so half K1's), samples per CTA, and the fewest
# tiles a split takes (K1's 512 codes)
K4_TILE = 64
K4_SAMPLES = 128
K4_MIN_SPAN = 8


def k4_sm90_splits(B: int, N: int, sms: int) -> int:
    """K4's and K9's codebook splits on a card of `sms` SMs: K1's rule on 64-code
    tiles: spans of whole tiles, as many as fill one wave of CTAs of 128
    samples, one CTA an SM (its ring takes about 193 KB of shared memory at
    D 64), rounded down to whole waves, and at least K4_MIN_SPAN tiles
    each: at B 4096 four splits (128 CTAs on an H100's 132 SMs), at the
    LVQ step's B 1024 x 65536 sixteen, at the masked LVQ cell's B 1024 x
    4096 eight, at the eval's 1M one, at the scans' B 1 x 4096 eight."""
    b_tiles, n_tiles = -(-B // K4_SAMPLES), -(-N // K4_TILE)
    return max(1, min(n_tiles // K4_MIN_SPAN, sms // b_tiles))


def k4_sm90_spans(N: int, splits: int) -> list:
    """The code ranges [lo, hi) K4's CTAs take for `splits`
    (csrc/argmin_masked_sm90.cu's launch), as `k1_sm90_spans` on 64-code
    tiles."""
    return _spans(N, splits, K4_TILE)


def split_codes_dp(D: int) -> int:
    """The row length of K1's split codebook: one 32-feature chunk (a
    128-byte swizzled row of the TMA tile) up to D 32, else whole
    64-feature slabs; zeros past D."""
    return 32 if D <= 32 else -(-D // 64) * 64


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fl(a b + c) with one rounding, as the card's fmaf: a b is
    exact in float64 and TwoSum recovers the float64 sum's error, which
    decides only where the float64 sum lies on a float32 rounding midpoint
    (the one place rounding twice can differ from rounding once)."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    r64 = r.double()
    inf = torch.full_like(r, float("inf"))
    o = torch.nextafter(r, torch.where(s > r64, inf, -inf))  # r's neighbour on s's side
    mid = (s != r64) & ((r64 + o.double()) * 0.5 == s)
    return torch.where(mid & (e != 0) & ((e > 0) == (o > r)), o, r)


def split_codes_plain(codes: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain K1/K2 prologue: (hi, lo) (N, Dp) float32, hi = tf32(m) and lo =
    tf32(m - hi) with zeros past D (Dp = `split_codes_dp(D)`), and m2 (N,)
    = ||m||^2 summed as the kernel sums it: per 64-feature slab, lane f
    takes fma(v[f + 32], v[f + 32], v[f] v[f]), the 32 lanes meet by an xor
    tree over 16, 8, 4, 2, 1 (lane 0's sums), and the slabs add left to
    right."""
    from .tf32x3 import tf32_split

    N, D = codes.shape
    slabs = -(-D // 64)
    v = torch.zeros((N, 64 * slabs), dtype=torch.float32, device=codes.device)
    v[:, :D] = codes
    hi, lo = tf32_split(v[:, :split_codes_dp(D)].contiguous())
    w = v.view(N, slabs, 2, 32)
    sq = _fma32(w[:, :, 1], w[:, :, 1], w[:, :, 0] * w[:, :, 0])  # (N, slabs, 32 lanes)
    lanes = torch.arange(32, device=codes.device)
    for off in (16, 8, 4, 2, 1):
        sq = sq + sq[..., lanes ^ off]
    m2 = sq[:, 0, 0]
    for sl in range(1, slabs):
        m2 = m2 + sq[:, sl, 0]
    return hi, lo, m2


def split_masked_codes_plain(codes: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain K4 prologue: (hi, lo, qhi, qlo) (N, Dp) float32 with Dp =
    `split_codes_dp(D)` and zeros past D: hi = tf32(m), lo = tf32(m - hi),
    and the same of q = m * m rounded to float32."""
    from .tf32x3 import tf32_split

    N, D = codes.shape
    v = torch.zeros((N, split_codes_dp(D)), dtype=torch.float32, device=codes.device)
    v[:, :D] = codes
    return (*tf32_split(v), *tf32_split(v * v))


def _check_codes(codes: torch.Tensor) -> None:
    if codes.dim() != 2 or codes.dtype != torch.float32 or codes.shape[0] == 0:
        raise ValueError(f"codes {tuple(codes.shape)} {codes.dtype}: a non-empty "
                         "(N, D) float32 codebook")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {codes.device}")


def split_masked_codes(codes: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """K4's prologue alone: the codebook (N, D) float32 split once into TF32
    (hi, lo, qhi, qlo) (N, Dp) rows, as `split_masked_codes_plain` computes
    them, bit for bit.  `dist_argmin_masked` launches the same kernel in the
    C call of its walk, into its scratch; this wrapper counts its own calls
    on `split_masked_codes.launches`."""
    _check_codes(codes)
    if codes.device.type == "cpu":
        return split_masked_codes_plain(codes)
    codes = codes.contiguous()
    N, D = codes.shape
    Dp = split_codes_dp(D)
    out = tuple(torch.empty((N, Dp), dtype=torch.float32, device=codes.device)
                for _ in range(4))
    _build.call("somvq_split_masked_codes", codes.data_ptr(), N, D, Dp,
                *(t.data_ptr() for t in out),
                torch.cuda.current_stream(codes.device).cuda_stream)
    split_masked_codes.launches += 1
    return out


def split_codes(codes: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's and K2's prologue alone: the codebook (N, D) float32 split once
    into TF32 (hi, lo) (N, Dp) rows and ||m||^2 (N,), as `split_codes_plain`
    computes them, bit for bit.  `dist_argmin` and `dist_argmin_t` launch the
    same kernel in the C call of their walk, into their scratch, and count
    it on `split_codes.launches` too."""
    _check_codes(codes)
    if codes.device.type == "cpu":
        return split_codes_plain(codes)
    codes = codes.contiguous()
    N, D = codes.shape
    Dp = split_codes_dp(D)
    hi = torch.empty((N, Dp), dtype=torch.float32, device=codes.device)
    lo = torch.empty((N, Dp), dtype=torch.float32, device=codes.device)
    m2 = torch.empty((N,), dtype=torch.float32, device=codes.device)
    _build.call("somvq_split_codes", codes.data_ptr(), N, D, Dp, hi.data_ptr(),
                lo.data_ptr(), m2.data_ptr(),
                torch.cuda.current_stream(codes.device).cuda_stream)
    split_codes.launches += 1
    return hi, lo, m2


def _launch(entry: str, wrapper, x: torch.Tensor, codes: torch.Tensor):
    x = x.contiguous()
    codes = codes.contiguous()
    B, D = x.shape
    N = codes.shape[0]
    val = torch.empty((B,), dtype=torch.float32, device=x.device)
    idx = torch.empty((B,), dtype=torch.int32, device=x.device)
    if B == 0:
        return val, idx
    Dp = split_codes_dp(D)
    # one C call launches the prologue and the walk; one scratch holds the
    # prologue's hi, lo (N, Dp) and m2 (N, padded to 4) and the (B,) u64
    # keys the walk folds its codebook splits into
    scratch = torch.empty((2 * N * Dp + -(-N // 4) * 4 + 2 * B,), dtype=torch.float32,
                          device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    _build.call(entry, x.data_ptr(), codes.data_ptr(), B, N, D, Dp,
                k1_sm90_splits(B, N, sms), scratch.data_ptr(), val.data_ptr(),
                idx.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    split_codes.launches += 1
    wrapper.launches += 1
    # the kernel returns the partial distance; add ||x||^2 here
    return torch.clamp(val + (x * x).sum(-1), min=0.0), idx


def dist_argmin(x: torch.Tensor, codes: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN winners of x (B, D) in codes (N, D): (sq_dists, int32 idx).
    `mask` (B, D), nonzero = masked, runs `dist_argmin_masked`."""
    if mask is not None:
        return dist_argmin_masked(x, codes, mask)
    if _check(x, codes) == "cpu":
        return dist_argmin_plain(x, codes)
    return _launch("somvq_dist_argmin", dist_argmin, x, codes)


def dist_argmin_masked(x: torch.Tensor, codes: torch.Tensor,
                       mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN winners over the unmasked components of each sample:
    (sq_dists, int32 idx)."""
    device = _check(x, codes)
    _check_mask(x, mask)
    if device == "cpu":
        return dist_argmin_masked_plain(x, codes, mask)
    x = x.contiguous()
    codes = codes.contiguous()
    m8 = mask_bytes(mask)
    B, D = x.shape
    N = codes.shape[0]
    val = torch.empty((B,), dtype=torch.float32, device=x.device)
    idx = torch.empty((B,), dtype=torch.int32, device=x.device)
    if B == 0:
        return val, idx
    Dp = split_codes_dp(D)
    # one C call launches the prologue and the walk; one scratch holds the
    # prologue's hi, lo, qhi, qlo (N, Dp) and the (B,) u64 keys the walk
    # folds its codebook splits into
    scratch = torch.empty((4 * N * Dp + 2 * B,), dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    _build.call("somvq_dist_argmin_masked", x.data_ptr(), m8.data_ptr(),
                codes.data_ptr(), B, N, D, Dp, k4_sm90_splits(B, N, sms),
                scratch.data_ptr(), val.data_ptr(), idx.data_ptr(),
                torch.cuda.current_stream(x.device).cuda_stream)
    dist_argmin_masked.launches += 1
    xk = x * keep_of(m8)
    return torch.clamp(val + (xk * xk).sum(-1), min=0.0), idx


def dist_argmin_t(x: torch.Tensor, codes: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN winners in the max-score form: (sq_dists, int32 idx)."""
    if _check(x, codes) == "cpu":
        return dist_argmin_t_plain(x, codes)
    return _launch("somvq_dist_argmin_t", dist_argmin_t, x, codes)


split_codes.launches = 0
split_masked_codes.launches = 0
dist_argmin.launches = 0
dist_argmin_masked.launches = 0
dist_argmin_t.launches = 0
