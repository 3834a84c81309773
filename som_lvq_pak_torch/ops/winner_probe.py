"""The winner-contraction probes: kernels K15 (`int8_winner_probe`) and K16
(`f32_winner_probe`), counterparts of tools/int8_probe.py's Pallas kernels
`kern` (:95, int8 x int8 -> int32) and `kern32` (:154, float32), which
measured whether the fused step's winners pay to run in int8 (the step's own
option is K14's `int8_win`, ops/som_step.py).

    out[b] = max_n sum_k m[n, k] x[k, b],   m (N, D), x (D, B)

A CUDA tensor launches the kernel (K15 in `csrc/winner_probe.cu`: warpgroup
`wgmma` on int8 operands fed by a TMA ring, 128 samples a CTA, the codebook
split by `k15_splits`; K16 in `csrc/dist_argmin_t.cu`, the split-TF32
mma.sync walk K8 and K10 run, without the norm, its codebook split by
`k2_splits`); a
CPU tensor runs the plain version beside it.  Any other device raises.  Each
wrapper counts its kernel launches in its `launches` attribute.

K15 reads m through a TMA tensor map, which needs rows of a multiple of 16
bytes at a 16-byte aligned address: other m are copied once, zero-padded
(`k15_codes`).  Its shared memory holds x's block of 128 samples whole, so
D is at most `K15_MAX_D` (`k15_layout` raises past it).

Both kernels are exact on the probe's inputs: an int8 dot is exact in int32,
and integer-valued float32 inputs with |v| <= 127 are exact in TF32 (the
split's lo is zero) with every partial sum an integer below 2^24 (D 64: at
most 64 * 127^2), exact in float32.  The plain versions take the products in
float64 (exact for such inputs), so the kernels are held to them bit for
bit.  On other float32 inputs K16 carries split TF32's rounding (about 2^-21
relative per product, `ops.tf32x3`).
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from .dist_argmin import k2_splits

# K15's shapes (csrc/winner_probe.cu): codes per tile (the wgmma's N),
# samples per CTA, the dynamic shared memory a CTA may take, the ring's
# most slots, the barriers' bytes and the alignment slack
K15_TILE = 256
K15_SAMPLES = 128
K15_SMEM_MAX = 232448
_K15_MAX_STAGES = 8
_K15_BARRIER_BYTES = 2 * _K15_MAX_STAGES * 8
_K15_ALIGN = 1024


def _k15_layout(D: int) -> dict:
    W = 64 if D <= 64 else 128
    KC = -(-D // W)
    xs, slot = KC * K15_SAMPLES * W, K15_TILE * W
    stages = min(_K15_MAX_STAGES,
                 (K15_SMEM_MAX - _K15_ALIGN - _K15_BARRIER_BYTES - xs) // slot)
    return dict(W=W, KC=KC, stages=stages,
                bytes=_K15_ALIGN + stages * slot + xs + _K15_BARRIER_BYTES)


# the widest D whose x block leaves room for a ring that holds a whole tile
# (its KC chunks) and at least two slots
K15_MAX_D = max(D for D in range(128, 4097, 128)
                if _k15_layout(D)["stages"] >= max(2, _k15_layout(D)["KC"]))


def k15_layout(D: int) -> dict:
    """K15's shared memory at width D, as the C launcher lays it out: rows
    of W bytes (64 up to D 64, else 128: the swizzle span), KC chunks of W
    along D, x's block (KC x 128 samples x W), as many ring slots of 256
    codes x W as fit (at most 8), the barriers and the alignment slack.  A
    tile's KC chunks must be in the ring together: past K15_MAX_D they do
    not fit beside x's block, and this raises ValueError."""
    if D > K15_MAX_D:
        raise ValueError(f"int8_winner_probe takes D up to {K15_MAX_D}, not {D}: x's "
                         "block and a ring holding one tile of m would not fit in shared "
                         "memory")
    return _k15_layout(D)


def k15_splits(B: int, N: int, device: torch.device) -> int:
    """K15's codebook splits: spans of whole 256-code tiles, enough that the
    CTAs of 128 samples come to at most one per SM (one fits: its
    accumulators and ring), at least 1, at most the tiles."""
    b_tiles, n_tiles = -(-B // K15_SAMPLES), -(-N // K15_TILE)
    return max(1, min(n_tiles, _sm_count(torch.device(device)) // b_tiles))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def k15_codes(m: torch.Tensor) -> torch.Tensor:
    """m as K15's tensor map reads it: itself if its rows are a multiple of
    16 bytes at a 16-byte aligned address, else one zero-padded (N,
    ceil16(D)) copy (zeros add nothing to an int8 dot)."""
    N, D = m.shape
    if D % 16 == 0 and m.data_ptr() % 16 == 0:
        return m
    out = torch.zeros((N, -(-D // 16) * 16), dtype=m.dtype, device=m.device)
    out[:, :D] = m
    return out


def _check(m: torch.Tensor, x: torch.Tensor, dtype: torch.dtype) -> str:
    if m.dim() != 2 or x.dim() != 2 or m.shape[1] != x.shape[0]:
        raise ValueError(f"m {tuple(m.shape)} and x {tuple(x.shape)} must be (N, D) "
                         "and (D, B)")
    if m.dtype != dtype or x.dtype != dtype:
        raise TypeError(f"m and x must be {dtype}")
    if m.device != x.device:
        raise ValueError(f"m on {m.device}, x on {x.device}")
    if 0 in m.shape or x.shape[1] == 0:
        raise ValueError("empty m or x")
    if m.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {m.device}")
    return m.device.type


def _plain_max(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """max_n of m . x in float64, (rows, B) blocks of about 1 GiB."""
    xd = x.to(torch.float64)
    step = max(1, (1 << 27) // x.shape[1])
    best = None
    for lo in range(0, m.shape[0], step):
        part = (m[lo:lo + step].to(torch.float64) @ xd).amax(0)
        best = part if best is None else torch.maximum(best, part)
    return best


def int8_winner_probe_plain(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain K15: (B,) int32 max over rows of the exact int8 dot."""
    return _plain_max(m, x).to(torch.int32)


def f32_winner_probe_plain(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain K16: (B,) float32 max over rows of m . x (float64 products,
    rounded once)."""
    return _plain_max(m, x).to(torch.float32)


def int8_winner_probe(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K15: m (N, D) int8, x (D, B) int8 -> (B,) int32 = max_n m[n] . x[:, b],
    int8 wgmma on the tensor cores.  D at most K15_MAX_D on the card."""
    if _check(m, x, torch.int8) == "cpu":
        return int8_winner_probe_plain(m, x)
    (N, D), B = m.shape, x.shape[1]
    k15_layout(D)  # raises past K15_MAX_D
    mp, x = k15_codes(m.contiguous()), x.contiguous()
    out = torch.empty((B,), dtype=torch.int32, device=m.device)  # the C call fills it
    _build.call("somvq_int8_winner_probe", mp.data_ptr(), x.data_ptr(), N, D, mp.shape[1],
                B, k15_splits(B, N, m.device), out.data_ptr(),
                torch.cuda.current_stream(m.device).cuda_stream)
    int8_winner_probe.launches += 1
    return out


def f32_winner_probe(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K16: m (N, D) float32, x (D, B) float32 -> (B,) float32 = max_n
    m[n] . x[:, b], split-TF32 products on the tensor cores."""
    if _check(m, x, torch.float32) == "cpu":
        return f32_winner_probe_plain(m, x)
    m, x = m.contiguous(), x.contiguous()
    (N, D), B = m.shape, x.shape[1]
    # the kernel folds the codebook splits into a (B,) u64 key scratch
    keys = torch.empty((B,), dtype=torch.int64, device=m.device)
    out = torch.empty((B,), dtype=torch.float32, device=m.device)
    _build.call("somvq_f32_winner_probe", m.data_ptr(), x.data_ptr(), N, D, B,
                k2_splits(B, N, m.device), keys.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream(m.device).cuda_stream)
    f32_winner_probe.launches += 1
    return out


int8_winner_probe.launches = 0
f32_winner_probe.launches = 0
