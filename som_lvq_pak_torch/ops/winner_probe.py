"""The winner-contraction probes: kernels K15 (`int8_winner_probe`) and K16
(`f32_winner_probe`), counterparts of tools/int8_probe.py's Pallas kernels
`kern` (:95, int8 x int8 -> int32) and `kern32` (:154, float32), which
measured whether the fused step's winners pay to run in int8 (the step's own
option is K14's `int8_win`, ops/som_step.py).

    out[b] = max_n sum_k m[n, k] x[k, b],   m (N, D), x (D, B)

A CUDA tensor launches the kernel (K15 in `csrc/winner_probe.cu`, `__dp4a`
on CUDA cores; K16 in `csrc/dist_argmin_t.cu`, K2's split-TF32 tensor-core
body without the norm, its codebook split by `k2_splits`); a CPU tensor runs
the plain version beside it.  Any other device raises.  Each wrapper counts
its kernel launches in its `launches` attribute.

Both kernels are exact on the probe's inputs: an int8 dot is exact in int32,
and integer-valued float32 inputs with |v| <= 127 are exact in TF32 (the
split's lo is zero) with every partial sum an integer below 2^24 (D 64: at
most 64 * 127^2), exact in float32.  The plain versions take the products in
float64 (exact for such inputs), so the kernels are held to them bit for
bit.  On other float32 inputs K16 carries split TF32's rounding (about 2^-21
relative per product, `ops.tf32x3`).
"""

from __future__ import annotations

import torch

from .. import _build
from .dist_argmin import k2_splits

INT32_MIN = -(2 ** 31)


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
    """K15: m (N, D) int8, x (D, B) int8 -> (B,) int32 = max_n m[n] . x[:, b]."""
    if _check(m, x, torch.int8) == "cpu":
        return int8_winner_probe_plain(m, x)
    m, x = m.contiguous(), x.contiguous()
    out = torch.full((x.shape[1],), INT32_MIN, dtype=torch.int32, device=m.device)
    _build.call("somvq_int8_winner_probe", m.data_ptr(), x.data_ptr(), m.shape[0],
                m.shape[1], x.shape[1], out.data_ptr(),
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
