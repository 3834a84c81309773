"""The fused step's skeleton: kernel K17 (`fused_step_skeleton`), the
counterpart of bench.py:_skeleton_kernel (:505, called at :556), the
matmul-only twin of the fused SOM step that the JAX bench turns into
`roofline_attainable_pct` (bench.py:1059-1063).

One W block (T, B) serves every T-row tile of the codebook, as bench.py:561
maps it:

    out[u]  = codes[u] + scale * sum_b w[u % T, b] x[b]
    vmax[b] = max_u out[u] . xn[b],  out[u] rounded to xn's type first

with no weight generation, no blend and no argmax.  `w`, `x` and `xn` are all
float32 or all bf16 (bench.py:585-587); sums are float32.  `scale` is 1e-30 in
the bench, below the ulp of every code, so `out` is `codes` there; it is an
argument only so that a check can see the accumulation.

A CUDA tensor launches the kernel `k17_route` names: for D <= 128 the Hopper
walk K3 runs on (`csrc/fused_skeleton_sm90.cu`: a TMA ring fed by a producer
warpgroup, wgmma TF32, W read and split in the consumers' registers), past it
the mma.sync kernel in `csrc/fused_skeleton.cu`, the two bit-equal; a CPU
tensor runs the plain version beside it.  Any other device raises.  The wrapper
counts its kernel launches in its `launches` attribute.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .distance import fp32_matmul
from .som_step import k3_route, sm90_scratch


def _check(codes, w, x, xn) -> str:
    if any(t.dim() != 2 for t in (codes, w, x, xn)):
        raise ValueError("codes, w, x and xn must be 2-D")
    N, D = codes.shape
    if x.shape[1] != D or xn.shape[1] != D or w.shape[1] != x.shape[0]:
        raise ValueError(f"shape mismatch: codes {tuple(codes.shape)}, w "
                         f"{tuple(w.shape)}, x {tuple(x.shape)}, xn {tuple(xn.shape)}")
    if 0 in codes.shape or 0 in w.shape or xn.shape[0] == 0:
        raise ValueError("empty codes, w, x or xn")
    if codes.dtype != torch.float32:
        raise TypeError("codes must be float32")
    if w.dtype not in (torch.float32, torch.bfloat16) or \
            x.dtype != w.dtype or xn.dtype != w.dtype:
        raise TypeError("w, x and xn must all be float32 or all bfloat16")
    if any(t.device != codes.device for t in (w, x, xn)):
        raise ValueError("codes, w, x and xn must share one device")
    dev = codes.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {codes.device}")
    return dev


def k17_route(D: int) -> str:
    """K17's kernel for D features: K3's rule (`ops.som_step.k3_route`), so
    that the skeleton stays on the route of the step it measures."""
    return k3_route(D)


def fused_step_skeleton_plain(codes, w, x, xn, scale: float = 1e-30
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K17: the (T, D) block W.X once, spread over the rows; vmax over
    row blocks of about 1 GiB."""
    fp32_matmul()
    N, T = codes.shape[0], w.shape[0]
    acc = w.to(torch.float32) @ x.to(torch.float32)
    rows = torch.arange(N, device=codes.device) % T
    out = codes + acc[rows] * scale
    cw = out.to(xn.dtype).to(torch.float32)
    xw = xn.to(torch.float32)
    step = max(1, (1 << 28) // xn.shape[0])
    vmax = None
    for lo in range(0, N, step):
        part = (cw[lo:lo + step] @ xw.T).amax(0)
        vmax = part if vmax is None else torch.maximum(vmax, part)
    return out, vmax


def fused_step_skeleton(codes: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                        xn: torch.Tensor, scale: float = 1e-30
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K17 on codes (N, D) float32, w (T, B), x (B, D), xn (B', D): returns
    (out (N, D) float32, vmax (B',) float32) as the module docstring says."""
    if _check(codes, w, x, xn) == "cpu":
        return fused_step_skeleton_plain(codes, w, x, xn, scale)
    dev = codes.device
    codes, w, x, xn = (t.contiguous() for t in (codes, w, x, xn))
    N, D = codes.shape
    Bn = xn.shape[0]
    out = torch.empty_like(codes)
    vkeys = torch.zeros((Bn,), dtype=torch.int32, device=dev)  # read as u32
    vmax = torch.empty((Bn,), dtype=torch.float32, device=dev)
    bf16 = w.dtype == torch.bfloat16
    args = (codes.data_ptr(), N, D, w.data_ptr(), w.shape[0], x.data_ptr(),
            x.shape[0], xn.data_ptr(), Bn, int(bf16), float(scale), out.data_ptr(),
            vkeys.data_ptr(), vmax.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if k17_route(D) == "sm90":
        xs = sm90_scratch(x.shape[0], Bn, D, dev, 1 if bf16 else 2, table=False)
        _build.call("somvq_fused_skeleton_sm90", *args, xs.data_ptr(), stream)
    else:
        _build.call("somvq_fused_skeleton", *args, stream)
    fused_step_skeleton.launches += 1
    return out, vmax


fused_step_skeleton.launches = 0
