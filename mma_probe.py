#!/usr/bin/env python3
"""The issue rate of mma.sync.m16n8k8 TF32 on this card: the ceiling of the
split-TF32 kernels K2 and K3 (som_lvq_pak_torch/csrc/tf32x3.cuh), which
issue three such products for each float32 product.

    python3 mma_probe.py        # one JSON line; needs a CUDA card and nvcc

Every warp of a grid of `ctas` CTAs x 8 warps runs `iters` rounds of `acc`
independent m16n8k8 TF32 mma.sync on register operands (no memory traffic),
timed by CUDA events after a warm-up.  The line gives TFLOP/s for each
(CTAs per SM, accumulators) pair, the best of them, its share of the
dense TF32 peak (495 TFLOP/s on an H100 SXM), and the split-TF32 ceiling
that follows: a third of the best.  The source is built with the kernels'
nvcc flags into som_lvq_pak_torch/_build/.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

PEAK_TF32_FLOPS = 495e12

SOURCE = r"""
#include <cuda_runtime.h>

template <int ACC>
__global__ void __launch_bounds__(256) mma_loop(int iters, float* out) {
  float d[ACC][4];
  for (int i = 0; i < ACC; ++i)
    for (int q = 0; q < 4; ++q) d[i][q] = 0.f;
  const unsigned a0 = __float_as_uint(1.0f + threadIdx.x), a1 = a0 ^ 1u,
                 a2 = a0 ^ 2u, a3 = a0 ^ 3u, b0 = a0 ^ 4u, b1 = a0 ^ 5u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < ACC; ++i)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int i = 0; i < ACC; ++i) s += d[i][0] + d[i][1] + d[i][2] + d[i][3];
  if (s == 12345.f) out[0] = s;  // keeps the loop; never true in practice
}

extern "C" int mma_probe(int acc, int ctas, int iters, float* out,
                         cudaStream_t stream) {
  switch (acc) {
    case 4: mma_loop<4><<<ctas, 256, 0, stream>>>(iters, out); break;
    case 8: mma_loop<8><<<ctas, 256, 0, stream>>>(iters, out); break;
    case 16: mma_loop<16><<<ctas, 256, 0, stream>>>(iters, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""


def build() -> ctypes.CDLL:
    from som_lvq_pak_torch import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "mma_probe.cu")
    lib = os.path.join(_build.BUILD_DIR, "libmma_probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, src],
                   check=True, capture_output=True, text=True)
    cdll = ctypes.CDLL(lib)
    cdll.mma_probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p]
    cdll.mma_probe.restype = ctypes.c_int
    return cdll


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_probe: no CUDA device", file=sys.stderr)
        return 1
    lib = build()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    iters = 4096
    rates = {}
    for per_sm in (1, 2, 4):
        for acc in (4, 8, 16):
            ctas = per_sm * sms

            def run():
                rc = lib.mma_probe(acc, ctas, iters, out.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"mma_probe: CUDA error {rc}")

            run()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(5):
                run()
            end.record()
            torch.cuda.synchronize()
            s = start.elapsed_time(end) / 5 / 1e3
            # per warp per round: acc products of 16 x 8 x 8 multiply-adds
            flops = 2.0 * 16 * 8 * 8 * acc * iters * ctas * 8
            rates[f"{per_sm}x{acc}"] = flops / s / 1e12
    best = max(rates.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"phase": "mma_probe", "card": smi,
                      "tf32_mma_sync_tflops": rates, "best_tflops": best,
                      "share_of_tf32_peak": best / (PEAK_TF32_FLOPS / 1e12),
                      "split_tf32_ceiling_tflops": best / 3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
