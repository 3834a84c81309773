// The SOM neighbourhood update of the two-kernel step without a mask:
// winners come from a separate dist_argmin launch, this kernel applies
//
//   codes <- guarded_blend(codes, W.X, W.1)        (K5)
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_update_kernel (K5),
// wrapper som_neighborhood_update_idx; the masked twin (K6) runs on K3's
// Hopper walk, som_update_masked_sm90.cu.  It writes the guarded blend IN
// PLACE: each CTA reads and writes only its own rows.  It takes any D, in
// passes of 256 features past 256 (fused_step_tc.cuh).
//
// The TPU grid walks batch tiles in order and carries acc/wsum in scratch
// across them.  Here one CTA owns a tile of codebook rows and loops over the
// whole batch in 32-sample chunks in a fixed order, so the sums stay in
// registers and the result is deterministic, with no atomics and no cross-CTA
// step.
//
// K5 (som_update_kernel) is the update half of K3 (fused_step_tc.cuh:
// fused_update_tc) with K3's closed-form W (ClosedFormW) at unit offset 0,
// exactly as K11 (som_accum.cu) runs it, then the guarded blend of each
// (row, component) from the mma's registers, in place, as K3 blends: the
// batch split into TF32 hi and lo once per call (split_batches_kernel, into
// the wrapper's scratch), walked in 32-sample chunks through a cp.async
// double buffer, W built in registers (bit-identical to neighborhood_w; 0
// where bmu < 0), W.X by split-TF32 mma.sync summed per chunk and added into
// float32 registers, wsum in a fixed order; K3's CTA height (128 rows, 64
// past D 128).  A row's arithmetic is K3's, so the codebook equals K3's rows
// for the same (codes, batch, winners, alpha, radius) bit for bit, and two
// runs are bit-equal.
//
// What bounds it on H100: the contraction W.X (2 noc B D FLOPs, issued as 6
// noc B D TF32 FLOPs) against the 495 TFLOP/s peak; W's expf and the chunk
// staging share the SM with the mma between barriers.  Device memory
// traffic is one codebook read and write; the batch is re-read from L2 by
// every CTA.

#include <cuda_runtime.h>

#include "fused_step_tc.cuh"

namespace {

template <int NT>
__global__ void __launch_bounds__(32 * k3_warps(NT), NT <= 8 ? 2 : 1)
som_update_kernel(float* __restrict__ codes, int noc, int D,
                  const float* __restrict__ xs, const int* __restrict__ bmu,
                  const float* __restrict__ alpha, int B, int xdim, int hexa,
                  int gaussian, float radius) {
  constexpr int WARPS = k3_warps(NT), DP = 8 * NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * 16 * WARPS;
  ClosedFormW wp = closed_form_w(bmu, alpha, B, xdim, hexa, gaussian, radius, 0);
  const size_t plane = (size_t)(B + 63) / 64 * 64 * DP;
  // feature passes past 8 NT (NT 32, D > 256): slab s's update, then its
  // columns' blend (fused_step_tc.cuh); one pass otherwise
  const int np = NT == 32 ? n_passes(D) : 1;
  for (int s = 0; s < np; ++s) {
    float acc[NT][4];
    float wsum[2];
    fused_update_tc<NT, WARPS, false>(acc, wsum, xs + 2 * s * plane, xs + (2 * s + 1) * plane,
                                      B, r0, wp);
    // guarded blend, per (row, component), in place: c0 (g, 2t), c1 (g,
    // 2t + 1), c2, c3: g + 8
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int u = r0 + 16 * warp + g + 8 * (q >> 1), k = s * DP + 8 * j + 2 * t + (q & 1);
        if (k < D && u < noc) {
          float* p = codes + (size_t)u * D + k;
          *p = guarded_blend(*p, acc[j][q], wsum[q >> 1]);
        }
      }
    }
    if (s + 1 < np) __syncthreads();  // the slab's fragments read: the buffers are free
  }
}

// the batch split once (into xs), then the update
template <int NT>
int launch_update(float* codes, int noc, int D, const float* xb, const int* bmu,
                  const float* alpha, int B, int xdim, int hexa, int gaussian,
                  float radius, float* xs, cudaStream_t stream) {
  using L = FusedSmem<NT, k3_warps(NT)>;
  const size_t smem = sizeof(float) * L::update_floats(ClosedFormW::floats());
  cudaError_t err = cudaFuncSetAttribute(
      som_update_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rc = split_batches(xb, B, nullptr, 0, D, L::DP, xs, stream);
  if (rc) return rc;
  som_update_kernel<NT><<<(noc + L::TN - 1) / L::TN, 32 * k3_warps(NT), smem, stream>>>(
      codes, noc, D, xs, bmu, alpha, B, xdim, hexa, gaussian, radius);
  return (int)cudaGetLastError();
}

}  // namespace

// K5; xs scratch for the split batch: 2 Bp W floats (B rounded up to a
// multiple of 64, W = ops.som_step.split_width(D): 8 times the power of two
// of 8-feature steps that covers D, 256 n_passes(D) past 256, the passes)
extern "C" int somvq_som_update(float* codes, int noc, int D, const float* xb,
                                const int* bmu, const float* alpha, int B,
                                int xdim, int hexa, int gaussian, float radius,
                                float* xs, cudaStream_t stream) {
  if (noc <= 0 || D <= 0 || B <= 0 || xdim <= 0 || !xs) return (int)cudaErrorInvalidValue;
  const int k8 = (D + 7) / 8;  // 8-feature steps, padded up to a power of two
#define K5_LAUNCH(NT)                                                          \
  if (k8 <= NT || NT == 32)                                                    \
    return launch_update<NT>(codes, noc, D, xb, bmu, alpha, B, xdim, hexa,     \
                             gaussian, radius, xs, stream);
  K5_LAUNCH(1)
  K5_LAUNCH(2)
  K5_LAUNCH(4)
  K5_LAUNCH(8)
  K5_LAUNCH(16)
  K5_LAUNCH(32)
#undef K5_LAUNCH
  return (int)cudaErrorInvalidValue;
}
