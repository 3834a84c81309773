// The SOM neighbourhood accumulators of a codebook shard, without the
// codebook: acc = W^T X (n_local, D) and wsum = W^T 1 (n_local, 1).
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_accum_kernel (wrapper
// som_neighborhood_accumulate), pass A of the mixed data x model fused SOM
// step: each data shard accumulates its batch rows, the accumulators are
// summed over the data axis, and K12 blends the sums into the codebook.
//
// K11 is the update half of K3 (fused_step_tc.cuh:fused_update_tc) with K3's
// closed-form W (ClosedFormW) at the GLOBAL unit unit_offset + row, and
// nothing after it: no codebook read, blend or winners; the accumulators are
// written out from the mma's registers.  The batch is split into TF32 hi and
// lo once (split_batches_kernel), walked in 32-sample chunks through a
// cp.async double buffer, W.X taken as split-TF32 mma.sync summed per chunk
// and added into float32 registers, wsum in a fixed order; K3's CTA height
// (128 rows, 64 past D 128).  A row's sums depend only on its unit and the
// batch (for a given CTA height, as K3's do), so they are the very floats K3
// blends into that row (K11 then K12's guarded_blend gives K3's rows bit for
// bit), reruns are bit-equal, and a shard accumulated in row segments that
// start on a CTA boundary gives the bits of accumulating it whole.
//
// What bounds it on H100: the W.X contraction, 2 n_local B D FLOPs, issued
// as three TF32 products each (6 n_local B D at 495 TFLOP/s), beside one expf
// per (row, sample) for the gaussian W.  Device memory traffic is the batch
// once per CTA (from L2) and the accumulators written once.

#include <cuda_runtime.h>

#include "fused_step_tc.cuh"

namespace {

template <int NT, bool kPasses>
__global__ void __launch_bounds__(32 * k3_warps(NT), NT <= 8 ? 2 : 1)
som_accum_kernel(int n_local, int D, const float* __restrict__ xs,
                 const int* __restrict__ bmu, const float* __restrict__ alpha, int B,
                 int xdim, int hexa, int gaussian, float radius, int unit_offset,
                 float* __restrict__ acc_out, float* __restrict__ wsum_out) {
  constexpr int WARPS = k3_warps(NT), DP = 8 * NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * 16 * WARPS;
  ClosedFormW wp = closed_form_w(bmu, alpha, B, xdim, hexa, gaussian, radius,
                                 unit_offset);
  float wsum[2];
  if constexpr (kPasses) {  // NT 32, D > 256, an instantiation of its own:
    // slab s's sums written to its columns (fused_step_tc.cuh); wsum the
    // same floats every pass
    const size_t plane = (size_t)(B + 63) / 64 * 64 * DP;
    const int np = n_passes(D);
    for (int s = 0; s < np; ++s) {
      float acc[NT][4];
      fused_update_tc<NT, WARPS, false>(acc, wsum, xs + 2 * s * plane,
                                        xs + (2 * s + 1) * plane, B, r0, wp);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // c0 (g, 2t), c1 (g, 2t + 1), c2, c3: g + 8
          const int u = r0 + 16 * warp + g + 8 * (q >> 1), k = s * DP + 8 * j + 2 * t + (q & 1);
          if (k < D && u < n_local) acc_out[(size_t)u * D + k] = acc[j][q];
        }
      }
      if (s + 1 < np) __syncthreads();  // the slab's fragments read: the buffers are free
    }
  } else {
    float acc[NT][4];
    fused_update_tc<NT, WARPS, false>(acc, wsum, xs, xs + (size_t)(B + 63) / 64 * 64 * DP,
                                      B, r0, wp);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // c0 (g, 2t), c1 (g, 2t + 1), c2, c3: g + 8
        const int u = r0 + 16 * warp + g + 8 * (q >> 1), k = 8 * j + 2 * t + (q & 1);
        if (k < D && u < n_local) acc_out[(size_t)u * D + k] = acc[j][q];
      }
    }
  }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = r0 + 16 * warp + g + 8 * h;
      if (u < n_local) wsum_out[u] = wsum[h];
    }
  }
}

// the batch split once (into xs), then the accumulation
template <int NT, bool kPasses = false>
int launch_accum(int n_local, int D, const float* xb, const int* bmu,
                 const float* alpha, int B, int xdim, int hexa, int gaussian,
                 float radius, int unit_offset, float* xs, float* acc, float* wsum,
                 cudaStream_t stream) {
  using L = FusedSmem<NT, k3_warps(NT)>;
  const size_t smem = sizeof(float) * L::update_floats(ClosedFormW::floats());
  cudaError_t err = cudaFuncSetAttribute(
      som_accum_kernel<NT, kPasses>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rc = split_batches(xb, B, nullptr, 0, D, L::DP, xs, stream);
  if (rc) return rc;
  som_accum_kernel<NT, kPasses>
      <<<(n_local + L::TN - 1) / L::TN, 32 * k3_warps(NT), smem, stream>>>(
      n_local, D, xs, bmu, alpha, B, xdim, hexa, gaussian, radius, unit_offset, acc, wsum);
  return (int)cudaGetLastError();
}

}  // namespace

// acc: (n_local, D), wsum: (n_local,) float32 outputs; xs scratch for the
// split batch: 2 Bp W floats (B rounded up to a multiple of 64, W =
// ops.som_step.split_width(D), the passes' slabs past 256)
extern "C" int somvq_som_accum(int n_local, int D, const float* xb,
                               const int* bmu, const float* alpha, int B,
                               int xdim, int hexa, int gaussian, float radius,
                               int unit_offset, float* xs, float* acc, float* wsum,
                               cudaStream_t stream) {
  if (n_local <= 0 || D <= 0 || B <= 0 || xdim <= 0 ||
      unit_offset < 0 || !xs)
    return (int)cudaErrorInvalidValue;
  const int k8 = (D + 7) / 8;  // 8-feature steps, padded up to a power of two
  if (D > kPassD)
    return launch_accum<32, true>(n_local, D, xb, bmu, alpha, B, xdim, hexa, gaussian,
                                  radius, unit_offset, xs, acc, wsum, stream);
#define K11_LAUNCH(NT)                                                          \
  if (k8 <= NT)                                                               \
    return launch_accum<NT>(n_local, D, xb, bmu, alpha, B, xdim, hexa, gaussian, \
                            radius, unit_offset, xs, acc, wsum, stream);
  K11_LAUNCH(1)
  K11_LAUNCH(2)
  K11_LAUNCH(4)
  K11_LAUNCH(8)
  K11_LAUNCH(16)
  K11_LAUNCH(32)
#undef K11_LAUNCH
  return (int)cudaErrorInvalidValue;
}
