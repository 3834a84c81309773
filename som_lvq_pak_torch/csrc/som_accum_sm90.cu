// K11 on Hopper: the SOM neighbourhood accumulators of a codebook shard,
// without the codebook: acc = W^T X (n_local, D) and wsum = W^T 1 (n_local,
// 1), W's rows those of the GLOBAL units unit_offset + row.
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_accum_kernel (:301,
// wrapper som_neighborhood_accumulate :370) -> som_accum_sm90_kernel (K11),
// with K3's prologue split_sm90_kernel: pass A of the mixed data x model
// fused SOM step, in which each data shard accumulates its batch rows, the
// accumulators are summed over the data axis, and K12 blends the sums into
// the codebook.
//
// What bounds it on H100: the W.X contraction, 2 n_local B D FLOPs, as split
// TF32: 6 n_local B D TF32 FLOPs at 495 TFLOP/s (0.0521 ms at 32768 rows, B
// 2048, D 64); beside them one W value per (row, sample) and feature slab (a
// grid distance, an expf for the gaussian, a split, a wsum add) and the L2
// reads of the split batch by every CTA.  Device memory moves the batch and
// the prologue's planes once and writes the accumulators once.
//
// The design is K5's (som_update_sm90.cu) without the blend: K3's prologue
// splits the batch once, transposed, beside K3's per-sample table; a CTA
// takes 128 rows and one feature slab (update_slab: 32, 64 or 128 features)
// on gridDim.y and runs K3's update walk on it (fused_step_sm90.cuh:
// slab_walk: a producer warpgroup's TMA ring, three TF32 wgmma a k step with
// W built in registers as their A fragments by ClosedFormW90 at the global
// unit, the chunk sums added into float32 registers), then writes its slab
// of acc from its registers; the blockIdx.y == 0 CTAs write wsum, the same
// float in every slab.  The sums are those of the mma.sync K11 this kernel
// replaced (fused_step_tc.cuh:fused_update_tc) and the floats K3 blends into
// the same rows, bit for bit: K11 then K12's guarded blend gives K3's rows.
// A row's sums depend only on its unit and the batch, so reruns are
// bit-equal and a shard accumulated in row segments (the mesh step's
// overlap_segments, 8-row-aligned) gives the bits of accumulating it whole.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_step_sm90.cuh"
#include "fused_step_tc.cuh"  // wsum_lanes

namespace {

using namespace fs90;

// CTA (blockIdx.x, blockIdx.y): rows blockIdx.x * TN.., features
// blockIdx.y * F.. of the shard's accumulators
template <int F>
__global__ void __launch_bounds__(THREADS, 1)
som_accum_sm90_kernel(const __grid_constant__ CUtensorMap xt_map,
                      const __grid_constant__ CUtensorMap smp_map, int n_local, int D, int Dp,
                      int B, int xdim, int hexa, int gaussian, float radius, int unit_offset,
                      float* __restrict__ acc_out, float* __restrict__ wsum_out) {
  constexpr int NT = F / 8;
  const int r0 = blockIdx.x * TN;
  float acc[NT][4];
  ClosedFormW90<SlabLayout<F, 2>::TABLE> wb;
  if (!slab_walk<F>(acc, wb, &xt_map, &smp_map, B, Dp, unit_offset + r0, xdim, hexa, gaussian,
                    radius))
    return;
  wsum_lanes(wb.wsum);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int f0 = blockIdx.y * F;
  // c0 (row g, component 2t), c1 (g, 2t + 1), c2, c3: row g + 8
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int u = r0 + 16 * warp + g + 8 * (q >> 1);
      const int k = f0 + 8 * j + 2 * t + (q & 1);
      if (u < n_local && k < D) acc_out[(size_t)u * D + k] = acc[j][q];
    }
  if (blockIdx.y == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = r0 + 16 * warp + g + 8 * h;
      if (u < n_local) wsum_out[u] = wb.wsum[h];
    }
  }
}

template <int F>
int launch_walk(int n_local, int D, int B, int xdim, int hexa, int gaussian, float radius,
                int unit_offset, const float* xs, float* acc, float* wsum,
                cudaStream_t stream) {
  using L = SlabLayout<F, 2>;
  const int Dp = update_dp(D);
  CUtensorMap xt, smp;
  const int rc = encode_slab_maps<F, 2>(&xt, &smp, xs, Dp, round_up(B, 64));
  if (rc) return rc;
  const auto kernel = som_accum_sm90_kernel<F>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((n_local + TN - 1) / TN, Dp / F);
  kernel<<<grid, THREADS, L::BYTES, stream>>>(xt, smp, n_local, D, Dp, B, xdim, hexa, gaussian,
                                               radius, unit_offset, acc, wsum);
  return (int)cudaGetLastError();
}

}  // namespace

// K11: acc (n_local, D), wsum (n_local,) float32 outputs; xs scratch for the
// prologue, 16-byte aligned: 2 Dp Bp + 4 Bp floats, K5's (Dp = update_dp(D);
// Bp = B rounded up to 64)
extern "C" int somvq_som_accum(int n_local, int D, const float* xb, const int* bmu,
                               const float* alpha, int B, int xdim, int hexa, int gaussian,
                               float radius, int unit_offset, float* xs, float* acc,
                               float* wsum, cudaStream_t stream) {
  if (n_local <= 0 || D <= 0 || B <= 0 || xdim <= 0 || unit_offset < 0 || !xs ||
      (reinterpret_cast<uintptr_t>(xs) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int rc = split_sm90<float, 2, false>(xb, B, nullptr, 0, D, update_dp(D), xs, bmu,
                                             alpha, xdim, hexa, stream);
  if (rc) return rc;
  switch (update_slab(D)) {
    case 32:
      return launch_walk<32>(n_local, D, B, xdim, hexa, gaussian, radius, unit_offset, xs,
                             acc, wsum, stream);
    case 64:
      return launch_walk<64>(n_local, D, B, xdim, hexa, gaussian, radius, unit_offset, xs,
                             acc, wsum, stream);
    default:
      return launch_walk<128>(n_local, D, B, xdim, hexa, gaussian, radius, unit_offset, xs,
                              acc, wsum, stream);
  }
}
