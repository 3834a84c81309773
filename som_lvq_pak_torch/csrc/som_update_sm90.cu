// K5 on Hopper: the SOM neighbourhood update of the two-kernel step without
// a mask (winners from a separate dist_argmin launch),
//
//   codes <- guarded_blend(codes, W.X, W.1)
//
// in place, per (unit, component): W (noc, B) from the given winners (0
// where bmu < 0) with a scalar or per-sample alpha.  Each CTA reads and
// writes only its own rows and features.
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_update_kernel (:116,
// wrapper som_neighborhood_update_idx :267) -> som_update_sm90_kernel (K5),
// with K3's prologue split_sm90_kernel; the masked twin (K6) is
// som_update_masked_sm90.cu.
//
// What bounds it on H100: the contraction W.X, 2 noc B D FLOPs, as split TF32
// (tf32x3.cuh): 6 noc B D TF32 FLOPs at 495 TFLOP/s (0.2082 ms at 256x256, B
// 4096, D 64); beside them the W values, noc B of them per feature slab, each
// a grid distance, an expf (gaussian), a split and a wsum add on the FP32
// and MUFU pipes, and the L2 reads of the split batch by every CTA.  Device
// memory moves the codebook in and out, the batch and the prologue's planes
// once.
//
// The design is K3's update on its Hopper walk (fused_step_sm90.cuh:
// slab_walk), then K3's blend.  K3's prologue (split_sm90_kernel, no next
// batch) splits the batch once a call into TF32 hi and lo, transposed to
// (Dp, Bp) (samples contiguous: wgmma takes 32-bit B operands K-major only,
// and K is the sample index), zeros past D and past the batch (Dp =
// update_dp(D), whole slabs; Bp = B rounded up to 64), then K3's per-sample
// table (BMU grid x, BMU row, alpha; zeros where bmu < 0).  A CTA takes 128
// rows, two consumer warpgroups of 64 (K3's row layout: rows 16 warp + g and
// + 8), and ONE feature slab of F = 32 (D <= 32), 64 (D <= 64) or 128
// features on gridDim.y: a component's blend needs only its own sum and its
// row's wsum, so the slabs are exact and the walk takes any D.  A producer
// warpgroup's thread streams by TMA (SWIZZLE_128B) each 32-sample chunk of
// the slab's rows of both planes, with the chunk's table slice, into a ring
// of slots behind full and empty mbarriers.  Per k step of 8 samples a
// consumer issues three wgmma.m64nFk8 with W's fragments as A in registers
// (lo.hi, hi.lo, hi.hi: mma_tf32x3's order) into a chunk sum that starts
// from zero (wgmma's scale-d 0), added into float32 registers once the
// chunk's products are done; the next chunk's W fragments and wsum are built
// from the table with K3's float operations (ClosedFormW90) while this
// chunk's products run; the two warpgroups take turns to issue.  This is the
// order of the mma.sync K5 this kernel replaced (K3's update half,
// fused_step_tc.cuh:fused_update_tc; ops.tf32x3.som_update_tf32x3), and
// wgmma's TF32 sums are mma.sync's where each k index maps to the same
// sample, so the codebook is that kernel's, and K3's rows on the same
// winners, bit for bit.  After the walk (nothing
// a warp does while its products are in flight branches on a per-lane
// value: see fused_step_sm90.cuh) wsum is summed over a row's four lanes by
// a fixed xor tree and each thread blends its (row, component) values in
// place from its registers.  Every sum runs in a fixed order: two runs are
// bit-equal.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_step_sm90.cuh"
#include "fused_step_tc.cuh"  // wsum_lanes

namespace {

using namespace fs90;

// CTA (blockIdx.x, blockIdx.y): rows blockIdx.x * TN.., features
// blockIdx.y * F.. of the codebook
template <int F>
__global__ void __launch_bounds__(THREADS, 1)
som_update_sm90_kernel(const __grid_constant__ CUtensorMap xt_map,
                       const __grid_constant__ CUtensorMap smp_map, float* __restrict__ codes,
                       int noc, int D, int Dp, int B, int xdim, int hexa, int gaussian,
                       float radius) {
  constexpr int NT = F / 8;
  const int r0 = blockIdx.x * TN;
  float acc[NT][4];
  ClosedFormW90<SlabLayout<F, 2>::TABLE> wb;
  if (!slab_walk<F>(acc, wb, &xt_map, &smp_map, B, Dp, r0, xdim, hexa, gaussian, radius))
    return;
  wsum_lanes(wb.wsum);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int f0 = blockIdx.y * F;
  // the guarded blend, per (row, component), in place: c0 (row g, component
  // 2t), c1 (g, 2t + 1), c2, c3: row g + 8
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int u = r0 + 16 * warp + g + 8 * (q >> 1);
      const int k = f0 + 8 * j + 2 * t + (q & 1);
      if (u < noc && k < D) {
        float* p = codes + (size_t)u * D + k;
        *p = guarded_blend(*p, acc[j][q], wb.wsum[q >> 1]);
      }
    }
}

template <int F>
int launch_walk(float* codes, int noc, int D, int B, int xdim, int hexa, int gaussian,
                float radius, const float* xs, cudaStream_t stream) {
  using L = SlabLayout<F, 2>;
  const int Dp = update_dp(D);
  CUtensorMap xt, smp;
  const int rc = encode_slab_maps<F, 2>(&xt, &smp, xs, Dp, round_up(B, 64));
  if (rc) return rc;
  const auto kernel = som_update_sm90_kernel<F>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((noc + TN - 1) / TN, Dp / F);
  kernel<<<grid, THREADS, L::BYTES, stream>>>(xt, smp, codes, noc, D, Dp, B, xdim, hexa,
                                               gaussian, radius);
  return (int)cudaGetLastError();
}

}  // namespace

// K5: codes (noc, D) float32, updated in place; xs scratch for the prologue,
// 16-byte aligned: 2 Dp Bp + 4 Bp floats (Dp = update_dp(D), whole slabs of
// ops.som_update.update_slabs; Bp = B rounded up to 64)
extern "C" int somvq_som_update(float* codes, int noc, int D, const float* xb,
                                const int* bmu, const float* alpha, int B, int xdim, int hexa,
                                int gaussian, float radius, float* xs, cudaStream_t stream) {
  if (noc <= 0 || D <= 0 || B <= 0 || xdim <= 0 || !xs ||
      (reinterpret_cast<uintptr_t>(xs) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int rc = split_sm90<float, 2, false>(xb, B, nullptr, 0, D, update_dp(D), xs, bmu,
                                             alpha, xdim, hexa, stream);
  if (rc) return rc;
  switch (update_slab(D)) {
    case 32:
      return launch_walk<32>(codes, noc, D, B, xdim, hexa, gaussian, radius, xs, stream);
    case 64:
      return launch_walk<64>(codes, noc, D, B, xdim, hexa, gaussian, radius, xs, stream);
    default:
      return launch_walk<128>(codes, noc, D, B, xdim, hexa, gaussian, radius, xs, stream);
  }
}
