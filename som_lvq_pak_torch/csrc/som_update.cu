// The SOM neighbourhood update of the two-kernel step: winners come from a
// separate dist_argmin launch, this kernel applies
//
//   codes <- guarded_blend(codes, W.X, W.1)        (K5, unmasked)
//   codes <- guarded_blend(codes, W.(X o K), W.K)  (K6, masked: per-(unit,
//                                                   component) weight mass)
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_update_kernel (K5) and
// _som_update_masked_kernel (K6), wrapper som_neighborhood_update_idx.  A
// sample's masked components leave every unit's matching component untouched
// (adapt_vector skips masked components, lvq_pak.c:349-356), which is why K6
// carries the weight mass per component.
//
// Design.  The TPU grid walks batch tiles in order and carries acc/wsum in
// scratch across them.  Here one CTA owns TN codebook rows and loops over the
// whole batch in BC-sample chunks in a fixed order (som_grid.cuh), so the sums
// stay in registers and the result is deterministic, with no atomics and no
// cross-CTA step.  W is rebuilt per chunk from the BMU indices with the
// exact-f32 grid algebra and expf.  The guarded blend is the epilogue and is
// written IN PLACE: each CTA reads and writes only its own rows.  This is K3's
// update phase without its winner phase; the device code is shared.
//
// What bounds it on H100: FP32 FMA issue (2 FMAs per (row, sample, column) in
// K6, 1 in K5; no tensor cores) and one expf per (row, sample) for the
// gaussian.  Device memory traffic is one codebook read and write; the batch
// is re-read from L2 by every CTA.

#include <cuda_runtime.h>

#include "som_grid.cuh"

namespace {

// Shared memory: xs[BC][DS] | ks[BC][DS] (K6 only) | ws[TN][BC]
size_t smem_bytes(int D, bool masked) {
  const int DS = D | 1;
  return sizeof(float) * ((size_t)(masked ? 2 : 1) * BC * DS + TN * BC);
}

template <int NJ, bool kMasked>
__global__ void __launch_bounds__(THREADS)
som_update_kernel(float* __restrict__ codes, int noc, int D,
                  const float* __restrict__ xb,
                  const unsigned char* __restrict__ mask,
                  const int* __restrict__ bmu, const float* __restrict__ alpha,
                  int B, int xdim, int hexa, int gaussian, float radius) {
  extern __shared__ float smem[];
  const int DS = D | 1;
  float* xs = smem;
  float* ks = xs + BC * DS;
  float* ws = ks + (kMasked ? BC * DS : 0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * TN;

  float acc[4][NJ];
  float wsum[4][kMasked ? NJ : 1];
  accumulate_update<NJ, kMasked>(acc, wsum, xs, ks, ws, r0, noc, D, xb, mask,
                                 bmu, alpha, B, xdim, hexa != 0, gaussian != 0,
                                 radius);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = r0 + warp * 4 + i;
    if (u >= noc) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = lane + 32 * j;
      if (k < D) {
        const size_t g = (size_t)u * D + k;
        codes[g] = guarded_blend(codes[g], acc[i][j], wsum[i][kMasked ? j : 0]);
      }
    }
  }
}

template <int NJ, bool kMasked>
int launch_update(float* codes, int noc, int D, const float* xb,
                  const unsigned char* mask, const int* bmu, const float* alpha,
                  int B, int xdim, int hexa, int gaussian, float radius,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes(D, kMasked);
  cudaError_t err = cudaFuncSetAttribute(
      som_update_kernel<NJ, kMasked>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  som_update_kernel<NJ, kMasked><<<(noc + TN - 1) / TN, THREADS, smem, stream>>>(
      codes, noc, D, xb, mask, bmu, alpha, B, xdim, hexa, gaussian, radius);
  return (int)cudaGetLastError();
}

template <bool kMasked>
int dispatch(float* codes, int noc, int D, const float* xb,
             const unsigned char* mask, const int* bmu, const float* alpha,
             int B, int xdim, int hexa, int gaussian, float radius,
             cudaStream_t stream) {
  if (noc <= 0 || D <= 0 || D > MAX_D || B <= 0 || xdim <= 0)
    return (int)cudaErrorInvalidValue;
  const int nj = (D + 31) / 32;
  if (nj <= 1)
    return launch_update<1, kMasked>(codes, noc, D, xb, mask, bmu, alpha, B,
                                     xdim, hexa, gaussian, radius, stream);
  if (nj <= 2)
    return launch_update<2, kMasked>(codes, noc, D, xb, mask, bmu, alpha, B,
                                     xdim, hexa, gaussian, radius, stream);
  if (nj <= 4)
    return launch_update<4, kMasked>(codes, noc, D, xb, mask, bmu, alpha, B,
                                     xdim, hexa, gaussian, radius, stream);
  return launch_update<8, kMasked>(codes, noc, D, xb, mask, bmu, alpha, B,
                                   xdim, hexa, gaussian, radius, stream);
}

}  // namespace

// K5
extern "C" int somvq_som_update(float* codes, int noc, int D, const float* xb,
                                const int* bmu, const float* alpha, int B,
                                int xdim, int hexa, int gaussian, float radius,
                                cudaStream_t stream) {
  return dispatch<false>(codes, noc, D, xb, nullptr, bmu, alpha, B, xdim, hexa,
                         gaussian, radius, stream);
}

// K6; mask is (B, D) uint8, nonzero = masked
extern "C" int somvq_som_update_masked(float* codes, int noc, int D,
                                       const float* xb,
                                       const unsigned char* mask,
                                       const int* bmu, const float* alpha,
                                       int B, int xdim, int hexa, int gaussian,
                                       float radius, cudaStream_t stream) {
  return dispatch<true>(codes, noc, D, xb, mask, bmu, alpha, B, xdim, hexa,
                        gaussian, radius, stream);
}
