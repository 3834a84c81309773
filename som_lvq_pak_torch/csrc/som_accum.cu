// The SOM neighbourhood accumulators of a codebook shard, without the
// codebook: acc = W^T X (n_local, D) and wsum = W^T 1 (n_local, 1).
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_accum_kernel (wrapper
// som_neighborhood_accumulate), pass A of the mixed data x model fused SOM
// step: each data shard accumulates its batch rows, the accumulators are
// summed over the data axis, and K12 blends the sums into the codebook.
//
// W[row, sample] is evaluated at the GLOBAL unit unit_offset + row with the
// exact-f32 grid algebra of _neighborhood_w (som_grid.cuh), never stored.
// One CTA owns TN rows and walks the whole batch in BC-sample chunks in a
// fixed order (som_grid.cuh's accumulate_update, the code K5 and K7 run), so
// the sums are deterministic with no atomics, and a row's sums do not depend
// on which rows share its CTA: accumulating a shard in row segments gives the
// same bits as accumulating it whole.
//
// What bounds it on H100: FP32 FMA issue and shared-memory loads, plus one
// expf per (row, sample) for the gaussian.  Device memory traffic is the
// batch once per CTA (from L2) and the accumulators written once.

#include <cuda_runtime.h>

#include "som_grid.cuh"

namespace {

// Shared memory: xs[BC][DS] | ws[TN][BC]
size_t smem_bytes(int D) {
  const int DS = D | 1;
  return sizeof(float) * ((size_t)BC * DS + TN * BC);
}

template <int NJ>
__global__ void __launch_bounds__(THREADS)
som_accum_kernel(int n_local, int D, const float* __restrict__ xb,
                 const int* __restrict__ bmu, const float* __restrict__ alpha,
                 int B, int xdim, int hexa, int gaussian, float radius,
                 int unit_offset, float* __restrict__ acc_out,
                 float* __restrict__ wsum_out) {
  extern __shared__ float smem[];
  const int DS = D | 1;
  float* xs = smem;
  float* ws = xs + BC * DS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * TN;

  float acc[4][NJ];
  float wsum[4];
  accumulate_update<NJ>(acc, wsum, xs, ws, r0, n_local, D, xb, bmu, alpha, B,
                        xdim, hexa != 0, gaussian != 0, radius, unit_offset);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int u = r0 + warp * 4 + i;
    if (u >= n_local) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = lane + 32 * j;
      if (k < D) acc_out[(size_t)u * D + k] = acc[i][j];
    }
    if (lane == 0) wsum_out[u] = wsum[i];
  }
}

template <int NJ>
int launch_accum(int n_local, int D, const float* xb, const int* bmu,
                 const float* alpha, int B, int xdim, int hexa, int gaussian,
                 float radius, int unit_offset, float* acc, float* wsum,
                 cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      som_accum_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  som_accum_kernel<NJ><<<(n_local + TN - 1) / TN, THREADS, smem, stream>>>(
      n_local, D, xb, bmu, alpha, B, xdim, hexa, gaussian, radius, unit_offset,
      acc, wsum);
  return (int)cudaGetLastError();
}

}  // namespace

// acc: (n_local, D), wsum: (n_local,) float32 outputs
extern "C" int somvq_som_accum(int n_local, int D, const float* xb,
                               const int* bmu, const float* alpha, int B,
                               int xdim, int hexa, int gaussian, float radius,
                               int unit_offset, float* acc, float* wsum,
                               cudaStream_t stream) {
  if (n_local <= 0 || D <= 0 || D > MAX_D || B <= 0 || xdim <= 0 ||
      unit_offset < 0)
    return (int)cudaErrorInvalidValue;
  const int nj = (D + 31) / 32;
  if (nj <= 1)
    return launch_accum<1>(n_local, D, xb, bmu, alpha, B, xdim, hexa, gaussian,
                           radius, unit_offset, acc, wsum, stream);
  if (nj <= 2)
    return launch_accum<2>(n_local, D, xb, bmu, alpha, B, xdim, hexa, gaussian,
                           radius, unit_offset, acc, wsum, stream);
  if (nj <= 4)
    return launch_accum<4>(n_local, D, xb, bmu, alpha, B, xdim, hexa, gaussian,
                           radius, unit_offset, acc, wsum, stream);
  return launch_accum<8>(n_local, D, xb, bmu, alpha, B, xdim, hexa, gaussian,
                         radius, unit_offset, acc, wsum, stream);
}
