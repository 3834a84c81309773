// K4: the masked 1-NN winner search on the tensor cores: for each sample
// x_b, the codebook row m_n that minimises the squared distance over x_b's
// unmasked components, without materialising the (B, N) distance matrix.
//
// Replaces som_lvq_pak_tpu/ops/pallas_distance.py:_dist_argmin_masked_kernel
// (wrapper dist_argmin with a mask): partial distance keep.(m o m) -
// 2 (x keep).m, masked components excluded, the lowest index on exact ties,
// -0 folded to +0; the wrapper adds ||x keep||^2.  The mask enters as (B, D)
// uint8, nonzero = masked.
//
// What bounds it on H100: the two contractions (x keep).m^T and keep.(m o
// m)^T, 4 B N D FLOPs, both on the tensor cores as split-TF32 mma.sync
// (tf32x3.cuh): (x keep).m by three TF32 products, float32 accuracy; keep is
// 0 or 1, exact in TF32, so keep.(m o m) needs two, keep.(m o m)_hi +
// keep.(m o m)_lo (the dropped remainder is below 2^-22 of each term, as for
// K6's weight mass): 10 B N D TF32 FLOPs against the 495 TFLOP/s peak.
//
// Design.  K4's masked walk (masked_walk.cuh: the mma.sync CTA shape from
// argmin_tc.cuh with the keep contraction beside it, split-TF32 mma.sync,
// D > 64 in 64-feature slabs in a one-CTA-per-SM instantiation) with an
// argmin fold: the score (x keep).m - keep.(m o m) / 2 kept with a strict >
// over ascending codes, then the four lanes of a sample merge (value, index)
// and the splits of the codebook (ops.dist_argmin.k4_splits, whole waves)
// fold -2 * the score with the packed-u64 atomicMin of argmin_keys.cuh: the
// same floats as the distance form, the lowest index among equal values, in
// any CTA order.  Every sum runs in a fixed order and a row's value depends
// only on its own data: two runs are bit-equal.  A fully masked sample
// scores 0 against every code and gets index 0.  K9 (dist_top2.cu) runs the
// same walk with a top-2 fold, so its best pair is this kernel's (value,
// index) bit for bit.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "masked_walk.cuh"

namespace {

// the walk's argmin fold: lane (g, t) keeps the best (score, code) of
// samples g (h 0) and g + 8 (h 1)
struct ArgminFold {
  float best[2] = {-INFINITY, -INFINITY};
  int bidx[2] = {INT_MAX, INT_MAX};
  __device__ __forceinline__ void visit(int h, float score, int code) {
    if (score > best[h]) {
      best[h] = score;
      bidx[h] = code;
    }
  }
};

// The masked winner search over codebook rows [n_lo, n_lo + n_span) of split
// blockIdx.y; kMulti: D > 64, walked in 64-feature slabs
template <int KT, bool kMulti>
__global__ void __launch_bounds__(kThreads, kMulti ? 1 : 2)
dist_argmin_masked_kernel(const float* __restrict__ x,
                          const unsigned char* __restrict__ mask,
                          const float* __restrict__ codes, int B, int N, int D,
                          int n_span, unsigned long long* __restrict__ keys) {
  ArgminFold fold;
  masked_walk<KT, kMulti>(x, mask, codes, B, N, D, n_span, fold);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  merge_fold(fold.best, fold.bidx, blockIdx.x * kTB + 16 * warp, B, lane, keys);
}

template <int KT, bool kMulti>
int launch_masked(const float* x, const unsigned char* mask, const float* codes, int B,
                  int N, int D, int splits, unsigned long long* keys,
                  cudaStream_t stream) {
  const size_t smem = K4Smem<KT>::bytes();
  const auto kernel = dist_argmin_masked_kernel<KT, kMulti>;
  cudaError_t err = cudaFuncSetAttribute(kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int n_span, used;
  tile_spans(N, splits, n_span, used);
  const dim3 grid((B + kTB - 1) / kTB, used);
  kernel<<<grid, kThreads, smem, stream>>>(x, mask, codes, B, N, D, n_span, keys);
  return (int)cudaGetLastError();
}

}  // namespace

// K4; keys: (B,) u64 scratch; val gets the partial distance
// keep.(m o m) - 2 (x keep).m of the winner
extern "C" int somvq_dist_argmin_masked(const float* x, const unsigned char* mask,
                                        const float* codes, int B, int N, int D,
                                        int splits, unsigned long long* keys,
                                        float* val, int* idx, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || D <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  init_keys<<<(B + 255) / 256, 256, 0, stream>>>(keys, B);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int k8 = (D + 7) / 8;
  rc = k8 <= 1   ? launch_masked<1, false>(x, mask, codes, B, N, D, splits, keys, stream)
       : k8 <= 2 ? launch_masked<2, false>(x, mask, codes, B, N, D, splits, keys, stream)
       : k8 <= 4 ? launch_masked<4, false>(x, mask, codes, B, N, D, splits, keys, stream)
       : k8 <= 8 ? launch_masked<8, false>(x, mask, codes, B, N, D, splits, keys, stream)
                 : launch_masked<8, true>(x, mask, codes, B, N, D, splits, keys, stream);
  if (rc) return rc;
  unpack_keys<<<(B + 255) / 256, 256, 0, stream>>>(keys, B, val, idx);
  return (int)cudaGetLastError();
}

extern "C" const char* somvq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
