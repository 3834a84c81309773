// Fused masked 2-NN winner search: for each sample x_b, the two codebook rows
// with the smallest ||x_b - m_n||^2 over its unmasked components, without
// materialising the (B, N) distance matrix.
//
// Replaces som_lvq_pak_tpu/ops/pallas_distance.py:_dist_top2_masked_kernel
// (dist_top2 with a mask): partial distance keep.(m o m) - 2 (x keep).m,
// running (best, second) pair                        -> dist_top2_masked_kernel (K9)
// The unmasked _dist_top2_kernel (K8) is K1's Hopper walk with a top-2
// fold: argmin_sm90.cu's top2_sm90_kernel.
//
// K9 returns the two smallest (value, index) pairs in lexicographic order,
// the function the TPU kernel's running merge (_top2_epilogue, strict <,
// earlier tile kept) computes: the lower index wins every exact tie, on the
// best pair and on the second.  The mask enters as (B, D) uint8, nonzero =
// masked.  A sample with every component masked scores 0 against every code
// and gets (0, 0), (0, 1), as in the JAX package.
//
// Design.  The masked mma.sync walk (masked_walk.cuh) with K10's fold at KM 2
// (topk_fold.cuh), as K10 is the mma.sync walk with that fold: one CTA of
// kTB = 128 samples, 16 per warp, their A fragments of x keep split into
// TF32 hi and lo in registers and their keep flags as bits; the codebook by a cp.async
// double buffer, split once at staging into m's and (m o m)'s hi and lo;
// (x keep).m by three TF32 products and keep.(m o m) by two; the score
// (x keep).m - keep.(m o m) / 2; D > 64 through the walk's 64-feature slab
// instantiation.  Each lane keeps a sorted (best, second) (score, code) list
// per sample, strict > over ascending codes; the four lanes of a sample
// merge lexicographically; each split of the codebook (ops.dist_argmin.
// k4_splits, K4's whole waves) writes its pairs as partial distances (-2 *
// the score, exact, -0 folded to +0) to a (splits, B, 2) scratch the wrapper
// allocates, and one small launch merges the splits in split order.  The
// walk hands the fold the floats of K4 (argmin_masked_sm90.cu, the same two
// sums on wgmma), so the best pair is K4's (value, index) bit for bit, and
// two runs are bit-equal.
//
// What bounds it on H100: the two contractions, 4 B N D FLOPs, issued as 10
// B N D TF32 FLOPs (three products for (x keep).m, two for keep.(m o m))
// against the 495 TFLOP/s peak; beside them each candidate's insertion into
// the pair (one compare when it does not enter).  The codebook is read from
// L2 once per CTA.

#include <cuda_runtime.h>

#include "masked_walk.cuh"
#include "topk_fold.cuh"

namespace {

// the (best, second) pairs of codebook rows [n_lo, n_lo + n_span) of split
// blockIdx.y into pv/pi[(split * B + b) * 2 + {0, 1}]; kMulti: D > 64
template <int KT, bool kMulti>
__global__ void __launch_bounds__(kThreads, kMulti ? 1 : 2)
dist_top2_masked_kernel(const float* __restrict__ x,
                        const unsigned char* __restrict__ mask,
                        const float* __restrict__ codes, int B, int N, int D,
                        int n_span, float* __restrict__ pv, int* __restrict__ pi) {
  ListFold<2> fold;
  masked_walk<KT, kMulti>(x, mask, codes, B, N, D, n_span, fold);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  fold.write(blockIdx.x * kTB + 16 * warp, B, lane, blockIdx.y, 2, pv, pi);
}

// the walk over the non-empty spans, then the split merge
template <int KT, bool kMulti>
int launch_masked(const float* x, const unsigned char* mask, const float* codes, int B,
                  int N, int D, int splits, float* pv, int* pi, PairOut out,
                  cudaStream_t stream) {
  const size_t smem = K4Smem<KT>::bytes();
  const auto kernel = dist_top2_masked_kernel<KT, kMulti>;
  cudaError_t err = cudaFuncSetAttribute(kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int n_span, used;
  tile_spans(N, splits, n_span, used);
  const dim3 grid((B + kTB - 1) / kTB, used);
  kernel<<<grid, kThreads, smem, stream>>>(x, mask, codes, B, N, D, n_span, pv, pi);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  topk_merge_splits<2><<<(B + 255) / 256, 256, 0, stream>>>(pv, pi, B, 2, used, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K9; pv/pi: (splits, B, 2) scratch; v1/v2 get partial distances
extern "C" int somvq_dist_top2_masked(const float* x, const unsigned char* mask,
                                      const float* codes, int B, int N, int D,
                                      int splits, float* pv, int* pi, float* v1,
                                      int* i1, float* v2, int* i2,
                                      cudaStream_t stream) {
  if (B <= 0 || N < 2 || D <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  const PairOut out{v1, v2, i1, i2};
  const int k8 = (D + 7) / 8;
  return k8 <= 1   ? launch_masked<1, false>(x, mask, codes, B, N, D, splits, pv, pi, out, stream)
         : k8 <= 2 ? launch_masked<2, false>(x, mask, codes, B, N, D, splits, pv, pi, out, stream)
         : k8 <= 4 ? launch_masked<4, false>(x, mask, codes, B, N, D, splits, pv, pi, out, stream)
         : k8 <= 8 ? launch_masked<8, false>(x, mask, codes, B, N, D, splits, pv, pi, out, stream)
                   : launch_masked<8, true>(x, mask, codes, B, N, D, splits, pv, pi, out, stream);
}
