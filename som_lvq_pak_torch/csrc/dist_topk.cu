// Fused k-NN winner search, k <= 16: for each sample x_b, the k codebook rows
// with the smallest ||x_b - m_n||^2, ascending, without materialising the
// (B, N) distance matrix.
//
// Replaces som_lvq_pak_tpu/ops/pallas_distance.py:_dist_topk_kernel (wrapper
// dist_topk): a running top-k merged tile by tile -> dist_topk_kernel<KT, KM>
// (K10).  It scores the partial distance ||m||^2 - 2 x.m, ties to the lowest
// index.  The result is the k smallest (value, index) pairs in lexicographic
// order, which is what the TPU kernel's re-selection (first minimum of the
// running entries before the tile's) computes; at k = 2 that is also what
// _dist_top2_kernel's running merge (_top2_epilogue, strict <, earlier tile
// kept) computes, so K10 at k 2 gives K8's pairs (argmin_sm90.cu's
// top2_sm90_kernel, on K1's Hopper walk) bit for bit.
//
// The walk is the mma.sync winner search (argmin_tc.cuh, as K16's in
// dist_argmin_t.cu) with a top-k fold: one CTA owns kTB = 128 samples, 16
// per warp, their A fragments split into TF32 hi and lo in registers for the
// whole walk (load_x; D > 64 in 64-feature slabs, reloaded per slab); the
// codebook streams through shared memory in 64-row tiles by a cp.async
// double buffer, split once at staging, ||m||^2 summed per row there in the
// order of K1's prologue (argmin_sm90.cu: lane f fma's features f and f + 32
// of a slab, an xor tree, the slabs in turn); S = x.m^T by split-TF32
// mma.sync.  Each lane keeps, for each of its two samples, a sorted list of
// KM in {2, 4, 8, 16} (score, code) pairs, score = x.m - ||m||^2 / 2, k <= KM
// chosen at run time: it visits its codes in ascending order, so a strict >
// keeps the lower code of equal scores everywhere in the list.  The four
// lanes of a sample merge their lists lexicographically by shuffles
// (topk_fold.cuh's merge_lists: the better of each pair of one list and the
// other reversed, then a bitonic merge; K9 folds K4's masked walk with the
// same lists at KM 2).  Values are -2 * the score, exact, -0 folded to +0:
// the partial distance, bit for bit the value K1 returns for the same code.
// The codebook is split across gridDim.y by ops.dist_argmin.k2_splits
// (whole waves of two CTAs per SM); each split writes its k pairs to a
// (splits, B, k) scratch the wrapper allocates, and a second small launch
// merges the splits.  A code's score depends only on its own data and every
// sum runs in a fixed order, so two runs are bit-equal and column 0 is K1's
// (value, index), bit for bit.
//
// What bounds it on H100: the contraction x.m^T (B x N x D), as split-TF32
// mma.sync (tf32x3.cuh): three TF32 products per float32 product, 6 B N D
// TF32 FLOPs against the 495 TFLOP/s peak; beside it each candidate's
// insertion (one compare when it does not enter the list, KM when it does).
// Registers: the split A fragments (64 at D 64) and S (32) beside the lists
// (4 KM); KM <= 4 keeps the walk's two CTAs per SM, KM 8 and 16 take one CTA per
// SM and the registers it leaves (the build's ptxas report gives the
// spills).

#include <cuda_runtime.h>

#include "argmin_tc.cuh"
#include "topk_fold.cuh"

namespace {

// the k (<= KM) best pairs of codebook rows [n_lo, n_lo + n_span) of split
// blockIdx.y into pv/pi[(split * B + b) * k + t], as partial distances; the
// walk is K16's (dist_argmin_t.cu) with the norm, x stored (B, D)
template <int KT, int KM>
__global__ void __launch_bounds__(kThreads, KM <= 4 ? 2 : 1)
dist_topk_kernel(const float* __restrict__ x, const float* __restrict__ codes, int B,
                 int N, int D, int n_span, int k, float* __restrict__ pv,
                 int* __restrict__ pi) {
  using L = K2Smem<KT>;
  constexpr int SW = L::SW, DC = L::DC;
  extern __shared__ __align__(16) float smem[];
  float* raw0 = smem;
  float* raw1 = raw0 + kTNC * SW;
  float* chi = raw1 + kTNC * SW;
  float* clo = chi + kTNC * DC;
  float* m2s = clo + kTNC * DC;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int b0 = blockIdx.x * kTB + 16 * warp;  // this warp's 16 samples
  const int n_lo = blockIdx.y * n_span;
  const int n_hi = min(N, n_lo + n_span);
  const int nslab = (D + SW - 1) / SW;
  const int ntiles = (n_hi - n_lo + kTNC - 1) / kTNC;
  const int nitems = ntiles * nslab;  // item = (tile, slab), slab fastest

  float ahi[KT][4], alo[KT][4];
  if (nslab == 1) load_x<KT, false>(ahi, alo, x, B, D, b0, 0, lane);
  ListFold<KM> fold;  // per sample: the KM best (score, code), sorted
  float S[kTNC / 8][4];

  if (nitems > 0) prefetch<KT>(raw0, codes, D, n_lo, n_hi, nslab, 0, tid);
  for (int i = 0; i < nitems; ++i) {
    const int n0 = n_lo + (i / nslab) * kTNC, sl = i % nslab;
    const int rows = min(kTNC, n_hi - n0), width = min(SW, D - sl * SW);
    float* raw = (i & 1) ? raw1 : raw0;
    cp_async_wait_all();
    __syncthreads();  // item i landed; item i - 1's fragments and m2s read
    if (i + 1 < nitems)
      prefetch<KT>((i & 1) ? raw0 : raw1, codes, D, n_lo, n_hi, nslab, i + 1, tid);
    // split: warp w takes rows w, w + 8, ...; ||m||^2 per row over slabs
    for (int r = warp; r < kTNC; r += kWarps) {
      float sq = 0.f;
#pragma unroll
      for (int f = lane; f < SW; f += 32) {
        const float v = (r < rows && f < width) ? raw[r * SW + f] : 0.f;
        float hi, lo;
        split_tf32(v, hi, lo);
        chi[r * DC + f] = hi;
        clo[r * DC + f] = lo;
        sq = __fmaf_rn(v, v, sq);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
      if (lane == 0) m2s[r] = sl == 0 ? sq : m2s[r] + sq;
    }
    if (nslab > 1) load_x<KT, false>(ahi, alo, x, B, D, b0, sl, lane);
    if (sl == 0) {
#pragma unroll
      for (int n = 0; n < kTNC / 8; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) S[n][q] = 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KT; ++ks) {
#pragma unroll
      for (int n = 0; n < kTNC / 8; ++n) {
        float bhi[2], blo[2];
        load_b_nk(bhi, chi, DC, 8 * n, 8 * ks, lane);
        load_b_nk(blo, clo, DC, 8 * n, 8 * ks, lane);
        mma_tf32x3(S[n], ahi[ks], alo[ks], bhi, blo);
      }
    }
    if (sl == nslab - 1) {
      // c0 (sample g, code 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8,
      // 2t + 1): codes ascend with n and q
#pragma unroll
      for (int n = 0; n < kTNC / 8; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 8 * n + 2 * t + (q & 1), h = q >> 1;
          if (c < rows) fold.visit(h, S[n][q] - 0.5f * m2s[c], n0 + c);
        }
    }
  }
  cp_async_wait_all();

  // merge the four lanes t of each sample, then write this split's pairs
  fold.write(b0, B, lane, blockIdx.y, k, pv, pi);
}

template <int KT, int KM>
int launch(const float* x, const float* codes, int B, int N, int D, int k,
           int splits, float* pv, int* pi, float* vo, int* io,
           cudaStream_t stream) {
  const size_t smem = K2Smem<KT>::bytes();
  cudaError_t err = cudaFuncSetAttribute(dist_topk_kernel<KT, KM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int n_span, used;
  tile_spans(N, splits, n_span, used);
  const dim3 grid((B + kTB - 1) / kTB, used);
  dist_topk_kernel<KT, KM><<<grid, kThreads, smem, stream>>>(x, codes, B, N, D, n_span,
                                                             k, pv, pi);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  topk_merge_splits<KM><<<(B + 255) / 256, 256, 0, stream>>>(pv, pi, B, k, used,
                                                             RowsOut{vo, io, k});
  return (int)cudaGetLastError();
}

template <int KM>
int launch_km(const float* x, const float* codes, int B, int N, int D, int k,
              int splits, float* pv, int* pi, float* vo, int* io,
              cudaStream_t stream) {
  const int k8 = (D + 7) / 8;
  if (k8 <= 1) return launch<1, KM>(x, codes, B, N, D, k, splits, pv, pi, vo, io, stream);
  if (k8 <= 2) return launch<2, KM>(x, codes, B, N, D, k, splits, pv, pi, vo, io, stream);
  if (k8 <= 4) return launch<4, KM>(x, codes, B, N, D, k, splits, pv, pi, vo, io, stream);
  return launch<8, KM>(x, codes, B, N, D, k, splits, pv, pi, vo, io, stream);
}

}  // namespace

// K10; pv/pi: (splits, B, k) scratch; vo/io: (B, k)
// outputs, vo the partial distances ||m||^2 - 2 x.m, ascending
extern "C" int somvq_dist_topk(const float* x, const float* codes, int B, int N,
                               int D, int k, int splits, float* pv, int* pi,
                               float* vo, int* io, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || D <= 0 || k < 1 || k > 16 || k > N || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (k <= 2) return launch_km<2>(x, codes, B, N, D, k, splits, pv, pi, vo, io, stream);
  if (k <= 4) return launch_km<4>(x, codes, B, N, D, k, splits, pv, pi, vo, io, stream);
  if (k <= 8) return launch_km<8>(x, codes, B, N, D, k, splits, pv, pi, vo, io, stream);
  return launch_km<16>(x, codes, B, N, D, k, splits, pv, pi, vo, io, stream);
}
