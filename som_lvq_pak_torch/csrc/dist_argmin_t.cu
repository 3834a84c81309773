// K1 and K2: the 1-NN winner search on the tensor cores.  For each sample
// x_b, the codebook row m_n that minimises ||x_b - m_n||^2 (the lowest n on
// exact ties), reported as the partial distance ||m_n||^2 - 2 x_b.m_n.
// K16: the same body's maximum of x_b.m_n alone.
//
// Replaces two TPU kernels of som_lvq_pak_tpu/ops/pallas_distance.py:
//   * _dist_argmin_kernel (wrapper dist_argmin, the distance form
//     ||m||^2 - 2 x.m with a strict-< running min)     -> dist_argmin_kernel (K1)
//   * _dist_argmin_t_kernel (wrapper dist_argmin_t, the max-score form
//     x.m - ||m||^2 / 2, reported as -2 * the best)   -> dist_argmin_t_kernel (K2)
// and tools/int8_probe.py's `kern32` (:154, out[b] = max_n m[n].x[:, b], x
// stored (D, B))                                     -> f32_winner_probe_kernel (K16)
// The two forms give the same floats here: halving and doubling are exact, so
// -2 fl(x.m - ||m||^2 / 2) = fl(||m||^2 - 2 x.m) for the same x.m and ||m||^2,
// and a strict > on the score over ascending codes is a strict < on the
// distance.  So K1 and K2 are one kernel body (argmin_tc), instantiated under
// two names so that a profile tells the trainers' and LVQ steps' winners (K1)
// from the fast qerror's (K2); both return the same (value, index) bit for
// bit on the same inputs.  K4, the masked distance form, runs the same CTA
// shape and staging (argmin_tc.cuh) with the keep contraction beside it, in
// dist_argmin.cu.  K16 is the third instantiation: no norm (the score is
// the plain dot product), x read as (D, B), and only the value kept: -2 *
// the best score is exact, and halved back exactly on unpacking.  On the
// probe's integer inputs (|v| <= 127) lo is zero and every partial sum is an
// integer below 2^24, so each product and sum is exact and K16 equals the
// float64 maximum bit for bit.  (On CUDA cores, one sample per thread and
// FP32 FMAs from shared broadcasts, it ran at 23 TFLOP/s, level with cuBLAS
// SGEMM then amax on an H100.)
//
// What bounds it on H100: the contraction x.m^T (B x N x D).  On CUDA cores
// (the earlier 4 x 4 FP32 micro-tile, two shared loads per FMA pair) it ran
// at about 21 FP32 TFLOP/s over 1M x 65536 x 64 on an H100, slower than
// torch.addmm then argmin.  The scores run on the tensor cores as split-TF32
// mma.sync (tf32x3.cuh): three TF32 products per float32 product, float32
// accumulators, float32 accuracy, a 165 TFLOP/s ceiling; and the codebook
// splits across gridDim.y when the batch alone gives too few CTAs (the LVQ
// steps' B 1024 is 8 CTAs, a mesh rank's B 512 only 4).  It reaches about a
// quarter of that bound on an H100 (1M x 65536 x 64), a third of what
// mma.sync issues there (mma_probe.py): the staging and scoring between the
// CTA's barriers share the SM with the mma (a producer warp feeding wgmma is
// the next step).
//
// Design.  One CTA owns TB = 128 samples, 16 per warp.  A warp keeps its
// samples' A fragments, split into hi and lo, in registers for the whole
// walk over the codebook (D <= 64: at most 8 k-steps, 64 registers); wider
// D is walked in 64-feature slabs whose fragments are reloaded per slab.
// The codebook streams through shared memory in TNC-row tiles: cp.async
// copies tile i + 1 into one half of a double buffer while tile i, split
// once into hi and lo, feeds the mma; ||m||^2 is summed per row at staging
// in float32 (per lane, then a fixed xor tree).  Each thread keeps, for its
// two samples, a running (max, index) with a strict > over its codes in
// ascending order; the four lanes of a sample merge theirs
// lexicographically (value, index).  Splits (ops.dist_argmin.k2_splits,
// spans of whole tiles) fold with the packed-u64 atomicMin of
// argmin_keys.cuh on -2 * the score: negation and doubling are exact, so
// the largest score wins and the lowest index among equal ones, in any CTA
// order.  Every sum runs in a fixed order, and a row's value depends only on
// its own data, not on the tile, split or shard that holds it: two runs are
// bit-equal, and the min over shards of a codebook is the whole run's.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "argmin_tc.cuh"

namespace {

// kNorm: the score x.m - ||m||^2 / 2 (K1, K2), else x.m (K16); kXT: x (D, B)
template <int KT, bool kNorm, bool kXT>
__device__ __forceinline__ void argmin_tc(const float* __restrict__ x,
                                          const float* __restrict__ codes, int B,
                                          int N, int D, int n_span,
                                          unsigned long long* __restrict__ keys) {
  using L = K2Smem<KT>;
  constexpr int SW = L::SW, DC = L::DC;
  extern __shared__ __align__(16) float smem[];
  float* raw0 = smem;
  float* raw1 = raw0 + kTNC * SW;
  float* chi = raw1 + kTNC * SW;
  float* clo = chi + kTNC * DC;
  float* m2s = clo + kTNC * DC;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.x * kTB + 16 * warp;  // this warp's 16 samples
  const int n_lo = blockIdx.y * n_span;
  const int n_hi = min(N, n_lo + n_span);
  const int nslab = (D + SW - 1) / SW;
  const int ntiles = (n_hi - n_lo + kTNC - 1) / kTNC;
  const int nitems = ntiles * nslab;  // item = (tile, slab), slab fastest

  float ahi[KT][4], alo[KT][4];
  if (nslab == 1) load_x<KT, kXT>(ahi, alo, x, B, D, b0, 0, lane);
  float best[2] = {-INFINITY, -INFINITY};
  int bidx[2] = {INT_MAX, INT_MAX};
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
        if (kNorm) sq += v * v;
      }
      if (kNorm) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sq += __shfl_xor_sync(0xffffffffu, sq, off);
        if (lane == 0) m2s[r] = sl == 0 ? sq : m2s[r] + sq;
      }
    }
    if (nslab > 1) load_x<KT, kXT>(ahi, alo, x, B, D, b0, sl, lane);
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
      // 2t + 1): codes ascend with n and q, so strict > keeps the first
#pragma unroll
      for (int n = 0; n < kTNC / 8; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 8 * n + 2 * t + (q & 1), h = q >> 1;
          if (c < rows) {
            const float sc = kNorm ? S[n][q] - 0.5f * m2s[c] : S[n][q];
            if (sc > best[h]) {
              best[h] = sc;
              bidx[h] = n0 + c;
            }
          }
        }
    }
  }
  cp_async_wait_all();

  merge_fold(best, bidx, b0, B, lane, keys);
}

// K1 (the distance form's wrapper dist_argmin) and K2 (dist_argmin_t): one
// body, two names; K16 (f32_winner_probe) the body without the norm, on x
// stored (D, B)
template <int KT>
__global__ void __launch_bounds__(kThreads, 2)
dist_argmin_kernel(const float* __restrict__ x, const float* __restrict__ codes,
                   int B, int N, int D, int n_span,
                   unsigned long long* __restrict__ keys) {
  argmin_tc<KT, true, false>(x, codes, B, N, D, n_span, keys);
}

template <int KT>
__global__ void __launch_bounds__(kThreads, 2)
dist_argmin_t_kernel(const float* __restrict__ x, const float* __restrict__ codes,
                     int B, int N, int D, int n_span,
                     unsigned long long* __restrict__ keys) {
  argmin_tc<KT, true, false>(x, codes, B, N, D, n_span, keys);
}

template <int KT>
__global__ void __launch_bounds__(kThreads, 2)
f32_winner_probe_kernel(const float* __restrict__ x, const float* __restrict__ codes,
                        int B, int N, int D, int n_span,
                        unsigned long long* __restrict__ keys) {
  argmin_tc<KT, false, true>(x, codes, B, N, D, n_span, keys);
}

enum Kind { kK1, kK2, kK16 };

// K16's read-back: the value of each key, -2 * the best x.m, halved back
// (exact; 0 - v turns a zero into +0)
__global__ void unpack_probe(const unsigned long long* __restrict__ keys, int n,
                             float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = 0.f - 0.5f * unorder_bits((unsigned int)(keys[i] >> 32));
}

template <int KT, Kind kKind>
int launch_t(const float* x, const float* codes, int B, int N, int D, int splits,
             unsigned long long* keys, cudaStream_t stream) {
  const size_t smem = K2Smem<KT>::bytes();
  auto kernel = kKind == kK1   ? dist_argmin_kernel<KT>
                : kKind == kK2 ? dist_argmin_t_kernel<KT>
                               : f32_winner_probe_kernel<KT>;
  cudaError_t err = cudaFuncSetAttribute(kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  // rows per split: spans of whole kTNC-row tiles
  const int n_tiles = (N + kTNC - 1) / kTNC;
  const int n_span = ((n_tiles + splits - 1) / splits) * kTNC;
  const dim3 grid((B + kTB - 1) / kTB, (N + n_span - 1) / n_span);
  kernel<<<grid, kThreads, smem, stream>>>(x, codes, B, N, D, n_span, keys);
  return (int)cudaGetLastError();
}

// val and idx from the keys (K1, K2); K16 writes its maxima to val
template <Kind kKind>
int search(const float* x, const float* codes, int B, int N, int D, int splits,
           unsigned long long* keys, float* val, int* idx, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || D <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  init_keys<<<(B + 255) / 256, 256, 0, stream>>>(keys, B);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int k8 = (D + 7) / 8;
  rc = k8 <= 1   ? launch_t<1, kKind>(x, codes, B, N, D, splits, keys, stream)
       : k8 <= 2 ? launch_t<2, kKind>(x, codes, B, N, D, splits, keys, stream)
       : k8 <= 4 ? launch_t<4, kKind>(x, codes, B, N, D, splits, keys, stream)
                 : launch_t<8, kKind>(x, codes, B, N, D, splits, keys, stream);
  if (rc) return rc;
  if (kKind == kK16)
    unpack_probe<<<(B + 255) / 256, 256, 0, stream>>>(keys, B, val);
  else
    unpack_keys<<<(B + 255) / 256, 256, 0, stream>>>(keys, B, val, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// K1; keys: (B,) u64 scratch; val gets the partial distance ||m||^2 - 2 x.m
extern "C" int somvq_dist_argmin(const float* x, const float* codes, int B,
                                 int N, int D, int splits,
                                 unsigned long long* keys, float* val, int* idx,
                                 cudaStream_t stream) {
  return search<kK1>(x, codes, B, N, D, splits, keys, val, idx, stream);
}

// K2; keys: (B,) u64 scratch; val gets -2 * the best score x.m - ||m||^2 / 2,
// the same float as K1's partial distance
extern "C" int somvq_dist_argmin_t(const float* x, const float* codes, int B,
                                   int N, int D, int splits,
                                   unsigned long long* keys, float* val, int* idx,
                                   cudaStream_t stream) {
  return search<kK2>(x, codes, B, N, D, splits, keys, val, idx, stream);
}

// K16: m (N, D) float32 (the codebook of the walk), x (D, B) float32 (the
// samples); keys: (B,) u64 scratch; out (B,) float32 gets max_n m[n].x[:, b]
extern "C" int somvq_f32_winner_probe(const float* m, const float* x, int N, int D,
                                      int B, int splits, unsigned long long* keys,
                                      float* out, cudaStream_t stream) {
  return search<kK16>(x, m, B, N, D, splits, keys, out, nullptr, stream);
}
