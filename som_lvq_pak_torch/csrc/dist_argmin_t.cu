// K16: the maximum of x_b.m_n over the codebook rows, on the tensor cores.
//
// Replaces tools/int8_probe.py's `kern32` (:154, out[b] = max_n m[n].x[:, b],
// x stored (D, B)) -> f32_winner_probe_kernel (K16), the float32 twin of the
// int8 probe K15 (winner_probe.cu).  On the probe's integer inputs (|v| <=
// 127) lo is zero and every partial sum is an integer below 2^24, so each
// product and sum is exact and K16 equals the float64 maximum bit for bit.
//
// What bounds it on H100: the contraction x.m^T (B x N x D) as split-TF32
// mma.sync (tf32x3.cuh): three TF32 products per float32 product, float32
// accumulators, 6 B N D TF32 FLOPs at 495 TFLOP/s, of which mma.sync issues
// about two thirds (mma_probe.py).
//
// Design: the mma.sync walk the winner searches ran on before K1 and K2
// moved to warpgroup wgmma fed by a TMA ring (argmin_sm90.cu), and K8, K4
// and K9 after them (argmin_sm90.cu, argmin_masked_sm90.cu); K10
// (dist_topk.cu) still walks this way.  One
// CTA owns TB = 128 samples, 16 per warp.  A warp keeps its samples' A
// fragments, split into hi and lo, in registers for the whole walk over the
// codebook (D <= 64: at most 8 k-steps, 64 registers); wider D is walked in
// 64-feature slabs whose fragments are reloaded per slab.  The codebook
// streams through shared memory in TNC-row tiles: cp.async copies tile i + 1
// into one half of a double buffer while tile i, split once into hi and lo,
// feeds the mma.  Each thread keeps, for its two samples, a running (max,
// index) with a strict > over its codes in ascending order; the four lanes
// of a sample merge theirs lexicographically (value, index).  Splits
// (ops.dist_argmin.k2_splits, spans of whole tiles) fold with the
// packed-u64 atomicMin of argmin_keys.cuh on -2 * the score: negation and
// doubling are exact, so the largest score wins in any CTA order, and the
// value is halved back exactly on unpacking.  Two runs are bit-equal.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "argmin_tc.cuh"

namespace {

// the score x.m, x stored (D, B)
template <int KT>
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

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int b0 = blockIdx.x * kTB + 16 * warp;  // this warp's 16 samples
  const int n_lo = blockIdx.y * n_span;
  const int n_hi = min(N, n_lo + n_span);
  const int nslab = (D + SW - 1) / SW;
  const int ntiles = (n_hi - n_lo + kTNC - 1) / kTNC;
  const int nitems = ntiles * nslab;  // item = (tile, slab), slab fastest

  float ahi[KT][4], alo[KT][4];
  if (nslab == 1) load_x<KT, true>(ahi, alo, x, B, D, b0, 0, lane);
  float best[2] = {-INFINITY, -INFINITY};
  int bidx[2] = {INT_MAX, INT_MAX};
  float S[kTNC / 8][4];

  if (nitems > 0) prefetch<KT>(raw0, codes, D, n_lo, n_hi, nslab, 0, tid);
  for (int i = 0; i < nitems; ++i) {
    const int n0 = n_lo + (i / nslab) * kTNC, sl = i % nslab;
    const int rows = min(kTNC, n_hi - n0), width = min(SW, D - sl * SW);
    float* raw = (i & 1) ? raw1 : raw0;
    cp_async_wait_all();
    __syncthreads();  // item i landed; item i - 1's fragments read
    if (i + 1 < nitems)
      prefetch<KT>((i & 1) ? raw0 : raw1, codes, D, n_lo, n_hi, nslab, i + 1, tid);
    // split: warp w takes rows w, w + 8, ...
    for (int r = warp; r < kTNC; r += kWarps) {
#pragma unroll
      for (int f = lane; f < SW; f += 32) {
        const float v = (r < rows && f < width) ? raw[r * SW + f] : 0.f;
        float hi, lo;
        split_tf32(v, hi, lo);
        chi[r * DC + f] = hi;
        clo[r * DC + f] = lo;
      }
    }
    if (nslab > 1) load_x<KT, true>(ahi, alo, x, B, D, b0, sl, lane);
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
          if (c < rows && S[n][q] > best[h]) {
            best[h] = S[n][q];
            bidx[h] = n0 + c;
          }
        }
    }
  }
  cp_async_wait_all();

  merge_fold(best, bidx, b0, B, lane, keys);
}

template <int KT>
__global__ void __launch_bounds__(kThreads, 2)
f32_winner_probe_kernel(const float* __restrict__ x, const float* __restrict__ codes,
                        int B, int N, int D, int n_span,
                        unsigned long long* __restrict__ keys) {
  argmin_tc<KT>(x, codes, B, N, D, n_span, keys);
}

// K16's read-back: the value of each key, -2 * the best x.m, halved back
// (exact; 0 - v turns a zero into +0)
__global__ void unpack_probe(const unsigned long long* __restrict__ keys, int n,
                             float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = 0.f - 0.5f * unorder_bits((unsigned int)(keys[i] >> 32));
}

template <int KT>
int launch_t(const float* x, const float* codes, int B, int N, int D, int splits,
             unsigned long long* keys, cudaStream_t stream) {
  const size_t smem = K2Smem<KT>::bytes();
  cudaError_t err = cudaFuncSetAttribute(f32_winner_probe_kernel<KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  // rows per split: spans of whole kTNC-row tiles
  const int n_tiles = (N + kTNC - 1) / kTNC;
  const int n_span = ((n_tiles + splits - 1) / splits) * kTNC;
  const dim3 grid((B + kTB - 1) / kTB, (N + n_span - 1) / n_span);
  f32_winner_probe_kernel<KT><<<grid, kThreads, smem, stream>>>(x, codes, B, N, D, n_span,
                                                                keys);
  return (int)cudaGetLastError();
}

// out gets the maxima, halved back from the keys
int search(const float* x, const float* codes, int B, int N, int D, int splits,
           unsigned long long* keys, float* out, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || D <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  init_keys<<<(B + 255) / 256, 256, 0, stream>>>(keys, B);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int k8 = (D + 7) / 8;
  rc = k8 <= 1   ? launch_t<1>(x, codes, B, N, D, splits, keys, stream)
       : k8 <= 2 ? launch_t<2>(x, codes, B, N, D, splits, keys, stream)
       : k8 <= 4 ? launch_t<4>(x, codes, B, N, D, splits, keys, stream)
                 : launch_t<8>(x, codes, B, N, D, splits, keys, stream);
  if (rc) return rc;
  unpack_probe<<<(B + 255) / 256, 256, 0, stream>>>(keys, B, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K16: m (N, D) float32 (the codebook of the walk), x (D, B) float32 (the
// samples); keys: (B,) u64 scratch; out (B,) float32 gets max_n m[n].x[:, b]
extern "C" int somvq_f32_winner_probe(const float* m, const float* x, int N, int D,
                                      int B, int splits, unsigned long long* keys,
                                      float* out, cudaStream_t stream) {
  return search(x, m, B, N, D, splits, keys, out, stream);
}
