// The masked mma.sync walk of K9 (dist_top2.cu, with topk_fold.cuh's list
// fold at KM 2), whose x keep fragments (load_xk, keep_frag) and order of the
// products K4 shares (argmin_masked_sm90.cu, on wgmma): for the warp's 16
// samples, the score (x keep).m - keep.(m o m) / 2 of every code of this
// CTA's codebook span, handed to the fold in ascending code order.
//
// One CTA owns kTB = 128 samples, 16 per warp (argmin_tc.cuh); a warp keeps
// its samples' A fragments of x keep, split into TF32 hi and lo, in registers
// for the whole walk (64 registers at D 64), and their keep flags as one bit
// each: a lane's four keep values of one k-step are four bits, so D <= 64
// fits in one 32-bit word, expanded to 0.0 or 1.0 with a select at the mma.
// The codebook streams through shared memory in kTNC-row tiles (cp.async
// double buffer); each tile is split once into m's hi and lo and m o m's hi
// and lo, m o m the float32 product m * m as the plain versions and the JAX
// kernels take it.  (x keep).m runs as three TF32 products (tf32x3.cuh) and
// keep.(m o m) as two, keep.(m o m)_lo + keep.(m o m)_hi: keep is 0 or 1,
// exact in TF32, and the dropped remainder is below 2^-22 of each term.  With
// one slab (D <= 64) a thread walks the tile n-tile by n-tile, summing both
// contractions over the k-steps in two 4-float accumulators and scoring at
// once, so no (samples x tile) sum array stays live; wider D walks 64-feature
// slabs and keeps the tile's sums across them (kMulti, its own
// instantiation, one CTA per SM).  A code's score depends only on its own
// data and every sum runs in a fixed order, so every fold sees the same
// floats: K9's best pair is K4's (value, index) bit for bit.  A fully masked
// sample scores 0 against every code.  Features are padded to a multiple of
// 8 with zeros and keep 0 in registers and shared memory only.
//
// A fold supplies visit(h, score, code): the next code of the lane's sample
// g (h 0) or g + 8 (h 1), codes ascending.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "argmin_tc.cuh"

namespace {

// Shared memory (floats): raw[2][kTNC * SW] | chi, clo, qhi, qlo [kTNC][DC]
// (q = m o m); SW = 8 KT, KT = 8 when D > 64
template <int KT>
struct K4Smem {
  static constexpr int SW = 8 * KT;
  static constexpr int DC = stride_nk(SW);
  static constexpr size_t bytes() {
    return sizeof(float) * (2 * (size_t)kTNC * SW + 4 * (size_t)kTNC * DC);
  }
};

// The A fragments of x keep of slab `sl` for the warp's samples b0..b0+15,
// split, and their keep flags, bit 4 ks + q for k-step ks and fragment
// register q: a0 (sample g, feature t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); zero and keep 0 past B and D or where masked
template <int KT>
__device__ __forceinline__ void load_xk(float (&ahi)[KT][4], float (&alo)[KT][4],
                                        uint32_t& kbits, const float* __restrict__ x,
                                        const unsigned char* __restrict__ mask, int B,
                                        int D, int b0, int sl, int lane) {
  const int g = lane >> 2, t = lane & 3;
  kbits = 0u;
#pragma unroll
  for (int ks = 0; ks < KT; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int b = b0 + g + 8 * (q & 1);
      const int k = sl * 8 * KT + 8 * ks + t + 4 * (q >> 1);
      float v = 0.f;
      if (b < B && k < D) {
        const size_t i = (size_t)b * D + k;
        if (__ldg(mask + i) == 0) {
          v = __ldg(x + i);
          kbits |= 1u << (4 * ks + q);
        }
      }
      split_tf32(v, ahi[ks][q], alo[ks][q]);
    }
}

// keep fragment of k-step ks: 1.0 or 0.0 (exact in TF32)
__device__ __forceinline__ void keep_frag(float (&a)[4], uint32_t kbits, int ks) {
#pragma unroll
  for (int q = 0; q < 4; ++q) a[q] = (kbits >> (4 * ks + q)) & 1u ? 1.f : 0.f;
}

// s1 += (x keep).m (three TF32 products), s2 += keep.(m o m) (two, the
// small term first) over k-step ks of n-tile n
__device__ __forceinline__ void k4_mma(float (&s1)[4], float (&s2)[4],
                                       const float (&ahi)[4], const float (&alo)[4],
                                       uint32_t kbits, int ks, const float* chi,
                                       const float* clo, const float* qhi,
                                       const float* qlo, int DC, int n, int lane) {
  float bhi[2], blo[2], kf[4];
  load_b_nk(bhi, chi, DC, 8 * n, 8 * ks, lane);
  load_b_nk(blo, clo, DC, 8 * n, 8 * ks, lane);
  mma_tf32x3(s1, ahi, alo, bhi, blo);
  load_b_nk(bhi, qhi, DC, 8 * n, 8 * ks, lane);
  load_b_nk(blo, qlo, DC, 8 * n, 8 * ks, lane);
  keep_frag(kf, kbits, ks);
  mma_tf32(s2, kf, blo);
  mma_tf32(s2, kf, bhi);
}

// the scores of n-tile n to the fold: c0 (sample g, code 2t), c1 (g, 2t +
// 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1); codes ascend with n and q
template <typename Fold>
__device__ __forceinline__ void k4_score(Fold& fold, const float (&s1)[4],
                                         const float (&s2)[4], int n, int n0, int rows,
                                         int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = 8 * n + 2 * t + (q & 1);
    if (c < rows) fold.visit(q >> 1, s1[q] - 0.5f * s2[q], n0 + c);
  }
}

// The masked walk over codebook rows [n_lo, n_lo + n_span) of split
// blockIdx.y for the warp's samples blockIdx.x * kTB + 16 warp..; kMulti:
// D > 64, walked in 64-feature slabs.  Uses K4Smem<KT>'s dynamic shared
// memory; every cp.async has landed when it returns.
template <int KT, bool kMulti, typename Fold>
__device__ __forceinline__ void masked_walk(const float* __restrict__ x,
                                            const unsigned char* __restrict__ mask,
                                            const float* __restrict__ codes, int B,
                                            int N, int D, int n_span, Fold& fold) {
  using L = K4Smem<KT>;
  constexpr int SW = L::SW, DC = L::DC, NN = kTNC / 8;
  extern __shared__ __align__(16) float smem[];
  float* raw0 = smem;
  float* raw1 = raw0 + kTNC * SW;
  float* chi = raw1 + kTNC * SW;
  float* clo = chi + kTNC * DC;
  float* qhi = clo + kTNC * DC;
  float* qlo = qhi + kTNC * DC;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * kTB + 16 * warp;  // this warp's 16 samples
  const int n_lo = blockIdx.y * n_span;
  const int n_hi = min(N, n_lo + n_span);
  const int nslab = (D + SW - 1) / SW;
  const int ntiles = (n_hi - n_lo + kTNC - 1) / kTNC;
  const int nitems = ntiles * nslab;  // item = (tile, slab), slab fastest

  float ahi[KT][4], alo[KT][4];
  uint32_t kbits = 0u;
  if constexpr (!kMulti) load_xk<KT>(ahi, alo, kbits, x, mask, B, D, b0, 0, lane);
  float S1[kMulti ? NN : 1][4], S2[kMulti ? NN : 1][4];

  if (nitems > 0) prefetch<KT>(raw0, codes, D, n_lo, n_hi, nslab, 0, tid);
  for (int i = 0; i < nitems; ++i) {
    const int n0 = n_lo + (i / nslab) * kTNC, sl = i % nslab;
    const int rows = min(kTNC, n_hi - n0), width = min(SW, D - sl * SW);
    float* raw = (i & 1) ? raw1 : raw0;
    cp_async_wait_all();
    __syncthreads();  // item i landed; item i - 1's fragments read
    if (i + 1 < nitems)
      prefetch<KT>((i & 1) ? raw0 : raw1, codes, D, n_lo, n_hi, nslab, i + 1, tid);
    // split m and m o m: warp w takes rows w, w + 8, ...
    for (int r = warp; r < kTNC; r += kWarps) {
#pragma unroll
      for (int f = lane; f < SW; f += 32) {
        const float v = (r < rows && f < width) ? raw[r * SW + f] : 0.f;
        split_tf32(v, chi[r * DC + f], clo[r * DC + f]);
        split_tf32(__fmul_rn(v, v), qhi[r * DC + f], qlo[r * DC + f]);
      }
    }
    if constexpr (kMulti) {
      load_xk<KT>(ahi, alo, kbits, x, mask, B, D, b0, sl, lane);
      if (sl == 0) {
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) S1[n][q] = S2[n][q] = 0.f;
      }
    }
    __syncthreads();
    if constexpr (kMulti) {
#pragma unroll
      for (int ks = 0; ks < KT; ++ks)
#pragma unroll
        for (int n = 0; n < NN; ++n)
          k4_mma(S1[n], S2[n], ahi[ks], alo[ks], kbits, ks, chi, clo, qhi, qlo, DC,
                 n, lane);
      if (sl == nslab - 1) {
#pragma unroll
        for (int n = 0; n < NN; ++n) k4_score(fold, S1[n], S2[n], n, n0, rows, lane);
      }
    } else {
#pragma unroll 2
      for (int n = 0; n < NN; ++n) {
        float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < KT; ++ks)
          k4_mma(s1, s2, ahi[ks], alo[ks], kbits, ks, chi, clo, qhi, qlo, DC, n, lane);
        k4_score(fold, s1, s2, n, n0, rows, lane);
      }
    }
  }
  cp_async_wait_all();
}

}  // namespace
