// The mma.sync winner search of K16 (dist_argmin_t.cu), the last kernel on
// it, and the pieces the Hopper walks share with it: the lane merge and split
// fold of K1 and K2 (argmin_sm90.cu) and K4 (argmin_masked_sm90.cu) and the
// split A fragments (load_x, K1's too).  K16's: the CTA shape, the cp.async
// staging of a codebook tile, and its shared-memory layout (K2Smem).
//
// One CTA owns kTB = 128 samples, 16 per warp, and walks its span of the
// codebook in kTNC-row tiles, each tile split into slabs of SW = 8 KT
// features (one slab when D <= 64).  An item is one (tile, slab), slab
// fastest; the raw rows of item i + 1 are copied while item i is split and
// scored.

#pragma once

#include <cuda_runtime.h>

#include <climits>

#include "argmin_keys.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kTB = 128;   // samples per CTA (8 warps x 16)
constexpr int kTNC = 64;   // codebook rows per tile (8 n-tiles)
constexpr int kWarps = kTB / 16;
constexpr int kThreads = 32 * kWarps;

// cp.async of item i's (tile, slab) into raw[row][feature]: rows past n_hi
// and features past D are not copied (the split reads zeros for them);
// 16-byte pieces when D % 4 == 0 (rows and slabs then 16-byte aligned)
template <int KT>
__device__ __forceinline__ void prefetch(float* raw, const float* __restrict__ codes,
                                         int D, int n_lo, int n_hi, int nslab, int i,
                                         int tid) {
  constexpr int SW = 8 * KT;
  const int n0 = n_lo + (i / nslab) * kTNC, f0 = (i % nslab) * SW;
  const int rows = min(kTNC, n_hi - n0), width = min(SW, D - f0);
  if ((D & 3) == 0) {
    for (int e = tid; e < rows * (SW / 4); e += kThreads) {
      const int r = e / (SW / 4), f = 4 * (e % (SW / 4));
      if (f < width) cp_async16(raw + r * SW + f, codes + (size_t)(n0 + r) * D + f0 + f);
    }
  } else {
    for (int e = tid; e < rows * SW; e += kThreads) {
      const int r = e / SW, f = e % SW;
      if (f < width) cp_async4(raw + r * SW + f, codes + (size_t)(n0 + r) * D + f0 + f);
    }
  }
  cp_async_commit();
}

// Lane (g, t) holds the best (score, code) of samples b0 + g (h 0) and
// b0 + g + 8 (h 1) over its codes: merge the four lanes t of each sample
// lexicographically, then fold -2 * the score across CTAs (negation and
// doubling are exact, so the smallest key is the largest score with the
// lowest code)
__device__ __forceinline__ void merge_fold(float (&best)[2], int (&bidx)[2], int b0,
                                           int B, int lane,
                                           unsigned long long* __restrict__ keys) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[h], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[h], off);
      if (lex_greater(ov, oi, best[h], bidx[h])) {
        best[h] = ov;
        bidx[h] = oi;
      }
    }
    const int b = b0 + g + 8 * h;
    if (t == 0 && b < B && bidx[h] != INT_MAX)
      fold_key(keys + b, -2.f * best[h], bidx[h]);
  }
}

// KT k-steps of 8 features per slab (slab width SW = 8 KT; KT = 8 when D >
// 64).  Shared memory (floats): raw[2][kTNC * SW] | chi, clo [kTNC][DC] |
// m2s[kTNC]
template <int KT>
struct K2Smem {
  static constexpr int SW = 8 * KT;
  static constexpr int DC = stride_nk(SW);
  static constexpr size_t bytes() {
    return sizeof(float) * (2 * (size_t)kTNC * SW + 2 * (size_t)kTNC * DC + kTNC);
  }
};

// The A fragments of slab `sl` for the warp's samples b0..b0+15, split:
// a0 (sample g, feature t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
// of each k-step, zero past B and D; x stored (B, D), or (D, B) with kXT
// (strided loads, once per walk)
template <int KT, bool kXT>
__device__ __forceinline__ void load_x(float (&ahi)[KT][4], float (&alo)[KT][4],
                                       const float* __restrict__ x, int B, int D,
                                       int b0, int sl, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < KT; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int b = b0 + g + 8 * (q & 1);
      const int k = sl * 8 * KT + 8 * ks + t + 4 * (q >> 1);
      const size_t i = kXT ? (size_t)k * B + b : (size_t)b * D + k;
      split_tf32((b < B && k < D) ? __ldg(x + i) : 0.f, ahi[ks][q], alo[ks][q]);
    }
}

}  // namespace
