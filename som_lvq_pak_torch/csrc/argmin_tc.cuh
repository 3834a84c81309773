// The pieces of the tensor-core winner search shared by K1, K2 and K16
// (dist_argmin_t.cu) and K4 (dist_argmin.cu): the CTA shape, the cp.async
// staging of a codebook tile, and the merge of a sample's four lanes with
// the fold across codebook splits.
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

}  // namespace
