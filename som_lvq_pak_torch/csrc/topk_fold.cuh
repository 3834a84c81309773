// The top-k fold of the tensor-core winner walks, shared by K8 and K10
// (argmin_sm90.cu, on K1's wgmma walk; K8 at KM 2, K10 at KM 2, 4, 8 or 16)
// and K9 (argmin_masked_sm90.cu, on K4's wgmma walk at KM 2): per lane and sample
// a sorted list of KM (score, code) pairs, the four lanes of a sample merged
// by shuffles, each codebook split's k pairs written to a (splits, B, k)
// scratch, and a second small launch that folds the splits in split order.
//
// A lane visits its codes in ascending order, so a strict > keeps the lower
// code of equal scores everywhere in its list.  The lane merge and the split
// merge are lexicographic on (score, code) over disjoint code sets: the
// result is the k smallest (value, index) pairs of the whole codebook in
// lexicographic order, whatever the order of the merges.  Values are -2 *
// the score, exact, -0 folded to +0: the partial distance, bit for bit the
// value K1 (K4 under a mask) returns for the same code.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "tf32x3.cuh"  // lex_greater, lex_less

namespace {

// the partial distance of a score: -2 * score (exact), -0 folded to +0
__device__ __forceinline__ float value_of(float score) {
  const float v = -2.f * score;
  return v == 0.f ? 0.f : v;
}

// (v, i) into the list (s, j) of KM scores sorted high first, where i is
// above every code in the list: past every equal score, the last pair
// dropped
template <int KM>
__device__ __forceinline__ void push(float (&s)[KM], int (&j)[KM], float v, int i) {
  if (!(v > s[KM - 1])) return;
  bool placed = false;
#pragma unroll
  for (int t = KM - 1; t > 0; --t) {
    const bool up = !placed && v > s[t - 1];
    if (!placed) {
      s[t] = up ? s[t - 1] : v;
      j[t] = up ? j[t - 1] : i;
    }
    placed = placed || !up;
  }
  if (!placed) {
    s[0] = v;
    j[0] = i;
  }
}

__device__ __forceinline__ void swap_pair(float& a, int& ai, float& b, int& bi) {
  const float v = a;
  const int i = ai;
  a = b;
  ai = bi;
  b = v;
  bi = i;
}

// the first KM of the union of two lists sorted by lex_greater on (score,
// code), over disjoint codes, into (s, j): the better of s[t] and w[KM - 1 -
// t] for each t holds the first KM as a bitonic sequence, which the
// half-cleaners sort
template <int KM>
__device__ __forceinline__ void merge_lists(float (&s)[KM], int (&j)[KM],
                                            const float (&w)[KM], const int (&wi)[KM]) {
#pragma unroll
  for (int t = 0; t < KM; ++t)
    if (lex_greater(w[KM - 1 - t], wi[KM - 1 - t], s[t], j[t])) {
      s[t] = w[KM - 1 - t];
      j[t] = wi[KM - 1 - t];
    }
#pragma unroll
  for (int h = KM / 2; h > 0; h >>= 1)
#pragma unroll
    for (int t = 0; t < KM; ++t)
      if ((t & h) == 0 && lex_greater(s[t + h], j[t + h], s[t], j[t]))
        swap_pair(s[t], j[t], s[t + h], j[t + h]);
}

// A walk's fold: lane (g, t) of a warp keeps the KM best (score, code) of
// samples b0 + g (h 0) and b0 + g + 8 (h 1) over the codes it visits
template <int KM>
struct ListFold {
  float s[2][KM];
  int j[2][KM];

  __device__ __forceinline__ ListFold() {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < KM; ++e) {
        s[h][e] = -INFINITY;
        j[h][e] = INT_MAX;
      }
  }

  // the next code of this lane's sample h, in ascending code order
  __device__ __forceinline__ void visit(int h, float score, int code) {
    push<KM>(s[h], j[h], score, code);
  }

  // merge the four lanes t of each sample, then write its k (<= KM) best
  // pairs as partial distances to pv/pi[(split * B + b) * k + e]
  __device__ __forceinline__ void write(int b0, int B, int lane, int split, int k,
                                        float* __restrict__ pv, int* __restrict__ pi) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        float w[KM];
        int wi[KM];
#pragma unroll
        for (int e = 0; e < KM; ++e) {
          w[e] = __shfl_xor_sync(0xffffffffu, s[h][e], off);
          wi[e] = __shfl_xor_sync(0xffffffffu, j[h][e], off);
        }
        merge_lists<KM>(s[h], j[h], w, wi);
      }
      const int b = b0 + g + 8 * h;
      if (t == 0 && b < B) {
        const size_t o = ((size_t)split * B + b) * k;
#pragma unroll
        for (int e = 0; e < KM; ++e) {
          if (e < k) {
            pv[o + e] = value_of(s[h][e]);
            pi[o + e] = j[h][e];
          }
        }
      }
    }
  }
};

// insert (d, n) into the list (v, ix) of KM pairs sorted by lex_less,
// dropping the last
template <int KM>
__device__ __forceinline__ void insert(float (&v)[KM], int (&ix)[KM], float d, int n) {
  if (!lex_less(d, n, v[KM - 1], ix[KM - 1])) return;
  v[KM - 1] = d;
  ix[KM - 1] = n;
#pragma unroll
  for (int t = KM - 1; t > 0; --t)
    if (lex_less(v[t], ix[t], v[t - 1], ix[t - 1]))
      swap_pair(v[t], ix[t], v[t - 1], ix[t - 1]);
}

// The split merge's outputs: (B, k) row-major (K10), or one array per
// column (K8's and K9's v1, i1, v2, i2)
struct RowsOut {
  float* v;
  int* i;
  int k;
  __device__ __forceinline__ void store(int b, int e, float d, int n) const {
    v[(size_t)b * k + e] = d;
    i[(size_t)b * k + e] = n;
  }
};

struct PairOut {
  float *v1, *v2;
  int *i1, *i2;
  __device__ __forceinline__ void store(int b, int e, float d, int n) const {
    (e == 0 ? v1 : v2)[b] = d;
    (e == 0 ? i1 : i2)[b] = n;
  }
};

// fold the `splits` partial lists of k pairs of each sample, in split order
template <int KM, typename Out>
__global__ void topk_merge_splits(const float* __restrict__ pv,
                                  const int* __restrict__ pi, int B, int k,
                                  int splits, Out out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float v[KM];
  int ix[KM];
#pragma unroll
  for (int t = 0; t < KM; ++t) {
    v[t] = INFINITY;
    ix[t] = INT_MAX;
  }
  for (int s = 0; s < splits; ++s) {
    const size_t o = ((size_t)s * B + b) * k;
    for (int t = 0; t < k; ++t) insert<KM>(v, ix, pv[o + t], pi[o + t]);
  }
#pragma unroll
  for (int t = 0; t < KM; ++t)
    if (t < k) out.store(b, t, v[t], ix[t]);
}

}  // namespace
