// Fused masked 2-NN winner search: for each sample x_b, the two codebook rows
// with the smallest ||x_b - m_n||^2 over its unmasked components, without
// materialising the (B, N) distance matrix.
//
// Replaces som_lvq_pak_tpu/ops/pallas_distance.py:_dist_top2_masked_kernel
// (dist_top2 with a mask): partial distance keep.(m o m) - 2 (x keep).m,
// running (best, second) pair                        -> dist_top2_masked_kernel (K9)
// The unmasked _dist_top2_kernel (K8) is K10's kernel at k = 2:
// dist_topk.cu's dist_topk_kernel<KT, 2>, launched by ops.dist_top2.
//
// K9 returns the two smallest (value, index) pairs in lexicographic order,
// the function the TPU kernel's running merge (_top2_epilogue, strict <,
// earlier tile kept) computes: the lower index wins every exact tie, on the
// best pair and on the second.  The lexicographic merge of two sorted pairs
// over disjoint code sets (merge_pairs) is associative and commutative, so
// lanes, warps and CTAs may merge in any order and give the same answer.
// The codebook is split across gridDim.y when the batch alone gives too few
// CTAs (the masked LVQ step's B 1024 is 16 CTAs of 64 samples on 132 SMs).
// The packed-u64 atomicMin of argmin_keys.cuh carries one pair, not two, so
// each split writes its partial pairs to a (splits, B, 2) scratch the
// wrapper allocates, and a second small launch merges the splits in split
// order.
//
// K9 stays on CUDA cores: one CTA owns TB samples, walks its codebook rows in
// TN-row tiles staged through shared memory in KC-wide slices of D (any D >=
// 1, no padding), and each of the 256 threads owns a 4 x 4 (sample, code)
// micro-tile, inserting each candidate into its registers' (v1, i1, v2, i2)
// per sample in ascending code order; the 16 threads that share a sample
// then merge their sorted pairs with shuffles.  The mask enters as (B, D)
// uint8, nonzero = masked: a masked component is zeroed in the staged x and
// gets keep 0, and keep.(m o m) squares the code slice already in shared
// memory (no extra codebook traffic).  A sample with every component masked
// scores 0 against every code and gets (0, 0), (0, 1), as in the JAX
// package.  What bounds it on H100: FP32 FMA issue and shared-memory loads
// (no tensor cores; K4's split-TF32 body with K10's fold is its next
// design).  The codebook is read once per CTA from L2.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "tf32x3.cuh"  // lex_less

namespace {

// (v1, i1) before (v2, i2) and (w1, j1) before (w2, j2) by lex_less, over
// disjoint code sets: (v1, i1, v2, i2) becomes the first two pairs of the
// union
__device__ __forceinline__ void merge_pairs(float& v1, int& i1, float& v2, int& i2,
                                            float w1, int j1, float w2, int j2) {
  if (lex_less(w1, j1, v1, i1)) {
    if (lex_less(w2, j2, v1, i1)) {
      v2 = w2;
      i2 = j2;
    } else {
      v2 = v1;
      i2 = i1;
    }
    v1 = w1;
    i1 = j1;
  } else if (lex_less(w1, j1, v2, i2)) {
    v2 = w1;
    i2 = j1;
  }
}

// ---- K9: the masked search on CUDA cores ------------------------------------

constexpr int TB = 64;        // samples per CTA
constexpr int TN = 64;        // codebook rows per tile
constexpr int KC = 32;        // feature slice staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 micro-tile each

// partial pairs of codebook rows [n_lo, n_lo + n_span) of split blockIdx.y
// into pv/pi[(split * B + b) * 2 + {0, 1}]
__global__ void __launch_bounds__(THREADS)
dist_top2_masked_kernel(const float* __restrict__ x,
                        const unsigned char* __restrict__ mask,
                        const float* __restrict__ codes, int B, int N, int D,
                        int n_span, float* __restrict__ pv, int* __restrict__ pi) {
  __shared__ float xs[TB][KC + 1];
  __shared__ float ks[TB][KC + 1];
  __shared__ float ms[TN][KC + 1];

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // code column group: codes tx + 16 j
  const int ty = tid >> 4;   // sample row group:  samples ty + 16 i
  const int b0 = blockIdx.x * TB;
  const int n_lo = blockIdx.y * n_span;
  const int n_hi = min(N, n_lo + n_span);

  float v1[4], v2[4];
  int i1[4], i2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v1[i] = v2[i] = INFINITY;
    i1[i] = i2[i] = INT_MAX;
  }

  for (int n0 = n_lo; n0 < n_hi; n0 += TN) {
    float xm[4][4], km2[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) xm[i][j] = km2[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KC) {
      __syncthreads();  // everyone is done reading the previous slice
      for (int e = tid; e < TB * KC; e += THREADS) {
        const int r = e / KC, c = e % KC;
        const int b = b0 + r, k = k0 + c;
        float xv = 0.f, kv = 0.f;
        if (b < B && k < D) {
          const size_t g = (size_t)b * D + k;
          if (mask[g] == 0) {
            xv = x[g];
            kv = 1.f;
          }
        }
        xs[r][c] = xv;
        ks[r][c] = kv;
      }
      for (int e = tid; e < TN * KC; e += THREADS) {
        const int r = e / KC, c = e % KC;
        const int n = n0 + r, k = k0 + c;
        ms[r][c] = (n < n_hi && k < D) ? codes[(size_t)n * D + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < KC; ++c) {
        float xv[4], mv[4], kv[4], mm[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[ty + 16 * i][c];
#pragma unroll
        for (int j = 0; j < 4; ++j) mv[j] = ms[tx + 16 * j][c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) xm[i][j] += xv[i] * mv[j];
#pragma unroll
        for (int i = 0; i < 4; ++i) kv[i] = ks[ty + 16 * i][c];
#pragma unroll
        for (int j = 0; j < 4; ++j) mm[j] = mv[j] * mv[j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) km2[i][j] += kv[i] * mm[j];
      }
    }

    // codes tx + 16 j visited in increasing index order: a strict comparison
    // keeps the lower index of equal values in both places
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < n_hi) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float d = km2[i][j] - 2.f * xm[i][j];
          d = (d == 0.f) ? 0.f : d;  // -0 -> +0
          if (d < v1[i]) {
            v2[i] = v1[i];
            i2[i] = i1[i];
            v1[i] = d;
            i1[i] = n;
          } else if (d < v2[i]) {
            v2[i] = d;
            i2[i] = n;
          }
        }
      }
    }
  }

  // merge the 16 threads (one half-warp) that share each sample
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float w1 = __shfl_xor_sync(0xffffffffu, v1[i], off);
      const int j1 = __shfl_xor_sync(0xffffffffu, i1[i], off);
      const float w2 = __shfl_xor_sync(0xffffffffu, v2[i], off);
      const int j2 = __shfl_xor_sync(0xffffffffu, i2[i], off);
      merge_pairs(v1[i], i1[i], v2[i], i2[i], w1, j1, w2, j2);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + ty + 16 * i;
      if (b < B) {
        const size_t o = ((size_t)blockIdx.y * B + b) * 2;
        pv[o] = v1[i];
        pi[o] = i1[i];
        pv[o + 1] = v2[i];
        pi[o + 1] = i2[i];
      }
    }
  }
}

// ---- the split merge and the launches ---------------------------------------

// fold the `splits` partial pairs of each sample, in split order
__global__ void top2_merge_splits(const float* __restrict__ pv,
                                  const int* __restrict__ pi, int B, int splits,
                                  float* __restrict__ v1o, int* __restrict__ i1o,
                                  float* __restrict__ v2o, int* __restrict__ i2o) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float v1 = pv[2 * (size_t)b], v2 = pv[2 * (size_t)b + 1];
  int i1 = pi[2 * (size_t)b], i2 = pi[2 * (size_t)b + 1];
  for (int s = 1; s < splits; ++s) {
    const size_t o = ((size_t)s * B + b) * 2;
    merge_pairs(v1, i1, v2, i2, pv[o], pi[o], pv[o + 1], pi[o + 1]);
  }
  v1o[b] = v1;
  i1o[b] = i1;
  v2o[b] = v2;
  i2o[b] = i2;
}

// the non-empty spans of `splits` spans of whole `tile`-row tiles: (rows per
// span, spans used)
void spans(int N, int splits, int tile, int& n_span, int& used) {
  const int n_tiles = (N + tile - 1) / tile;
  n_span = ((n_tiles + splits - 1) / splits) * tile;
  used = (N + n_span - 1) / n_span;
}

int check_args(int B, int N, int D, int splits) {
  return (B <= 0 || N < 2 || D <= 0 || splits < 1) ? (int)cudaErrorInvalidValue : 0;
}

int merge(const float* pv, const int* pi, int B, int used, float* v1, int* i1,
          float* v2, int* i2, cudaStream_t stream) {
  top2_merge_splits<<<(B + 255) / 256, 256, 0, stream>>>(pv, pi, B, used, v1, i1,
                                                         v2, i2);
  return (int)cudaGetLastError();
}

}  // namespace

// K9; pv/pi: (splits, B, 2) scratch; v1/v2 get partial distances
extern "C" int somvq_dist_top2_masked(const float* x, const unsigned char* mask,
                                      const float* codes, int B, int N, int D,
                                      int splits, float* pv, int* pi, float* v1,
                                      int* i1, float* v2, int* i2,
                                      cudaStream_t stream) {
  int rc = check_args(B, N, D, splits);
  if (rc) return rc;
  int n_span, used;
  spans(N, splits, TN, n_span, used);
  const dim3 grid((B + TB - 1) / TB, used);
  dist_top2_masked_kernel<<<grid, THREADS, 0, stream>>>(x, mask, codes, B, N, D,
                                                        n_span, pv, pi);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  return merge(pv, pi, B, used, v1, i1, v2, i2, stream);
}
