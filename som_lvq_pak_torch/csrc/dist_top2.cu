// Fused 2-NN winner search: for each sample x_b, the two codebook rows with the
// smallest ||x_b - m_n||^2, without materialising the (B, N) distance matrix.
//
// Replaces two TPU kernels of som_lvq_pak_tpu/ops/pallas_distance.py:
//   * _dist_top2_kernel (wrapper dist_top2): partial distance ||m||^2 - 2 x.m,
//     running (best, second) pair                     -> dist_top2_kernel (K8)
//   * _dist_top2_masked_kernel (dist_top2 with a mask): partial distance
//     keep.(m o m) - 2 (x keep).m                -> dist_top2_masked_kernel (K9)
// Both return the two smallest (value, index) pairs in lexicographic order,
// the function the TPU kernels' running merge (_top2_epilogue, strict <,
// earlier tile kept) computes: the lower index wins every exact tie, on the
// best pair and on the second.  The lexicographic merge of two sorted pairs
// over disjoint code sets (merge_pairs) is associative and commutative, so
// lanes, warps and CTAs may merge in any order and give the same answer.
// The codebook is split across gridDim.y when the batch alone gives too few
// CTAs (the LVQ steps' B 1024 is 8 CTAs of 128 samples on 132 SMs).  The
// packed-u64 atomicMin of argmin_keys.cuh carries one pair, not two, so each
// split writes its partial pairs to a (splits, B, 2) scratch the wrapper
// allocates, and a second small launch merges the splits in split order.
//
// K8 runs K1's tensor-core body (argmin_tc.cuh, the walk of dist_argmin_t.cu)
// with a top-2 fold in place of K1's running maximum.
//
//   What bounds it on H100: the contraction x.m^T (B x N x D), as split-TF32
//   mma.sync (tf32x3.cuh): three TF32 products per float32 product, float32
//   accumulators, 6 B N D TF32 FLOPs against the 495 TFLOP/s peak (on CUDA
//   cores, a 4 x 4 FP32 micro-tile with two shared loads per FMA pair, it
//   ran at 0.6394 ms at B 1024 x 65536 x 64 on an H100, 20% of the FP32
//   bound).  The staging and the fold share the SM with the mma between the
//   CTA's barriers, as in K1.
//
//   Design.  One CTA owns kTB = 128 samples, 16 per warp, their A fragments
//   split into hi and lo in registers for the whole walk (load_x; D > 64 in
//   64-feature slabs, reloaded per slab).  The codebook streams through
//   shared memory in kTNC-row tiles by a cp.async double buffer, split once
//   at staging, ||m||^2 summed per row there in K1's order.  Each lane keeps,
//   for each of its two samples, a sorted (best, second) pair of (score,
//   code) over its codes, score = x.m - ||m||^2 / 2: it visits its codes in
//   ascending order, so a strict > keeps the lower code of equal scores in
//   both places.  The four lanes of a sample merge their pairs
//   lexicographically (merge_pairs on scores); each value is -2 * the score,
//   exact, -0 folded to +0: the partial distance, bit for bit the value K1
//   returns for the same code (its val), so K8's best pair is K1's (val,
//   idx).  The splits are ops.dist_argmin.k2_splits, K1's whole waves of two
//   CTAs per SM.  Every sum runs in a fixed order and a code's score depends
//   only on its own data: two runs are bit-equal.
//
// K9 stays on CUDA cores: one CTA owns TB samples, walks its codebook rows in
// TN-row tiles staged through shared memory in KC-wide slices of D (any D >=
// 1, no padding), and each of the 256 threads owns a 4 x 4 (sample, code)
// micro-tile, inserting each candidate into its registers' (v1, i1, v2, i2)
// per sample in ascending code order; the 16 threads that share a sample
// then merge their sorted pairs with shuffles.  The mask enters as (B, D)
// uint8, nonzero = masked: a masked component is zeroed in the staged x and
// gets keep 0, and keep.(m o m) squares the code slice already in shared
// memory (twice K8's FMAs, no extra codebook traffic).  A sample with every
// component masked scores 0 against every code and gets (0, 0), (0, 1), as
// in the JAX package.  What bounds it on H100: FP32 FMA issue and
// shared-memory loads (no tensor cores; K4's split-TF32 body with a top-2
// fold is its next design).  The codebook is read once per CTA from L2.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "argmin_tc.cuh"

namespace {

// (value, index) order of a pair list: lex_less on partial distances, or
// lex_greater on K8's scores
template <bool kScore>
__device__ __forceinline__ bool first(float v, int i, float w, int j) {
  return kScore ? lex_greater(v, i, w, j) : lex_less(v, i, w, j);
}

// (v1, i1) before (v2, i2) and (w1, j1) before (w2, j2), over disjoint code
// sets: (v1, i1, v2, i2) becomes the first two pairs of the union
template <bool kScore>
__device__ __forceinline__ void merge_pairs(float& v1, int& i1, float& v2, int& i2,
                                            float w1, int j1, float w2, int j2) {
  if (first<kScore>(w1, j1, v1, i1)) {
    if (first<kScore>(w2, j2, v1, i1)) {
      v2 = w2;
      i2 = j2;
    } else {
      v2 = v1;
      i2 = i1;
    }
    v1 = w1;
    i1 = j1;
  } else if (first<kScore>(w1, j1, v2, i2)) {
    v2 = w1;
    i2 = j1;
  }
}

// the partial distance of a score: -2 * score (exact), -0 folded to +0
__device__ __forceinline__ float value_of(float score) {
  const float v = -2.f * score;
  return v == 0.f ? 0.f : v;
}

// ---- K8: K1's body with a top-2 fold ----------------------------------------

// partial pairs of codebook rows [n_lo, n_lo + n_span) of split blockIdx.y
// into pv/pi[(split * B + b) * 2 + {0, 1}]; the walk is argmin_tc's
// (dist_argmin_t.cu) with the norm, x stored (B, D)
template <int KT>
__global__ void __launch_bounds__(kThreads, 2)
dist_top2_kernel(const float* __restrict__ x, const float* __restrict__ codes, int B,
                 int N, int D, int n_span, float* __restrict__ pv,
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
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.x * kTB + 16 * warp;  // this warp's 16 samples
  const int n_lo = blockIdx.y * n_span;
  const int n_hi = min(N, n_lo + n_span);
  const int nslab = (D + SW - 1) / SW;
  const int ntiles = (n_hi - n_lo + kTNC - 1) / kTNC;
  const int nitems = ntiles * nslab;  // item = (tile, slab), slab fastest

  float ahi[KT][4], alo[KT][4];
  if (nslab == 1) load_x<KT, false>(ahi, alo, x, B, D, b0, 0, lane);
  // per sample h: the best and second (score, code), sorted
  float s1[2] = {-INFINITY, -INFINITY}, s2[2] = {-INFINITY, -INFINITY};
  int j1[2] = {INT_MAX, INT_MAX}, j2[2] = {INT_MAX, INT_MAX};
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
        sq += v * v;
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
      // 2t + 1): codes ascend with n and q, so strict > keeps the first
#pragma unroll
      for (int n = 0; n < kTNC / 8; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 8 * n + 2 * t + (q & 1), h = q >> 1;
          if (c < rows) {
            const float sc = S[n][q] - 0.5f * m2s[c];
            if (sc > s1[h]) {
              s2[h] = s1[h];
              j2[h] = j1[h];
              s1[h] = sc;
              j1[h] = n0 + c;
            } else if (sc > s2[h]) {
              s2[h] = sc;
              j2[h] = n0 + c;
            }
          }
        }
    }
  }
  cp_async_wait_all();

  // merge the four lanes t of each sample, then write this split's pairs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float w1 = __shfl_xor_sync(0xffffffffu, s1[h], off);
      const int k1 = __shfl_xor_sync(0xffffffffu, j1[h], off);
      const float w2 = __shfl_xor_sync(0xffffffffu, s2[h], off);
      const int k2 = __shfl_xor_sync(0xffffffffu, j2[h], off);
      merge_pairs<true>(s1[h], j1[h], s2[h], j2[h], w1, k1, w2, k2);
    }
    const int b = b0 + g + 8 * h;
    if (t == 0 && b < B) {
      const size_t o = ((size_t)blockIdx.y * B + b) * 2;
      pv[o] = value_of(s1[h]);
      pi[o] = j1[h];
      pv[o + 1] = value_of(s2[h]);
      pi[o + 1] = j2[h];
    }
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
      merge_pairs<false>(v1[i], i1[i], v2[i], i2[i], w1, j1, w2, j2);
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
    merge_pairs<false>(v1, i1, v2, i2, pv[o], pi[o], pv[o + 1], pi[o + 1]);
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

template <int KT>
int launch_k8(const float* x, const float* codes, int B, int N, int D, int splits,
              float* pv, int* pi, int& used, cudaStream_t stream) {
  const size_t smem = K2Smem<KT>::bytes();
  cudaError_t err = cudaFuncSetAttribute(dist_top2_kernel<KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int n_span;
  spans(N, splits, kTNC, n_span, used);
  const dim3 grid((B + kTB - 1) / kTB, used);
  dist_top2_kernel<KT><<<grid, kThreads, smem, stream>>>(x, codes, B, N, D, n_span,
                                                         pv, pi);
  return (int)cudaGetLastError();
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

// K8; pv/pi: (splits, B, 2) scratch; v1/v2 get partial distances, as K1's val
// does
extern "C" int somvq_dist_top2(const float* x, const float* codes, int B, int N,
                               int D, int splits, float* pv, int* pi, float* v1,
                               int* i1, float* v2, int* i2, cudaStream_t stream) {
  int rc = check_args(B, N, D, splits);
  if (rc) return rc;
  int used = 0;
  const int k8 = (D + 7) / 8;
  rc = k8 <= 1   ? launch_k8<1>(x, codes, B, N, D, splits, pv, pi, used, stream)
       : k8 <= 2 ? launch_k8<2>(x, codes, B, N, D, splits, pv, pi, used, stream)
       : k8 <= 4 ? launch_k8<4>(x, codes, B, N, D, splits, pv, pi, used, stream)
                 : launch_k8<8>(x, codes, B, N, D, splits, pv, pi, used, stream);
  if (rc) return rc;
  return merge(pv, pi, B, used, v1, i1, v2, i2, stream);
}

// K9; the same scratch and outputs
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
