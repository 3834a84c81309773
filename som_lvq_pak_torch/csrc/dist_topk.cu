// Fused k-NN winner search, k <= 16: for each sample x_b, the k codebook rows
// with the smallest ||x_b - m_n||^2, ascending, without materialising the
// (B, N) distance matrix.
//
// Replaces som_lvq_pak_tpu/ops/pallas_distance.py:_dist_topk_kernel (wrapper
// dist_topk): partial distance ||m||^2 - 2 x.m, a running top-k merged tile
// by tile, ties to the lowest index.  The result is the k smallest (value,
// index) pairs in lexicographic order, which is what the TPU kernel's
// re-selection (first minimum of the running entries before the tile's)
// computes.
//
// Design: K8's (dist_top2.cu) generalised from two to KM in {2, 4, 8, 16}
// entries, k <= KM chosen at run time.  K8's tiling: one CTA owns TB
// samples, walks its codebook rows in TN-row tiles staged through shared
// memory in KC-wide slices of D (any D >= 1, no padding); each of the 256
// threads owns a 4 x 4 (sample, code) micro-tile and keeps, per sample, a
// sorted list of KM (value, index) pairs in registers (fully unrolled, so
// every index is a compile-time constant).  A thread visits its codes in
// increasing index order, and every insertion and merge compares
// lexicographically, so threads, warps and CTAs may merge in any order and
// give the same answer.  The 16 threads of a sample merge their lists by
// shuffles; the codebook is split across gridDim.y as K8 splits it (about
// two CTAs per SM), each split writes its k pairs to a scratch, and a second
// small launch merges the splits.
//
// What bounds it on H100: FP32 FMA issue and shared-memory loads (no tensor
// cores); at large KM, the insertions (KM compares per candidate) and the
// register lists.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int TB = 64;        // samples per CTA
constexpr int TN = 64;        // codebook rows per tile
constexpr int KC = 32;        // feature slice staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 micro-tile each

__device__ __forceinline__ bool lex_less(float v, int i, float w, int j) {
  return v < w || (v == w && i < j);
}

// insert (d, n) into the sorted list (v, ix) of KM pairs, dropping the last
template <int KM>
__device__ __forceinline__ void insert(float (&v)[KM], int (&ix)[KM], float d,
                                       int n) {
  if (!lex_less(d, n, v[KM - 1], ix[KM - 1])) return;
  v[KM - 1] = d;
  ix[KM - 1] = n;
#pragma unroll
  for (int t = KM - 1; t > 0; --t) {
    if (lex_less(v[t], ix[t], v[t - 1], ix[t - 1])) {
      const float tv = v[t];
      const int ti = ix[t];
      v[t] = v[t - 1];
      ix[t] = ix[t - 1];
      v[t - 1] = tv;
      ix[t - 1] = ti;
    }
  }
}

// the k (<= KM) smallest pairs of codebook rows [n_lo, n_lo + n_span) of
// split blockIdx.y into pv/pi[(split * B + b) * k + t]
template <int KM>
__global__ void __launch_bounds__(THREADS)
dist_topk_kernel(const float* __restrict__ x, const float* __restrict__ codes,
                 int B, int N, int D, int n_span, int k,
                 float* __restrict__ pv, int* __restrict__ pi) {
  __shared__ float xs[TB][KC + 1];
  __shared__ float ms[TN][KC + 1];
  __shared__ float m2s[TN];

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // code column group: codes tx + 16 j
  const int ty = tid >> 4;   // sample row group:  samples ty + 16 i
  const int b0 = blockIdx.x * TB;
  const int n_lo = blockIdx.y * n_span;
  const int n_hi = min(N, n_lo + n_span);

  float v[4][KM];
  int ix[4][KM];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < KM; ++t) {
      v[i][t] = INFINITY;
      ix[i][t] = INT_MAX;
    }

  for (int n0 = n_lo; n0 < n_hi; n0 += TN) {
    float xm[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) xm[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KC) {
      __syncthreads();  // everyone is done reading the previous slice / m2s
      for (int e = tid; e < TB * KC; e += THREADS) {
        const int r = e / KC, c = e % KC;
        const int b = b0 + r, kk = k0 + c;
        xs[r][c] = (b < B && kk < D) ? x[(size_t)b * D + kk] : 0.f;
      }
      for (int e = tid; e < TN * KC; e += THREADS) {
        const int r = e / KC, c = e % KC;
        const int n = n0 + r, kk = k0 + c;
        ms[r][c] = (n < n_hi && kk < D) ? codes[(size_t)n * D + kk] : 0.f;
      }
      __syncthreads();
      if (tid < TN) {
        float s = (k0 == 0) ? 0.f : m2s[tid];
        for (int c = 0; c < KC; ++c) s += ms[tid][c] * ms[tid][c];
        m2s[tid] = s;
      }
#pragma unroll 4
      for (int c = 0; c < KC; ++c) {
        float xv[4], mv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[ty + 16 * i][c];
#pragma unroll
        for (int j = 0; j < 4; ++j) mv[j] = ms[tx + 16 * j][c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) xm[i][j] += xv[i] * mv[j];
      }
    }
    __syncthreads();  // m2s of this tile is complete

    // codes tx + 16 j visited in increasing index order
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < n_hi) {
        const float m2 = m2s[tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float d = m2 - 2.f * xm[i][j];
          d = (d == 0.f) ? 0.f : d;  // -0 -> +0
          insert<KM>(v[i], ix[i], d, n);
        }
      }
    }
  }

  // merge the 16 threads (one half-warp) that share each sample: take the
  // partner's whole list first, then insert it
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      float w[KM];
      int wi[KM];
#pragma unroll
      for (int t = 0; t < KM; ++t) {
        w[t] = __shfl_xor_sync(0xffffffffu, v[i][t], off);
        wi[t] = __shfl_xor_sync(0xffffffffu, ix[i][t], off);
      }
#pragma unroll
      for (int t = 0; t < KM; ++t) insert<KM>(v[i], ix[i], w[t], wi[t]);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + ty + 16 * i;
      if (b >= B) continue;
      const size_t o = ((size_t)blockIdx.y * B + b) * k;
#pragma unroll
      for (int t = 0; t < KM; ++t) {
        if (t < k) {
          pv[o + t] = v[i][t];
          pi[o + t] = ix[i][t];
        }
      }
    }
  }
}

// fold the `splits` partial lists of each sample
template <int KM>
__global__ void topk_merge_splits(const float* __restrict__ pv,
                                  const int* __restrict__ pi, int B, int k,
                                  int splits, float* __restrict__ vo,
                                  int* __restrict__ io) {
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
  for (int t = 0; t < KM; ++t) {
    if (t < k) {
      vo[(size_t)b * k + t] = v[t];
      io[(size_t)b * k + t] = ix[t];
    }
  }
}

template <int KM>
int launch(const float* x, const float* codes, int B, int N, int D, int k,
           int splits, float* pv, int* pi, float* vo, int* io,
           cudaStream_t stream) {
  // `splits` spans of whole tiles; the grid holds the non-empty ones
  const int n_tiles = (N + TN - 1) / TN;
  const int n_span = ((n_tiles + splits - 1) / splits) * TN;
  const int used = (N + n_span - 1) / n_span;
  const dim3 grid((B + TB - 1) / TB, used);
  dist_topk_kernel<KM><<<grid, THREADS, 0, stream>>>(x, codes, B, N, D, n_span,
                                                     k, pv, pi);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  topk_merge_splits<KM><<<(B + 255) / 256, 256, 0, stream>>>(pv, pi, B, k, used,
                                                             vo, io);
  return (int)cudaGetLastError();
}

}  // namespace

// pv/pi: (splits, B, k) scratch; vo/io: (B, k) outputs, vo the partial
// distances ||m||^2 - 2 x.m, ascending
extern "C" int somvq_dist_topk(const float* x, const float* codes, int B, int N,
                               int D, int k, int splits, float* pv, int* pi,
                               float* vo, int* io, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || D <= 0 || k < 1 || k > 16 || k > N || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (k <= 2) return launch<2>(x, codes, B, N, D, k, splits, pv, pi, vo, io, stream);
  if (k <= 4) return launch<4>(x, codes, B, N, D, k, splits, pv, pi, vo, io, stream);
  if (k <= 8) return launch<8>(x, codes, B, N, D, k, splits, pv, pi, vo, io, stream);
  return launch<16>(x, codes, B, N, D, k, splits, pv, pi, vo, io, stream);
}
