// K4: the masked 1-NN winner search: for each sample x_b, the codebook row
// m_n that minimises the squared distance over x_b's unmasked components,
// without materialising the (B, N) distance matrix.
//
// Replaces som_lvq_pak_tpu/ops/pallas_distance.py:_dist_argmin_masked_kernel
// (wrapper dist_argmin with a mask): partial distance keep.(m o m) -
// 2 (x keep).m, masked components excluded, a strict-< running min; the
// lowest index wins exact ties, the reference's rule.  The unmasked search
// (K1, dist_argmin_kernel) and the max-score form (K2) run on the tensor
// cores in dist_argmin_t.cu; K4 stays here on CUDA cores.
//
// Design.  One CTA owns TB samples and walks the codebook in TN-row tiles;
// the TPU's sequential codebook grid axis becomes this loop, so the running
// (best, index) pair stays in registers and is updated only on a strict
// comparison.  Each tile is staged through shared memory in KC-wide slices of
// D, so any D >= 1 works with no padding.  Each of the 256 threads owns a
// 4 x 4 (sample, code) micro-tile; at the end the 16 threads that share a
// sample merge their pairs with a (value, index) lexicographic shuffle
// reduction, which is the same rule.  The codebook splits across gridDim.y
// CTAs when the batch alone gives too few CTAs to fill the card (a training
// batch of 1024 is 16 CTAs on 132 SMs); the splits fold their (value, index)
// pairs with the packed-u64 atomicMin of argmin_keys.cuh, which keeps the
// same tie rule and does not depend on the order the CTAs run in.  Splits are
// spans of whole TN-row tiles, so every (sample, code) partial distance is
// computed exactly as without a split.  The caller passes the split count
// (ops.dist_argmin.codebook_splits).
//
// The mask enters as (B, D) uint8, nonzero = masked.  A masked component is
// zeroed in the staged x and gets keep 0; the second contraction keep.(m o m)
// squares the code slice already in shared memory, so the masked search
// costs twice the FMAs of the unmasked one and no extra codebook traffic.
//
// What bounds it on H100: FP32 FMA issue and shared-memory loads (3 loads
// per 2 FMA pairs in this micro-tile; no tensor cores).  The codebook is read
// once per CTA from L2, so device memory is not the limit at eval shapes.
// K1's split-TF32 body plus the keep.(m o m) contraction (K exact in TF32) is
// its next design.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "argmin_keys.cuh"

namespace {

constexpr int TB = 64;        // samples per CTA
constexpr int TN = 64;        // codebook rows per tile
constexpr int KC = 32;        // feature slice staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 micro-tile each

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  // lexicographic (value, index): equal values go to the lower index
  return v < bv || (v == bv && i < bi);
}

// The masked winner search over codebook rows [n_lo, n_lo + n_span) of
// split blockIdx.y; each sample's (partial distance, index) is folded into
// keys[b].
__global__ void __launch_bounds__(THREADS)
dist_argmin_masked_kernel(const float* __restrict__ x,
                          const unsigned char* __restrict__ mask,
                          const float* __restrict__ codes, int B, int N, int D,
                          int n_span, unsigned long long* __restrict__ keys) {
  __shared__ float xs[TB][KC + 1];
  __shared__ float ks[TB][KC + 1];
  __shared__ float ms[TN][KC + 1];

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // code column group: codes tx + 16 j
  const int ty = tid >> 4;   // sample row group:  samples ty + 16 i
  const int b0 = blockIdx.x * TB;
  const int n_lo = blockIdx.y * n_span;
  const int n_hi = min(N, n_lo + n_span);

  float best[4];
  int bidx[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = INFINITY;
    bidx[i] = INT_MAX;
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
        ms[r][c] = (n < N && k < D) ? codes[(size_t)n * D + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < KC; ++c) {
        float xv[4], kv[4], mv[4], mm[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          xv[i] = xs[ty + 16 * i][c];
          kv[i] = ks[ty + 16 * i][c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mv[j] = ms[tx + 16 * j][c];
          mm[j] = mv[j] * mv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            xm[i][j] += xv[i] * mv[j];
            km2[i][j] += kv[i] * mm[j];
          }
      }
    }

    // codes tx + 16 j visited in increasing order: a strict comparison keeps
    // the first (lowest) index of this thread's subset
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < n_hi) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d = km2[i][j] - 2.f * xm[i][j];
          if (d < best[i]) {
            best[i] = d;
            bidx[i] = n;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx[i], off);
      if (better(ov, oi, best[i], bidx[i])) {
        best[i] = ov;
        bidx[i] = oi;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + ty + 16 * i;
      if (b < B && bidx[i] != INT_MAX) fold_key(keys + b, best[i], bidx[i]);
    }
  }
}

// rows per codebook split: `splits` spans of whole TN-row tiles (the caller's
// count, ops.dist_argmin.codebook_splits, the rule K8-K10 use too)
int split_span(int N, int splits) {
  const int n_tiles = (N + TN - 1) / TN;
  return ((n_tiles + splits - 1) / splits) * TN;
}

}  // namespace

// K4; keys: (B,) u64 scratch; val gets the partial distance
extern "C" int somvq_dist_argmin_masked(const float* x, const unsigned char* mask,
                                        const float* codes, int B, int N, int D,
                                        int splits, unsigned long long* keys,
                                        float* val, int* idx, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || D <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  const int n_span = split_span(N, splits);
  const dim3 grid((B + TB - 1) / TB, (N + n_span - 1) / n_span);
  init_keys<<<(B + 255) / 256, 256, 0, stream>>>(keys, B);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  dist_argmin_masked_kernel<<<grid, THREADS, 0, stream>>>(x, mask, codes, B, N,
                                                          D, n_span, keys);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  unpack_keys<<<(B + 255) / 256, 256, 0, stream>>>(keys, B, val, idx);
  return (int)cudaGetLastError();
}

extern "C" const char* somvq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
