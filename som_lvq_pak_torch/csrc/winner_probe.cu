// The winner-contraction probes: out[b] = max over rows n of sum_k m[n, k]
// x[k, b], m (N, D), x (D, B).
//
// Replace tools/int8_probe.py's Pallas kernels `kern` (:95, int8 x int8 ->
// int32, K15 int8_winner_probe) and `kern32` (:154, its float32 twin, K16
// f32_winner_probe), which measured whether an int8 winner contraction pays
// (pallas_som.py:969-970; its use in the fused step is K14's int8_win).  The
// TPU kernels fold a running max over 256-row tiles of an in-order grid into a
// (1, B) row; here every CTA takes one 32-row tile of m against one
// 256-sample chunk of x, and the maximum across CTAs is folded by atomicMax:
// on int32 for K15, on the order-preserving unsigned image of the float for
// K16 (argmin_keys.cuh's order_bits, -0 folded to +0), read back by a second
// small launch.
//
// The layout: the tile's rows are staged in shared memory 32 words at a time
// (32 float32 columns, or 128 int8 columns packed four to a word with D padded
// by zeros); each thread owns one sample, whose slice of x is staged
// sample-contiguous (a warp's loads hit distinct banks), keeps 32 running sums
// in registers and reads the rows' words as 16-byte broadcasts: 128 FP32
// FMAs, or 128 __dp4a (512 int8 MACs into int32), per 4 loads of x.
//
// Both results are exact for the probe's inputs: an int8 dot is exact in
// int32, and for integer-valued float32 inputs with |sum| < 2^24 (D 64: at
// most 64 * 127^2) every partial sum of the FP32 FMAs is exact, so each is
// bit-equal to a float64 reference.
//
// What bounds it on H100: the multiply-adds (FP32 FMA issue, or __dp4a
// issue: no tensor cores), 2 N D B operations; device memory traffic is m
// and x read once (x re-read from L2 by every row tile) and B results.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "argmin_keys.cuh"

namespace {

constexpr int PR = 32;   // rows of m per CTA
constexpr int PB = 256;  // samples per CTA, one per thread
constexpr int KW = 32;   // 4-byte words of a row staged per slice: 32 float
                         // columns or 128 int8 columns

// thread b's 32 sums over one staged slice: the tile's rows against x's
__device__ __forceinline__ void probe_slice(const float* __restrict__ ms,
                                            const float* __restrict__ xs,
                                            float (&acc)[PR]) {
  const int tid = threadIdx.x;
  for (int w = 0; w < KW; w += 4) {
    const float x0 = xs[(w + 0) * PB + tid], x1 = xs[(w + 1) * PB + tid];
    const float x2 = xs[(w + 2) * PB + tid], x3 = xs[(w + 3) * PB + tid];
#pragma unroll
    for (int r = 0; r < PR; ++r) {
      const float4 m4 = *reinterpret_cast<const float4*>(ms + r * KW + w);
      acc[r] = fmaf(m4.x, x0, acc[r]);
      acc[r] = fmaf(m4.y, x1, acc[r]);
      acc[r] = fmaf(m4.z, x2, acc[r]);
      acc[r] = fmaf(m4.w, x3, acc[r]);
    }
  }
}

__device__ __forceinline__ void probe_slice(const int* __restrict__ ms,
                                            const int* __restrict__ xs,
                                            int (&acc)[PR]) {
  const int tid = threadIdx.x;
  for (int w = 0; w < KW; w += 4) {
    const int x0 = xs[(w + 0) * PB + tid], x1 = xs[(w + 1) * PB + tid];
    const int x2 = xs[(w + 2) * PB + tid], x3 = xs[(w + 3) * PB + tid];
#pragma unroll
    for (int r = 0; r < PR; ++r) {
      const int4 m4 = *reinterpret_cast<const int4*>(ms + r * KW + w);
      acc[r] = __dp4a(m4.x, x0, acc[r]);
      acc[r] = __dp4a(m4.y, x1, acc[r]);
      acc[r] = __dp4a(m4.z, x2, acc[r]);
      acc[r] = __dp4a(m4.w, x3, acc[r]);
    }
  }
}

// stage the slice from column k0 of rows n0.. of m and samples b0.. of x
// (zeros beyond N, D and B)
__device__ __forceinline__ void stage(const float* __restrict__ m,
                                      const float* __restrict__ x, int N, int D,
                                      int B, int n0, int b0, int k0, float* ms,
                                      float* xs) {
  for (int e = threadIdx.x; e < PR * KW; e += PB) {
    const int r = e / KW, k = k0 + e % KW;
    ms[e] = (n0 + r < N && k < D) ? m[(size_t)(n0 + r) * D + k] : 0.f;
  }
  for (int e = threadIdx.x; e < KW * PB; e += PB) {
    const int k = k0 + e / PB, b = b0 + e % PB;
    xs[e] = (k < D && b < B) ? x[(size_t)k * B + b] : 0.f;
  }
}

__device__ __forceinline__ void stage(const signed char* __restrict__ m,
                                      const signed char* __restrict__ x, int N,
                                      int D, int B, int n0, int b0, int k0, int* ms,
                                      int* xs) {
  for (int e = threadIdx.x; e < PR * KW; e += PB) {
    const int r = e / KW, k = k0 + 4 * (e % KW);
    unsigned int v = 0u;
    if (n0 + r < N) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + j < D)
          v |= (unsigned int)(unsigned char)m[(size_t)(n0 + r) * D + k + j] << (8 * j);
    }
    ms[e] = (int)v;
  }
  for (int e = threadIdx.x; e < KW * PB; e += PB) {
    const int k = k0 + 4 * (e / PB), b = b0 + e % PB;
    unsigned int v = 0u;
    if (b < B) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + j < D) v |= (unsigned int)(unsigned char)x[(size_t)(k + j) * B + b] << (8 * j);
    }
    xs[e] = (int)v;
  }
}

__device__ __forceinline__ void fold_max(int* out, int v) {
  if (v > __ldcg(out)) atomicMax(out, v);  // out only grows
}

__device__ __forceinline__ void fold_max(unsigned int* out, float v) {
  const unsigned int o = order_bits(v);
  if (o > __ldcg(out)) atomicMax(out, o);
}

// K15 (T int8, A int, O int) and K16 (T float, A float, O unsigned: ordered
// bits); O starts at INT_MIN (K15) or 0, below every ordered float (K16)
template <typename T, typename A, typename O>
__global__ void __launch_bounds__(PB)
winner_probe_kernel(const T* __restrict__ m, const T* __restrict__ x, int N, int D,
                    int B, O* __restrict__ out) {
  constexpr int CK = KW * (int)(sizeof(A) / sizeof(T));  // columns per slice
  __shared__ __align__(16) A ms[PR * KW];
  __shared__ __align__(16) A xs[KW * PB];
  const int n0 = blockIdx.x * PR, b0 = blockIdx.y * PB, b = b0 + threadIdx.x;
  A acc[PR];
#pragma unroll
  for (int r = 0; r < PR; ++r) acc[r] = 0;
  for (int k0 = 0; k0 < D; k0 += CK) {
    __syncthreads();  // the previous slice consumed
    stage(m, x, N, D, B, n0, b0, k0, ms, xs);
    __syncthreads();
    probe_slice(ms, xs, acc);
  }
  if (b >= B) return;
  A best = acc[0];
#pragma unroll
  for (int r = 1; r < PR; ++r)
    if (n0 + r < N && acc[r] > best) best = acc[r];
  fold_max(out + b, best);
}

__global__ void unorder_floats(const unsigned int* __restrict__ keys, int n,
                               float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = unorder_bits(keys[i]);
}

}  // namespace

// K15: m (N, D) int8, x (D, B) int8; out (B,) int32, set to INT_MIN by the
// wrapper, gets max_n m[n].x[:, b]
extern "C" int somvq_int8_winner_probe(const signed char* m, const signed char* x,
                                       int N, int D, int B, int* out,
                                       cudaStream_t stream) {
  if (N <= 0 || D <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + PR - 1) / PR, (B + PB - 1) / PB);
  winner_probe_kernel<signed char, int, int><<<grid, PB, 0, stream>>>(m, x, N, D, B, out);
  return (int)cudaGetLastError();
}

// K16: m (N, D) float32, x (D, B) float32; keys (B,) u32, set to 0 by the
// wrapper; out (B,) float32 gets max_n m[n].x[:, b]
extern "C" int somvq_f32_winner_probe(const float* m, const float* x, int N, int D,
                                      int B, unsigned int* keys, float* out,
                                      cudaStream_t stream) {
  if (N <= 0 || D <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + PR - 1) / PR, (B + PB - 1) / PB);
  winner_probe_kernel<float, float, unsigned int><<<grid, PB, 0, stream>>>(m, x, N, D, B,
                                                                           keys);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  unorder_floats<<<(B + 255) / 256, 256, 0, stream>>>(keys, B, out);
  return (int)cudaGetLastError();
}
