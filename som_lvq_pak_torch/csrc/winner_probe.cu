// The int8 winner-contraction probe (K15): out[b] = max over rows n of
// sum_k m[n, k] x[k, b], m (N, D) int8, x (D, B) int8, into int32.
//
// Replaces tools/int8_probe.py's Pallas kernel `kern` (:95, int8 x int8 ->
// int32, K15 int8_winner_probe), which measured whether an int8 winner
// contraction pays (pallas_som.py:969-970; its use in the fused step is
// K14's int8_win).  Its float32 twin `kern32` (:154, K16 f32_winner_probe)
// runs on the tensor cores as an instantiation of K2's body
// (dist_argmin_t.cu).  The TPU kernel folds a running max over 256-row tiles
// of an in-order grid into a (1, B) row; here every CTA takes one 32-row
// tile of m against one 256-sample chunk of x, and the maximum across CTAs
// is folded by atomicMax on int32.
//
// The layout: the tile's rows are staged in shared memory 32 words at a time
// (128 int8 columns packed four to a word, D padded by zeros); each thread
// owns one sample, whose slice of x is staged sample-contiguous (a warp's
// loads hit distinct banks), keeps 32 running sums in registers and reads
// the rows' words as 16-byte broadcasts: 128 __dp4a (512 int8 MACs into
// int32) per 4 loads of x.  An int8 dot is exact in int32, so the result is
// bit-equal to a float64 reference.
//
// What bounds it on H100: the multiply-adds (__dp4a issue: no tensor cores;
// IMMA is a later redesign), 2 N D B operations; device memory traffic is m
// and x read once (x re-read from L2 by every row tile) and B results.

#include <cuda_runtime.h>

namespace {

constexpr int PR = 32;   // rows of m per CTA
constexpr int PB = 256;  // samples per CTA, one per thread
constexpr int KW = 32;   // 4-byte words of a row staged per slice: 128 int8
                         // columns

// thread b's 32 sums over one staged slice: the tile's rows against x's
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
// (zeros beyond N, D and B), four int8 columns to a word
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

// out starts at INT_MIN
__global__ void __launch_bounds__(PB)
int8_winner_probe_kernel(const signed char* __restrict__ m,
                         const signed char* __restrict__ x, int N, int D, int B,
                         int* __restrict__ out) {
  constexpr int CK = 4 * KW;  // int8 columns per slice
  __shared__ __align__(16) int ms[PR * KW];
  __shared__ __align__(16) int xs[KW * PB];
  const int n0 = blockIdx.x * PR, b0 = blockIdx.y * PB, b = b0 + threadIdx.x;
  int acc[PR];
#pragma unroll
  for (int r = 0; r < PR; ++r) acc[r] = 0;
  for (int k0 = 0; k0 < D; k0 += CK) {
    __syncthreads();  // the previous slice consumed
    stage(m, x, N, D, B, n0, b0, k0, ms, xs);
    __syncthreads();
    probe_slice(ms, xs, acc);
  }
  if (b >= B) return;
  int best = acc[0];
#pragma unroll
  for (int r = 1; r < PR; ++r)
    if (n0 + r < N && acc[r] > best) best = acc[r];
  fold_max(out + b, best);
}

}  // namespace

// K15: m (N, D) int8, x (D, B) int8; out (B,) int32, set to INT_MIN by the
// wrapper, gets max_n m[n].x[:, b]
extern "C" int somvq_int8_winner_probe(const signed char* m, const signed char* x,
                                       int N, int D, int B, int* out,
                                       cudaStream_t stream) {
  if (N <= 0 || D <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + PR - 1) / PR, (B + PB - 1) / PB);
  int8_winner_probe_kernel<<<grid, PB, 0, stream>>>(m, x, N, D, B, out);
  return (int)cudaGetLastError();
}
