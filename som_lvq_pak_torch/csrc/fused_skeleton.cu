// The fused step's skeleton: the matmul-only twin of the fused SOM step, the
// yardstick of how much of a fused step's time its two contractions take.
//
// Replaces bench.py:_skeleton_kernel (K17 fused_step_skeleton, called at
// bench.py:556).  Per 256-row tile the TPU kernel accumulates acc = W(256, B)
// . X(B, D), writes codes + acc * 1e-30, and folds the running max over tiles
// of out . x'^T into a (1, B) row, with no weight generation, no blend and no
// argmax.  One W block serves every tile (bench.py:561), so row u of the
// output is codes[u] + scale * sum_b w[u % T, b] x[b], T = w's rows (256 in
// the bench), and vmax[b] = max_u out[u] . x'[b], out rounded to x''s type
// first (bench.py:529).  W, X and X' are all float32 or all bf16
// (bench.py:585-587); a product of two bf16 values is exact in float32.
// `scale` (1e-30 in the bench, below the ulp of every code) is an argument
// only so that a check can see the accumulation.
//
// The design is K3's tiling (som_fused_step.cu): one CTA per 32 codebook rows,
// the batch and the tile's W block staged in shared memory 32 samples at a
// time, FP32 FMAs into registers; the written rows stay in shared memory for
// the second contraction, 32 samples of x' at a time.  The maximum folds
// across CTAs by atomicMax on the order-preserving unsigned image of the
// float (argmin_keys.cuh, -0 folded to +0), read back by a second launch.
//
// What bounds it on H100: 4 N B D multiply-adds (FP32 FMA issue, no tensor
// cores; bf16 operands would run at the BF16 tensor peak in a kernel that
// used them); device memory traffic is one codebook read and write.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "argmin_keys.cuh"
#include "som_grid.cuh"

namespace {

__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return bf16_round(v);
}

// Shared memory: tile[TN][D] | xs[BC][DS] | ws[TN][BC] | redv[THREADS]
size_t skeleton_smem_bytes(int D) {
  const int DS = D | 1;
  return sizeof(float) * ((size_t)TN * D + (size_t)BC * DS + TN * BC + THREADS);
}

template <int NJ, typename T>
__global__ void __launch_bounds__(THREADS)
fused_skeleton_kernel(const float* __restrict__ codes, int N, int D,
                      const T* __restrict__ w, int T_rows, const T* __restrict__ x,
                      int B, const T* __restrict__ xn, int Bn, float scale,
                      float* __restrict__ out, unsigned int* __restrict__ vkeys) {
  extern __shared__ float smem[];
  const int DS = D | 1;
  float* tile = smem;
  float* xs = tile + TN * D;
  float* ws = xs + BC * DS;
  float* redv = ws + TN * BC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * TN;

  // ---- acc = W.X over the whole batch ------------------------------------
  // thread (warp, lane): rows 4 warp..4 warp+3, columns lane + 32 j
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int s0 = 0; s0 < B; s0 += BC) {
    __syncthreads();  // the previous chunk consumed
    for (int e = tid; e < BC * D; e += THREADS) {
      const int s = e / D, k = e % D;
      xs[s * DS + k] = (s0 + s < B) ? load_f32(x + (size_t)(s0 + s) * D + k) : 0.f;
    }
    for (int e = tid; e < TN * BC; e += THREADS) {
      const int r = e / BC, s = e % BC;
      const int u = r0 + r, b = s0 + s;
      ws[r * BC + s] = (u < N && b < B) ? load_f32(w + (size_t)(u % T_rows) * B + b) : 0.f;
    }
    __syncthreads();
    const int nb = min(BC, B - s0);
    for (int s = 0; s < nb; ++s) {
      float wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] = ws[(warp * 4 + i) * BC + s];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int k = lane + 32 * j;
        const float xv = (k < D) ? xs[s * DS + k] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += wv[i] * xv;
      }
    }
  }

  // ---- out = codes + acc * scale, kept in shared memory as x''s type ------
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i, u = r0 + r;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = lane + 32 * j;
      if (k < D) {
        float o = 0.f;
        if (u < N) {
          const size_t g = (size_t)u * D + k;
          o = codes[g] + __fmul_rn(acc[i][j], scale);
          out[g] = o;
        }
        tile[r * D + k] = round_as(o, xn);
      }
    }
  }

  // ---- vmax[b] = max over the tile's rows of out . x'[b] -----------------
  for (int s0 = 0; s0 < Bn; s0 += BC) {
    __syncthreads();  // tile written; the previous chunk's reduction read
    for (int e = tid; e < BC * D; e += THREADS) {
      const int s = e / D, k = e % D;
      xs[s * DS + k] = (s0 + s < Bn) ? load_f32(xn + (size_t)(s0 + s) * D + k) : 0.f;
    }
    __syncthreads();
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < D; ++k) {
      const float xv = xs[lane * DS + k];
#pragma unroll
      for (int i = 0; i < 4; ++i) dot[i] += tile[(warp * 4 + i) * D + k] * xv;
    }
    float bv = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r0 + warp * 4 + i < N) bv = fmaxf(bv, dot[i]);
    redv[warp * 32 + lane] = bv;
    __syncthreads();
    if (warp == 0) {
      for (int v = 1; v < THREADS / 32; ++v) bv = fmaxf(bv, redv[v * 32 + lane]);
      const int b = s0 + lane;
      if (b < Bn) {
        const unsigned int o = order_bits(bv);
        if (o > __ldcg(vkeys + b)) atomicMax(vkeys + b, o);  // keys only grow
      }
    }
  }
}

__global__ void skeleton_unorder(const unsigned int* __restrict__ keys, int n,
                                 float* __restrict__ vmax) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) vmax[i] = unorder_bits(keys[i]);
}

template <int NJ, typename T>
int launch_skeleton(const float* codes, int N, int D, const void* w, int T_rows,
                    const void* x, int B, const void* xn, int Bn, float scale,
                    float* out, unsigned int* vkeys, cudaStream_t stream) {
  const size_t smem = skeleton_smem_bytes(D);
  const auto kernel = fused_skeleton_kernel<NJ, T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(N + TN - 1) / TN, THREADS, smem, stream>>>(
      codes, N, D, static_cast<const T*>(w), T_rows, static_cast<const T*>(x), B,
      static_cast<const T*>(xn), Bn, scale, out, vkeys);
  return (int)cudaGetLastError();
}

template <typename T>
int run_skeleton(const float* codes, int N, int D, const void* w, int T_rows,
                 const void* x, int B, const void* xn, int Bn, float scale,
                 float* out, unsigned int* vkeys, cudaStream_t stream) {
  const int nj = (D + 31) / 32;
  if (nj <= 1)
    return launch_skeleton<1, T>(codes, N, D, w, T_rows, x, B, xn, Bn, scale, out,
                                 vkeys, stream);
  if (nj <= 2)
    return launch_skeleton<2, T>(codes, N, D, w, T_rows, x, B, xn, Bn, scale, out,
                                 vkeys, stream);
  if (nj <= 4)
    return launch_skeleton<4, T>(codes, N, D, w, T_rows, x, B, xn, Bn, scale, out,
                                 vkeys, stream);
  return launch_skeleton<8, T>(codes, N, D, w, T_rows, x, B, xn, Bn, scale, out,
                               vkeys, stream);
}

}  // namespace

// K17: codes (N, D) float32; w (T_rows, B), x (B, D), xn (Bn, D) all float32,
// or all bf16 with bf16; out (N, D) float32 gets codes + scale * W.X row by
// row (W row u % T_rows); vkeys (Bn,) u32 set to 0 by the wrapper; vmax (Bn,)
// float32 gets max_u out[u] . xn[b], out rounded to xn's type.
extern "C" int somvq_fused_skeleton(const float* codes, int N, int D, const void* w,
                                    int T_rows, const void* x, int B, const void* xn,
                                    int Bn, int bf16, float scale, float* out,
                                    unsigned int* vkeys, float* vmax,
                                    cudaStream_t stream) {
  if (N <= 0 || D <= 0 || D > MAX_D || T_rows <= 0 || B <= 0 || Bn <= 0)
    return (int)cudaErrorInvalidValue;
  const int rc = bf16 ? run_skeleton<__nv_bfloat16>(codes, N, D, w, T_rows, x, B, xn,
                                                    Bn, scale, out, vkeys, stream)
                      : run_skeleton<float>(codes, N, D, w, T_rows, x, B, xn, Bn,
                                            scale, out, vkeys, stream);
  if (rc) return rc;
  skeleton_unorder<<<(Bn + 255) / 256, 256, 0, stream>>>(vkeys, Bn, vmax);
  return (int)cudaGetLastError();
}
