// The SOM neighbourhood update's device code: the weights, shared by every
// SOM kernel; accumulate_update (FP32 FMAs on CUDA cores), K5's
// (som_update.cu).  K3 and K11 (fused_step_tc.cuh), K6 (som_update.cu) and
// K7 (som_vmem_steps.cu) build the same weights from staged grid coordinates
// (grid_x, grid_d2_at, weight_of_d2) for their tensor-core updates.
//
// W[unit, sample] is built from flat unit indices with the exact-f32 algebra
// of som_lvq_pak_tpu/ops/pallas_som.py:_neighborhood_w: dx from columns and
// 0.5 offsets, hexa dy^2 as rowdiff^2 * 0.75 (exact in float32, so the bubble
// test d2 <= r*r is exact at boundary distances); bubble alpha inside the
// radius, gaussian alpha * expf(-d2 / (2 r r)); 0 where bmu < 0.
//
// Layout of the update: one CTA owns TN codebook rows; warp w owns rows
// 4w..4w+3 and lane l owns columns l + 32 j (j < NJ), so D <= 32 NJ <= 256.
// The batch is walked in BC-sample chunks staged in shared memory, in a fixed
// order, so acc = W.X and the weight mass are deterministic with no atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int TN = 32;        // codebook rows per CTA (8 warps x 4 rows)
constexpr int BC = 32;        // batch samples staged per chunk
constexpr int THREADS = 256;
constexpr int MAX_D = 256;    // 32 lanes x NJ (<= 8) columns

// the exact-f32 grid x coordinate of the unit in column c, row r (hexa odd
// rows at c + 0.5)
__device__ __forceinline__ float grid_x(int c, int r, bool hexa) {
  return hexa ? (float)c + 0.5f * (float)(r & 1) : (float)c;
}

// exact-f32 squared grid distance between a unit at (lx, row ly) and a BMU
// at (bx, row by): x from grid_x, rows as floats, exact below 2^24, so
// ly - by is the exact row difference
__device__ __forceinline__ float grid_d2_at(float lx, float ly, float bx, float by,
                                            bool hexa) {
  const float rd = ly - by;
  const float dx = lx - bx;
  if (hexa) return dx * dx + (rd * rd) * 0.75f;
  return dx * dx + rd * rd;
}

// exact-f32 squared grid distance between unit u and BMU bm
__device__ __forceinline__ float grid_d2(int u, int bm, int xdim, bool hexa) {
  const int uc = u % xdim, ur = u / xdim;
  const int bc = bm % xdim, br = bm / xdim;
  return grid_d2_at(grid_x(uc, ur, hexa), (float)ur, grid_x(bc, br, hexa),
                    (float)br, hexa);
}

// the neighbourhood weight at squared grid distance d2 for alpha a
__device__ __forceinline__ float weight_of_d2(float d2, float a, bool gaussian,
                                              float r2, float den) {
  return gaussian ? a * expf(-d2 / den) : (d2 <= r2 ? a : 0.f);
}

// the neighbourhood weight of unit u for a sample with BMU bm and alpha a;
// r2 = radius^2, den = 2 radius^2
__device__ __forceinline__ float neighborhood_w(int u, int bm, float a, int xdim,
                                                bool hexa, bool gaussian,
                                                float r2, float den) {
  if (bm < 0) return 0.f;
  return weight_of_d2(grid_d2(u, bm, xdim, hexa), a, gaussian, r2, den);
}

// _guarded_blend: exact c + acc - wsum * c while wsum <= 1, the weighted
// mean acc / wsum beyond
__device__ __forceinline__ float guarded_blend(float c, float acc, float wsum) {
  const float safe = fmaxf(wsum, 1e-30f);
  const float blend = fminf(wsum, 1.0f);
  return c + blend * (acc / safe - c);
}

// A codebook entry as float32, and back: a bf16 codebook (SOMTrainer(bf16=
// True)) is read upcast and written rounded to nearest even, as astype does
__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Accumulate, for rows r0 + 4 warp + i, acc[i][j] = sum_b W x_b (column
// lane + 32 j) and the weight mass wsum[i] = sum_b W.  Shared memory:
// xs[BC][DS], ws[TN][BC], DS = D | 1 (an odd stride puts each sample's row on
// distinct banks).  W is evaluated at the GLOBAL unit unit_offset + row (a
// model-axis shard of a larger map; 0 on a whole map), while rows index the
// local codebook.
template <int NJ>
__device__ __forceinline__ void accumulate_update(
    float (&acc)[4][NJ], float (&wsum)[4], float* xs, float* ws, int r0, int noc,
    int D, const float* __restrict__ xb, const int* __restrict__ bmu,
    const float* __restrict__ alpha, int B, int xdim, bool hexa, bool gaussian,
    float radius, int unit_offset = 0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int DS = D | 1;
  const float r2 = radius * radius;
  const float den = 2.0f * radius * radius;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int s0 = 0; s0 < B; s0 += BC) {
    __syncthreads();  // previous chunk fully consumed
    for (int e = tid; e < BC * D; e += THREADS) {
      const int s = e / D, k = e % D;
      xs[s * DS + k] = (s0 + s < B) ? xb[(size_t)(s0 + s) * D + k] : 0.f;
    }
    for (int e = tid; e < TN * BC; e += THREADS) {
      const int r = e / BC, s = e % BC;
      const int u = r0 + r, b = s0 + s;
      ws[r * BC + s] = (b < B && u < noc)
                           ? neighborhood_w(unit_offset + u, bmu[b], alpha[b],
                                            xdim, hexa, gaussian, r2, den)
                           : 0.f;
    }
    __syncthreads();
    const int nb = min(BC, B - s0);
    for (int s = 0; s < nb; ++s) {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = ws[(warp * 4 + i) * BC + s];
        wsum[i] += w[i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int k = lane + 32 * j;
        const float xv = (k < D) ? xs[s * DS + k] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += w[i] * xv;
      }
    }
  }
}

}  // namespace
