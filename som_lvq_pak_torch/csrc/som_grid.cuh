// The SOM neighbourhood weights' device code, shared by every SOM kernel:
// K3, K5 and K11 (fused_step_tc.cuh), K3 and K6 on the Hopper walk
// (fused_step_sm90.cuh's ClosedFormW90), K7
// (som_vmem_steps.cu) and K13/K14 (separable_w.cuh, som_fused_factored.cu)
// build W from staged grid coordinates (grid_x, grid_d2_at, weight_of_d2);
// beside them the guarded blend, a bf16 codebook's loads and stores, and the
// feature passes past 256 (kPassD, n_passes).
//
// W[unit, sample] follows the exact-f32 algebra of
// som_lvq_pak_tpu/ops/pallas_som.py:_neighborhood_w: dx from columns and
// 0.5 offsets, hexa dy^2 as rowdiff^2 * 0.75 (exact in float32, so the bubble
// test d2 <= r*r is exact at boundary distances); bubble alpha inside the
// radius, gaussian alpha * expf(-d2 / (2 r r)); 0 where bmu < 0 (staged with
// alpha 0).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

// Features per pass past the SOM step kernels' widest instantiation (NT 32,
// 8 NT = 256 features): a wider D runs in n_passes(D) passes of kPassD
// features (fused_step_tc.cuh), which every kernel of K3, K5-K7, K11-K14 and
// K17 takes; none has a widest D
constexpr int kPassD = 256;
__host__ __device__ constexpr int n_passes(int D) {
  return D <= kPassD ? 1 : (D + kPassD - 1) / kPassD;
}

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

// the neighbourhood weight at squared grid distance d2 for alpha a
__device__ __forceinline__ float weight_of_d2(float d2, float a, bool gaussian,
                                              float r2, float den) {
  return gaussian ? a * expf(-d2 / den) : (d2 <= r2 ? a : 0.f);
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

}  // namespace
