// K17's W and operand helpers, shared by its mma.sync kernel
// (fused_skeleton.cu, D > 128) and its Hopper walk (fused_skeleton_sm90.cu):
// a W row's samples read as floats, a value rounded to x''s type, and the
// split of an operand (hi and lo for float32, the value itself for bf16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "som_grid.cuh"
#include "tf32x3.cuh"

namespace {

__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return bf16_round(v);
}

// samples s .. s + 7 of one W row as floats, zero from B on
__device__ __forceinline__ void load_w8(float (&v)[8], const float* row, int s, int B,
                                        bool vec) {
  if (vec && s + 8 <= B) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(row + s));
    const float4 b = __ldg(reinterpret_cast<const float4*>(row + s + 4));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = s + i < B ? __ldg(row + s + i) : 0.f;
  }
}
__device__ __forceinline__ void load_w8(float (&v)[8], const __nv_bfloat16* row, int s,
                                        int B, bool vec) {
  if (vec && s + 8 <= B) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(row + s));
    const uint32_t u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 pairs, the lower address in the low half
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = s + i < B ? __bfloat162float(row[s + i]) : 0.f;
  }
}

// (hi, lo) of a float32 operand; a bf16 value is its own hi, lo unused
template <bool kSplit>
__device__ __forceinline__ void split_route(float v, float& hi, float& lo) {
  if constexpr (kSplit) {
    split_tf32(v, hi, lo);
  } else {
    hi = v;
    lo = 0.f;
  }
}

}  // namespace
