// Cross-CTA (min, first argmin) fold shared by K1 and K2 (argmin_sm90.cu) and
// K4 (argmin_masked_sm90.cu), on -2 * the max score, K16 and the fused SOM
// steps.
//
// The TPU kernels fold their running (min, argmin) across an in-order grid;
// Hopper CTAs run in any order.  Each CTA therefore packs its candidate as
// (order-preserving u32 of the float, u32 index) into a u64 and combines it
// with atomicMin: the smallest value wins, and among equal values the lowest
// index, the reference's tie rule.  The result does not depend on the order
// the CTAs run in.  -0 is folded to +0 first so equal floats order by index.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned int order_bits(float f) {
  unsigned int u = __float_as_uint(f == 0.f ? 0.f : f);  // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unorder_bits(unsigned int o) {
  const unsigned int u = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(u);
}

__device__ __forceinline__ unsigned long long pack_key(float v, int i) {
  return ((unsigned long long)order_bits(v) << 32) | (unsigned int)i;
}

// keys only decrease, so a stale read can only cost a spare atomic
__device__ __forceinline__ void fold_key(unsigned long long* key, float v, int i) {
  const unsigned long long k = pack_key(v, i);
  if (k < __ldcg(key)) atomicMin(key, k);
}

__global__ void init_keys(unsigned long long* keys, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = ~0ull;
}

__global__ void unpack_keys(const unsigned long long* __restrict__ keys, int n,
                            float* __restrict__ val, int* __restrict__ idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const unsigned long long k = keys[i];
    val[i] = unorder_bits((unsigned int)(k >> 32));
    idx[i] = (int)(unsigned int)(k & 0xffffffffull);
  }
}

}  // namespace
