// K14's main form: the batch-chunked separable step (replaces
// som_lvq_pak_tpu/ops/pallas_som.py:_som_fused_factored_chunked_kernel without
// its stagger and int8_win options) on K13's tensor-core body
// (fused_step_tc.cuh with separable_w.cuh's W from the tables).  The TPU
// kernel's batch chunk is a VMEM device; what is left of K14 beside K13 are
// its roundings:
//
//   wxa_bf16    the x-pattern table is bf16 (PT), staged by cp.async in
//               16-byte pieces of 8 values and widened where W is built;
//   batch_bf16  kBf16: x and x' rounded to bf16 by the split launch, W rounded
//               to bf16 for its product with x (wsum from the unrounded W),
//               the blended float32 rows rounded to bf16 for the winners'
//               scores (||m||^2 from the float32 rows); every operand is then
//               exact in TF32 and every product exact in float32, so W.X and
//               the scores are ONE TF32 mma.sync product each, with no lo half
//               split or staged (without batch_bf16, K13's three products).
//
// Rows per CTA: 64 or 32 (the wrapper takes ops.som_step.K14_ROWS, 64: each
// CTA walks the whole batch in about the same time at either height, so the
// main path's 64x64 map at B 4096, 64 CTAs of 64 rows on 132 SMs, is no
// slower than 128 of 32; chip_smoke.py times both).  Each row's batch stays
// in one CTA, so reruns are bit-equal.
//
// What bounds it on H100: the two contractions, 4 noc B D FLOPs per step,
// issued as 4 noc B D TF32 FLOPs under batch_bf16 (12 noc B D otherwise) at
// 495 TFLOP/s, 4.3 GFLOP at 64x64 B 4096 D 64: far less than the time each
// CTA takes to walk the batch, one barrier-separated 32-sample chunk after
// another (staging, W build, mma), then the winner chunks.  That walk, the
// same for every map the trainer gives K14, sets the time; a split of the
// batch across CTAs would shorten it (PERF.md).  Instantiated per codebook type
// in som_fused_chunked_tc_f32.cu and som_fused_chunked_tc_bf16.cu.

#pragma once

#include "separable_w.cuh"

namespace {

template <int NT, int WARPS, typename CT, typename PT, bool kBf16>
__global__ void __launch_bounds__(32 * WARPS, (NT <= 8 ? 2 : 1) * 8 / WARPS)
som_fused_factored_chunked_tc_kernel(CT* __restrict__ codes, int noc, int D,
                                     const float* __restrict__ xs,
                                     const float* __restrict__ aw, int B, int Bn,
                                     int xdim, int hexa, int gaussian, float radius,
                                     int ny, const PT* __restrict__ pat,
                                     const float* __restrict__ ytab,
                                     unsigned long long* __restrict__ keys) {
  separable_step_tc<NT, WARPS, kBf16>(codes, noc, D, xs, aw, B, Bn, xdim, hexa, gaussian,
                                      radius, ny, pat, ytab, keys);
}

// for D's width and the rows per CTA (a.rows: 64 or 32)
template <typename CT, typename PT, bool kBf16>
int launch_k14_tc(const StepArgs& a) {
  const int k8 = (a.D + 7) / 8;  // 8-feature steps, padded up to a power of two
  if (a.rows != 32 && a.rows != 64) return (int)cudaErrorInvalidValue;
#define K14_LAUNCH(NT)                                                              \
  if (k8 <= NT)                                                                   \
    return a.rows == 32                                                           \
               ? launch_separable_tc<NT, 2, kBf16, CT, PT>(                       \
                     som_fused_factored_chunked_tc_kernel<NT, 2, CT, PT, kBf16>, a) \
               : launch_separable_tc<NT, 4, kBf16, CT, PT>(                       \
                     som_fused_factored_chunked_tc_kernel<NT, 4, CT, PT, kBf16>, a);
  K14_LAUNCH(1)
  K14_LAUNCH(2)
  K14_LAUNCH(4)
  K14_LAUNCH(8)
  K14_LAUNCH(16)
  K14_LAUNCH(32)
#undef K14_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K14's main launch for its bf16 options (wxa_bf16 only on a gaussian map)
template <typename CT>
int run_k14_tc(const StepArgs& a, int wxa_bf16, int batch_bf16) {
  if (wxa_bf16 && batch_bf16) return launch_k14_tc<CT, __nv_bfloat16, true>(a);
  if (wxa_bf16) return launch_k14_tc<CT, __nv_bfloat16, false>(a);
  if (batch_bf16) return launch_k14_tc<CT, float, true>(a);
  return launch_k14_tc<CT, float, false>(a);
}

}  // namespace
