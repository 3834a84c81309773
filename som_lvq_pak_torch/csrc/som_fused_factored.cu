// The separable fused SOM step: batch t's neighbourhood update and batch
// t+1's winners against the updated rows, in one pass over the codebook, with
// the neighbourhood weight factored as W = Wx(column, row parity) * Wy(row).
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_fused_factored_kernel (K13)
// and _som_fused_factored_chunked_kernel (K14, with its options wxa_bf16,
// batch_bf16, int8_win and stagger), from the one entry
// somvq_som_fused_factored: one table launch, then K13's launch, K14's main
// launch, or for K14's stagger and int8_win its walk
// (som_fused_chunked_tc.cuh), all on the tensor cores.  The wrapper
// som_fused_train_step routes to them as the TPU wrapper does.
//
// What they compute, with the TPU kernels' float32 algebra kept as it is:
// s = 1 / (2 r r); dx from columns and 0.5 offsets, hexa dy^2 = rowdiff^2 *
// 0.75 (exact in float32, so the bubble boundary is exact);
//   gaussian  Wx = alpha * expf(-dx^2 s), Wy = expf(-dy^2 s), W = Wx * Wy;
//   bubble    Wx = dx^2, Wy = dy^2, W = (Wx + Wy <= r r) ? alpha : 0;
// W = 0 where bmu < 0; acc = W.X, wsum = W.1 and the guarded blend; then the
// next batch's winners in max-score form, score = x.m - ||m||^2 / 2, reported
// as -2 * score, the lowest row on ties.  K14's options and roundings are
// described in som_fused_chunked_tc.cuh.
//
// The x-pattern.  The TPU kernels build the (pattern rows, B) table of Wx at
// grid step 0 into scratch that every later grid step reads, which holds only
// because the TPU grid runs in order.  Here a first small launch
// (separable_w.cuh: factored_tables_kernel) writes Wx,
// indexed by (row parity, column), Wy, indexed by grid row, and alpha (0 where
// bmu < 0) into buffers the wrapper allocates, and the main launch reads them
// (12 MB at 256x256 hexa, B 4096: L2-resident).  The TPU kernels' 0/1
// "expand" matmul that spreads Wy over a tile's rows (a relayout device) is
// the index Wy[u / xdim].
//
// K13 for D <= 128 runs K3's Hopper walk (som_fused_factored_sm90.cu, its own
// entry somvq_som_fused_factored_sm90; ops.som_step.k13_route), bit-equal to
// the kernel here, which takes wider D.
//
// K13's main launch runs K3's body on the tensor cores (fused_step_tc.cuh:
// split-TF32 mma.sync for W.X and the winners' scores, the chunked cp.async
// double buffer, per-chunk mma sums added into float32 registers, the
// winners' fixed-order merge and u64 fold), with W built from the tables
// (separable_w.cuh:SeparableW): each CTA reads its rows' x-pattern and y-factor
// entries for a 32-sample chunk into shared memory beside the batch (each
// row's x-pattern row found once per CTA, not once per chunk), and
// each thread builds its A fragments' W with the separable form's float
// operations above.  The winners come in distance form, ||m||^2 - 2 x'.m, which
// is -2 fl(x'.m - ||m||^2 / 2) exactly: the max-score form's value bit for
// bit.  Rows per CTA follow the map (the wrapper's choice, ops.som_step.
// k13_rows): 128 where every SM still gets two CTAs, else 64 (128x128 is
// 256 CTAs of 64 rows); the batch is never split across CTAs, so each row's
// sums keep one order and two runs are bit-equal.  Across CTAs each sample's
// (-2 * score, row) pair is folded with the packed-u64 atomicMin of
// argmin_keys.cuh, as K12 does: -2 * score is an exact, order-reversing
// scaling, so the smallest key is the largest score with the lowest row; -0
// is folded to +0.
//
// The codebook is float32 or bf16 (SOMTrainer(bf16=True)): rows are read and
// upcast, blended in float32 and written back rounded to nearest even; the
// winners are taken against the float32 blended rows (rounded to bf16 only
// under batch_bf16, quantized under int8_win), as in the TPU kernels.
//
// What bounds them on H100: the two contractions, 4 noc B D FLOPs per step,
// as split-TF32 products on the tensor cores (12 noc B D TF32 FLOPs; 4 noc B
// D, one product each, under batch_bf16; int8_win's winners as 2 noc B D
// int8 operations).  The exponentials drop from noc B (K3) to (pattern rows +
// grid rows) B, in the table launch.  Device memory traffic is one codebook
// read and write; the batches and the tables are re-read from L2 by every
// CTA.  Rows beyond noc are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include "argmin_keys.cuh"
#include "separable_w.cuh"
#include "som_grid.cuh"

namespace {

// K13: the separable step on the tensor cores (separable_w.cuh), 16 WARPS
// rows per CTA
template <int NT, int WARPS, typename CT, bool kPasses>
__global__ void __launch_bounds__(32 * WARPS, (NT <= 8 ? 2 : 1) * 8 / WARPS)
som_fused_factored_kernel(CT* __restrict__ codes, int noc, int D,
                          const float* __restrict__ xs,
                          const float* __restrict__ aw, int B, int Bn, int xdim,
                          int hexa, int gaussian, float radius, int ny,
                          const float* __restrict__ pat,
                          const float* __restrict__ ytab,
                          unsigned long long* __restrict__ keys, float* rows32) {
  separable_step_tc<NT, WARPS, false, kPasses>(codes, noc, D, xs, aw, B, Bn, xdim, hexa,
                                               gaussian, radius, ny, pat, ytab, keys,
                                               rows32);
}

// K13 for D's width and the wrapper's rows per CTA: 128 or 64 (64 past D 128,
// where 128 rows would not fit); past D 256 NT 32's feature passes (64 rows)
template <typename CT>
int run_k13(const StepArgs& a) {
  const int k8 = (a.D + 7) / 8;
  if (!(a.rows == 64 || (a.rows == 128 && k8 <= 16))) return (int)cudaErrorInvalidValue;
  if (a.D > kPassD)
    return launch_separable_tc<32, 4, false, CT, float>(
        som_fused_factored_kernel<32, 4, CT, true>, a);
#define K13_LAUNCH(NT)                                                         \
  if (k8 <= NT)                                                              \
    return a.rows == 64                                                      \
               ? launch_separable_tc<NT, 4, false, CT, float>(                 \
                     som_fused_factored_kernel<NT, 4, CT, false>, a)           \
               : launch_separable_tc<NT, (NT <= 16 ? 8 : 4), false, CT, float>( \
                     som_fused_factored_kernel<NT, (NT <= 16 ? 8 : 4), CT, false>, a);
  K13_LAUNCH(1)
  K13_LAUNCH(2)
  K13_LAUNCH(4)
  K13_LAUNCH(8)
  K13_LAUNCH(16)
  K13_LAUNCH(32)
#undef K13_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K13 (not chunked), or K14: its main form, or its walk under stagger or
// int8_win
template <typename CT>
int run_flags(const StepArgs& a, int chunked, int wxa_bf16, int batch_bf16,
              int int8_win) {
  if (!chunked) {
    const int rc = launch_tables<float>(a, a.B);
    return rc ? rc : run_k13<CT>(a);
  }
  const int rc = wxa_bf16 ? launch_tables<__nv_bfloat16>(a, a.B)
                          : launch_tables<float>(a, a.B);
  if (rc) return rc;
  constexpr bool f32 = std::is_same<CT, float>::value;
  if (int8_win)
    return f32 ? somvq::k14_walk_int8_f32codes(a, wxa_bf16, batch_bf16)
               : somvq::k14_walk_int8_bf16codes(a, wxa_bf16, batch_bf16);
  if (a.stagger)
    return f32 ? somvq::k14_walk_f32codes(a, wxa_bf16, batch_bf16)
               : somvq::k14_walk_bf16codes(a, wxa_bf16, batch_bf16);
  return f32 ? somvq::k14_tc_f32codes(a, wxa_bf16, batch_bf16)
             : somvq::k14_tc_bf16codes(a, wxa_bf16, batch_bf16);
}

}  // namespace

// K13 (chunked 0) or K14 (chunked 1, with 8c's options wxa_bf16, gaussian
// only, batch_bf16, stagger and int8_win).  K14 without stagger and int8_win
// is its main form; with either, its walk (som_fused_chunked_tc.cuh).
// codes (noc, D) float32, or bf16 with codes_bf16, updated in place; xb (B,
// D), bmu (B,), alpha (B,), xn (Bn, D) float32; stagger 0, or the most CTAs
// of the staggered schedule's persistent grid (at least 1); under int8_win xq
// (Bnp, D32) int8, x' quantized by the wrapper and padded with zeros to D32 =
// D rounded up to 32 features and Bnp = Bn rounded up to 64 samples, and q
// (2,) float32 = (127 / sm, sm sx / 127^2) on the device (xn is then not
// read).  Scratch from the wrapper: keys (Bn,) u64; aw (B,), ytab (ceil(noc /
// xdim), B) float32 and pat (n_pat, B), n_pat = 2 xdim (hexa) or xdim, bf16
// under wxa_bf16, else float32; xs, 2 (Bp + Bnp) DP float32, (Bp + Bnp) DP
// under batch_bf16, Bnp 0 under int8_win (B and Bn rounded up to a multiple
// of 64, DP = ops.som_step.split_width(D): 8 times the power of two of
// 8-feature steps that covers D, 256 n_passes(D) past 256); rows32: (noc, D)
// float32 scratch for a bf16 codebook past D 256, else unread;
// rows, the rows per CTA (ops.som_step.k13_rows: 128 or 64; K14's
// ops.som_step.k14_rows: 64, or 32 under stagger past D 128).  val gets -2 * the best score, idx its row.
extern "C" int somvq_som_fused_factored(
    void* codes, int codes_bf16, int noc, int D, const float* xb,
    const int* bmu, const float* alpha, int B, const float* xn, int Bn,
    int xdim, int hexa, int gaussian, float radius, int chunked, int wxa_bf16,
    int batch_bf16, int stagger, int int8_win, int rows, float* xs,
    const signed char* xq, const float* q, void* pat, float* ytab, float* aw,
    unsigned long long* keys, float* val, int* idx, float* rows32, cudaStream_t stream) {
  if (noc <= 0 || D <= 0 || B <= 0 || Bn <= 0 || xdim <= 0 || stagger < 0 ||
      (codes_bf16 && D > kPassD && !rows32) ||
      (!chunked && (wxa_bf16 || batch_bf16 || stagger || int8_win)) || !xs ||
      (wxa_bf16 && !gaussian) || (int8_win && (xq == nullptr || q == nullptr)))
    return (int)cudaErrorInvalidValue;
  const StepArgs a{codes,  noc,     D,    xb, bmu,  alpha, B,
                   xn,     xq,      q,    Bn, xdim, hexa,  gaussian,
                   radius, stagger, rows, xs, pat,  ytab,  aw,
                   keys,   rows32, stream};
  const int rc = codes_bf16
                     ? run_flags<__nv_bfloat16>(a, chunked, wxa_bf16, batch_bf16, int8_win)
                     : run_flags<float>(a, chunked, wxa_bf16, batch_bf16, int8_win);
  if (rc) return rc;
  unpack_keys<<<(Bn + 255) / 256, 256, 0, stream>>>(keys, Bn, val, idx);
  return (int)cudaGetLastError();
}

