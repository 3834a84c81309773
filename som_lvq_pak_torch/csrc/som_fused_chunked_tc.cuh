// K14, the batch-chunked separable step (replaces
// som_lvq_pak_tpu/ops/pallas_som.py:_som_fused_factored_chunked_kernel), on
// K13's tensor-core body (fused_step_tc.cuh with separable_w.cuh's W from the
// tables).  The TPU kernel's batch chunk is a VMEM device; what is left of
// K14 beside K13 are its roundings and its two options:
//
//   wxa_bf16    the x-pattern table is bf16 (PT), staged by cp.async in
//               16-byte pieces of 8 values and widened where W is built;
//   batch_bf16  kBf16: x and x' rounded to bf16 by the split launch, W rounded
//               to bf16 for its product with x (wsum from the unrounded W),
//               the blended float32 rows rounded to bf16 for the winners'
//               scores (||m||^2 from the float32 rows); every operand is then
//               exact in TF32 and every product exact in float32, so W.X and
//               the scores are ONE TF32 mma.sync product each, with no lo half
//               split or staged (without batch_bf16, K13's three products);
//   int8_win    (pallas_som.py:1056-1061, 1087-1094) the winners' contraction
//               in int8: the wrapper quantizes x' against its global scale
//               (xq, padded with zeros to D32 = D rounded up to 32 features
//               and to a multiple of the 64-sample winner chunk) and passes q
//               = (127 / sm, sm sx / 127^2) on the device; each blended
//               float32 value is quantized in registers, clamp(rintf(
//               __fmul_rn(nc, q0)), +-127) (round half to even, as
//               jnp.round; the float32 blend under a bf16 codebook and under
//               batch_bf16 too), and kept as int8 in shared memory; the dot
//               is mma.sync.m16n8k32 on int8 into exact int32 (tf32x3.cuh:
//               mma_s8), S = __fmul_rn((float)dot, q1) and d = ||m||^2 - 2 S
//               with the float32 rows' ||m||^2.  Scaling by a power of two
//               commutes with rounding, so d is -2 fl(fl(dot q1) - ||m||^2 /
//               2), the JAX form's value, bit for bit.  The update half is the
//               main form's, so the codebook is bit-equal to the step without
//               int8_win;
//   stagger     (pallas_som.py:950-958, 1117-1147) the TPU grid runs in order
//               and its cell i interleaves tile i's update chunks with tile
//               i-1's winner chunks against the previous updated tile, kept in
//               scratch, then drains the last tile.  Here a persistent grid of
//               min(tiles, resident CTAs) CTAs (capped by the wrapper), each
//               walking its tiles blockIdx.x, blockIdx.x + gridDim.x, ... in
//               order: one update chunk of its tile, then one winner chunk of
//               its previous tile, kept blended in shared memory with its
//               ||m||^2, and so on; then the blend; then it drains its last
//               tile.  No CTA waits on another.
//
// The main form (neither option) is fused_step_tc's schedule: the update,
// the blend, the winners.  The two options run the walk below: the same
// chunk functions (fused_step_tc.cuh: update_chunk_tc, blend_rows_tc,
// winner_scores_tc, winner_fold_tc, winner_merge_tc), called in the walk's
// order, through a two-slot ring of shared memory that holds an update chunk
// or a winner chunk, beside the previous tile.  A row's floats are the main
// form's and the winners' (value, row) fold is order-free, so stagger is
// bit-equal to the main form at the same CTA height, and int8_win's codebook
// is the main form's.  A CTA's first tile runs fused_update_tc itself, so
// int8_win alone, the walk on a grid of one CTA per tile, is the main form's
// update, the blend, then its tile's int8 winners.
//
// Rows per CTA (ops.som_step.k14_rows): 64, but 32 under stagger past D 128,
// where the walk's ring and previous float tile do not fit beside 64 rows.
// Each row's batch stays in one CTA, so reruns are bit-equal.
//
// What bounds it on H100: the two contractions, 4 noc B D FLOPs per step,
// issued as 4 noc B D TF32 FLOPs under batch_bf16 (12 noc B D otherwise) at
// 495 TFLOP/s; under int8_win the update's third (2 or 6 noc B D TF32) and 2
// noc B D int8 operations at 1979 TOP/s.  That is far less than the time each
// CTA takes to walk the batch, one barrier-separated 32-sample chunk after
// another (staging, W build, mma), then the winner chunks.  That walk sets the
// time; K14's main form for D <= 128 splits it across the CTAs of a cluster
// (separable_sm90.cuh).  The main form is
// instantiated per codebook type in som_fused_chunked_tc_f32.cu and _bf16.cu,
// the walk in som_fused_chunked_walk_f32.cu, _bf16.cu, _int8_f32.cu and
// _int8_bf16.cu.

#pragma once

#include "separable_w.cuh"

namespace {

template <int NT, int WARPS, typename CT, typename PT, bool kBf16, bool kPasses>
__global__ void __launch_bounds__(32 * WARPS, (NT <= 8 ? 2 : 1) * 8 / WARPS)
som_fused_factored_chunked_tc_kernel(CT* __restrict__ codes, int noc, int D,
                                     const float* __restrict__ xs,
                                     const float* __restrict__ aw, int B, int Bn,
                                     int xdim, int hexa, int gaussian, float radius,
                                     int ny, const PT* __restrict__ pat,
                                     const float* __restrict__ ytab,
                                     unsigned long long* __restrict__ keys, float* rows32) {
  separable_step_tc<NT, WARPS, kBf16, kPasses>(codes, noc, D, xs, aw, B, Bn, xdim, hexa,
                                               gaussian, radius, ny, pat, ytab, keys,
                                               rows32);
}

// for D's width, 64 rows a CTA: NT 32 from D 129 to 256, past D 256 its
// feature passes, an instantiation of their own; D <= 128 runs on K13's
// Hopper walk (separable_sm90.cuh), not here
template <typename CT, typename PT, bool kBf16>
int launch_k14_tc(const StepArgs& a) {
  if (a.rows != 64 || a.D <= 128) return (int)cudaErrorInvalidValue;
  if (a.D > kPassD)
    return launch_separable_tc<32, 4, kBf16, CT, PT>(
        som_fused_factored_chunked_tc_kernel<32, 4, CT, PT, kBf16, true>, a);
  return launch_separable_tc<32, 4, kBf16, CT, PT>(
      som_fused_factored_chunked_tc_kernel<32, 4, CT, PT, kBf16, false>, a);
}

// K14's main launch for its bf16 options (wxa_bf16 only on a gaussian map)
template <typename CT>
int run_k14_tc(const StepArgs& a, int wxa_bf16, int batch_bf16) {
  if (wxa_bf16 && batch_bf16) return launch_k14_tc<CT, __nv_bfloat16, true>(a);
  if (wxa_bf16) return launch_k14_tc<CT, __nv_bfloat16, false>(a);
  if (batch_bf16) return launch_k14_tc<CT, float, true>(a);
  return launch_k14_tc<CT, float, false>(a);
}

// Shared memory of the walk (floats): the ring's two slots, each an update
// chunk (P planes of kBC samples, row stride DSU) or a winner chunk (P planes
// of BW samples, stride DT; int8: BW rows of K8 int8 values, stride XW
// words) | the previous tile (P planes of TN rows, stride DT; int8: TN rows,
// stride XW) | m2s[TN] | redv, redi [WARPS][BW] | the policy's staging.
// K8: DP rounded up to 32, the depth of one int8 product.
// A CTA's first tile runs fused_update_tc, whose double buffer is the ring
// (an update chunk is the larger slot) and whose staging lies past it, over
// the previous tile, not yet live then.
template <int NT, int WARPS, bool kBf16, bool kInt8>
struct WalkSmem {
  static constexpr int P = kBf16 ? 1 : 2;
  static constexpr int DP = 8 * NT, TN = 16 * WARPS, BW = kInt8 ? 64 : 32;
  static constexpr int DSU = stride_kn(DP), DT = stride_nk(DP);
  static constexpr int K8 = DP < 32 ? 32 : DP, XW = stride_s8(K8);
  static constexpr int U = P * kBC * DSU, W = kInt8 ? BW * XW : P * BW * DT;
  static constexpr int SLOT = U > W ? U : W;
  static constexpr int PREV = kInt8 ? TN * XW : P * TN * DT;
  static constexpr int STAGING = 2 * SLOT + PREV + TN + 2 * WARPS * BW;
  static_assert(SLOT == U && U == FusedSmem<NT, WARPS, kBf16>::P * kBC * FusedSmem<NT, WARPS, kBf16>::DSU,
                "the ring is fused_update_tc's double buffer");
  static size_t bytes(size_t staged) { return sizeof(float) * (STAGING + staged); }
};

// cp.async of the walk's winner chunk c (samples c BW..) into `dst`, then a
// commit: the split rows of x' (xn_hi, xn_lo), or under kInt8 the padded xq
// rows of D32 bytes
template <int NT, int WARPS, bool kBf16, bool kInt8>
__device__ __forceinline__ void fetch_winner_chunk(float* dst, const float* __restrict__ xn_hi,
                                                   const float* __restrict__ xn_lo,
                                                   const signed char* __restrict__ xq,
                                                   int D32, int c, int tid) {
  using L = WalkSmem<NT, WARPS, kBf16, kInt8>;
  constexpr int THREADS = 32 * WARPS;
  if constexpr (kInt8) {
    const int q = D32 / 16;  // 16-byte pieces per row
    const signed char* src = xq + (size_t)c * L::BW * D32;
    char* d = reinterpret_cast<char*>(dst);
    for (int e = tid; e < L::BW * q; e += THREADS) {
      const int r = e / q, f = 16 * (e - r * q);
      cp_async16(d + 4 * r * L::XW + f, src + (size_t)r * D32 + f);
    }
  } else {
    const size_t o = (size_t)c * L::BW * L::DP;
    copy_rows<L::DP>(dst, L::DT, xn_hi + o, L::BW, tid, THREADS);
    if constexpr (!kBf16) copy_rows<L::DP>(dst + L::BW * L::DT, L::DT, xn_lo + o, L::BW, tid,
                                           THREADS);
  }
  cp_async_commit();
}

// One winner chunk c of the walk: the chunk staged in `slot` against the
// previous tile (rows r0..), as the main form takes its winners: the scores
// S (winner_scores_tc, or under kInt8 the int8 product of the tile's rows, A,
// and the chunk's samples, B, on mma_s8 into exact int32, scaled by q1), then
// winner_fold_tc, a barrier, winner_merge_tc
template <int NT, int WARPS, bool kBf16, bool kInt8>
__device__ __forceinline__ void walk_winner_chunk(const float* slot, const float* prv,
                                                  const float* m2s, float* redv, int* redi,
                                                  int r0, int c, int noc, int D, int Bn,
                                                  float q1,
                                                  unsigned long long* __restrict__ keys) {
  using L = WalkSmem<NT, WARPS, kBf16, kInt8>;
  constexpr int BW = L::BW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float S[BW / 8][4];
  if constexpr (kInt8) {
    int I[BW / 8][4];
#pragma unroll
    for (int n = 0; n < BW / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) I[n][q] = 0;
    const int* t8 = reinterpret_cast<const int*>(prv);
    const int* x8 = reinterpret_cast<const int*>(slot);
    for (int ks = 0; ks < (D + 31) / 32; ++ks) {
      int a[4];
      load_a_s8(a, t8, L::XW, 16 * warp, 8 * ks, lane);
#pragma unroll
      for (int n = 0; n < BW / 8; ++n) {
        int b[2];
        load_b_s8(b, x8, L::XW, 8 * n, 8 * ks, lane);
        mma_s8(I[n], a, b);
      }
    }
#pragma unroll
    for (int n = 0; n < BW / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) S[n][q] = __fmul_rn((float)I[n][q], q1);  // exact int
  } else {
    winner_scores_tc<NT, BW, kBf16>(S, prv, prv + L::TN * L::DT, L::DT, slot,
                                    slot + BW * L::DT, L::DT, warp, lane);
  }
  winner_fold_tc<BW>(S, m2s, r0, noc, redv, redi, warp, lane);
  __syncthreads();  // every warp's fold written
  winner_merge_tc<BW, WARPS>(redv, redi, c * BW, Bn, keys, tid);
}

// The int8 winners of rows r0..r0 + TN - 1 past 8 NT features (NT 32, D >
// 256): for each BW-sample chunk the exact int32 dot summed over the feature
// slabs in order, each slab of the rows read back from `rows` (the blended
// float32 rows, row stride D, through L2) and quantized as the walk quantizes
// them into the previous-tile region, the chunk's slab of xq ((Bnp, D32)
// int8, zeros past D32) in ring slot 0; then S = dot q1, the fold against
// m2s and the merge, as walk_winner_chunk takes them.  An integer sum has no
// order, so the values are the one-pass form's.
template <int NT, int WARPS, bool kBf16>
__device__ __forceinline__ void int8_winners_passes(const float* rows, int noc, int D,
                                                    const signed char* __restrict__ xq,
                                                    float q0, float q1, int Bn,
                                                    unsigned long long* __restrict__ keys,
                                                    int r0) {
  using L = WalkSmem<NT, WARPS, kBf16, true>;
  constexpr int DP = L::DP, TN = L::TN, BW = L::BW, THREADS = 32 * WARPS;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* prv = smem + 2 * L::SLOT;
  float* m2s = prv + L::PREV;
  float* redv = m2s + TN;
  int* redi = reinterpret_cast<int*>(redv + WARPS * BW);
  signed char* t8 = reinterpret_cast<signed char*>(prv);
  char* x8 = reinterpret_cast<char*>(smem);
  const int NP = n_passes(D), D32 = (D + 31) / 32 * 32;
  for (int n0 = 0; n0 < Bn; n0 += BW) {
    int I[BW / 8][4];
#pragma unroll
    for (int n = 0; n < BW / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) I[n][q] = 0;
    for (int s = 0; s < NP; ++s) {
      const int f0 = s * DP;
      for (int e = tid; e < BW * (DP / 16); e += THREADS) {  // x' slab, 16 bytes a piece
        const int r = e / (DP / 16), f = 16 * (e - r * (DP / 16));
        char* d = x8 + 4 * r * L::XW + f;
        if (f0 + f < D32)
          cp_async16(d, xq + (size_t)(n0 + r) * D32 + f0 + f);
        else
          *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
      }
      cp_async_commit();
      for (int e = tid; e < TN * DP; e += THREADS) {
        const int r = e / DP, k = e - r * DP, u = r0 + r;
        const float nc = (u < noc && f0 + k < D) ? __ldcg(rows + (size_t)u * D + f0 + k) : 0.f;
        const float v = fminf(fmaxf(rintf(__fmul_rn(nc, q0)), -127.f), 127.f);
        t8[4 * L::XW * r + k] = (signed char)(int)v;
      }
      cp_async_wait_all();
      __syncthreads();  // the slab's rows and samples staged (and m2s written)
      const int* ti = reinterpret_cast<const int*>(prv);
      const int* xi = reinterpret_cast<const int*>(smem);
#pragma unroll 2
      for (int ks = 0; ks < DP / 32; ++ks) {
        int a[4];
        load_a_s8(a, ti, L::XW, 16 * warp, 8 * ks, lane);
#pragma unroll
        for (int n = 0; n < BW / 8; ++n) {
          int b[2];
          load_b_s8(b, xi, L::XW, 8 * n, 8 * ks, lane);
          mma_s8(I[n], a, b);
        }
      }
      __syncthreads();  // every fragment of the slab read
    }
    float S[BW / 8][4];
#pragma unroll
    for (int n = 0; n < BW / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) S[n][q] = __fmul_rn((float)I[n][q], q1);  // exact int
    winner_fold_tc<BW>(S, m2s, r0, noc, redv, redi, warp, lane);
    __syncthreads();  // every warp's fold written
    winner_merge_tc<BW, WARPS>(redv, redi, n0, Bn, keys, tid);
  }
}

// The walk of K14's options past 8 NT features (NT 32, D > 256) on this
// CTA's tiles blockIdx.x, blockIdx.x + gridDim.x, ...: each tile's feature
// passes as the main form takes them (fused_step_tc.cuh:
// fused_step_passes_tc, the same floats), its winners in float32 or, under
// kInt8, int8_winners_passes.  The interleave of a tile's update with the
// previous tile's winners is the one-slab schedule's; here the tiles run one
// after another, which changes no float.  Not inlined: the walk kernel calls
// it past D 256 only, and inlined its registers made the one-slab walk
// spill twice as much
template <int NT, int WARPS, bool kBf16, bool kInt8, typename CT, typename PT>
__device__ __noinline__ void chunked_walk_passes(
    CT* __restrict__ codes, int noc, int D, const float* __restrict__ xs,
    const signed char* __restrict__ xq, const float* __restrict__ q,
    const float* __restrict__ aw, int B, int Bn, int xdim, int hexa, int gaussian,
    float radius, int ny, const PT* __restrict__ pat, const float* __restrict__ ytab,
    unsigned long long* __restrict__ keys, float* rows32) {
  using L = WalkSmem<NT, WARPS, kBf16, kInt8>;
  using F = FusedSmem<NT, WARPS, kBf16>;
  constexpr int DP = L::DP, TN = L::TN;
  constexpr bool kF32 = sizeof(CT) == sizeof(float);
  extern __shared__ __align__(16) float smem[];
  const int n_tiles = (noc + TN - 1) / TN, NP = n_passes(D);
  const size_t Bp = (B + 63) / 64 * 64;
  auto wp = separable_policy<TN>(aw, B, noc, xdim, hexa, gaussian, radius, ny, pat, ytab);
  const float* rows;
  if constexpr (kF32)
    rows = reinterpret_cast<const float*>(codes);
  else
    rows = rows32;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * TN;
    if constexpr (kInt8) {
      float sq[2] = {0.f, 0.f};
      for (int s = 0; s < NP; ++s) {
        const float* xb_hi = xs + (size_t)s * F::P * Bp * DP;
        float acc[NT][4];
        float wsum[2];
        fused_update_tc<NT, WARPS, kBf16>(acc, wsum, xb_hi, xb_hi + Bp * DP, B, r0, wp);
        __syncthreads();  // every fragment read: the ring is free
        const int k0 = s * DP;
        blend_pass_tc<NT, WARPS>(acc, wsum, codes, noc, D, k0, r0, sq,
                                 [&](int r, int k, float nc) {
                                   if constexpr (!kF32) {
                                     if (k0 + k < D && r0 + r < noc)
                                       rows32[(size_t)(r0 + r) * D + k0 + k] = nc;
                                   }
                                 });
      }
      m2_lanes(sq, smem + 2 * L::SLOT + L::PREV);
      int8_winners_passes<NT, WARPS, kBf16>(rows, noc, D, xq, q[0], q[1], Bn, keys, r0);
    } else {
      fused_step_passes_tc<NT, WARPS, kBf16>(codes, noc, D, xs, B, Bn, keys, wp, rows32, r0);
    }
    __syncthreads();  // the tile's last merge read before the next tile's staging
  }
}

// The walk of K14's options on this CTA's tiles blockIdx.x, blockIdx.x +
// gridDim.x, ...: the first tile's update is fused_update_tc's (the main
// form's); each later tile's update chunks are interleaved with the previous
// tile's winner chunks (U0 W0 U1 W1 ..., the longer stream's rest after), op
// k in ring slot k & 1 while op k + 1 lands in the other; after each update
// the blend into the previous-tile region; then the last tile's winners.
// xs: the split batches (x' not split under kInt8); xq (Bnp, D32) int8 and
// q (2,) under kInt8
template <int NT, int WARPS, bool kBf16, bool kInt8, typename CT, typename PT>
__device__ __forceinline__ void chunked_walk(
    CT* __restrict__ codes, int noc, int D, const float* __restrict__ xs,
    const signed char* __restrict__ xq, const float* __restrict__ q,
    const float* __restrict__ aw, int B, int Bn, int xdim, int hexa, int gaussian,
    float radius, int ny, const PT* __restrict__ pat, const float* __restrict__ ytab,
    unsigned long long* __restrict__ keys, float* rows32) {
  using L = WalkSmem<NT, WARPS, kBf16, kInt8>;
  constexpr int DP = L::DP, TN = L::TN, BW = L::BW, THREADS = 32 * WARPS;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2;
  if constexpr (NT == 32) {
    if (D > DP) {
      chunked_walk_passes<NT, WARPS, kBf16, kInt8>(codes, noc, D, xs, xq, q, aw, B, Bn, xdim,
                                                   hexa, gaussian, radius, ny, pat, ytab, keys,
                                                   rows32);
      return;
    }
  }
  float* prv = smem + 2 * L::SLOT;
  float* m2s = prv + L::PREV;
  float* redv = m2s + TN;
  int* redi = reinterpret_cast<int*>(redv + WARPS * BW);
  auto wp = separable_policy<TN>(aw, B, noc, xdim, hexa, gaussian, radius, ny, pat, ytab);
  const size_t Bp = (B + 63) / 64 * 64, Bnp = (Bn + 63) / 64 * 64;
  const float* xb_hi = xs;
  const float* xb_lo = xs + Bp * DP;
  const float* xn_hi = xs + L::P * Bp * DP;
  const float* xn_lo = xn_hi + Bnp * DP;
  const int D32 = (D + 31) / 32 * 32;
  const float q0 = kInt8 ? q[0] : 0.f, q1 = kInt8 ? q[1] : 0.f;
  const int n_tiles = (noc + TN - 1) / TN;
  const int nU = (B + kBC - 1) / kBC, nW = (Bn + BW - 1) / BW;
  int prev = -1;  // row 0 of the previous (blended) tile, -1 none
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * TN;
    float acc[NT][4];
    float wsum[2];
    if (prev < 0) {  // the CTA's first tile: the main form's update
      fused_update_tc<NT, WARPS, kBf16>(acc, wsum, xb_hi, xb_lo, B, r0, wp);
    } else {
      wp.init(L::STAGING, r0, warp, g);
      wsum[0] = 0.f;
      wsum[1] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) acc[j][qq] = 0.f;
      // op k: update chunk k / 2 (k even) or winner chunk k / 2 (k odd) of
      // the previous tile while both streams last, then chunk k - m of the
      // longer one
      const int m = min(nU, nW), n = nU + nW;
      fetch_update_chunk<DP, kBf16>(smem, smem + kBC * L::DSU, L::DSU, xb_hi, xb_lo, 0, B,
                                    wp, tid, THREADS);
      for (int k = 0; k < n; ++k) {
        const bool upd = k < 2 * m ? !(k & 1) : nU > nW;
        const int c = k < 2 * m ? k >> 1 : k - m;
        cp_async_wait_all();
        __syncthreads();  // op k landed; op k - 1 done with the other slot
        if (k + 1 < n) {
          const int k1 = k + 1, c1 = k1 < 2 * m ? k1 >> 1 : k1 - m;
          float* dst = smem + (k1 & 1) * L::SLOT;
          if (k1 < 2 * m ? !(k1 & 1) : nU > nW)
            fetch_update_chunk<DP, kBf16>(dst, dst + kBC * L::DSU, L::DSU, xb_hi, xb_lo, c1,
                                          B, wp, tid, THREADS);
          else
            fetch_winner_chunk<NT, WARPS, kBf16, kInt8>(dst, xn_hi, xn_lo, xq, D32, c1, tid);
        }
        const float* s = smem + (k & 1) * L::SLOT;
        if (upd)
          update_chunk_tc<NT, kBf16>(acc, wsum, s, s + kBC * L::DSU, L::DSU, c,
                                     min(kBC, B - c * kBC), wp, lane);
        else
          walk_winner_chunk<NT, WARPS, kBf16, kInt8>(s, prv, m2s, redv, redi, prev, c, noc,
                                                     D, Bn, q1, keys);
      }
      wsum_lanes(wsum);
    }
    __syncthreads();  // the previous tile, m2s and the ring read for good
    if constexpr (kInt8) {
      signed char* t8 = reinterpret_cast<signed char*>(prv);
      blend_rows_tc<NT, WARPS>(acc, wsum, codes, noc, D, r0, m2s, [&](int r, int k, float nc) {
        const float v = fminf(fmaxf(rintf(__fmul_rn(nc, q0)), -127.f), 127.f);
        t8[4 * L::XW * r + k] = (signed char)(int)v;
      });
      if constexpr (DP < 32) {  // the int8 rows' columns DP..31: zeros
        for (int e = tid; e < TN * (32 - DP); e += THREADS)
          t8[4 * L::XW * (e / (32 - DP)) + DP + e % (32 - DP)] = 0;
      }
    } else {
      float* thi = prv;
      float* tlo = prv + TN * L::DT;
      blend_rows_tc<NT, WARPS>(acc, wsum, codes, noc, D, r0, m2s, [&](int r, int k, float nc) {
        if constexpr (kBf16) {
          thi[r * L::DT + k] = bf16_round(nc);
        } else {
          float hi, lo;
          split_tf32(nc, hi, lo);
          thi[r * L::DT + k] = hi;
          tlo[r * L::DT + k] = lo;
        }
      });
    }
    prev = r0;
  }
  if (prev < 0) return;
  // drain: the last tile's winner chunks, double-buffered on the ring
  fetch_winner_chunk<NT, WARPS, kBf16, kInt8>(smem, xn_hi, xn_lo, xq, D32, 0, tid);
  for (int c = 0; c < nW; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c landed (and the tile blended); chunk c - 1 read
    if (c + 1 < nW)
      fetch_winner_chunk<NT, WARPS, kBf16, kInt8>(smem + ((c + 1) & 1) * L::SLOT, xn_hi,
                                                  xn_lo, xq, D32, c + 1, tid);
    walk_winner_chunk<NT, WARPS, kBf16, kInt8>(smem + (c & 1) * L::SLOT, prv, m2s, redv,
                                               redi, prev, c, noc, D, Bn, q1, keys);
  }
}

// K14's stagger with float32 winners (the wrapper launches it only with
// stagger) and its int8_win (either schedule): one walk, two names, so that
// chip_smoke.py finds IMMA in every instantiation of the second
template <int NT, int WARPS, typename CT, typename PT, bool kBf16>
__global__ void __launch_bounds__(32 * WARPS, (NT <= 8 ? 2 : 1) * 8 / WARPS)
som_fused_chunked_stagger_kernel(CT* __restrict__ codes, int noc, int D,
                                 const float* __restrict__ xs,
                                 const signed char* __restrict__ xq,
                                 const float* __restrict__ q, const float* __restrict__ aw,
                                 int B, int Bn, int xdim, int hexa, int gaussian,
                                 float radius, int ny, const PT* __restrict__ pat,
                                 const float* __restrict__ ytab,
                                 unsigned long long* __restrict__ keys, float* rows32) {
  chunked_walk<NT, WARPS, kBf16, false>(codes, noc, D, xs, xq, q, aw, B, Bn, xdim, hexa,
                                        gaussian, radius, ny, pat, ytab, keys, rows32);
}

template <int NT, int WARPS, typename CT, typename PT, bool kBf16>
__global__ void __launch_bounds__(32 * WARPS, (NT <= 8 ? 2 : 1) * 8 / WARPS)
som_fused_chunked_int8_kernel(CT* __restrict__ codes, int noc, int D,
                              const float* __restrict__ xs,
                              const signed char* __restrict__ xq,
                              const float* __restrict__ q, const float* __restrict__ aw,
                              int B, int Bn, int xdim, int hexa, int gaussian,
                              float radius, int ny, const PT* __restrict__ pat,
                              const float* __restrict__ ytab,
                              unsigned long long* __restrict__ keys, float* rows32) {
  chunked_walk<NT, WARPS, kBf16, true>(codes, noc, D, xs, xq, q, aw, B, Bn, xdim, hexa,
                                       gaussian, radius, ny, pat, ytab, keys, rows32);
}

template <int NT, int WARPS, typename CT, typename PT, bool kBf16, bool kInt8>
auto walk_kernel() {
  if constexpr (kInt8)
    return som_fused_chunked_int8_kernel<NT, WARPS, CT, PT, kBf16>;
  else
    return som_fused_chunked_stagger_kernel<NT, WARPS, CT, PT, kBf16>;
}

// The persistent grid of the staggered schedule: min(tiles, resident CTAs),
// the resident count from the occupancy API for the kernel's own block and
// shared memory
template <typename K>
int stagger_grid(K kernel, int threads, size_t smem, int n_tiles, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms <= 0) return (int)cudaErrorInvalidConfiguration;
  *grid = (unsigned)(n_tiles < per_sm * sms ? n_tiles : per_sm * sms);
  return 0;
}

// The walk's launch: NT 8-feature steps, WARPS warps of 16 rows; the batch
// split first into a.xs (x' too unless kInt8); a grid of one CTA per tile,
// or under stagger the persistent grid, at most a.stagger CTAs.  A height
// whose ring does not fit in shared memory is refused (cudaErrorInvalidValue),
// never shrunk.
template <int NT, int WARPS, bool kBf16, bool kInt8, typename CT, typename PT>
int launch_walk(const StepArgs& a) {
  constexpr int TNR = 16 * WARPS;
  const auto kernel = walk_kernel<NT, WARPS, CT, PT, kBf16, kInt8>();
  const int ydim = (a.noc + a.xdim - 1) / a.xdim;
  const int ny = min((TNR - 1) / a.xdim + 2, ydim);
  const size_t smem = WalkSmem<NT, WARPS, kBf16, kInt8>::bytes(SeparableW<TNR, PT>::floats(ny));
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int rc = split_batches<kBf16>(a.xb, a.B, a.xn, kInt8 ? 0 : a.Bn, a.D, 8 * NT, a.xs,
                                a.stream);
  if (rc) return rc;
  const int n_tiles = (a.noc + TNR - 1) / TNR;
  unsigned grid = (unsigned)n_tiles;
  if (a.stagger) {
    rc = stagger_grid(kernel, 32 * WARPS, smem, n_tiles, &grid);
    if (rc) return rc;
    if (grid > (unsigned)a.stagger) grid = (unsigned)a.stagger;
  }
  kernel<<<grid, 32 * WARPS, smem, a.stream>>>(
      static_cast<CT*>(a.codes), a.noc, a.D, a.xs, a.xq, a.q, a.aw, a.B, a.Bn, a.xdim,
      a.hexa, a.gaussian, a.radius, ny, static_cast<const PT*>(a.pat), a.ytab, a.keys,
      a.rows32);
  return (int)cudaGetLastError();
}

// for D's width and the rows per CTA (a.rows: 64 or 32)
template <typename CT, typename PT, bool kBf16, bool kInt8>
int launch_k14_walk(const StepArgs& a) {
  const int k8 = (a.D + 7) / 8;
  if (a.rows != 32 && a.rows != 64) return (int)cudaErrorInvalidValue;
#define K14_WALK(NT)                                                     \
  if (k8 <= NT || NT == 32)                                            \
    return a.rows == 32 ? launch_walk<NT, 2, kBf16, kInt8, CT, PT>(a)  \
                        : launch_walk<NT, 4, kBf16, kInt8, CT, PT>(a);
  K14_WALK(1)
  K14_WALK(2)
  K14_WALK(4)
  K14_WALK(8)
  K14_WALK(16)
  K14_WALK(32)
#undef K14_WALK
  return (int)cudaErrorInvalidValue;
}

// K14's walk for its bf16 options (wxa_bf16 only on a gaussian map)
template <typename CT, bool kInt8>
int run_k14_walk(const StepArgs& a, int wxa_bf16, int batch_bf16) {
  if (wxa_bf16 && batch_bf16) return launch_k14_walk<CT, __nv_bfloat16, true, kInt8>(a);
  if (wxa_bf16) return launch_k14_walk<CT, __nv_bfloat16, false, kInt8>(a);
  if (batch_bf16) return launch_k14_walk<CT, float, true, kInt8>(a);
  return launch_k14_walk<CT, float, false, kInt8>(a);
}

}  // namespace
