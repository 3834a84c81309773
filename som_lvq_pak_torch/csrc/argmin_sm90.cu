// K1, K2 and K8 on Hopper: the 1-NN and 2-NN winner searches.  For each
// sample x_b, the codebook row m_n that minimises ||x_b - m_n||^2 (the
// lowest n on exact ties), or the two smallest (value, index) pairs,
// reported as the partial distance ||m_n||^2 - 2 x_b.m_n.
//
// Replaces four TPU kernels of som_lvq_pak_tpu/ops/pallas_distance.py:
//   * _dist_argmin_kernel (:60, wrapper dist_argmin, the distance form
//     ||m||^2 - 2 x.m with a strict-< running min)     -> dist_argmin_kernel (K1)
//   * _dist_argmin_t_kernel (:426, wrapper dist_argmin_t, the max-score form
//     x.m - ||m||^2 / 2, reported as -2 * the best)   -> dist_argmin_t_kernel (K2)
//   * _dist_top2_kernel (:295, wrapper dist_top2, the running (best, second)
//     pair, strict <, earlier tile kept)              -> top2_sm90_kernel (K8)
//   * _dist_topk_kernel (:583, wrapper dist_topk, k <= 16, the running top
//     k merged tile by tile)                          -> dist_topk_sm90_kernel (K10)
// and the ||m||^2 row the JAX wrapper of K1 computes in XLA (its m2_ref),
// here split_codes_kernel, the walk's prologue.  The two forms give the
// same floats: halving and doubling are exact, so -2 fl(x.m - ||m||^2 / 2)
// = fl(||m||^2 - 2 x.m) for the same x.m and ||m||^2, and a strict > on the
// score over ascending codes is a strict < on the distance.  So K1 and K2
// are one walk, instantiated under two names so that a profile tells the
// trainers' and LVQ steps' winners (K1) from the fast qerror's (K2).
//
// What bounds it on H100: the contraction x.m^T (B x N x D) as split TF32
// (tf32x3.cuh): three TF32 products per float32 product, 6 B N D TF32 FLOPs
// at 495 TFLOP/s (50.8 ms at 1M x 65536 x 64); then the L2 reads of the
// split codebook, which every CTA of 128 samples walks (hi and lo, 8 N D
// bytes a CTA: about 5 TB/s at the tensor-core rate).  Device memory moves
// x, the codebook, its split and the (B,) results once.  The products and
// their feed alone (the fold cut to one compare a tile) ran at 81-86% of
// that bound (58.9-62.8 ms; tools/argmin_fold_ab.py, one H100 80GB HBM3 at
// 700 W).
//
// The design.  The split of the codebook into TF32 hi and lo, and ||m||^2,
// are computed once per call by the prologue (split_codes_kernel: a warp a
// row, (N, Dp) hi and lo with zeros past D, m2 (N,)), not once per CTA;
// K1's and K2's entries launch it and the walk in one call, on one scratch
// buffer.  ||m||^2 is summed in the order the mma.sync walks of K8/K10 use
// (dist_topk.cu): lane f of a warp takes features f and f + 32 of a
// 64-feature slab, sq = fma(v1, v1, v0 * v0), then an xor tree over 16, 8,
// 4, 2, 1, then the slabs left to right; so K1's values are K10's bit for
// bit (ops.dist_argmin.split_codes_plain re-enacts it).  The walk: a CTA
// takes 128 samples, two consumer warpgroups of 64 and one producer warp.
// Each consumer keeps its samples' A fragments (split hi and lo) in
// registers for the whole walk (D <= 64; past it, 64-feature slabs reloaded
// per slab).  The producer streams (128 codes x slab) tiles of hi and lo,
// as 32-feature chunks of 128-byte rows swizzled by TMA (SWIZZLE_128B), and
// the tile's 128 m2 values, into a ring of `stages` slots behind full and
// empty mbarriers.  Per k step of 8 features a consumer issues the three
// products in mma_tf32x3's order (lo.hi, hi.lo, hi.hi) as warpgroup
// wgmma.m64n128k8.f32.tf32.tf32, A from registers and B straight from the
// swizzled slot, into 64 float32 accumulators a thread; no thread copies or
// splits a code.  The accumulators hold the m16n8k8 C fragment of each
// 8-code column block.  The fold keeps the mma.sync walk's result with
// fewer instructions: the scores S - 0.5 m2[c] in place, a max tree per
// sample, and only where the tile's max beats the running best the first
// code reaching it, so each thread keeps the (max, first index) a strict >
// over ascending codes would; the four lanes merge lexicographically, and
// the codebook splits (ops.dist_argmin.k1_sm90_splits: spans of at least
// four whole 128-code tiles in whole waves of one CTA an SM) fold by the
// packed-u64 atomicMin of argmin_keys.cuh on -2 * the score (-0 to +0, the
// lowest index on ties).  The fold, not the products, set the first
// version's pace (1M x 65536 x 64, the same A/B: 104-105 ms with a compare
// and select per score, 64-66 ms as written), so the two warpgroups also
// take turns to issue their products (named barriers, as K15's) and each
// folds under the other's (at B 4096: 0.29 ms, 0.33-0.34 without the
// turns).  Two accumulators in one warpgroup (a tile's fold under its
// successor's products) would not fit beside the A fragments in the 168
// registers ptxas gives a thread of a 288-thread CTA (it allots registers to
// whole warpgroups; K4's walk, argmin_masked_sm90.cu, moves them from a
// producer warpgroup to its consumers with setmaxnreg).  Every sum runs in a
// fixed order and a row's value depends only on its own data, not on the
// tile, split or shard that holds it: two runs are bit-equal, and the min
// over shards of a codebook is the whole run's.
//
// K8 is the same walk with a top-2 fold (topk_fold.cuh's ListFold at 2):
// per sample the lane keeps a sorted (best, second) of (score, code); only
// where the tile's max (the same max tree) beats the sample's bar, the
// highest second of its four lanes at the tile's start (two shuffles), does
// it visit its 32 scores of the tile in ascending code order, four at a
// time and only where their max beats the bar and its own second too, each
// entering on a strict >.  A code at or below the bar has two better codes
// of lower index in one lane, so it cannot be in the sample's pair, and a
// later code of an equal score never enters: the pairs are exact.  The four lanes
// merge their lists (merge_lists), each codebook split writes its pairs as
// partial distances (-2 * the score, -0 to +0) to a (splits, B, 2) scratch,
// and topk_merge_splits<2> folds the splits in split order.  Its scores are
// K1's floats, so its best pair is K1's (value, index) and its pairs are
// K10's at k 2 (dist_topk_sm90_kernel below) bit for bit.
//
// K10 is the same walk with the fold at a list of KM in {2, 4, 8, 16}
// pairs (k <= KM chosen at run time): the sample's bar is the highest KM-th
// entry of its four lanes' lists, and a lane visits a tile's codes four at a
// time where their max beats the bar and its own KM-th.  A code at or below
// the bar has KM >= k better codes of lower index in one lane, so it cannot
// be in the sample's top k; the lists, the lane merge and
// topk_merge_splits<KM> give the k smallest (value, index) pairs in
// lexicographic order, whatever the order of the visits, so the pruning
// changes no pair.  At KM 2 it is K8's instance under its own name.  The
// lists of KM 4 and up (16 KM registers) do not fit beside S and the A
// fragments in the 168 registers a thread of the 288-thread CTA gets, so
// those instances take K4's layout (argmin_masked_sm90.cu): a producer
// warpgroup that gives its registers to the consumers by setmaxnreg (232 a
// consumer thread, 40 a producer's), one of its threads issuing the loads.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "argmin_tc.cuh"
#include "sm90_pipe.cuh"
#include "topk_fold.cuh"

namespace {

constexpr int TN = 128;                        // codes per tile: the wgmma's N
constexpr int CONSUMERS = 2;                   // warpgroups of 64 samples
constexpr int BS = 64 * CONSUMERS;             // samples per CTA
constexpr int THREADS = 128 * CONSUMERS + 32;  // and the producer warp
// K10's lists of KM > 2: a producer warpgroup, whose registers go to the
// consumers (K4's split)
constexpr int WIDE_THREADS = 128 * (CONSUMERS + 1);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int CHUNK = 32;                      // features per 128-byte swizzled row
constexpr int CHUNK_BYTES = TN * CHUNK * 4;
constexpr int SMEM_MAX = 232448;               // a CTA's dynamic shared memory
constexpr int ALIGN = 1024;                    // the 128B swizzle's period
constexpr int MAX_STAGES = 8;
constexpr int BARRIER_BYTES = 2 * MAX_STAGES * 8;
constexpr int TURN = 256;                      // a turn's barrier: both warpgroups

// the split's row length (ops.dist_argmin.split_codes_dp): one chunk up to D
// 32, else whole 64-feature slabs
__host__ __device__ constexpr int padded_d(int D) { return D <= 32 ? 32 : (D + 63) / 64 * 64; }

// a slot: KC chunks of hi, KC of lo, then the tile's m2 (TN floats), padded
// to keep the next slot aligned
template <int KC>
__host__ __device__ constexpr int slot_bytes() {
  return 2 * KC * CHUNK_BYTES + ALIGN;
}

template <int KC>
__host__ __device__ constexpr int ring_stages() {
  return (SMEM_MAX - ALIGN - BARRIER_BYTES) / slot_bytes<KC>() < MAX_STAGES
             ? (SMEM_MAX - ALIGN - BARRIER_BYTES) / slot_bytes<KC>()
             : MAX_STAGES;
}

// The prologue: row n of codes (N, D) into hi[n], lo[n] (Dp floats, zeros
// past D) and m2[n] = ||m_n||^2 in the walks' order; a warp a row
__global__ void __launch_bounds__(256)
split_codes_kernel(const float* __restrict__ codes, int N, int D, int Dp,
                   float* __restrict__ hi, float* __restrict__ lo, float* __restrict__ m2) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (n >= N) return;
  const float* row = codes + (size_t)n * D;
  float* h = hi + (size_t)n * Dp;
  float* l = lo + (size_t)n * Dp;
  const int nslab = (D + 63) / 64;
  float m = 0.f;
  for (int sl = 0; sl < nslab; ++sl) {
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int f = 64 * sl + 32 * j + lane;
      const float v = f < D ? row[f] : 0.f;
      if (f < Dp) {
        float vh, vl;
        split_tf32(v, vh, vl);
        h[f] = vh;
        l[f] = vl;
      }
      sq = __fmaf_rn(v, v, sq);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    m = sl == 0 ? sq : m + sq;
  }
  if (lane == 0) m2[n] = m;
}

int split(const float* codes, int N, int D, int Dp, float* hi, float* lo, float* m2,
          cudaStream_t stream) {
  if (N <= 0 || D <= 0 || Dp != padded_d(D)) return (int)cudaErrorInvalidValue;
  split_codes_kernel<<<(N + 7) / 8, 256, 0, stream>>>(codes, N, D, Dp, hi, lo, m2);
  return (int)cudaGetLastError();
}

// a CTA's threads for a fold of KM pairs (0: the argmin)
template <int KM>
__host__ __device__ constexpr int threads_of() {
  return KM > 2 ? WIDE_THREADS : THREADS;
}

// The walk of CTA (blockIdx.x, blockIdx.y): samples blockIdx.x * BS.., the
// tiles [blockIdx.y * span, +span) of the codebook, in nslab slabs of
// 32 KC features each; the argmin fold into `keys` (K1, K2; KM 0), or the
// fold of KM pairs into split blockIdx.y's k best pairs of pv/pi (K8, K10)
template <int KC, int KM>
__device__ __forceinline__ void walk(const CUtensorMap* hi_map, const CUtensorMap* lo_map,
                                     const CUtensorMap* m2_map, const float* __restrict__ x,
                                     int B, int N, int D, int nslab, int span, int stages,
                                     int k, unsigned long long* __restrict__ keys,
                                     float* __restrict__ pv, int* __restrict__ pi) {
  constexpr bool kList = KM > 0;
  constexpr int KS = 4 * KC;  // k steps of 8 features a slab
  constexpr int SW = CHUNK * KC;
  constexpr int SLOT = slot_bytes<KC>();
  const int tiles = (N + TN - 1) / TN;
  const int t0 = blockIdx.y * span, t1 = min(tiles, t0 + span);
  const int nitems = (t1 - t0) * nslab;  // item = (tile, slab), slab fastest

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((ALIGN - (sm90::smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * SLOT);
  uint64_t* empty = full + MAX_STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * CONSUMERS);  // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * CONSUMERS) {  // the producer warp (warpgroup past KM 2)
    if constexpr (KM > 2) sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      int s = 0;
      uint32_t phase = 0;  // of slot s's current use
      for (int i = 0; i < nitems; ++i) {
        const int n0 = (t0 + i / nslab) * TN, f0 = (i % nslab) * SW;
        unsigned char* slot = ring + s * SLOT;
        sm90::mbar_wait(&empty[s], phase ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], 2 * KC * CHUNK_BYTES + TN * 4);
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          sm90::tma_load_2d(slot + c * CHUNK_BYTES, hi_map, &full[s], f0 + CHUNK * c, n0);
          sm90::tma_load_2d(slot + (KC + c) * CHUNK_BYTES, lo_map, &full[s], f0 + CHUNK * c,
                            n0);
        }
        sm90::tma_load_1d(slot + 2 * KC * CHUNK_BYTES, m2_map, &full[s], n0);
        if (++s == stages) s = 0, phase ^= 1;
      }
    }
    return;
  }

  if constexpr (KM > 2) sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int b0 = blockIdx.x * BS + 16 * (threadIdx.x >> 5);  // this warp's 16 samples
  float ahi[KS][4], alo[KS][4];
  if (nslab == 1) load_x<KS, false>(ahi, alo, x, B, D, b0, 0, lane);
  float best[2] = {-INFINITY, -INFINITY};
  int bidx[2] = {INT_MAX, INT_MAX};
  ListFold<kList ? KM : 2> list;  // K8, K10: each sample's KM best, sorted
  float S[64];
  int s = 0;
  uint32_t phase = 0;
  // the warpgroups take turns to issue a tile's products (named barrier 2 +
  // wg: wg's turn), so that each folds while the other's products run
  const int wg = threadIdx.x / 128;
  if (wg == 1) sm90::bar_arrive(2, TURN);
  for (int i = 0; i < nitems; ++i) {
    const int n0 = (t0 + i / nslab) * TN, sl = i % nslab;
    if (nslab > 1) load_x<KS, false>(ahi, alo, x, B, D, b0, sl, lane);
    if (sl == 0) {
#pragma unroll
      for (int j = 0; j < 64; ++j) S[j] = 0.f;
    }
    const uint32_t slot = sm90::smem_u32(ring + s * SLOT);
    sm90::mbar_wait(&full[s], phase);
    sm90::bar_sync(2 + wg, TURN);
    sm90::fence_operand(S);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t off = (ks / 4) * CHUNK_BYTES + 32 * (ks % 4);
      const uint64_t bh = sm90::kmajor_desc<128>(slot + off);
      const uint64_t bl = sm90::kmajor_desc<128>(slot + KC * CHUNK_BYTES + off);
      sm90::wgmma_tf32_n128(S, alo[ks], bh);
      sm90::wgmma_tf32_n128(S, ahi[ks], bl);
      sm90::wgmma_tf32_n128(S, ahi[ks], bh);
    }
    sm90::wgmma_commit();
    if (wg != 1 || i + 1 < nitems) sm90::bar_arrive(2 + (wg ^ 1), TURN);
    sm90::wgmma_wait<0>();
    sm90::fence_operand(S);
    if (sl == nslab - 1) {
      // S[4j + q]: sample g + 8 (q >> 1), code 8 j + 2 t + (q & 1), made the
      // score x.m - m2 / 2 in place; codes past N score -inf
      const float* m2s = reinterpret_cast<const float*>(ring + s * SLOT + 2 * KC * CHUNK_BYTES);
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const float2 mm = *reinterpret_cast<const float2*>(m2s + 8 * j + 2 * t);
        S[4 * j] = S[4 * j] - 0.5f * mm.x;
        S[4 * j + 1] = S[4 * j + 1] - 0.5f * mm.y;
        S[4 * j + 2] = S[4 * j + 2] - 0.5f * mm.x;
        S[4 * j + 3] = S[4 * j + 3] - 0.5f * mm.y;
      }
      const int rows = N - n0;
      if (rows < TN) {
#pragma unroll
        for (int j = 0; j < TN / 8; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (8 * j + 2 * t + (q & 1) >= rows) S[4 * j + q] = -INFINITY;
      }
      // per sample, the tile's best score by a max tree; only where it beats
      // the running best (rarely, past the first tiles) the first code that
      // reaches it: the (max, first index) a strict > over ascending codes
      // keeps, with fewer instructions on the path every tile takes.  K8,
      // K10: only where it beats the sample's bar, the lane's codes in
      // ascending order into its list, four at a time where their max beats
      // the bar and the lane's KM-th too
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m[TN / 16];
#pragma unroll
        for (int j = 0; j < TN / 16; ++j)
          m[j] = fmaxf(fmaxf(S[8 * j + 2 * h], S[8 * j + 2 * h + 1]),
                       fmaxf(S[8 * j + 4 + 2 * h], S[8 * j + 4 + 2 * h + 1]));
#pragma unroll
        for (int w = TN / 32; w >= 1; w >>= 1)
#pragma unroll
          for (int j = 0; j < w; ++j) m[j] = fmaxf(m[j], m[j + w]);
        if constexpr (kList) {
          // the sample's bar: the highest KM-th of its four lanes, whose
          // codes all precede this tile's; a code at or below it has KM
          // better ones in that lane and cannot enter the sample's top k
          float bar = list.s[h][KM - 1];
          bar = fmaxf(bar, __shfl_xor_sync(0xffffffffu, bar, 1));
          bar = fmaxf(bar, __shfl_xor_sync(0xffffffffu, bar, 2));
          if (m[0] > bar) {
#pragma unroll
            for (int j = 0; j < TN / 16; ++j) {  // four codes: column blocks 2j, 2j + 1
              const float gm = fmaxf(fmaxf(S[8 * j + 2 * h], S[8 * j + 2 * h + 1]),
                                     fmaxf(S[8 * j + 4 + 2 * h], S[8 * j + 4 + 2 * h + 1]));
              if (gm > fmaxf(bar, list.s[h][KM - 1])) {
#pragma unroll
                for (int c = 4 * j; c < 4 * j + 4; ++c)
                  list.visit(h, S[4 * (c >> 1) + 2 * h + (c & 1)],
                             n0 + 8 * (c >> 1) + 2 * t + (c & 1));
              }
            }
          }
        } else if (m[0] > best[h]) {
          int k = 0;
#pragma unroll
          for (int c = TN / 4 - 1; c >= 0; --c)
            if (S[4 * (c >> 1) + 2 * h + (c & 1)] == m[0]) k = 8 * (c >> 1) + 2 * t + (c & 1);
          best[h] = m[0];
          bidx[h] = n0 + k;
        }
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
    if (++s == stages) s = 0, phase ^= 1;
  }

  if constexpr (kList)
    list.write(b0, B, lane, blockIdx.y, k, pv, pi);
  else
    merge_fold(best, bidx, b0, B, lane, keys);
}

// K1 (the distance form's wrapper dist_argmin) and K2 (dist_argmin_t): one
// walk, two names; K8 (dist_top2) the walk with the top-2 fold, K10
// (dist_topk) with the fold of KM pairs, k <= KM
template <int KC>
__global__ void __launch_bounds__(THREADS, 1)
dist_argmin_kernel(const __grid_constant__ CUtensorMap hi_map,
                   const __grid_constant__ CUtensorMap lo_map,
                   const __grid_constant__ CUtensorMap m2_map, const float* __restrict__ x,
                   int B, int N, int D, int nslab, int span, int stages,
                   unsigned long long* __restrict__ keys, float* pv, int* pi) {
  walk<KC, 0>(&hi_map, &lo_map, &m2_map, x, B, N, D, nslab, span, stages, 0, keys, pv, pi);
}

template <int KC>
__global__ void __launch_bounds__(THREADS, 1)
dist_argmin_t_kernel(const __grid_constant__ CUtensorMap hi_map,
                     const __grid_constant__ CUtensorMap lo_map,
                     const __grid_constant__ CUtensorMap m2_map, const float* __restrict__ x,
                     int B, int N, int D, int nslab, int span, int stages,
                     unsigned long long* __restrict__ keys, float* pv, int* pi) {
  walk<KC, 0>(&hi_map, &lo_map, &m2_map, x, B, N, D, nslab, span, stages, 0, keys, pv, pi);
}

template <int KC>
__global__ void __launch_bounds__(THREADS, 1)
top2_sm90_kernel(const __grid_constant__ CUtensorMap hi_map,
                 const __grid_constant__ CUtensorMap lo_map,
                 const __grid_constant__ CUtensorMap m2_map, const float* __restrict__ x,
                 int B, int N, int D, int nslab, int span, int stages,
                 unsigned long long* __restrict__ keys, float* pv, int* pi) {
  walk<KC, 2>(&hi_map, &lo_map, &m2_map, x, B, N, D, nslab, span, stages, 2, keys, pv, pi);
}

template <int KC, int KM>
__global__ void __launch_bounds__(threads_of<KM>(), 1)
dist_topk_sm90_kernel(const __grid_constant__ CUtensorMap hi_map,
                      const __grid_constant__ CUtensorMap lo_map,
                      const __grid_constant__ CUtensorMap m2_map, const float* __restrict__ x,
                      int B, int N, int D, int nslab, int span, int stages, int k,
                      float* pv, int* pi) {
  walk<KC, KM>(&hi_map, &lo_map, &m2_map, x, B, N, D, nslab, span, stages, k, nullptr, pv,
               pi);
}

enum Kind { kK1, kK2, kK8 };

// the walk's tensor maps of the prologue's split: hi and lo (N, Dp) in
// (CHUNK, TN) boxes, 128B-swizzled, and m2 (N,) in TN boxes
int encode(CUtensorMap& hi_map, CUtensorMap& lo_map, CUtensorMap& m2_map, const float* hi,
           const float* lo, const float* m2, int N, int Dp) {
  int rc = sm90::encode_map(&hi_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, hi, N, Dp, CHUNK, TN,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  if (!rc)
    rc = sm90::encode_map(&lo_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, lo, N, Dp, CHUNK, TN,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (!rc)
    rc = sm90::encode_map(&m2_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, m2, 0, N, TN, 1,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
  return rc;
}

// `splits` spans of whole tiles, every span used non-empty: the tiles a
// span takes, and the spans used into `used`
int span_of(int N, int splits, int& used) {
  const int tiles = (N + TN - 1) / TN;
  const int span = (tiles + splits - 1) / splits;
  used = (tiles + span - 1) / span;
  return span;
}

// the walk over the non-empty spans of `splits`; their count into `used`
template <int KC, Kind kKind>
int launch(const float* x, const float* hi, const float* lo, const float* m2, int B, int N,
           int D, int Dp, int splits, unsigned long long* keys, float* pv, int* pi,
           int& used, cudaStream_t stream) {
  CUtensorMap hi_map, lo_map, m2_map;
  const int rc = encode(hi_map, lo_map, m2_map, hi, lo, m2, N, Dp);
  if (rc) return rc;
  constexpr int stages = ring_stages<KC>();
  constexpr int bytes = ALIGN + stages * slot_bytes<KC>() + BARRIER_BYTES;
  auto kernel = kKind == kK1   ? dist_argmin_kernel<KC>
                : kKind == kK2 ? dist_argmin_t_kernel<KC>
                               : top2_sm90_kernel<KC>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  const int span = span_of(N, splits, used);
  const dim3 grid((B + BS - 1) / BS, used);
  kernel<<<grid, THREADS, bytes, stream>>>(hi_map, lo_map, m2_map, x, B, N, D, Dp / (CHUNK * KC),
                                          span, stages, keys, pv, pi);
  return (int)cudaGetLastError();
}

// K10's walk at list width KM (k <= KM) over the non-empty spans of
// `splits`, then the merge of the splits' (splits, B, k) pairs into (B, k)
template <int KC, int KM>
int launch_topk(const float* x, const float* hi, const float* lo, const float* m2, int B,
                int N, int D, int Dp, int k, int splits, float* pv, int* pi, float* vo,
                int* io, cudaStream_t stream) {
  CUtensorMap hi_map, lo_map, m2_map;
  int rc = encode(hi_map, lo_map, m2_map, hi, lo, m2, N, Dp);
  if (rc) return rc;
  constexpr int stages = ring_stages<KC>();
  constexpr int bytes = ALIGN + stages * slot_bytes<KC>() + BARRIER_BYTES;
  const auto kernel = dist_topk_sm90_kernel<KC, KM>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  int used = 0;
  const int span = span_of(N, splits, used);
  const dim3 grid((B + BS - 1) / BS, used);
  kernel<<<grid, threads_of<KM>(), bytes, stream>>>(hi_map, lo_map, m2_map, x, B, N, D,
                                                    Dp / (CHUNK * KC), span, stages, k, pv, pi);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  topk_merge_splits<KM><<<(B + 255) / 256, 256, 0, stream>>>(pv, pi, B, k, used,
                                                             RowsOut{vo, io, k});
  return (int)cudaGetLastError();
}

// the prologue, then the walk on its split: scratch holds hi (N, Dp), lo
// (N, Dp), m2 (N, padded to 4), then K1's and K2's (B,) u64 keys, or K8's
// (splits, B, 2) pair values and indices, in that order; K1 and K2 write
// (val, idx), K8 (val, idx) and (val2, idx2)
template <Kind kKind>
int search(const float* x, const float* codes, int B, int N, int D, int Dp, int splits,
           float* scratch, float* val, int* idx, float* val2, int* idx2,
           cudaStream_t stream) {
  if (B <= 0 || splits < 1 || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  float* hi = scratch;
  float* lo = hi + (size_t)N * Dp;
  float* m2 = lo + (size_t)N * Dp;
  float* tail = m2 + (N + 3) / 4 * 4;
  auto* keys = reinterpret_cast<unsigned long long*>(tail);
  float* pv = tail;
  int* pi = reinterpret_cast<int*>(pv + (size_t)splits * B * 2);
  int rc = split(codes, N, D, Dp, hi, lo, m2, stream);
  if (rc) return rc;
  if (kKind != kK8) {
    init_keys<<<(B + 255) / 256, 256, 0, stream>>>(keys, B);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  int used = 0;
  rc = Dp == CHUNK
           ? launch<1, kKind>(x, hi, lo, m2, B, N, D, Dp, splits, keys, pv, pi, used, stream)
           : launch<2, kKind>(x, hi, lo, m2, B, N, D, Dp, splits, keys, pv, pi, used, stream);
  if (rc) return rc;
  if (kKind == kK8)
    topk_merge_splits<2><<<(B + 255) / 256, 256, 0, stream>>>(pv, pi, B, 2, used,
                                                              PairOut{val, val2, idx, idx2});
  else
    unpack_keys<<<(B + 255) / 256, 256, 0, stream>>>(keys, B, val, idx);
  return (int)cudaGetLastError();
}

// K10 at KM for both chunk widths
template <int KM>
int topk_km(const float* x, const float* hi, const float* lo, const float* m2, int B, int N,
            int D, int Dp, int k, int splits, float* pv, int* pi, float* vo, int* io,
            cudaStream_t stream) {
  return Dp == CHUNK ? launch_topk<1, KM>(x, hi, lo, m2, B, N, D, Dp, k, splits, pv, pi, vo,
                                          io, stream)
                     : launch_topk<2, KM>(x, hi, lo, m2, B, N, D, Dp, k, splits, pv, pi, vo,
                                          io, stream);
}

}  // namespace

// K1/K2's prologue alone: codes (N, D) -> hi, lo (N, Dp) and m2 (N,), Dp =
// padded_d(D)
extern "C" int somvq_split_codes(const float* codes, int N, int D, int Dp, float* hi,
                                 float* lo, float* m2, cudaStream_t stream) {
  return split(codes, N, D, Dp, hi, lo, m2, stream);
}

// K1: the prologue, then the walk; scratch: 2 N Dp + 4 ceil(N / 4) + 2 B
// floats, 16-byte aligned (search's layout); val gets the partial distance
// ||m||^2 - 2 x.m
extern "C" int somvq_dist_argmin(const float* x, const float* codes, int B, int N, int D,
                                 int Dp, int splits, float* scratch, float* val, int* idx,
                                 cudaStream_t stream) {
  return search<kK1>(x, codes, B, N, D, Dp, splits, scratch, val, idx, nullptr, nullptr,
                     stream);
}

// K2; val gets -2 * the best score x.m - ||m||^2 / 2, the same float as K1's
// partial distance
extern "C" int somvq_dist_argmin_t(const float* x, const float* codes, int B, int N, int D,
                                   int Dp, int splits, float* scratch, float* val, int* idx,
                                   cudaStream_t stream) {
  return search<kK2>(x, codes, B, N, D, Dp, splits, scratch, val, idx, nullptr, nullptr,
                     stream);
}

// K10: the prologue, then the walk with the fold of KM pairs (the smallest
// of 2, 4, 8, 16 that holds k, 1 <= k <= 16, k <= N), then the split merge;
// scratch: 2 N Dp + 4 ceil(N / 4) + 2 splits B k floats, 16-byte aligned
// (hi, lo, m2 as search's, then the splits' pair values and indices); vo, io
// (B, k) get the k smallest partial distances ||m||^2 - 2 x.m, ascending,
// and their rows, equal values lowest row first
extern "C" int somvq_dist_topk(const float* x, const float* codes, int B, int N, int D,
                               int Dp, int k, int splits, float* scratch, float* vo, int* io,
                               cudaStream_t stream) {
  if (B <= 0 || N <= 0 || k < 1 || k > 16 || k > N || splits < 1 ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  float* hi = scratch;
  float* lo = hi + (size_t)N * Dp;
  float* m2 = lo + (size_t)N * Dp;
  float* pv = m2 + (N + 3) / 4 * 4;
  int* pi = reinterpret_cast<int*>(pv + (size_t)splits * B * k);
  const int rc = split(codes, N, D, Dp, hi, lo, m2, stream);
  if (rc) return rc;
  if (k <= 2) return topk_km<2>(x, hi, lo, m2, B, N, D, Dp, k, splits, pv, pi, vo, io, stream);
  if (k <= 4) return topk_km<4>(x, hi, lo, m2, B, N, D, Dp, k, splits, pv, pi, vo, io, stream);
  if (k <= 8) return topk_km<8>(x, hi, lo, m2, B, N, D, Dp, k, splits, pv, pi, vo, io, stream);
  return topk_km<16>(x, hi, lo, m2, B, N, D, Dp, k, splits, pv, pi, vo, io, stream);
}

// K8: the prologue, then the walk with the top-2 fold, then the split merge;
// scratch: 2 N Dp + 4 ceil(N / 4) + 4 splits B floats, 16-byte aligned
// (search's layout); (v1, i1) and (v2, i2) get the best and second pairs,
// partial distances ||m||^2 - 2 x.m, N >= 2
extern "C" int somvq_dist_top2(const float* x, const float* codes, int B, int N, int D,
                               int Dp, int splits, float* scratch, float* v1, int* i1,
                               float* v2, int* i2, cudaStream_t stream) {
  if (N < 2) return (int)cudaErrorInvalidValue;
  return search<kK8>(x, codes, B, N, D, Dp, splits, scratch, v1, i1, v2, i2, stream);
}

extern "C" const char* somvq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
