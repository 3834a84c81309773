// K4 and K9 on Hopper: the masked 1-NN and 2-NN winner searches.  For each
// sample x_b, the codebook row m_n that minimises the squared distance over
// x_b's unmasked components (the lowest n on exact ties), or the two smallest
// (value, index) pairs, reported as the partial distance keep.(m_n o m_n) -
// 2 (x_b keep).m_n; the wrappers add ||x_b keep||^2.  The mask enters as (B,
// D) uint8, nonzero = masked.
//
// Replaces two TPU kernels of som_lvq_pak_tpu/ops/pallas_distance.py:
//   * _dist_argmin_masked_kernel (:74, wrapper dist_argmin with a mask)
//                                                -> masked_argmin_sm90_kernel (K4)
//   * _dist_top2_masked_kernel (:308, wrapper dist_top2 with a mask, the
//     running (best, second) pair, strict <, earlier tile kept)
//                                                -> masked_top2_sm90_kernel (K9)
// with the split of the codebook they need, once a call:
// split_masked_codes_kernel.
//
// What bounds it on H100: the two contractions (x keep).m^T and keep.(m o
// m)^T, 4 B N D FLOPs, on the tensor cores as split TF32 (tf32x3.cuh):
// (x keep).m by three TF32 products, keep.(m o m) by two (keep is 0 or 1,
// exact in TF32; the dropped remainder is below 2^-22 of each term): 10 B N
// D TF32 FLOPs at 495 TFLOP/s (84.7 ms at 1M x 65536 x 64).  Then the L2
// reads of the split codebook: every CTA of 128 samples walks four (N, Dp)
// arrays, 16 N Dp bytes, twice K1's (argmin_sm90.cu) for 5/3 of its
// products.  Device memory moves x, the mask, the codebook, its split and
// the (B,) results once.
//
// The design is K1's walk (argmin_sm90.cu) with the keep contraction beside
// it.  The prologue splits the codebook once a call into four (N, Dp) arrays
// (split_codes_dp's row length, zeros past D): m's TF32 hi and lo and q's,
// q = m * m rounded to float32, the floats the mma.sync walk K4 and K9 ran
// on before split per CTA, so the scores keep their bits; each entry launches
// it and the walk in one call, on one scratch buffer.  The walk: a CTA takes
// 128 samples, two consumer warpgroups of 64 and a producer warpgroup, whose
// registers go to the consumers (setmaxnreg: 232 a consumer thread, 40 a
// producer's; one thread of the producer issues the loads).  Each
// consumer keeps its samples' split A fragments of x keep, and their keep
// fragments (1.0 or 0.0), in registers for the whole walk (D <= 64; past it,
// 64-feature slabs reloaded per slab).  The producer streams each
// (64 codes x slab) tile of the four arrays by TMA (32-feature chunks of
// 128-byte rows, SWIZZLE_128B) into a ring of `stages` slots (three at D
// 64, seven up to D 32) behind full and empty mbarriers.  Per k step of 8
// features a consumer issues five warpgroup wgmma.m64n64k8.f32.tf32.tf32,
// in the mma.sync walk's order: lo.hi, hi.lo, hi.hi into S1 = (x keep).m,
// then keep.q_lo, keep.q_hi into S2 = keep.(m o m).  The two sums stay
// apart, as in the mma.sync walk, so every score S1 - 0.5 S2 is the float
// that walk gave.  64-code tiles: a 128-code slot of four
// arrays at D 64 is 128 KB (one stage), and two 64-float accumulators beside
// the A and keep fragments would pass even a consumer's 232 registers; two
// of 32 are K1's one of 64.  K1's 288-thread CTA gives a thread 168 (ptxas
// allots whole warpgroups), where this walk spilled and serialized its
// wgmma: hence the producer warpgroup and the register split.  K4's fold is
// K1's: the
// scores in place, codes past N at -inf (TMA fills their rows with zeros,
// which would score 0), a max tree per sample and the first code reaching
// the tile's max only where it beats the running best, the warpgroups taking
// turns to issue (named barriers) so that each folds under the other's
// products; the four lanes merge lexicographically and the codebook splits
// (ops.dist_argmin.k4_sm90_splits: spans of whole 64-code tiles, one CTA an
// SM) fold by argmin_keys.cuh's packed-u64 atomicMin on -2 * the score (-0
// to +0, the lowest index on ties).  A fully masked sample scores 0 against
// every code and gets index 0, value 0 (K9: (0, 0), (0, 1)).  Every sum runs
// in a fixed order and a code's score depends only on its own data: two runs
// are bit-equal.
//
// K9 is the same walk with K8's top-2 fold (argmin_sm90.cu, topk_fold.cuh's
// ListFold at 2): per sample the lane keeps a sorted (best, second) of
// (score, code); only where the tile's max beats the sample's bar, the
// highest second of its four lanes at the tile's start, does it visit its 16
// scores of the tile in ascending code order, four at a time and only where
// their max beats the bar and its own second too, each entering on a strict
// >.  The four lanes merge their lists, each codebook split writes its pairs
// as partial distances (-2 * the score, -0 to +0) to a (splits, B, 2)
// scratch, and topk_merge_splits<2> folds the splits in split order.  Its
// scores are K4's floats, so its best pair is K4's (value, index) bit for
// bit.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "argmin_tc.cuh"  // merge_fold, init_keys, unpack_keys, split_tf32
#include "sm90_pipe.cuh"
#include "topk_fold.cuh"

namespace {

constexpr int TN = 64;                         // codes per tile: the wgmma's N
constexpr int CONSUMERS = 2;                   // warpgroups of 64 samples
constexpr int BS = 64 * CONSUMERS;             // samples per CTA
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and the producer warpgroup
// the registers a thread of a 384-thread CTA gets (168 a thread at launch):
// the producer warpgroup gives its share to the consumers, which hold the A
// and keep fragments (96 at D 64) beside the two sums (64)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int CHUNK = 32;                      // features per 128-byte swizzled row
constexpr int CHUNK_BYTES = TN * CHUNK * 4;
constexpr int ARRAYS = 4;                      // m hi, m lo, q hi, q lo
constexpr int SMEM_MAX = 232448;               // a CTA's dynamic shared memory
constexpr int ALIGN = 1024;                    // the 128B swizzle's period
constexpr int MAX_STAGES = 8;
constexpr int BARRIER_BYTES = 2 * MAX_STAGES * 8;
constexpr int TURN = 256;                      // a turn's barrier: both warpgroups

// the split's row length (ops.dist_argmin.split_codes_dp), as K1's
__host__ __device__ constexpr int padded_d(int D) { return D <= 32 ? 32 : (D + 63) / 64 * 64; }

// a slot: KC chunks of each array, in the order m hi, m lo, q hi, q lo
template <int KC>
__host__ __device__ constexpr int slot_bytes() {
  return ARRAYS * KC * CHUNK_BYTES;
}

template <int KC>
__host__ __device__ constexpr int ring_stages() {
  return (SMEM_MAX - ALIGN - BARRIER_BYTES) / slot_bytes<KC>() < MAX_STAGES
             ? (SMEM_MAX - ALIGN - BARRIER_BYTES) / slot_bytes<KC>()
             : MAX_STAGES;
}

// The A fragments of x keep of slab `sl` for the warp's samples b0..b0+15,
// split, and their keep flags, bit 4 ks + q for k-step ks and fragment
// register q: a0 (sample g, feature t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); zero and keep 0 past B and D or where masked
template <int KT>
__device__ __forceinline__ void load_xk(float (&ahi)[KT][4], float (&alo)[KT][4],
                                        uint32_t& kbits, const float* __restrict__ x,
                                        const unsigned char* __restrict__ mask, int B,
                                        int D, int b0, int sl, int lane) {
  const int g = lane >> 2, t = lane & 3;
  kbits = 0u;
#pragma unroll
  for (int ks = 0; ks < KT; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int b = b0 + g + 8 * (q & 1);
      const int k = sl * 8 * KT + 8 * ks + t + 4 * (q >> 1);
      float v = 0.f;
      if (b < B && k < D) {
        const size_t i = (size_t)b * D + k;
        if (__ldg(mask + i) == 0) {
          v = __ldg(x + i);
          kbits |= 1u << (4 * ks + q);
        }
      }
      split_tf32(v, ahi[ks][q], alo[ks][q]);
    }
}

// keep fragment of k-step ks: 1.0 or 0.0 (exact in TF32)
__device__ __forceinline__ void keep_frag(float (&a)[4], uint32_t kbits, int ks) {
#pragma unroll
  for (int q = 0; q < 4; ++q) a[q] = (kbits >> (4 * ks + q)) & 1u ? 1.f : 0.f;
}

// The prologue: element (n, f) of the (N, Dp) arrays, v = codes[n][f] (0
// past D): hi, lo = split(v), qhi, qlo = split(fl(v * v)); a thread an
// element
__global__ void __launch_bounds__(256)
split_masked_codes_kernel(const float* __restrict__ codes, int N, int D, int Dp,
                          float* __restrict__ hi, float* __restrict__ lo,
                          float* __restrict__ qhi, float* __restrict__ qlo) {
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= (size_t)N * Dp) return;
  const size_t n = i / Dp;
  const int f = (int)(i - n * Dp);
  const float v = f < D ? codes[n * D + f] : 0.f;
  split_tf32(v, hi[i], lo[i]);
  split_tf32(__fmul_rn(v, v), qhi[i], qlo[i]);
}

int split(const float* codes, int N, int D, int Dp, float* hi, float* lo, float* qhi,
          float* qlo, cudaStream_t stream) {
  if (N <= 0 || D <= 0 || Dp != padded_d(D)) return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)N * Dp;
  split_masked_codes_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      codes, N, D, Dp, hi, lo, qhi, qlo);
  return (int)cudaGetLastError();
}

// The walk of CTA (blockIdx.x, blockIdx.y): samples blockIdx.x * BS.., the
// tiles [blockIdx.y * span, +span) of the codebook, in nslab slabs of
// 32 KC features each; the argmin fold into `keys` (K4), or with kTop2
// the top-2 fold into split blockIdx.y's pairs of pv/pi (K9)
template <int KC, bool kTop2>
__device__ __forceinline__ void walk(const CUtensorMap* const (&maps)[ARRAYS],
                                     const float* __restrict__ x,
                                     const unsigned char* __restrict__ mask, int B, int N,
                                     int D, int nslab, int span, int stages,
                                     unsigned long long* __restrict__ keys,
                                     float* __restrict__ pv, int* __restrict__ pi) {
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

  if (threadIdx.x >= 128 * CONSUMERS) {  // the producer warpgroup: one thread
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      int s = 0;
      uint32_t phase = 0;  // of slot s's current use
      for (int i = 0; i < nitems; ++i) {
        const int n0 = (t0 + i / nslab) * TN, f0 = (i % nslab) * SW;
        unsigned char* slot = ring + s * SLOT;
        sm90::mbar_wait(&empty[s], phase ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], SLOT);
#pragma unroll
        for (int a = 0; a < ARRAYS; ++a)
#pragma unroll
          for (int c = 0; c < KC; ++c)
            sm90::tma_load_2d(slot + (a * KC + c) * CHUNK_BYTES, maps[a], &full[s],
                              f0 + CHUNK * c, n0);
        if (++s == stages) s = 0, phase ^= 1;
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int b0 = blockIdx.x * BS + 16 * (threadIdx.x >> 5);  // this warp's 16 samples
  // x keep split (A of S1) and keep as 1.0 or 0.0 (A of S2); the keep
  // fragments pass an empty asm, so they stay in registers and are not
  // recomputed under a product that reads them
  float ahi[KS][4], alo[KS][4], kf[KS][4];
  uint32_t kbits;
  auto load = [&](int sl) {
    load_xk<KS>(ahi, alo, kbits, x, mask, B, D, b0, sl, lane);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      keep_frag(kf[ks], kbits, ks);
      sm90::fence_operand(kf[ks]);
    }
  };
  if (nslab == 1) load(0);
  float best[2] = {-INFINITY, -INFINITY};
  int bidx[2] = {INT_MAX, INT_MAX};
  ListFold<2> top2;  // K9: each sample's (best, second), sorted
  float S1[TN / 2], S2[TN / 2];
  int s = 0;
  uint32_t phase = 0;
  // the warpgroups take turns to issue a tile's products (named barrier 2 +
  // wg: wg's turn), so that each folds while the other's products run
  const int wg = threadIdx.x / 128;
  if (wg == 1) sm90::bar_arrive(2, TURN);
  for (int i = 0; i < nitems; ++i) {
    const int n0 = (t0 + i / nslab) * TN, sl = i % nslab;
    if (nslab > 1) load(sl);
    if (sl == 0) {
#pragma unroll
      for (int j = 0; j < TN / 2; ++j) S1[j] = S2[j] = 0.f;
    }
    const uint32_t slot = sm90::smem_u32(ring + s * SLOT);
    sm90::mbar_wait(&full[s], phase);
    sm90::bar_sync(2 + wg, TURN);
    sm90::fence_operand(S1);
    sm90::fence_operand(S2);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t off = (ks / 4) * CHUNK_BYTES + 32 * (ks % 4);
      const uint64_t bh = sm90::kmajor_desc<128>(slot + off);
      const uint64_t bl = sm90::kmajor_desc<128>(slot + KC * CHUNK_BYTES + off);
      const uint64_t qh = sm90::kmajor_desc<128>(slot + 2 * KC * CHUNK_BYTES + off);
      const uint64_t ql = sm90::kmajor_desc<128>(slot + 3 * KC * CHUNK_BYTES + off);
      sm90::wgmma_tf32_n64(S1, alo[ks], bh);
      sm90::wgmma_tf32_n64(S1, ahi[ks], bl);
      sm90::wgmma_tf32_n64(S1, ahi[ks], bh);
      sm90::wgmma_tf32_n64(S2, kf[ks], ql);
      sm90::wgmma_tf32_n64(S2, kf[ks], qh);
    }
    sm90::wgmma_commit();
    if (wg != 1 || i + 1 < nitems) sm90::bar_arrive(2 + (wg ^ 1), TURN);
    sm90::wgmma_wait<0>();
    sm90::fence_operand(S1);
    sm90::fence_operand(S2);
    if (sl == nslab - 1) {
      // S1[4j + q]: sample g + 8 (q >> 1), code 8 j + 2 t + (q & 1), made the
      // score (x keep).m - keep.(m o m) / 2 in place; codes past N score -inf
#pragma unroll
      for (int j = 0; j < TN / 2; ++j) S1[j] = S1[j] - 0.5f * S2[j];
      const int rows = N - n0;
      if (rows < TN) {
#pragma unroll
        for (int j = 0; j < TN / 8; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (8 * j + 2 * t + (q & 1) >= rows) S1[4 * j + q] = -INFINITY;
      }
      // per sample, the tile's best score by a max tree; only where it beats
      // the running best the first code that reaches it: the (max, first
      // index) a strict > over ascending codes keeps.  K9: only where it
      // beats the sample's bar, the lane's codes in ascending order into the
      // pair, four at a time where their max beats the bar and the lane's
      // second too (K8's fold, argmin_sm90.cu)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m[TN / 16];
#pragma unroll
        for (int j = 0; j < TN / 16; ++j)
          m[j] = fmaxf(fmaxf(S1[8 * j + 2 * h], S1[8 * j + 2 * h + 1]),
                       fmaxf(S1[8 * j + 4 + 2 * h], S1[8 * j + 4 + 2 * h + 1]));
#pragma unroll
        for (int w = TN / 32; w >= 1; w >>= 1)
#pragma unroll
          for (int j = 0; j < w; ++j) m[j] = fmaxf(m[j], m[j + w]);
        if constexpr (kTop2) {
          // the sample's bar: the highest second of its four lanes, whose
          // codes all precede this tile's; a code at or below it has two
          // better ones in that lane and cannot enter the sample's pair
          float bar = top2.s[h][1];
          bar = fmaxf(bar, __shfl_xor_sync(0xffffffffu, bar, 1));
          bar = fmaxf(bar, __shfl_xor_sync(0xffffffffu, bar, 2));
          if (m[0] > bar) {
#pragma unroll
            for (int j = 0; j < TN / 16; ++j) {  // four codes: column blocks 2j, 2j + 1
              const float gm = fmaxf(fmaxf(S1[8 * j + 2 * h], S1[8 * j + 2 * h + 1]),
                                     fmaxf(S1[8 * j + 4 + 2 * h], S1[8 * j + 4 + 2 * h + 1]));
              if (gm > fmaxf(bar, top2.s[h][1])) {
#pragma unroll
                for (int c = 4 * j; c < 4 * j + 4; ++c)
                  top2.visit(h, S1[4 * (c >> 1) + 2 * h + (c & 1)],
                             n0 + 8 * (c >> 1) + 2 * t + (c & 1));
              }
            }
          }
        } else if (m[0] > best[h]) {
          int k = 0;
#pragma unroll
          for (int c = TN / 4 - 1; c >= 0; --c)
            if (S1[4 * (c >> 1) + 2 * h + (c & 1)] == m[0]) k = 8 * (c >> 1) + 2 * t + (c & 1);
          best[h] = m[0];
          bidx[h] = n0 + k;
        }
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
    if (++s == stages) s = 0, phase ^= 1;
  }

  if constexpr (kTop2)
    top2.write(b0, B, lane, blockIdx.y, 2, pv, pi);
  else
    merge_fold(best, bidx, b0, B, lane, keys);
}

// K4 (the masked dist_argmin) and K9 (the masked dist_top2): one walk, two
// folds
template <int KC>
__global__ void __launch_bounds__(THREADS, 1)
masked_argmin_sm90_kernel(const __grid_constant__ CUtensorMap hi_map,
                          const __grid_constant__ CUtensorMap lo_map,
                          const __grid_constant__ CUtensorMap qhi_map,
                          const __grid_constant__ CUtensorMap qlo_map,
                          const float* __restrict__ x, const unsigned char* __restrict__ mask,
                          int B, int N, int D, int nslab, int span, int stages,
                          unsigned long long* __restrict__ keys, float* pv, int* pi) {
  const CUtensorMap* const maps[ARRAYS] = {&hi_map, &lo_map, &qhi_map, &qlo_map};
  walk<KC, false>(maps, x, mask, B, N, D, nslab, span, stages, keys, pv, pi);
}

template <int KC>
__global__ void __launch_bounds__(THREADS, 1)
masked_top2_sm90_kernel(const __grid_constant__ CUtensorMap hi_map,
                        const __grid_constant__ CUtensorMap lo_map,
                        const __grid_constant__ CUtensorMap qhi_map,
                        const __grid_constant__ CUtensorMap qlo_map,
                        const float* __restrict__ x, const unsigned char* __restrict__ mask,
                        int B, int N, int D, int nslab, int span, int stages,
                        unsigned long long* __restrict__ keys, float* pv, int* pi) {
  const CUtensorMap* const maps[ARRAYS] = {&hi_map, &lo_map, &qhi_map, &qlo_map};
  walk<KC, true>(maps, x, mask, B, N, D, nslab, span, stages, keys, pv, pi);
}

// the walk over the non-empty spans of `splits`; their count into `used`
template <int KC, bool kTop2>
int launch(const float* x, const unsigned char* mask, float* const (&arrays)[ARRAYS], int B,
           int N, int D, int Dp, int splits, unsigned long long* keys, float* pv, int* pi,
           int& used, cudaStream_t stream) {
  CUtensorMap maps[ARRAYS];
  for (int a = 0; a < ARRAYS; ++a) {
    const int rc = sm90::encode_map(&maps[a], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, arrays[a], N,
                                    Dp, CHUNK, TN, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc) return rc;
  }
  constexpr int stages = ring_stages<KC>();
  constexpr int bytes = ALIGN + stages * slot_bytes<KC>() + BARRIER_BYTES;
  const auto kernel = kTop2 ? masked_top2_sm90_kernel<KC> : masked_argmin_sm90_kernel<KC>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  // `splits` spans of whole tiles; every span used is non-empty
  const int tiles = (N + TN - 1) / TN;
  const int span = (tiles + splits - 1) / splits;
  used = (tiles + span - 1) / span;
  const dim3 grid((B + BS - 1) / BS, used);
  kernel<<<grid, THREADS, bytes, stream>>>(maps[0], maps[1], maps[2], maps[3], x, mask, B, N,
                                          D, Dp / (CHUNK * KC), span, stages, keys, pv, pi);
  return (int)cudaGetLastError();
}

// the prologue, then the walk on its split: scratch holds hi, lo, qhi, qlo
// (N, Dp), then K4's (B,) u64 keys or K9's (splits, B, 2) pair values and
// indices, in that order; K4 writes (val, idx), K9 (val, idx) and (val2,
// idx2)
template <bool kTop2>
int search(const float* x, const unsigned char* mask, const float* codes, int B, int N, int D,
           int Dp, int splits, float* scratch, float* val, int* idx, float* val2, int* idx2,
           cudaStream_t stream) {
  if (B <= 0 || splits < 1 || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  float* const arrays[ARRAYS] = {scratch, scratch + (size_t)N * Dp,
                                 scratch + 2 * (size_t)N * Dp, scratch + 3 * (size_t)N * Dp};
  float* const tail = scratch + 4 * (size_t)N * Dp;
  auto* keys = reinterpret_cast<unsigned long long*>(tail);
  float* pv = tail;
  int* pi = reinterpret_cast<int*>(pv + (size_t)splits * B * 2);
  int rc = split(codes, N, D, Dp, arrays[0], arrays[1], arrays[2], arrays[3], stream);
  if (rc) return rc;
  if (!kTop2) {
    init_keys<<<(B + 255) / 256, 256, 0, stream>>>(keys, B);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  int used = 0;
  rc = Dp == CHUNK
           ? launch<1, kTop2>(x, mask, arrays, B, N, D, Dp, splits, keys, pv, pi, used, stream)
           : launch<2, kTop2>(x, mask, arrays, B, N, D, Dp, splits, keys, pv, pi, used, stream);
  if (rc) return rc;
  if (kTop2)
    topk_merge_splits<2><<<(B + 255) / 256, 256, 0, stream>>>(pv, pi, B, 2, used,
                                                              PairOut{val, val2, idx, idx2});
  else
    unpack_keys<<<(B + 255) / 256, 256, 0, stream>>>(keys, B, val, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// K4's prologue alone: codes (N, D) -> hi, lo, qhi, qlo (N, Dp), Dp =
// padded_d(D)
extern "C" int somvq_split_masked_codes(const float* codes, int N, int D, int Dp, float* hi,
                                        float* lo, float* qhi, float* qlo,
                                        cudaStream_t stream) {
  return split(codes, N, D, Dp, hi, lo, qhi, qlo, stream);
}

// K4: the prologue, then the walk; scratch: 4 N Dp + 2 B floats, 16-byte
// aligned (search's layout); val gets the partial distance keep.(m o m) -
// 2 (x keep).m of the winner
extern "C" int somvq_dist_argmin_masked(const float* x, const unsigned char* mask,
                                        const float* codes, int B, int N, int D, int Dp,
                                        int splits, float* scratch, float* val, int* idx,
                                        cudaStream_t stream) {
  return search<false>(x, mask, codes, B, N, D, Dp, splits, scratch, val, idx, nullptr,
                       nullptr, stream);
}

// K9: the prologue, then the walk with the top-2 fold, then the split
// merge; scratch: 4 N Dp + 4 splits B floats, 16-byte aligned (search's
// layout); (v1, i1) and (v2, i2) get the best and second pairs, partial
// distances, N >= 2
extern "C" int somvq_dist_top2_masked(const float* x, const unsigned char* mask,
                                      const float* codes, int B, int N, int D, int Dp,
                                      int splits, float* scratch, float* v1, int* i1, float* v2,
                                      int* i2, cudaStream_t stream) {
  if (N < 2) return (int)cudaErrorInvalidValue;
  return search<true>(x, mask, codes, B, N, D, Dp, splits, scratch, v1, i1, v2, i2, stream);
}
