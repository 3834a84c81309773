// K4 on Hopper: the masked 1-NN winner search.  For each sample x_b, the
// codebook row m_n that minimises the squared distance over x_b's unmasked
// components (the lowest n on exact ties), reported as the partial distance
// keep.(m_n o m_n) - 2 (x_b keep).m_n; the wrapper adds ||x_b keep||^2.  The
// mask enters as (B, D) uint8, nonzero = masked.
//
// Replaces som_lvq_pak_tpu/ops/pallas_distance.py:_dist_argmin_masked_kernel
// (:74, wrapper dist_argmin with a mask)      -> masked_argmin_sm90_kernel (K4)
// with the split of the codebook it needs, once a call: split_masked_codes_kernel.
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
// q = m * m rounded to float32, the floats K4's mma.sync walk split per CTA
// (masked_walk.cuh), so the scores keep their bits; the entry launches it
// and the walk in one call, on one scratch buffer.  The walk: a CTA takes
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
// in masked_walk.cuh's k4_mma order: lo.hi, hi.lo, hi.hi into S1 = (x
// keep).m, then keep.q_lo, keep.q_hi into S2 = keep.(m o m).  The two sums
// stay apart, as in the mma.sync walk, so every score S1 - 0.5 S2 is the
// float that walk gives and K9 (dist_top2.cu, still on it) keeps this
// kernel's best pair bit for bit.  64-code tiles: a 128-code slot of four
// arrays at D 64 is 128 KB (one stage), and two 64-float accumulators beside
// the A and keep fragments would pass even a consumer's 232 registers; two
// of 32 are K1's one of 64.  K1's 288-thread CTA gives a thread 168 (ptxas
// allots whole warpgroups), where this walk spilled and serialized its
// wgmma: hence the producer warpgroup and the register split.  The fold is K1's: the
// scores in place, codes past N at -inf (TMA fills their rows with zeros,
// which would score 0), a max tree per sample and the first code reaching
// the tile's max only where it beats the running best, the warpgroups taking
// turns to issue (named barriers) so that each folds under the other's
// products; the four lanes merge lexicographically and the codebook splits
// (ops.dist_argmin.k4_sm90_splits: spans of whole 64-code tiles, one CTA an
// SM) fold by argmin_keys.cuh's packed-u64 atomicMin on -2 * the score (-0
// to +0, the lowest index on ties).  A fully masked sample scores 0 against
// every code and gets index 0, value 0.  Every sum runs in a fixed order and
// a code's score depends only on its own data: two runs are bit-equal.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "masked_walk.cuh"  // load_xk, keep_frag; argmin_tc.cuh's merge_fold
#include "sm90_pipe.cuh"

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
// 32 KC features each; the argmin fold into `keys`
template <int KC>
__global__ void __launch_bounds__(THREADS, 1)
masked_argmin_sm90_kernel(const __grid_constant__ CUtensorMap hi_map,
                          const __grid_constant__ CUtensorMap lo_map,
                          const __grid_constant__ CUtensorMap qhi_map,
                          const __grid_constant__ CUtensorMap qlo_map,
                          const float* __restrict__ x, const unsigned char* __restrict__ mask,
                          int B, int N, int D, int nslab, int span, int stages,
                          unsigned long long* __restrict__ keys) {
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
      const CUtensorMap* maps[ARRAYS] = {&hi_map, &lo_map, &qhi_map, &qlo_map};
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
      // index) a strict > over ascending codes keeps
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
        if (m[0] > best[h]) {
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

  merge_fold(best, bidx, b0, B, lane, keys);
}

template <int KC>
int launch(const float* x, const unsigned char* mask, float* const (&arrays)[ARRAYS], int B,
           int N, int D, int Dp, int splits, unsigned long long* keys, cudaStream_t stream) {
  CUtensorMap maps[ARRAYS];
  for (int a = 0; a < ARRAYS; ++a) {
    const int rc = sm90::encode_map(&maps[a], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, arrays[a], N,
                                    Dp, CHUNK, TN, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc) return rc;
  }
  constexpr int stages = ring_stages<KC>();
  constexpr int bytes = ALIGN + stages * slot_bytes<KC>() + BARRIER_BYTES;
  const cudaError_t attr = cudaFuncSetAttribute(
      masked_argmin_sm90_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  // `splits` spans of whole tiles; every span used is non-empty
  const int tiles = (N + TN - 1) / TN;
  const int span = (tiles + splits - 1) / splits;
  const dim3 grid((B + BS - 1) / BS, (tiles + span - 1) / span);
  masked_argmin_sm90_kernel<KC><<<grid, THREADS, bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], x, mask, B, N, D, Dp / (CHUNK * KC), span, stages,
      keys);
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
// aligned, holding hi, lo, qhi, qlo (N, Dp) and the (B,) u64 keys; val gets
// the partial distance keep.(m o m) - 2 (x keep).m of the winner
extern "C" int somvq_dist_argmin_masked(const float* x, const unsigned char* mask,
                                        const float* codes, int B, int N, int D, int Dp,
                                        int splits, float* scratch, float* val, int* idx,
                                        cudaStream_t stream) {
  if (B <= 0 || splits < 1 || (reinterpret_cast<uintptr_t>(scratch) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  float* const arrays[ARRAYS] = {scratch, scratch + (size_t)N * Dp,
                                 scratch + 2 * (size_t)N * Dp, scratch + 3 * (size_t)N * Dp};
  auto* keys = reinterpret_cast<unsigned long long*>(scratch + 4 * (size_t)N * Dp);
  int rc = split(codes, N, D, Dp, arrays[0], arrays[1], arrays[2], arrays[3], stream);
  if (rc) return rc;
  init_keys<<<(B + 255) / 256, 256, 0, stream>>>(keys, B);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = Dp == CHUNK ? launch<1>(x, mask, arrays, B, N, D, Dp, splits, keys, stream)
                   : launch<2>(x, mask, arrays, B, N, D, Dp, splits, keys, stream);
  if (rc) return rc;
  unpack_keys<<<(B + 255) / 256, 256, 0, stream>>>(keys, B, val, idx);
  return (int)cudaGetLastError();
}
