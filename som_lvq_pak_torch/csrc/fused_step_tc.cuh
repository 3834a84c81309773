// The fused SOM step on the tensor cores, shared by K3 past D 128
// (som_fused_step.cu, W from the closed form; up to D 128 K3 runs the Hopper
// walk of fused_step_sm90.cuh, bit-equal to this body), K13 and K14
// (som_fused_factored.cu and
// som_fused_chunked_tc.cuh, W from the separable tables): batch t's
// neighbourhood update, then batch t+1's winners against the updated rows,
// in one pass over the codebook.  Its blend-and-winner half
// (fused_blend_winners_tc) runs alone as K12 (som_blend_winner.cu, on the
// accumulators of a model shard summed over the data axis, which K11 writes
// on K3's Hopper walk, som_accum_sm90.cu; K5, the update with the blend,
// runs that walk too, som_update_sm90.cu).  Each half is a loop over chunk functions (fetch_update_chunk,
// update_chunk_tc; blend_rows_tc; winner_scores_tc, winner_fold_tc,
// winner_merge_tc), which K14's stagger and int8_win call in another order
// (som_fused_chunked_tc.cuh: chunked_walk) with the same floats.  The
// kernels differ only in how a W value is built, which a weight policy
// (ClosedFormW below, SeparableW in separable_w.cuh) supplies:
//
//   static size_t floats(...)      shared memory it stages into, per CTA
//   init(st, r0, warp, g)          its staging area (an offset in the dynamic
//                                  shared array) and the thread's rows
//   prefetch(c, s0, nb, tid, n)    cp.async of chunk c's inputs (before the
//                                  chunk's commit; nothing for K3)
//   kStage, stage(c, s0, nb, tid)  with kStage, plain stores of chunk c's
//                                  inputs after the chunk landed (K3's
//                                  per-sample BMU data), then a barrier
//   w(c, q, ks, nb)                fragment register q of k-step ks of chunk
//                                  c: row g + 8 (q & 1), sample 8 ks + t +
//                                  4 (q >> 1), 0 past the batch
//
// What bounds it on H100: the two contractions, acc = W.X (noc x B x D) and
// the scores tile.X'^T (noc x B' x D), as split-TF32 mma.sync (tf32x3.cuh):
// three TF32 products per float32 product, float32 accumulators, float32
// accuracy (about 2^-21 relative per product), a 495 / 3 = 165 TFLOP/s
// ceiling.  mma.sync itself issues TF32 at two thirds of the peak on an H100
// (mma_probe.py); the staging, the W values and the scoring share the SM with
// the mma between barriers (fused_step_sm90.cuh moves K3 and K17 onto wgmma
// fed by TMA from a producer warpgroup; the kernels below are next).
//
// kBf16 (K14's batch_bf16): both batches are rounded to bf16, W is rounded to
// bf16 for its product with X (wsum sums the unrounded W) and the blended
// rows are rounded to bf16 for the winners (||m||^2 from the float32 rows).
// A bf16 value is exact in TF32 and a product of two is exact in float32, so
// each contraction is ONE TF32 product, with no lo half split or staged:
// the staged operands are one plane, not two.
//
// Layout.  One CTA owns TN = 16 WARPS rows; warp w owns the 16-row m-tile
// 16w.. and every feature column, so each W value is built once per CTA and
// the batch is read from L2 once per CTA.  Features are padded to DP = 8 NT
// (a power of two) with zeros in shared memory only.
//
// Update (fused_update_tc).  Both batches are split into hi and lo once per
// step by a small launch (split_batches_kernel), so no CTA splits a sample.
// The batch is walked in kBC-sample chunks: cp.async copies chunk c + 1's hi
// and lo rows (and the policy's inputs for it) into one half of a double
// buffer while chunk c feeds the mma.  Each thread builds the W values of its
// A fragments straight in registers.  wsum is the float32 sum of the same W
// values: per thread in a fixed order (chunk, k-step, sample t then t + 4),
// then over the four lanes of a row by a fixed xor tree.  acc is a split-TF32
// mma against the staged X, summed in the mma's accumulators over one chunk
// only, then added into float32 registers with round-to-nearest adds: the
// tensor core's own accumulation loses low bits, and summed there over a
// whole batch of 4096 the blended rows drifted far enough from the plain
// step's to fail its bf16-codebook gate.
//
// Blend.  c + min(wsum, 1) * (acc / max(wsum, 1e-30) - c) (guarded_blend) is
// written back IN PLACE: each CTA reads and writes only its own rows.  A
// bf16 codebook is read upcast and written rounded to nearest even.  The
// float32 blended rows stay in shared memory, split into hi and lo, with
// their ||m||^2 (per-thread then xor-tree sums, fixed order) for the winners.
// Rows beyond noc are masked, never padded.
//
// Winners.  For each BW-sample chunk of the next batch (its split rows
// copied with cp.async, the first chunk while the tile blends, the next one
// while the chunk's winners fold), S = tile.X'^T on the same split-TF32 mma,
// d = ||m||^2 - 2 S, the
// (min, first row) per sample over the CTA's rows by a lexicographic (value,
// row) merge, folded across CTAs as a packed u64 with atomicMin
// (argmin_keys.cuh): the lowest row among equal values, in any CTA order.
// d is -2 fl(S - ||m||^2 / 2) exactly (halving and doubling are exact), so
// the max-score form's value comes out bit for bit.
//
// Feature passes (D > 256).  The widest instantiation is NT 32 (DP 256), and
// a wider row does not fit a thread's registers or a CTA's shared memory, so
// past 256 features the step runs in ceil(D / 256) passes of 256 (kPassD),
// all in one launch: split_batches_kernel writes each batch slab by slab
// (the planes of features 256 s.. of every sample, then the next slab's), and
// pass s runs the update of its slab (W rebuilt, the same floats every pass,
// so wsum too) and blends its columns in place.  Each feature's sum runs over
// the batch alone, so a pass needs nothing from the others.  The winners need
// the whole row: ||m||^2 is summed per thread over every pass's columns in
// pass order, then the xor tree; the scores of each winner chunk are summed
// in the mma over the slabs in order, each slab of the CTA's rows read back
// from device memory (its own freshly blended float32 rows, through L2: the
// codebook itself, or for a bf16 codebook a float32 copy the blend writes
// beside it) and split, beside the chunk's slab of x'.  Every order is
// fixed, so two runs are bit-equal.  The passes run in kernel instantiations
// of their own (kPasses), so at D <= 256 the code below runs as it did.
//
// Determinism.  Every sum runs in a fixed order inside one CTA: no split of
// the batch across CTAs, no float atomics.  A row's arithmetic depends only
// on its own data and its unit, not on the tile or shard that holds it (for
// a given CTA height), so two runs are bit-equal, the accumulators of a row
// that K11 writes (on K3's Hopper walk, whose sums are this body's) are the
// very floats K3 blends into it, and K12 blending them gives K3's rows,
// winners and values bit for bit.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "argmin_keys.cuh"
#include "som_grid.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kBC = 32;  // update: batch samples per chunk (4 k-steps)

// next-batch samples per winner chunk (8 n-tiles; 4 for D > 128, where 8
// would not fit in 227 KB of shared memory beside 128 rows)
__host__ __device__ constexpr int k3_bw(int NT) { return NT <= 16 ? 64 : 32; }

// K3's warps per CTA (16 rows each): 8, or 4 for D > 128, where a
// 128-row tile and a 64-sample winner chunk would not fit in 227 KB of
// shared memory
__host__ __device__ constexpr int k3_warps(int NT) { return NT <= 16 ? 8 : 4; }

// Shared memory (floats), two regions that are never live together; P = 2
// planes (hi, lo) of each staged operand, 1 under kBf16:
// update: x [2 buffers][P][kBC][DSU] | the policy's staging
// winner: t [P][TN][DT] | x' [P][BW][DW] | m2s[TN] | redv, redi [WARPS][BW]
template <int NT, int WARPS, bool kBf16 = false>
struct FusedSmem {
  static constexpr int P = kBf16 ? 1 : 2;
  static constexpr int DP = 8 * NT, TN = 16 * WARPS, BW = k3_bw(NT);
  static constexpr int DSU = stride_kn(DP), DT = stride_nk(DP), DW = DT;
  static size_t update_floats(size_t staged) {
    return 2 * P * (size_t)kBC * DSU + staged;
  }
  static constexpr size_t winner_floats() {
    return P * (size_t)TN * DT + P * (size_t)BW * DW + TN + 2 * WARPS * BW;
  }
  static size_t bytes(size_t staged) {
    const size_t u = update_floats(staged), w = winner_floats();
    return sizeof(float) * (u > w ? u : w);
  }
};

// The step's batches split once: xs = xb hi, xb lo (Bp, DP) | xn hi, xn lo
// (Bnp, DP), zero past D and past the batch (Bp, Bnp: B and Bn rounded up to
// a multiple of 64, so whole chunks copy), one thread per entry.  kBf16:
// each value rounded to bf16 (nearest even), one plane: xs = xb (Bp, DP) |
// xn (Bnp, DP).  With NP feature passes (D > DP) each batch is NP slabs in
// turn, slab s the planes of features s DP.. (xb's slabs, then xn's); NP 1 is
// the layout above
template <bool kBf16 = false>
__global__ void split_batches_kernel(const float* __restrict__ xb, int B,
                                     const float* __restrict__ xn, int Bn, int D,
                                     int DP, int NP, int Bp, int Bnp,
                                     float* __restrict__ xs) {
  constexpr int P = kBf16 ? 1 : 2;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t W = (int64_t)NP * DP;
  const int64_t nb = (int64_t)Bp * W, nn = (int64_t)Bnp * W;
  if (e >= nb + nn) return;
  const bool next = e >= nb;
  const int64_t i = next ? e - nb : e;
  const int b = (int)(i / W), f = (int)(i % W);
  const float* x = next ? xn : xb;
  const float v = (b < (next ? Bn : B) && f < D) ? x[(size_t)b * D + f] : 0.f;
  const int64_t rows = next ? Bnp : Bp;
  // slab f / DP's hi plane, row b, column f % DP
  float* hi = xs + (next ? P * nb : 0) + (int64_t)(f / DP) * P * rows * DP +
              (int64_t)b * DP + f % DP;
  if constexpr (kBf16) {
    hi[0] = bf16_round(v);
  } else {
    split_tf32(v, hi[0], hi[rows * DP]);
  }
}

// split_batches_kernel's launch for DP-wide rows, in n_passes(D) slabs when
// D > DP (Bn may be 0: xb alone)
template <bool kBf16 = false>
int split_batches(const float* xb, int B, const float* xn, int Bn, int D, int DP,
                  float* xs, cudaStream_t stream) {
  const int Bp = (B + 63) / 64 * 64, Bnp = (Bn + 63) / 64 * 64;
  const int NP = D > DP ? (D + DP - 1) / DP : 1;
  const int64_t n = ((int64_t)Bp + Bnp) * DP * NP;  // one thread per hi, lo pair
  split_batches_kernel<kBf16><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      xb, B, xn, Bn, D, DP, NP, Bp, Bnp, xs);
  return (int)cudaGetLastError();
}

// cp.async of `rows` rows of a pre-split (rows, DP) array into shared memory
// rows of `stride` floats, 16 bytes a piece
template <int DP>
__device__ __forceinline__ void copy_rows(float* dst, int stride,
                                          const float* __restrict__ src, int rows,
                                          int tid, int nthreads) {
  constexpr int Q = DP / 4;
  for (int e = tid; e < rows * Q; e += nthreads) {
    const int r = e / Q, f = 4 * (e - r * Q);
    cp_async16(dst + r * stride + f, src + (size_t)r * DP + f);
  }
}

// K3's W: the closed form at the row's global unit, from each
// sample's BMU grid x, BMU row and alpha staged per chunk (float4: x, row,
// alpha, 0).  The staging is found from the dynamic shared array and an
// offset, not a stored pointer, so its loads compile as shared-memory loads.
struct ClosedFormW {
  const int* bmu;
  const float* alpha;
  int B, xdim, unit_offset;
  bool hexa, gaussian;
  float r2, den;
  int st;               // the staging's offset in the shared array (floats)
  float lx[2], fur[2];  // this thread's two rows: grid x and row

  static constexpr size_t floats() { return 4 * kBC; }
  static constexpr bool kStage = true;

  __device__ __forceinline__ float4* smp() const {
    extern __shared__ __align__(16) float smem[];
    return reinterpret_cast<float4*>(smem + st);
  }

  __device__ __forceinline__ void init(int st_, int r0, int warp, int g) {
    st = st_;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = unit_offset + r0 + 16 * warp + g + 8 * h;
      lx[h] = grid_x(u % xdim, u / xdim, hexa);
      fur[h] = (float)(u / xdim);
    }
  }
  __device__ __forceinline__ void prefetch(int, int, int, int, int) {}
  __device__ __forceinline__ void stage(int, int s0, int, int tid) {
    if (tid < kBC) {
      const int b = s0 + tid;
      const int bm = b < B ? bmu[b] : -1;
      // weight_of_d2 with alpha 0 is +0, neighborhood_w's 0 for bmu < 0
      smp()[tid] = bm >= 0 ? make_float4(grid_x(bm % xdim, bm / xdim, hexa),
                                         (float)(bm / xdim), alpha[b], 0.f)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ float w(int, int q, int ks, int) const {
    const int t = threadIdx.x & 3;
    const float4 sm = smp()[8 * ks + t + 4 * (q >> 1)];
    const int h = q & 1;
    return weight_of_d2(grid_d2_at(lx[h], fur[h], sm.x, sm.y, hexa), sm.z, gaussian,
                        r2, den);
  }
};

__device__ __forceinline__ ClosedFormW closed_form_w(const int* bmu, const float* alpha,
                                                     int B, int xdim, int hexa,
                                                     int gaussian, float radius,
                                                     int unit_offset) {
  ClosedFormW wp;
  wp.bmu = bmu;
  wp.alpha = alpha;
  wp.B = B;
  wp.xdim = xdim;
  wp.unit_offset = unit_offset;
  wp.hexa = hexa != 0;
  wp.gaussian = gaussian != 0;
  wp.r2 = radius * radius;
  wp.den = 2.0f * radius * radius;
  return wp;
}

// cp.async of update chunk c (samples c kBC..): its rows of the split batch
// (xb_hi, xb_lo as split_batches_kernel wrote them) into xhi (and xlo) with
// row stride `stride`, and the policy's inputs for it; then a commit
template <int DP, bool kBf16, typename WP>
__device__ __forceinline__ void fetch_update_chunk(float* xhi, float* xlo, int stride,
                                                   const float* __restrict__ xb_hi,
                                                   const float* __restrict__ xb_lo, int c,
                                                   int B, WP& wp, int tid, int nthreads) {
  const size_t o = (size_t)c * kBC * DP;
  copy_rows<DP>(xhi, stride, xb_hi + o, kBC, tid, nthreads);
  if constexpr (!kBf16) copy_rows<DP>(xlo, stride, xb_lo + o, kBC, tid, nthreads);
  wp.prefetch(c, c * kBC, min(kBC, B - c * kBC), tid, nthreads);
  cp_async_commit();
}

// One update chunk c (nb samples) on its staged rows xhi, xlo (row stride
// `stride`): the chunk's W.X summed in the mma (split-TF32, or one TF32
// product under kBf16), then added into acc; wsum += its W values in a fixed
// order (k-step, sample t then t + 4)
template <int NT, bool kBf16, typename WP>
__device__ __forceinline__ void update_chunk_tc(float (&acc)[NT][4], float (&wsum)[2],
                                                const float* xhi, const float* xlo,
                                                int stride, int c, int nb, const WP& wp,
                                                int lane) {
  float part[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) part[j][q] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kBC / 8; ++ks) {
    // A fragment: a0 (row g, sample t), a1 (g + 8, t), a2 (g, t + 4),
    // a3 (g + 8, t + 4)
    float w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = wp.w(c, q, ks, nb);
    wsum[0] += w[0];
    wsum[0] += w[2];
    wsum[1] += w[1];
    wsum[1] += w[3];
    if constexpr (kBf16) {  // bf16 W and X: one exact TF32 product
      float a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = bf16_round(w[q]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float b[2];
        load_b_kn(b, xhi, stride, 8 * ks, 8 * j, lane);
        mma_tf32(part[j], a, b);
      }
    } else {
      float ahi[4], alo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(w[q], ahi[q], alo[q]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float bhi[2], blo[2];
        load_b_kn(bhi, xhi, stride, 8 * ks, 8 * j, lane);
        load_b_kn(blo, xlo, stride, 8 * ks, 8 * j, lane);
        mma_tf32x3(part[j], ahi, alo, bhi, blo);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] += part[j][q];
}

// wsum of each row over its four lanes, by a fixed xor tree
__device__ __forceinline__ void wsum_lanes(float (&wsum)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    wsum[h] += __shfl_xor_sync(0xffffffffu, wsum[h], 1);
    wsum[h] += __shfl_xor_sync(0xffffffffu, wsum[h], 2);
  }
}

// The update of rows r0 = blockIdx.x * TN..: acc = W.X (split-TF32 mma, or
// one TF32 product under kBf16) in the mma's C layout, c0 (row g, column 2t),
// c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1) of n-tile j, and wsum[h]
// = W.1 of row g + 8h, over every lane of the row.  xb_hi, xb_lo: the batch
// as split_batches_kernel wrote it (xb_lo unread under kBf16).  Leaves the
// update region of shared memory to be read by other threads: the caller
// synchronizes before reusing it.
template <int NT, int WARPS, bool kBf16, typename WP>
__device__ __forceinline__ void fused_update_tc(float (&acc)[NT][4], float (&wsum)[2],
                                                const float* __restrict__ xb_hi,
                                                const float* __restrict__ xb_lo, int B,
                                                int r0, WP& wp) {
  using L = FusedSmem<NT, WARPS, kBf16>;
  constexpr int DP = L::DP;
  constexpr int THREADS = 32 * WARPS;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2;

  // the double buffer: chunk planes hi (and lo) of each buffer
  float* xhi0 = smem;
  float* xlo0 = xhi0 + kBC * L::DSU;
  float* xhi1 = xhi0 + L::P * kBC * L::DSU;
  float* xlo1 = xhi1 + kBC * L::DSU;
  wp.init((int)(xhi1 + L::P * kBC * L::DSU - smem), r0, warp, g);

#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  wsum[0] = 0.f;
  wsum[1] = 0.f;

  const int nchunks = (B + kBC - 1) / kBC;
  fetch_update_chunk<DP, kBf16>(xhi0, xlo0, L::DSU, xb_hi, xb_lo, 0, B, wp, tid, THREADS);
  for (int c = 0; c < nchunks; ++c) {
    const int s0 = c * kBC, nb = min(kBC, B - s0);
    float* xhi = (c & 1) ? xhi1 : xhi0;
    float* xlo = (c & 1) ? xlo1 : xlo0;
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; chunk c - 1's fragments all read
    if (c + 1 < nchunks)  // its buffers were last read by chunk c - 1
      fetch_update_chunk<DP, kBf16>((c & 1) ? xhi0 : xhi1, (c & 1) ? xlo0 : xlo1, L::DSU,
                                    xb_hi, xb_lo, c + 1, B, wp, tid, THREADS);
    if constexpr (WP::kStage) {
      wp.stage(c, s0, nb, tid);
      __syncthreads();
    }
    update_chunk_tc<NT, kBf16>(acc, wsum, xhi, xlo, L::DSU, c, nb, wp, lane);
  }
  wsum_lanes(wsum);
}

// The guarded blend of columns k0..k0 + 8 NT - 1 of rows r0..r0 + 16 WARPS
// - 1 from (acc, wsum) in fused_update_tc's register layout, written IN
// PLACE; each blended float32 value's square added to sq[h] (this thread's
// part of ||m||^2 of row g + 8 h, in a fixed order) and the value handed to
// store(r, k, nc), k < 8 NT the column in the pass (0 past D and past noc)
template <int NT, int WARPS, typename CT, typename Store>
__device__ __forceinline__ void blend_pass_tc(const float (&acc)[NT][4],
                                              const float (&wsum)[2],
                                              CT* __restrict__ codes, int noc, int D,
                                              int k0, int r0, float (&sq)[2],
                                              Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // c0 (g, 2t), c1 (g, 2t + 1), c2, c3: g + 8
      const int h = q >> 1, r = 16 * warp + g + 8 * h, k = 8 * j + 2 * t + (q & 1);
      const int u = r0 + r;
      float nc = 0.f;
      if (k0 + k < D && u < noc) {
        CT* p = codes + (size_t)u * D + k0 + k;
        nc = guarded_blend(load_f32(p), acc[j][q], wsum[h]);
        store_f32(p, nc);
      }
      sq[h] += nc * nc;
      store(r, k, nc);
    }
  }
}

// ||m||^2 of the warp's rows into m2s[row]: each thread's part sq[h] of row
// 16 warp + g + 8 h, then over the row's four lanes by a fixed xor tree
__device__ __forceinline__ void m2_lanes(float (&sq)[2], float* m2s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 1);
    sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 2);
    if ((lane & 3) == 0) m2s[16 * warp + (lane >> 2) + 8 * h] = sq[h];
  }
}

// The guarded blend of rows r0..r0 + 16 WARPS - 1 (D <= 8 NT) from (acc,
// wsum) in fused_update_tc's register layout, written IN PLACE; ||m||^2 of
// each float32 blended row (per thread, then a fixed xor tree) into
// m2s[row]; and each blended float32 value handed to store(r, k, nc), k < DP
// (0 past D and past noc), for the winners' tile
template <int NT, int WARPS, typename CT, typename Store>
__device__ __forceinline__ void blend_rows_tc(const float (&acc)[NT][4],
                                              const float (&wsum)[2],
                                              CT* __restrict__ codes, int noc, int D,
                                              int r0, float* m2s, Store store) {
  float sq[2] = {0.f, 0.f};
  blend_pass_tc<NT, WARPS>(acc, wsum, codes, noc, D, 0, r0, sq, store);
  m2_lanes(sq, m2s);
}

// S = tile.X'^T of one BW-sample winner chunk: the split rows 16 warp.. of
// the tile (thi, tlo; row stride DT) against the chunk's split samples (whi,
// wlo; stride DW), split-TF32 (one TF32 product under kBf16; tlo, wlo unread);
// kZero false: added to S as it is (the next feature slab of a pass walk)
template <int NT, int BW, bool kBf16, bool kZero = true>
__device__ __forceinline__ void winner_scores_tc(float (&S)[BW / 8][4], const float* thi,
                                                 const float* tlo, int DT,
                                                 const float* whi, const float* wlo,
                                                 int DW, int warp, int lane) {
  if constexpr (kZero) {
#pragma unroll
    for (int n = 0; n < BW / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) S[n][q] = 0.f;
  }
#pragma unroll 2
  for (int ks = 0; ks < NT; ++ks) {
    if constexpr (kBf16) {
      float a[4];
      load_a(a, thi, DT, 16 * warp, 8 * ks, lane);
#pragma unroll
      for (int n = 0; n < BW / 8; ++n) {
        float b[2];
        load_b_nk(b, whi, DW, 8 * n, 8 * ks, lane);
        mma_tf32(S[n], a, b);
      }
    } else {
      float ahi[4], alo[4];
      load_a(ahi, thi, DT, 16 * warp, 8 * ks, lane);
      load_a(alo, tlo, DT, 16 * warp, 8 * ks, lane);
#pragma unroll
      for (int n = 0; n < BW / 8; ++n) {
        float bhi[2], blo[2];
        load_b_nk(bhi, whi, DW, 8 * n, 8 * ks, lane);
        load_b_nk(blo, wlo, DW, 8 * n, 8 * ks, lane);
        mma_tf32x3(S[n], ahi, alo, bhi, blo);
      }
    }
  }
}

// Each sample's (d, row) minimum over the tile's rows r0 + 16 warp.. that
// this warp holds, d = ||m||^2 - 2 S (S in the mma's C layout), over its two
// rows per lane, then over the 8 lanes g by a lexicographic (value, row)
// merge, into redv, redi [warp][BW].  d is -2 fl(S - ||m||^2 / 2) exactly
// (halving and doubling are exact): the max-score form's value
template <int BW>
__device__ __forceinline__ void winner_fold_tc(const float (&S)[BW / 8][4],
                                               const float* m2s, int r0, int noc,
                                               float* redv, int* redi, int warp,
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int ra = r0 + 16 * warp + g, rb = ra + 8;
  const float m2a = m2s[16 * warp + g], m2b = m2s[16 * warp + g + 8];
#pragma unroll
  for (int n = 0; n < BW / 8; ++n) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {  // sample 8 n + 2 t + q: rows ra, then rb
      float bv = INFINITY;
      int bi = INT_MAX;
      if (ra < noc) {
        bv = m2a - 2.f * S[n][q];
        bi = ra;
      }
      if (rb < noc) {
        const float d = m2b - 2.f * S[n][2 + q];
        if (d < bv) {
          bv = d;
          bi = rb;
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {  // the 8 lanes g of sample
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (lex_less(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (g == 0) {
        redv[warp * BW + 8 * n + 2 * t + q] = bv;
        redi[warp * BW + 8 * n + 2 * t + q] = bi;
      }
    }
  }
}

// The chunk's (d, row) minimum over the CTA's warps, folded into keys
// (samples n0..), after a barrier past every warp's winner_fold_tc
template <int BW, int WARPS>
__device__ __forceinline__ void winner_merge_tc(const float* redv, const int* redi, int n0,
                                                int Bn,
                                                unsigned long long* __restrict__ keys,
                                                int tid) {
  if (tid < BW) {
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int w = 0; w < WARPS; ++w) {
      const float v = redv[w * BW + tid];
      const int i = redi[w * BW + tid];
      if (lex_less(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    const int b = n0 + tid;
    if (b < Bn && bi != INT_MAX) fold_key(keys + b, bv, bi);
  }
}

// The blend and winners of rows r0..r0 + TN - 1: each row's guarded blend of
// its (acc, wsum), in fused_update_tc's register layout, written IN PLACE,
// then the next batch's winners against the blended rows, folded into
// `keys`.  xn_hi, xn_lo: the next batch as split_batches_kernel wrote it
// (xn_lo unread under kBf16).  Uses the winner region of shared memory, which
// must be free: nothing else of the CTA may read or write it any more.  K12
// (som_blend_winner.cu) runs it alone on accumulators K11 wrote out
// (som_accum_sm90.cu, the same sums as this body's update half).
template <int NT, int WARPS, bool kBf16, typename CT>
__device__ __forceinline__ void fused_blend_winners_tc(
    const float (&acc)[NT][4], const float (&wsum)[2], CT* __restrict__ codes, int noc,
    int D, const float* __restrict__ xn_hi, const float* __restrict__ xn_lo, int Bn,
    unsigned long long* __restrict__ keys, int r0) {
  using L = FusedSmem<NT, WARPS, kBf16>;
  constexpr int DP = L::DP, TN = L::TN, BW = L::BW;
  constexpr int THREADS = 32 * WARPS;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // ---- guarded blend, written in place; the tile kept split ---------------
  float* thi = smem;
  float* tlo = thi + TN * L::DT;
  float* whi = thi + L::P * TN * L::DT;
  float* wlo = whi + BW * L::DW;
  float* m2s = whi + L::P * BW * L::DW;
  float* redv = m2s + TN;
  int* redi = reinterpret_cast<int*>(redv + WARPS * BW);
  // the first winner chunk lands while the tile blends
  copy_rows<DP>(whi, L::DW, xn_hi, BW, tid, THREADS);
  if constexpr (!kBf16) copy_rows<DP>(wlo, L::DW, xn_lo, BW, tid, THREADS);
  cp_async_commit();

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

  // ---- next batch's winners against the updated tile ---------------------
  for (int n0 = 0; n0 < Bn; n0 += BW) {
    cp_async_wait_all();
    __syncthreads();  // chunk landed; tile and m2s written
    float S[BW / 8][4];
    winner_scores_tc<NT, BW, kBf16>(S, thi, tlo, L::DT, whi, wlo, L::DW, warp, lane);
    winner_fold_tc<BW>(S, m2s, r0, noc, redv, redi, warp, lane);
    __syncthreads();  // every fragment of this chunk read
    if (n0 + BW < Bn) {
      const size_t o = (size_t)(n0 + BW) * DP;
      copy_rows<DP>(whi, L::DW, xn_hi + o, BW, tid, THREADS);
      if constexpr (!kBf16) copy_rows<DP>(wlo, L::DW, xn_lo + o, BW, tid, THREADS);
      cp_async_commit();
    }
    winner_merge_tc<BW, WARPS>(redv, redi, n0, Bn, keys, tid);
  }
}

// The winners of the next batch against rows r0..r0 + TN - 1 over NP
// feature slabs (D > 8 NT): for each BW-sample chunk, the scores summed in
// the mma over the slabs in order, each slab of the rows read back from
// `rows` (the blended float32 rows, row stride D, written by this CTA before
// a barrier: loads through L2, __ldcg) and split (rounded to bf16 under
// kBf16) into the tile, the chunk's slab of x' (xn0: split_batches_kernel's
// slabs of the next batch) copied beside it; then the fold against m2s (set
// by the caller) and the merge into keys.  Uses the winner region of shared
// memory.
template <int NT, int WARPS, bool kBf16>
__device__ __forceinline__ void winners_passes_tc(const float* rows, int noc, int D, int NP,
                                                  const float* __restrict__ xn0, int Bn,
                                                  unsigned long long* __restrict__ keys,
                                                  int r0) {
  using L = FusedSmem<NT, WARPS, kBf16>;
  constexpr int DP = L::DP, TN = L::TN, BW = L::BW, Q = DP / 4;
  constexpr int THREADS = 32 * WARPS;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* thi = smem;
  float* tlo = thi + TN * L::DT;
  float* whi = thi + L::P * TN * L::DT;
  float* wlo = whi + BW * L::DW;
  float* m2s = whi + L::P * BW * L::DW;
  float* redv = m2s + TN;
  int* redi = reinterpret_cast<int*>(redv + WARPS * BW);
  const size_t Bnp = (Bn + 63) / 64 * 64;
  const bool vec = (D & 3) == 0 && (reinterpret_cast<uintptr_t>(rows) & 15) == 0;
  auto put = [&](int r, int k, float v) {
    if constexpr (kBf16) {
      thi[r * L::DT + k] = bf16_round(v);
    } else {
      split_tf32(v, thi[r * L::DT + k], tlo[r * L::DT + k]);
    }
  };
  for (int n0 = 0; n0 < Bn; n0 += BW) {
    float S[BW / 8][4];
#pragma unroll
    for (int n = 0; n < BW / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) S[n][q] = 0.f;
    for (int s = 0; s < NP; ++s) {
      const int f0 = s * DP;
      const float* xh = xn0 + (size_t)s * L::P * Bnp * DP + (size_t)n0 * DP;
      copy_rows<DP>(whi, L::DW, xh, BW, tid, THREADS);
      if constexpr (!kBf16) copy_rows<DP>(wlo, L::DW, xh + Bnp * DP, BW, tid, THREADS);
      cp_async_commit();
      if (vec) {
        for (int e = tid; e < TN * Q; e += THREADS) {
          const int r = e / Q, k = 4 * (e - r * Q), u = r0 + r;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (u < noc && f0 + k < D)
            v = __ldcg(reinterpret_cast<const float4*>(rows + (size_t)u * D + f0 + k));
          put(r, k, v.x);
          put(r, k + 1, v.y);
          put(r, k + 2, v.z);
          put(r, k + 3, v.w);
        }
      } else {
        for (int e = tid; e < TN * DP; e += THREADS) {
          const int r = e / DP, k = e - r * DP, u = r0 + r;
          put(r, k, (u < noc && f0 + k < D) ? __ldcg(rows + (size_t)u * D + f0 + k) : 0.f);
        }
      }
      cp_async_wait_all();
      __syncthreads();  // the slab's rows and samples staged (and m2s written)
      winner_scores_tc<NT, BW, kBf16, false>(S, thi, tlo, L::DT, whi, wlo, L::DW, warp,
                                             lane);
      __syncthreads();  // every fragment of the slab read
    }
    winner_fold_tc<BW>(S, m2s, r0, noc, redv, redi, warp, lane);
    __syncthreads();  // every warp's fold written
    winner_merge_tc<BW, WARPS>(redv, redi, n0, Bn, keys, tid);
  }
}

// The step on rows r0.. past 8 NT features (NT 32, D > 256), in
// n_passes(D) passes over the feature slabs: pass s the update of slab s (W rebuilt: the same floats
// each pass) and the blend of its columns in place, ||m||^2 summed over the
// passes in order; then winners_passes_tc on the blended float32 rows
// (`codes` itself, or for a bf16 codebook `rows32`, (noc, D) float32, which
// the blend fills)
template <int NT, int WARPS, bool kBf16, typename CT, typename WP>
__device__ __forceinline__ void fused_step_passes_tc(CT* __restrict__ codes, int noc, int D,
                                                     const float* __restrict__ xs, int B,
                                                     int Bn,
                                                     unsigned long long* __restrict__ keys,
                                                     WP& wp, float* rows32, int r0) {
  using L = FusedSmem<NT, WARPS, kBf16>;
  constexpr int DP = L::DP;
  constexpr bool kF32 = sizeof(CT) == sizeof(float);
  extern __shared__ __align__(16) float smem[];
  const int NP = n_passes(D);
  const size_t Bp = (B + 63) / 64 * 64;
  float sq[2] = {0.f, 0.f};
  for (int s = 0; s < NP; ++s) {
    const float* xb_hi = xs + (size_t)s * L::P * Bp * DP;
    float acc[NT][4];
    float wsum[2];
    fused_update_tc<NT, WARPS, kBf16>(acc, wsum, xb_hi, xb_hi + Bp * DP, B, r0, wp);
    __syncthreads();  // every fragment read: the update region is free
    const int k0 = s * DP;
    blend_pass_tc<NT, WARPS>(acc, wsum, codes, noc, D, k0, r0, sq, [&](int r, int k, float nc) {
      if constexpr (!kF32) {
        if (k0 + k < D && r0 + r < noc) rows32[(size_t)(r0 + r) * D + k0 + k] = nc;
      }
    });
  }
  m2_lanes(sq, smem + L::P * L::TN * L::DT + L::P * L::BW * L::DW);
  const float* rows;
  if constexpr (kF32)
    rows = reinterpret_cast<const float*>(codes);
  else
    rows = rows32;
  winners_passes_tc<NT, WARPS, kBf16>(rows, noc, D, NP, xs + (size_t)NP * L::P * Bp * DP, Bn,
                                      keys, r0);
}

// The step on rows r0 = blockIdx.x * TN.. of the codebook; `wp` builds W.
// xs holds the batches xb (B, D) and xn (Bn, D) as split_batches_kernel
// wrote them (its kBf16 form under kBf16).  kPasses (an instantiation of its
// own, NT 32, for D > 256, so that the one-pass kernels keep their code):
// fused_step_passes_tc, with rows32 the float32 rows of a bf16 codebook
// (unread otherwise)
template <int NT, int WARPS, bool kBf16, bool kPasses = false, typename CT, typename WP>
__device__ __forceinline__ void fused_step_tc(CT* __restrict__ codes, int noc, int D,
                                              const float* __restrict__ xs, int B,
                                              int Bn, unsigned long long* __restrict__ keys,
                                              WP& wp, float* rows32 = nullptr) {
  using L = FusedSmem<NT, WARPS, kBf16>;
  constexpr int DP = L::DP;
  if constexpr (kPasses) {
    static_assert(NT == 32, "feature passes run the widest instantiation");
    fused_step_passes_tc<NT, WARPS, kBf16>(codes, noc, D, xs, B, Bn, keys, wp, rows32,
                                           blockIdx.x * L::TN);
    return;
  }
  const int r0 = blockIdx.x * L::TN;
  // the split arrays: the planes of (Bp, DP), then of (Bnp, DP)
  const size_t Bp = (B + 63) / 64 * 64, Bnp = (Bn + 63) / 64 * 64;
  const float* xb_hi = xs;
  const float* xb_lo = xs + Bp * DP;
  const float* xn_hi = xs + L::P * Bp * DP;
  const float* xn_lo = xn_hi + Bnp * DP;

  // ---- update: acc = W.X, wsum = W.1 ----------------------------------------
  float acc[NT][4];
  float wsum[2];
  fused_update_tc<NT, WARPS, kBf16>(acc, wsum, xb_hi, xb_lo, B, r0, wp);
  __syncthreads();  // every fragment read: the update region is free

  // ---- the blend, then the next batch's winners --------------------------
  fused_blend_winners_tc<NT, WARPS, kBf16>(acc, wsum, codes, noc, D, xn_hi, xn_lo, Bn,
                                           keys, r0);
}

}  // namespace
