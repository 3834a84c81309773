// The separable fused SOM step: batch t's neighbourhood update and batch
// t+1's winners against the updated rows, in one pass over the codebook, with
// the neighbourhood weight factored as W = Wx(column, row parity) * Wy(row).
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_fused_factored_kernel (K13)
// and _som_fused_factored_chunked_kernel (K14, with its options wxa_bf16,
// batch_bf16, int8_win and stagger), from the one entry
// somvq_som_fused_factored: one table launch, then K13's or K14's main launch
// on the tensor cores, or, for K14's stagger and int8_win, K14's CUDA-core
// launch.  The wrapper som_fused_train_step routes to them as the TPU wrapper
// does.
//
// What they compute, with the TPU kernels' float32 algebra kept as it is:
// s = 1 / (2 r r); dx from columns and 0.5 offsets, hexa dy^2 = rowdiff^2 *
// 0.75 (exact in float32, so the bubble boundary is exact);
//   gaussian  Wx = alpha * expf(-dx^2 s), Wy = expf(-dy^2 s), W = Wx * Wy;
//   bubble    Wx = dx^2, Wy = dy^2, W = (Wx + Wy <= r r) ? alpha : 0;
// W = 0 where bmu < 0; acc = W.X, wsum = W.1 and the guarded blend; then the
// next batch's winners in max-score form, score = x.m - ||m||^2 / 2, reported
// as -2 * score, the lowest row on ties.
//
// K14 adds the batch-chunked kernel's options.  wxa_bf16 (gaussian only)
// keeps Wx rounded to bf16.  batch_bf16 rounds x and x' to bf16, rounds W to
// bf16 before its product with x (wsum keeps the unrounded W), and rounds the
// updated row to bf16 for the winners' dot products (||m||^2 from the float32
// row).  A product of two bf16 values is exact in float32, so FP32 FMAs over
// the rounded operands give the MXU's products; only the order of the
// additions differs.  The TPU kernel's batch chunk is a VMEM device: here
// every launch walks the batch through shared memory in chunks anyway, so it
// has no counterpart in the kernel.
//
// int8_win (pallas_som.py:1056-1061, 1087-1094): the winners' contraction in
// int8.  The wrapper quantizes x' against its global scale (xq int8) and
// passes q = (127 / sm, sm sx / 127^2) on the device; here each blended
// float32 row is quantized in shared memory, clamp(rintf(m q0), +-127) (round
// half to even, as jnp.round), packed four to a word with D padded by zeros to
// a multiple of 4, and dotted with the staged xq words by __dp4a into int32.
// The score is (float)dot * q1 - ||m||^2 / 2, the norm from the float32 row
// (also under batch_bf16), folded by the same key.  The update half is the
// same code, so the codebook is bit-equal to the step without int8_win.
//
// stagger (pallas_som.py:950-958, 1117-1147): the TPU grid runs in order, and
// its cell i interleaves tile i's update chunks with tile i-1's winner chunks
// against the previous updated tile, kept in scratch, then drains the last
// tile.  Here the grid is persistent: min(tiles, resident CTAs) CTAs, each
// walking its own tiles blockIdx.x, blockIdx.x + gridDim.x, ... in order,
// keeping the previous updated tile and its ||m||^2 / 2 in shared memory,
// interleaving one 32-sample update chunk of its tile with one winner chunk of
// the previous tile, and draining its last tile.  No CTA waits on another.
// Each row's additions run in the same order and the key fold is order-free,
// so the result is bit-equal to the step without stagger.
//
// The x-pattern.  The TPU kernels build the (pattern rows, B) table of Wx at
// grid step 0 into scratch that every later grid step reads, which holds only
// because the TPU grid runs in order.  Here a first small launch writes Wx,
// indexed by (row parity, column), Wy, indexed by grid row, and alpha (0 where
// bmu < 0) into buffers the wrapper allocates, and the main launch reads them
// (12 MB at 256x256 hexa, B 4096: L2-resident).  The TPU kernels' 0/1
// "expand" matmul that spreads Wy over a tile's rows (a relayout device) is
// the index Wy[u / xdim].
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
// sums keep one order and two runs are bit-equal.
//
// K14's main form (no stagger, no int8_win) is the same body with its bf16
// options (som_fused_chunked_tc.cuh): a bf16 x-pattern, and under batch_bf16
// one TF32 product per contraction on bf16 operands.
//
// K14's stagger and int8_win keep the CUDA-core body below: one CTA per 32
// codebook rows, the batch staged in shared memory 32 samples at a time, the
// chunk's weights built from the tables, FP32 FMAs into registers; the blend
// is written in place and the updated rows kept in shared memory for the
// winners.  Their gates hold each option to this body without it, which the
// entry's cuda_cores flag runs (ops.som_step's private
// _som_fused_factored_chunked_step_cuda_cores).  Across CTAs each sample's
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
// What bounds them on H100: the two contractions, 4 noc B D FLOPs per step:
// for K13 and K14's main form as split-TF32 products on the tensor cores (12
// noc B D TF32 FLOPs; 4 noc B D, one product each, under batch_bf16), for
// the CUDA-core body as FP32 FMAs and shared-memory loads (int8_win: half of
// them int8 MACs).  The exponentials drop from noc B (K3) to (pattern
// rows + grid rows) B, in the table launch.  Device memory traffic is one
// codebook read and write; the batches and the tables are re-read from L2 by
// every CTA.  Rows beyond noc are masked.

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

__device__ __forceinline__ float to_pattern(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_pattern(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// The tables of one step, one thread per sample b.  pat[p][b] with p = parity
// * xdim + column (parity 0 only on a rect map): gaussian alpha_b *
// expf(-dx^2 s), stored as PT (bf16 rounds it), bubble dx^2; ytab[y][b] for
// grid row y: gaussian expf(-dy^2 s), bubble dy^2; aw[b]: alpha_b, 0 where
// bmu_b < 0.  Grid rows of the launch walk the n_pat + ydim table rows; the
// first also sets the Bn winner keys to their start value (init_keys).
template <typename PT>
__global__ void factored_tables_kernel(const int* __restrict__ bmu,
                                       const float* __restrict__ alpha, int B,
                                       int Bn, int xdim, int hexa, int gaussian,
                                       float radius, int n_pat, int ydim,
                                       PT* __restrict__ pat,
                                       float* __restrict__ ytab,
                                       float* __restrict__ aw,
                                       unsigned long long* __restrict__ keys) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.y == 0 && b < Bn) keys[b] = ~0ull;
  if (b >= B) return;
  const int bm = bmu[b];
  const bool none = bm < 0;
  const int bmc = none ? 0 : bm;
  const int bcol = bmc % xdim, brow = bmc / xdim;
  const float a = none ? 0.f : alpha[b];
  const float s = 1.0f / (2.0f * radius * radius);
  const float bx = hexa ? (float)bcol + 0.5f * (float)(brow & 1) : (float)bcol;
  if (blockIdx.y == 0) aw[b] = a;
  for (int p = blockIdx.y; p < n_pat + ydim; p += gridDim.y) {
    if (p < n_pat) {
      const int col = p % xdim, par = p / xdim;
      const float xq = hexa ? (float)col + 0.5f * (float)par : (float)col;
      const float dx = xq - bx;
      const float dx2 = dx * dx;
      pat[(size_t)p * B + b] = to_pattern(gaussian ? a * expf(-dx2 * s) : dx2, pat);
    } else {
      const int y = p - n_pat;
      const float rd = (float)(y - brow);
      const float dy2 = hexa ? (rd * rd) * 0.75f : rd * rd;
      ytab[(size_t)y * B + b] = gaussian ? expf(-dy2 * s) : dy2;
    }
  }
}

// Shared memory: tile[TN][D] | xs[BC][DS] | ws[TN][BC] | m2h[TN] |
//                redv[THREADS] | redi[THREADS]
// Under int8_win, tile holds the quantized rows as TN x ceil(D / 4) words and
// xs the staged xq as BC x (ceil(D / 4) | 1) words, both within their float
// sizes.
size_t smem_bytes(int D) {
  const int DS = D | 1;  // odd stride: per-sample rows hit distinct banks
  return sizeof(float) * ((size_t)TN * D + (size_t)BC * DS + TN * BC + TN +
                          THREADS) +
         sizeof(int) * THREADS;
}

struct Smem {
  float* tile;  // the updated rows the winners are taken against
  float* xs;    // a staged chunk of x or x'
  float* ws;    // a chunk's weights
  float* m2h;   // ||m||^2 / 2 of the rows in tile
  float* redv;
  int* redi;
};

__device__ __forceinline__ Smem smem_layout(int D) {
  extern __shared__ float smem[];
  Smem s;
  s.tile = smem;
  s.xs = s.tile + TN * D;
  s.ws = s.xs + BC * (D | 1);
  s.m2h = s.ws + TN * BC;
  s.redv = s.m2h + TN;
  s.redi = reinterpret_cast<int*>(s.redv + THREADS);
  return s;
}

// One 32-sample chunk (samples s0..) of the update of rows r0..: acc += W.X,
// wsum += W.1; thread (warp, lane): rows 4 warp..4 warp+3, columns lane + 32 j
template <int NJ, typename PT, bool kBatchBf16>
__device__ __forceinline__ void update_chunk(
    float (&acc)[4][NJ], float (&wsum)[4], const Smem& sm, int s0, int r0,
    int noc, int D, const float* __restrict__ xb, const float* __restrict__ aw,
    int B, int xdim, int hexa, int gaussian, float r2, const PT* __restrict__ pat,
    const float* __restrict__ ytab) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int DS = D | 1;
  __syncthreads();  // the previous chunk fully consumed
  for (int e = tid; e < BC * D; e += THREADS) {
    const int s = e / D, k = e % D;
    float xv = (s0 + s < B) ? xb[(size_t)(s0 + s) * D + k] : 0.f;
    if (kBatchBf16) xv = bf16_round(xv);
    sm.xs[s * DS + k] = xv;
  }
  for (int e = tid; e < TN * BC; e += THREADS) {
    const int r = e / BC, s = e % BC;
    const int u = r0 + r, b = s0 + s;
    float w = 0.f;
    if (u < noc && b < B) {
      const int row = u / xdim, col = u - row * xdim;
      const int p = (hexa ? (row & 1) * xdim : 0) + col;
      const float wx = load_f32(pat + (size_t)p * B + b);
      const float wy = ytab[(size_t)row * B + b];
      w = gaussian ? wx * wy : (wx + wy <= r2 ? aw[b] : 0.f);
    }
    sm.ws[r * BC + s] = w;
  }
  __syncthreads();
  const int nb = min(BC, B - s0);
  for (int s = 0; s < nb; ++s) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = sm.ws[(warp * 4 + i) * BC + s];
      wsum[i] += w[i];
      if (kBatchBf16) w[i] = bf16_round(w[i]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = lane + 32 * j;
      const float xv = (k < D) ? sm.xs[s * DS + k] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] += w[i] * xv;
    }
  }
}

// The guarded blend of rows r0.., written in place, and the rows the winners
// are taken against kept in shared memory with their ||m||^2 / 2 (float32)
template <int NJ, typename CT, bool kBatchBf16, bool kInt8>
__device__ __forceinline__ void finish_tile(const float (&acc)[4][NJ],
                                            const float (&wsum)[4], const Smem& sm,
                                            int r0, int noc, int D,
                                            CT* __restrict__ codes, float q0) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int WS4 = 4 * ((D + 3) >> 2);  // bytes per quantized row
  signed char* t8 = reinterpret_cast<signed char*>(sm.tile);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i, u = r0 + r;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = lane + 32 * j;
      if (k < D) {
        float nc = 0.f;
        if (u < noc) {
          const size_t g = (size_t)u * D + k;
          nc = guarded_blend(load_f32(codes + g), acc[i][j], wsum[i]);
          store_f32(codes + g, nc);
        }
        if (kInt8) {
          const float v = fminf(fmaxf(rintf(__fmul_rn(nc, q0)), -127.f), 127.f);
          t8[r * WS4 + k] = (signed char)(int)v;
        } else {
          sm.tile[r * D + k] = kBatchBf16 ? bf16_round(nc) : nc;
        }
        sq += nc * nc;
      } else if (kInt8 && k < WS4) {
        t8[r * WS4 + k] = 0;  // D padded to a multiple of 4 by zeros
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    if (lane == 0) sm.m2h[r] = 0.5f * sq;
  }
}

// One 32-sample chunk (samples s0..) of the next batch's max-score winners
// against the rows r0.. kept in shared memory; thread (warp, lane): rows
// 4 warp..4 warp+3 against sample s0 + lane
template <bool kBatchBf16, bool kInt8>
__device__ __forceinline__ void winner_chunk(const Smem& sm, int s0, int r0, int noc,
                                             int D, const float* __restrict__ xn,
                                             const signed char* __restrict__ xq,
                                             int Bn, float q1,
                                             unsigned long long* __restrict__ keys) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
  __syncthreads();  // tile/m2h written; the previous chunk's reduction read
  if (kInt8) {
    const int WS = (D + 3) >> 2, WSS = WS | 1;
    int* xw = reinterpret_cast<int*>(sm.xs);
    for (int e = tid; e < BC * WS; e += THREADS) {
      const int s = e / WS, w = e % WS, b = s0 + s;
      unsigned int v = 0u;
      if (b < Bn) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * w + j;
          if (k < D) v |= (unsigned int)(unsigned char)xq[(size_t)b * D + k] << (8 * j);
        }
      }
      xw[s * WSS + w] = (int)v;
    }
    __syncthreads();
    const int* tw = reinterpret_cast<const int*>(sm.tile);
    int idot[4] = {0, 0, 0, 0};
    for (int w = 0; w < WS; ++w) {
      const int xv = xw[lane * WSS + w];
#pragma unroll
      for (int i = 0; i < 4; ++i) idot[i] = __dp4a(tw[(warp * 4 + i) * WS + w], xv, idot[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) dot[i] = __fmul_rn((float)idot[i], q1);  // exact int
  } else {
    const int DS = D | 1;
    for (int e = tid; e < BC * D; e += THREADS) {
      const int s = e / D, k = e % D;
      float xv = (s0 + s < Bn) ? xn[(size_t)(s0 + s) * D + k] : 0.f;
      if (kBatchBf16) xv = bf16_round(xv);
      sm.xs[s * DS + k] = xv;
    }
    __syncthreads();
    for (int k = 0; k < D; ++k) {
      const float xv = sm.xs[lane * DS + k];
#pragma unroll
      for (int i = 0; i < 4; ++i) dot[i] += sm.tile[(warp * 4 + i) * D + k] * xv;
    }
  }
  float bv = -INFINITY;
  int bi = INT_MAX;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i;
    if (r0 + r < noc) {
      const float sc = dot[i] - sm.m2h[r];
      if (sc > bv) {  // rows ascend with i: strict > keeps the first
        bv = sc;
        bi = r0 + r;
      }
    }
  }
  sm.redv[warp * 32 + lane] = bv;
  sm.redi[warp * 32 + lane] = bi;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < THREADS / 32; ++w) {  // rows ascend with w
      const float v = sm.redv[w * 32 + lane];
      if (v > bv) {
        bv = v;
        bi = sm.redi[w * 32 + lane];
      }
    }
    const int b = s0 + lane;
    if (b < Bn && bi != INT_MAX) fold_key(keys + b, -2.f * bv, bi);
  }
}

// The step on this CTA's tiles blockIdx.x, blockIdx.x + gridDim.x, ... (one
// tile per CTA unless stagger); kBatchBf16: 8c's batch_bf16, kInt8: int8_win
template <int NJ, typename CT, typename PT, bool kBatchBf16, bool kInt8>
__device__ __forceinline__ void factored_step(
    CT* __restrict__ codes, int noc, int D, const float* __restrict__ xb,
    const float* __restrict__ aw, int B, const float* __restrict__ xn,
    const signed char* __restrict__ xq, const float* __restrict__ q, int Bn,
    int xdim, int hexa, int gaussian, float radius, int stagger,
    const PT* __restrict__ pat, const float* __restrict__ ytab,
    unsigned long long* __restrict__ keys) {
  const Smem sm = smem_layout(D);
  const float r2 = radius * radius;
  const float q0 = kInt8 ? q[0] : 0.f, q1 = kInt8 ? q[1] : 0.f;
  const int n_tiles = (noc + TN - 1) / TN;
  const int nB = (B + BC - 1) / BC, nBn = (Bn + BC - 1) / BC;
  int prev = -1;  // row 0 of the previous updated tile (stagger), -1 none
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int r0 = t * TN;
    float acc[4][NJ];
    float wsum[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wsum[i] = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    }
    const bool lead = stagger && prev >= 0;  // interleave the previous tile's winners
    const int nc = lead ? max(nB, nBn) : nB;
    for (int c = 0; c < nc; ++c) {
      if (c < nB)
        update_chunk<NJ, PT, kBatchBf16>(acc, wsum, sm, c * BC, r0, noc, D, xb, aw,
                                         B, xdim, hexa, gaussian, r2, pat, ytab);
      if (lead && c < nBn)
        winner_chunk<kBatchBf16, kInt8>(sm, c * BC, prev, noc, D, xn, xq, Bn, q1,
                                        keys);
    }
    // every thread is past the last chunk's reads of tile and m2h
    finish_tile<NJ, CT, kBatchBf16, kInt8>(acc, wsum, sm, r0, noc, D, codes, q0);
    if (stagger) {
      prev = r0;
    } else {
      for (int c = 0; c < nBn; ++c)
        winner_chunk<kBatchBf16, kInt8>(sm, c * BC, r0, noc, D, xn, xq, Bn, q1, keys);
    }
  }
  if (stagger && prev >= 0) {  // drain: the last tile's winners
    for (int c = 0; c < nBn; ++c)
      winner_chunk<kBatchBf16, kInt8>(sm, c * BC, prev, noc, D, xn, xq, Bn, q1, keys);
  }
}

// K14 on CUDA cores: the batch-chunked step with its bf16 x-pattern (PT), bf16 batches,
// int8 winners and the staggered schedule
template <int NJ, typename CT, typename PT, bool kBatchBf16, bool kInt8>
__global__ void __launch_bounds__(THREADS)
som_fused_factored_chunked_kernel(CT* __restrict__ codes, int noc, int D,
                                  const float* __restrict__ xb,
                                  const float* __restrict__ aw, int B,
                                  const float* __restrict__ xn,
                                  const signed char* __restrict__ xq,
                                  const float* __restrict__ q, int Bn, int xdim,
                                  int hexa, int gaussian, float radius, int stagger,
                                  const PT* __restrict__ pat,
                                  const float* __restrict__ ytab,
                                  unsigned long long* __restrict__ keys) {
  factored_step<NJ, CT, PT, kBatchBf16, kInt8>(codes, noc, D, xb, aw, B, xn, xq, q,
                                               Bn, xdim, hexa, gaussian, radius,
                                               stagger, pat, ytab, keys);
}

// K13: the separable step on the tensor cores (separable_w.cuh), 16 WARPS
// rows per CTA
template <int NT, int WARPS, typename CT>
__global__ void __launch_bounds__(32 * WARPS, (NT <= 8 ? 2 : 1) * 8 / WARPS)
som_fused_factored_kernel(CT* __restrict__ codes, int noc, int D,
                          const float* __restrict__ xs,
                          const float* __restrict__ aw, int B, int Bn, int xdim,
                          int hexa, int gaussian, float radius, int ny,
                          const float* __restrict__ pat,
                          const float* __restrict__ ytab,
                          unsigned long long* __restrict__ keys) {
  separable_step_tc<NT, WARPS, false>(codes, noc, D, xs, aw, B, Bn, xdim, hexa, gaussian,
                                      radius, ny, pat, ytab, keys);
}

// The persistent grid of the staggered schedule: min(tiles, resident CTAs)
template <typename K>
int stagger_grid(K kernel, size_t smem, int n_tiles, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm * sms <= 0) return (int)cudaErrorInvalidConfiguration;
  *grid = (unsigned)(n_tiles < per_sm * sms ? n_tiles : per_sm * sms);
  return 0;
}

// K14's CUDA-core launch (stagger, int8_win, cuda_cores)
template <int NJ, typename CT, typename PT, bool kBatchBf16, bool kInt8>
int launch_main(const StepArgs& a) {
  const size_t smem = smem_bytes(a.D);
  const int n_tiles = (a.noc + TN - 1) / TN;
  unsigned grid = (unsigned)n_tiles;
  const auto kernel = som_fused_factored_chunked_kernel<NJ, CT, PT, kBatchBf16, kInt8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (a.stagger) {
    const int rc = stagger_grid(kernel, smem, n_tiles, &grid);
    if (rc) return rc;
  }
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<CT*>(a.codes), a.noc, a.D, a.xb, a.aw, a.B, a.xn, a.xq, a.q, a.Bn,
      a.xdim, a.hexa, a.gaussian, a.radius, a.stagger,
      static_cast<const PT*>(a.pat), a.ytab, a.keys);
  return (int)cudaGetLastError();
}

// K13 for D's width and the wrapper's rows per CTA: 128 or 64 (64 past D 128,
// where 128 rows would not fit)
template <typename CT>
int run_k13(const StepArgs& a) {
  const int k8 = (a.D + 7) / 8;
  if (!(a.rows == 64 || (a.rows == 128 && k8 <= 16))) return (int)cudaErrorInvalidValue;
#define K13_LAUNCH(NT)                                                         \
  if (k8 <= NT)                                                              \
    return a.rows == 64                                                      \
               ? launch_separable_tc<NT, 4, false, CT, float>(                 \
                     som_fused_factored_kernel<NT, 4, CT>, a)                  \
               : launch_separable_tc<NT, (NT <= 16 ? 8 : 4), false, CT, float>( \
                     som_fused_factored_kernel<NT, (NT <= 16 ? 8 : 4), CT>, a);
  K13_LAUNCH(1)
  K13_LAUNCH(2)
  K13_LAUNCH(4)
  K13_LAUNCH(8)
  K13_LAUNCH(16)
  K13_LAUNCH(32)
#undef K13_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The table launch of one step (it also sets the winner keys)
template <typename PT>
int launch_tables(const StepArgs& a) {
  const int n_pat = a.hexa ? 2 * a.xdim : a.xdim;
  const int ydim = (a.noc + a.xdim - 1) / a.xdim;
  const int trows = n_pat + ydim < 65535 ? n_pat + ydim : 65535;
  const dim3 tgrid(((a.B > a.Bn ? a.B : a.Bn) + 255) / 256, trows);
  factored_tables_kernel<PT><<<tgrid, 256, 0, a.stream>>>(
      a.bmu, a.alpha, a.B, a.Bn, a.xdim, a.hexa, a.gaussian, a.radius, n_pat,
      ydim, static_cast<PT*>(a.pat), a.ytab, a.aw, a.keys);
  return (int)cudaGetLastError();
}

// The table launch, then K14's CUDA-core launch for D's register width
template <typename CT, typename PT, bool kBatchBf16, bool kInt8>
int run_cuda_cores(const StepArgs& a) {
  const int rc = launch_tables<PT>(a);
  if (rc) return rc;
  const int nj = (a.D + 31) / 32;
  if (nj <= 1) return launch_main<1, CT, PT, kBatchBf16, kInt8>(a);
  if (nj <= 2) return launch_main<2, CT, PT, kBatchBf16, kInt8>(a);
  if (nj <= 4) return launch_main<4, CT, PT, kBatchBf16, kInt8>(a);
  return launch_main<8, CT, PT, kBatchBf16, kInt8>(a);
}

template <typename CT, bool kInt8>
int run_chunked(const StepArgs& a, int wxa_bf16, int batch_bf16) {
  if (wxa_bf16 && batch_bf16) return run_cuda_cores<CT, __nv_bfloat16, true, kInt8>(a);
  if (wxa_bf16) return run_cuda_cores<CT, __nv_bfloat16, false, kInt8>(a);
  if (batch_bf16) return run_cuda_cores<CT, float, true, kInt8>(a);
  return run_cuda_cores<CT, float, false, kInt8>(a);
}

// K13 (not chunked), K14's main form on the tensor cores, or K14 on CUDA
// cores (stagger, int8_win, or the private cuda_cores route)
template <typename CT>
int run_flags(const StepArgs& a, int chunked, int wxa_bf16, int batch_bf16,
              int int8_win, int cuda_cores) {
  if (!chunked) {
    const int rc = launch_tables<float>(a);
    return rc ? rc : run_k13<CT>(a);
  }
  if (a.stagger || int8_win || cuda_cores)
    return int8_win ? run_chunked<CT, true>(a, wxa_bf16, batch_bf16)
                    : run_chunked<CT, false>(a, wxa_bf16, batch_bf16);
  const int rc = wxa_bf16 ? launch_tables<__nv_bfloat16>(a) : launch_tables<float>(a);
  if (rc) return rc;
  if constexpr (std::is_same<CT, float>::value)
    return somvq::k14_tc_f32codes(a, wxa_bf16, batch_bf16);
  else
    return somvq::k14_tc_bf16codes(a, wxa_bf16, batch_bf16);
}

}  // namespace

// K13 (chunked 0) or K14 (chunked 1, with 8c's options wxa_bf16, gaussian
// only, batch_bf16, stagger and int8_win).  K14 without stagger and int8_win
// is its main form on the tensor cores; with either, or with cuda_cores (a
// private route of the gates that hold those options to K14 without them),
// the CUDA-core body.  codes (noc, D) float32, or bf16 with codes_bf16,
// updated in place; xb (B, D), bmu (B,), alpha (B,), xn (Bn, D) float32;
// under int8_win xq (Bn, D) int8, x' quantized by the wrapper, and q (2,)
// float32 = (127 / sm, sm sx / 127^2) on the device (xn is then not read).
// Scratch from the wrapper: keys (Bn,) u64; aw (B,), ytab (ceil(noc / xdim),
// B) float32 and pat (n_pat, B), n_pat = 2 xdim (hexa) or xdim, bf16 under
// wxa_bf16, else float32; for the tensor-core kernels also xs, 2 (Bp + Bnp)
// DP float32, (Bp + Bnp) DP under batch_bf16 (B and Bn rounded up to a
// multiple of 64, DP = 8 times the power of two of 8-feature steps that
// covers D), and rows, the rows per CTA (ops.som_step.k13_rows: 128 or 64;
// K14_ROWS: 64, or 32).  val gets -2 * the best score, idx its row.
extern "C" int somvq_som_fused_factored(
    void* codes, int codes_bf16, int noc, int D, const float* xb,
    const int* bmu, const float* alpha, int B, const float* xn, int Bn,
    int xdim, int hexa, int gaussian, float radius, int chunked, int wxa_bf16,
    int batch_bf16, int stagger, int int8_win, int cuda_cores, int rows,
    float* xs,
    const signed char* xq,
    const float* q, void* pat, float* ytab, float* aw, unsigned long long* keys,
    float* val, int* idx, cudaStream_t stream) {
  if (noc <= 0 || D <= 0 || D > MAX_D || B <= 0 || Bn <= 0 || xdim <= 0 ||
      (!chunked && (wxa_bf16 || batch_bf16 || stagger || int8_win || cuda_cores)) ||
      (!(chunked && (stagger || int8_win || cuda_cores)) && !xs) ||
      (wxa_bf16 && !gaussian) || (int8_win && (xq == nullptr || q == nullptr)))
    return (int)cudaErrorInvalidValue;
  const StepArgs a{codes,  noc,     D,    xb, bmu,  alpha, B,
                   xn,     xq,      q,    Bn, xdim, hexa,  gaussian,
                   radius, stagger, rows, xs, pat,  ytab,  aw,
                   keys,   stream};
  const int rc = codes_bf16
                     ? run_flags<__nv_bfloat16>(a, chunked, wxa_bf16, batch_bf16, int8_win,
                                                cuda_cores)
                     : run_flags<float>(a, chunked, wxa_bf16, batch_bf16, int8_win,
                                        cuda_cores);
  if (rc) return rc;
  unpack_keys<<<(Bn + 255) / 256, 256, 0, stream>>>(keys, Bn, val, idx);
  return (int)cudaGetLastError();
}
