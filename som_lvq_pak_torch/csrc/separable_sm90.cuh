// The separable fused SOM step on K3's Hopper walk (fused_step_sm90.cuh), for
// D <= 128: K13 (som_lvq_pak_tpu/ops/pallas_som.py:_som_fused_factored_kernel,
// :743) and K14's main form (_som_fused_factored_chunked_kernel, :904) are
// instances of one walk, `separable_walk<DP, kGauss, P, kSplit, CT>`:
//   * K13: P 2, no split, run as som_fused_factored_sm90_kernel
//     (som_fused_factored_sm90.cu, C entry somvq_som_fused_factored_sm90);
//   * K14: P 2, or P 1 under batch_bf16, with each tile's batch split across
//     a thread-block cluster, run as som_chunked_sm90_kernel
//     (som_fused_chunked_sm90_{f32,bf16}.cu, C entry
//     somvq_som_fused_chunked_sm90).
// Wider D: som_fused_factored.cu's and som_fused_chunked_tc.cuh's mma.sync
// kernels (ops.som_step.k13_route, k14_route); K14's stagger and int8_win
// run their own walk (som_fused_chunked_tc.cuh) at any D.  Each C entry is
// `separable_step`: the step's table launch (separable_w.cuh:
// factored_tables_kernel, which also sets the winner keys; under K14's
// wxa_bf16 the x-pattern rounded to bf16 and kept as float32), the
// prologue (the batches split, or under batch_bf16 rounded to bf16 and one
// plane written: split_sm90_kernel's kRound), the walk, the keys unpacked.
//
// The walk:
//   * W (SeparableW90): each thread's two rows' x-pattern and y-factor table
//     entries for its eight samples of a 32-sample chunk (and, on a bubble
//     map, the samples' alpha) read from L2 with __ldg, in rows padded to Bp
//     with samples of alpha 0; W = Wx * Wy (gaussian) or (Wx + Wy <= r r) ?
//     alpha : 0 (bubble), separable_w.cuh's float operations, +0 past the
//     batch with no test (no branch on a lane's value while a wgmma is in
//     flight: that made ptxas serialize K3's wgmma); split into TF32 hi and
//     lo as the A fragments (P 1: W rounded to bf16, wsum from the unrounded
//     W), chunk c + 1's built while chunk c's products run; wsum in
//     update_chunk_tc's order.  The update slot holds the chunk's X planes
//     alone (no per-sample table).
//   * The rows: fused_step_tc.cuh's blend (guarded_blend, ||m||^2 from the
//     float32 rows), the blended rows kept in the tile for the winners,
//     split (P 2) or rounded to bf16 (P 1).
//   * The fold: K3's (fs90::argmin_fold), in distance form, ||m||^2 - 2
//     x'.m, which is -2 fl(x'.m - ||m||^2 / 2) exactly: K13's max-score
//     value bit for bit.
// Under P 1 every operand is exact in TF32, so each k step issues ONE wgmma
// in the update and one in the winners, where P 2 issues three, and the
// producer streams no lo planes.  Without the split every W value and wsum
// is som_fused_factored.cu's float and the walk's sums are mma.sync's, so
// K13's codebook, winners and values are the mma.sync K13's bit for bit
// (tools/fused_step_ab.py's digests).
//
// The split (kSplit, K14).  Without it a CTA takes one 128-row tile's whole
// batch, 32 samples a chunk (at 64x64, B 4096: 32 CTAs on 132 SMs, each
// walking 128 chunks).  With it a cluster of c in {1, 2, 4, 8} CTAs (the
// launch's, chosen by ops.som_step.k14_cluster) takes one tile: CTA rank r
// takes the contiguous update chunks [r nu / c, (r + 1) nu / c) and sums
// them in chunk order into float32 registers as the walk does (acc = W.X,
// its threads' wsum, then wsum_lanes).  The ranks then exchange their
// partial sums through distributed shared memory: each writes its acc
// (float4 a thread and column block) into its tile region, which the
// blended rows take next, and its rows' wsum into m2s; a cluster barrier;
// each reads the c partials in rank order and adds them (the first copied,
// the others added), so every rank holds the same floats; it also reads its
// threads' old codebook entries; a second barrier, after which no CTA reads
// another's shared memory or an entry of the codebook it has not yet
// written.  Every rank then blends the tile's 128 rows (each rank writes the
// rows of its warps w, w % c == r, to the codebook; all keep them in their
// tile) and scores its contiguous share of the next batch's 64-sample winner
// chunks against the whole tile; the winners' fold (packed-u64 atomicMin) is
// order-free.  At c = 1 the exchange copies each sum to itself: the
// codebook, winners and values are the mma.sync K14's bit for bit.  At c > 1
// the batch sum is reassociated at c - 1 points (per row and feature: the
// partial of each range in chunk order, the partials in rank order), so the
// codebook differs from c = 1 by float32 rounding only, and reruns are
// bit-equal (every sum in a fixed order, whatever the CTAs' timing).  The
// producer thread takes part in the two cluster barriers (a thread that has
// not exited counts): it streams the rank's update chunks, then as many
// winner items as the ring holds, whose slots the update walk frees before
// its consumers reach the first barrier, then the two barriers, then the
// rest.  The producer warpgroup's other threads have exited by then.
//
// What bounds it on H100: the two contractions, 4 noc B D FLOPs, as 12 noc
// B D TF32 FLOPs (4 noc B D under batch_bf16) at 495 TFLOP/s, and each CTA's
// L2 reads of its share of both batches and of the tables.  K13's W is a
// product (gaussian) or a sum and a compare (bubble) of two table entries,
// a handful of instructions against K3's 27 a value.  The exchange moves 2
// DP (TN + 1) floats a CTA per rank through distributed shared memory.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "fused_step_sm90.cuh"
#include "fused_step_tc.cuh"  // blend_rows_tc, wsum_lanes, m2_lanes
#include "separable_w.cuh"    // StepArgs, launch_tables

namespace {

using namespace fs90;

// W from the separable tables: pat (n_pat, Bp), ytab (ydim, Bp), aw (Bp,)
// as the table launch wrote them, rows of Bp (B rounded up to 64) entries,
// the samples past B written with alpha 0, so that every chunk reads whole
// with no test: their W is +0, the mma.sync kernels' 0 past the batch.  Built
// a chunk at a time for the thread's rows g and g + 8 (their x-pattern and
// y-factor rows at element offsets po, yo; a row past noc reads row noc - 1's,
// and its sums are never blended or scored) and samples 8 ks + t + 4 e of
// the chunk; P 1 (K14's batch_bf16): the A fragment is W rounded to bf16.
// The table pointers start at the CTA's first update chunk.  With a test per
// value and per row the DP 128 walk spilled
template <bool kGauss, int P>
struct SeparableW90 {
  const float* pat;
  const float* ytab;
  const float* aw;
  float r2;
  int po[2], yo[2];
  float wsum[2];

  __device__ __forceinline__ void build(float (&hi)[4][4], float (&lo)[4][4],
                                        const unsigned char*, int c) {
    const int t = threadIdx.x & 3;
    // w[ks][q]: a0 (row g, sample t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
    // t + 4) of k step ks
    float w[UC / 8][4];
#pragma unroll
    for (int ks = 0; ks < UC / 8; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = c * UC + 8 * ks + t + 4 * (q >> 1), h = q & 1;
        const float wx = __ldg(pat + po[h] + s), wy = __ldg(ytab + yo[h] + s);
        if constexpr (kGauss) {
          w[ks][q] = wx * wy;
        } else {
          w[ks][q] = wx + wy <= r2 ? __ldg(aw + s) : 0.f;
        }
      }
#pragma unroll
    for (int ks = 0; ks < UC / 8; ++ks) {
      wsum[0] += w[ks][0];
      wsum[0] += w[ks][2];
      wsum[1] += w[ks][1];
      wsum[1] += w[ks][3];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (P == 2) {
          split_tf32(w[ks][q], hi[ks][q], lo[ks][q]);
        } else {
          hi[ks][q] = bf16_round(w[ks][q]);
        }
      }
    }
  }
};

// [lo, hi) of n items split into c contiguous ranges: range r's
__host__ __device__ __forceinline__ int range_lo(int n, int c, int r) { return r * n / c; }

// The split's producer thread: the rank's nu update chunks from chunk c0,
// then its nw winner chunks from chunk w0 in NSLAB items each, with the
// cluster's two barriers after the first ring-full of winner items (all in
// slots the update walk frees)
template <class L, int P>
__device__ __forceinline__ void produce_split(Ring r, const CUtensorMap* xt,
                                              const CUtensorMap* xnr, int c0, int nu, int w0,
                                              int nw, int Bnp) {
  for (int c = 0; c < nu; ++c) {
    sm90::mbar_wait(&r.empty[r.s], r.phase ^ 1);
    sm90::mbar_arrive_expect_tx(&r.full[r.s], L::UPD);
    unsigned char* slot = r.slot();
#pragma unroll
    for (int p = 0; p < P; ++p)
      sm90::tma_load_2d(slot + p * L::UPD_PLANE, xt, &r.full[r.s], (c0 + c) * UC,
                        p * (L::KCT * CHUNK));
    r.advance();
  }
  const int items = nw * L::NSLAB;
  for (int i = 0; i < items; ++i) {
    if (i == L::STAGES) {
      sm90::cluster_sync_thread();
      sm90::cluster_sync_thread();
    }
    const int n = w0 + i / L::NSLAB, sl = i % L::NSLAB;
    sm90::mbar_wait(&r.empty[r.s], r.phase ^ 1);
    sm90::mbar_arrive_expect_tx(&r.full[r.s], L::WIN);
    unsigned char* slot = r.slot();
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int kc = 0; kc < L::KCW; ++kc)
        sm90::tma_load_2d(slot + (p * L::KCW + kc) * L::WIN_CHUNK, xnr, &r.full[r.s],
                          sl * L::WS + kc * CHUNK, p * Bnp + n * WC);
    r.advance();
  }
  if (items <= L::STAGES) {
    sm90::cluster_sync_thread();
    sm90::cluster_sync_thread();
  }
}

// The split's exchange: acc and wsum become the cluster's sums, the ranks'
// partials added in rank order; old gets the thread's entries of the
// codebook as they were, read before any rank writes them
template <int DP, typename CT>
__device__ __forceinline__ void exchange_partials(float (&acc)[DP / 8][4], float (&wsum)[2],
                                                  float (&old)[DP / 8][4],
                                                  unsigned char* tile, float* m2s,
                                                  const CT* __restrict__ codes, int noc,
                                                  int D, int r0, int nc) {
  constexpr int NT = DP / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float4* part = reinterpret_cast<float4*>(tile);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    part[j * ALL + threadIdx.x] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) m2s[16 * warp + g + 8 * h] = wsum[h];
  }
  sm90::cluster_sync();
  const uint32_t pa = sm90::smem_u32(part + threadIdx.x);
  const uint32_t wa = sm90::smem_u32(m2s + 16 * warp + g);
  for (int r = 0; r < nc; ++r) {
    const uint32_t pr = sm90::cluster_map(pa, r), wr = sm90::cluster_map(wa, r);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 v = sm90::ld_cluster_v4(pr + 16 * ALL * j);
      if (r == 0) {
        acc[j][0] = v.x;
        acc[j][1] = v.y;
        acc[j][2] = v.z;
        acc[j][3] = v.w;
      } else {
        acc[j][0] += v.x;
        acc[j][1] += v.y;
        acc[j][2] += v.z;
        acc[j][3] += v.w;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float w = sm90::ld_cluster_f32(wr + 32 * h);
      wsum[h] = r == 0 ? w : wsum[h] + w;
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int u = r0 + 16 * warp + g + 8 * (q >> 1), k = 8 * j + 2 * t + (q & 1);
      old[j][q] = (k < D && u < noc) ? load_f32(codes + (size_t)u * D + k) : 0.f;
    }
  sm90::cluster_sync();
}

// Row r, feature k of the tile for the winners: split (P 2) or rounded to
// bf16 (P 1)
template <int DP, int P>
__device__ __forceinline__ void store_tile(unsigned char* tile, int r, int k, float v) {
  if constexpr (P == 2) {
    float hi, lo;
    split_tf32(v, hi, lo);
    *reinterpret_cast<float*>(tile + tile_offset<DP>(0, r, k)) = hi;
    *reinterpret_cast<float*>(tile + tile_offset<DP>(1, r, k)) = lo;
  } else {
    *reinterpret_cast<float*>(tile + tile_offset<DP>(0, r, k)) = bf16_round(v);
  }
}

// One step of the walk for the CTA's tile (the cluster's, under kSplit)
template <int DP, bool kGauss, int P, bool kSplit, typename CT>
__device__ __forceinline__ void separable_walk(const CUtensorMap* xt_map,
                                              const CUtensorMap* xn_map,
                                              CT* __restrict__ codes, int noc, int D, int B,
                                              int Bn, int xdim, int hexa, float radius,
                                              const float* __restrict__ pat,
                                              const float* __restrict__ ytab,
                                              const float* __restrict__ aw,
                                              unsigned long long* __restrict__ keys) {
  using L = Layout<DP, P, false>;
  constexpr int NT = DP / 8;
  static_assert(!kSplit || NT * ALL * 16 <= L::TILE, "a rank's partials fit in its tile");
  unsigned char* tile;
  float* m2s;
  Ring ring = setup<L>(tile, m2s);
  const int nc = kSplit ? (int)sm90::cluster_size() : 1;
  const int rank = kSplit ? (int)sm90::cluster_rank() : 0;
  const int nu_all = (B + UC - 1) / UC, nw_all = (Bn + WC - 1) / WC;
  const int c0 = range_lo(nu_all, nc, rank), nu = range_lo(nu_all, nc, rank + 1) - c0;
  const int w0 = range_lo(nw_all, nc, rank), nw = range_lo(nw_all, nc, rank + 1) - w0;
  if (threadIdx.x >= ALL) {  // the producer warpgroup: one thread
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == ALL) {
      if constexpr (kSplit)
        produce_split<L, P>(ring, xt_map, xn_map, c0, nu, w0, nw, round_up(Bn, 64));
      else
        produce<L, P>(ring, xt_map, xn_map, nullptr, nu, nw, round_up(Bn, 64));
    }
    return;
  }
  sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (blockIdx.x / nc) * TN;

  // ---- update (of the rank's chunks): acc = W.X, wsum = W.1 -----------------
  SeparableW90<kGauss, P> wb;
  wb.pat = pat + c0 * UC;
  wb.ytab = ytab + c0 * UC;
  wb.aw = aw + c0 * UC;
  wb.r2 = radius * radius;
  const int Bp = round_up(B, 64);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = min(r0 + 16 * warp + g + 8 * h, noc - 1);
    const int row = u / xdim, col = u - row * xdim;
    wb.po[h] = ((hexa ? (row & 1) * xdim : 0) + col) * Bp;
    wb.yo[h] = row * Bp;
    wb.wsum[h] = 0.f;
  }
  float acc[NT][4];
  if (!kSplit || nu > 0) {
    update_walk<DP, P>(acc, wb, ring, nu, consumer_wg(), lane);
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  }
  wsum_lanes(wb.wsum);

  // ---- the blend, written in place; the tile kept for the winners -----------
  if constexpr (kSplit) {
    float old[NT][4];
    exchange_partials<DP>(acc, wb.wsum, old, tile, m2s, codes, noc, D, r0, nc);
    const bool mine = warp % nc == rank;
    float sq[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int h = q >> 1, r = 16 * warp + g + 8 * h, k = 8 * j + 2 * t + (q & 1);
        const int u = r0 + r;
        float v = 0.f;
        if (k < D && u < noc) {
          v = guarded_blend(old[j][q], acc[j][q], wb.wsum[h]);
          if (mine) store_f32(codes + (size_t)u * D + k, v);
        }
        sq[h] += v * v;
        store_tile<DP, P>(tile, r, k, v);
      }
    m2_lanes(sq, m2s);
  } else {
    blend_rows_tc<NT, 2 * CONSUMERS * 4>(
        acc, wb.wsum, codes, noc, D, r0, m2s,
        [&](int r, int k, float v) { store_tile<DP, P>(tile, r, k, v); });
  }
  // ||m||^2 +inf past noc: such a row's d is +inf, and a row of the CTA below
  // noc comes first on equal values
  const int rows = noc - r0;
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (16 * warp + g + 8 * h >= rows) m2s[16 * warp + g + 8 * h] = INFINITY;
  }
  sm90::fence_proxy_async();
  sm90::bar_sync(1, ALL);  // the tile and m2s written

  // ---- next batch's winners (the rank's share) against the updated tile -----
  winner_walk<L, P>(ring, tile, nw, consumer_wg(), lane, [&](float (&S)[64], int n0) {
    argmin_fold(S, w0 * WC + n0, m2s, keys, Bn, r0, warp, lane);
  });
}

// The walk's kernels, one name each for the profile: K13's and K14's
template <int DP, bool kGauss, typename CT>
__global__ void __launch_bounds__(THREADS, 1)
som_fused_factored_sm90_kernel(const __grid_constant__ CUtensorMap xt_map,
                               const __grid_constant__ CUtensorMap xn_map,
                               CT* __restrict__ codes, int noc, int D, int B, int Bn,
                               int xdim, int hexa, float radius,
                               const float* __restrict__ pat,
                               const float* __restrict__ ytab,
                               const float* __restrict__ aw,
                               unsigned long long* __restrict__ keys) {
  separable_walk<DP, kGauss, 2, false, CT>(&xt_map, &xn_map, codes, noc, D, B, Bn, xdim, hexa,
                                           radius, pat, ytab, aw, keys);
}

template <int DP, bool kGauss, int P, typename CT>
__global__ void __launch_bounds__(THREADS, 1)
som_chunked_sm90_kernel(const __grid_constant__ CUtensorMap xt_map,
                        const __grid_constant__ CUtensorMap xn_map, CT* __restrict__ codes,
                        int noc, int D, int B, int Bn, int xdim, int hexa, float radius,
                        const float* __restrict__ pat, const float* __restrict__ ytab,
                        const float* __restrict__ aw, unsigned long long* __restrict__ keys) {
  separable_walk<DP, kGauss, P, true, CT>(&xt_map, &xn_map, codes, noc, D, B, Bn, xdim, hexa,
                                          radius, pat, ytab, aw, keys);
}

template <int DP, bool kGauss, int P, bool kSplit, typename CT>
auto separable_kernel() {
  static_assert(kSplit || P == 2, "K13 runs the split-TF32 planes");
  if constexpr (kSplit)
    return som_chunked_sm90_kernel<DP, kGauss, P, CT>;
  else
    return som_fused_factored_sm90_kernel<DP, kGauss, CT>;
}

// The launch of `tiles` tiles of the walk at its opt-in shared memory, under
// kSplit on clusters of `cluster` CTAs a tile (attr: the config's one
// attribute), or a CUDA error
template <int DP, bool kGauss, int P, bool kSplit, typename CT>
int walk_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int tiles, int cluster,
                cudaStream_t stream) {
  using L = Layout<DP, P, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(separable_kernel<DP, kGauss, P, kSplit, CT>(),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = {};
  cfg.gridDim = dim3(tiles * cluster);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = kSplit ? 1 : 0;
  return 0;
}

template <int DP, bool kGauss, int P, bool kSplit, typename CT>
int launch_walk(const StepArgs& a, int cluster) {
  CUtensorMap xt, xnr;
  int rc = encode_maps<P>(&xt, &xnr, nullptr, a.xs, a.B, a.Bn, DP);
  if (rc) return rc;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  rc = walk_config<DP, kGauss, P, kSplit, CT>(cfg, attr, (a.noc + TN - 1) / TN, cluster,
                                              a.stream);
  if (rc) return rc;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, separable_kernel<DP, kGauss, P, kSplit, CT>(), xt, xnr, static_cast<CT*>(a.codes),
      a.noc, a.D, a.B, a.Bn, a.xdim, a.hexa, a.radius, static_cast<const float*>(a.pat),
      static_cast<const float*>(a.ytab), static_cast<const float*>(a.aw), a.keys);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The prologue (both batches split, or under P 1 rounded to bf16; no
// per-sample table), then the walk at the batch width DP (under kSplit on
// clusters of `cluster` CTAs a tile)
template <int P, bool kSplit, typename CT>
int separable_sm90(const StepArgs& a, int cluster) {
  const int DP = dp_of(a.D);
  if (!(cluster == 1 || (kSplit && (cluster == 2 || cluster == 4 || cluster == 8))))
    return (int)cudaErrorInvalidValue;
  const int rc = split_sm90<float, P, false, P == 1>(a.xb, a.B, a.xn, a.Bn, a.D, DP, a.xs,
                                                     nullptr, nullptr, a.xdim, a.hexa,
                                                     a.stream);
  if (rc) return rc;
#define SEPARABLE_WALK(W)                                                       \
  if (DP == W)                                                                  \
    return a.gaussian ? launch_walk<W, true, P, kSplit, CT>(a, cluster)         \
                      : launch_walk<W, false, P, kSplit, CT>(a, cluster);
  SEPARABLE_WALK(32)
  SEPARABLE_WALK(64)
  SEPARABLE_WALK(128)
#undef SEPARABLE_WALK
  return (int)cudaErrorInvalidValue;
}

// K14's main form: its prologue and walk for batch_bf16 (P 1) or not (P 2)
template <typename CT>
int k14_sm90(const StepArgs& a, int batch_bf16, int cluster) {
  return batch_bf16 ? separable_sm90<1, true, CT>(a, cluster)
                    : separable_sm90<2, true, CT>(a, cluster);
}

// One step, as each C entry runs it: the checks, the table launch (rows of
// Bp = B rounded up to 64, the x-pattern rounded to bf16 and kept as float32
// under wxa_bf16, gaussian only; it also sets the winner keys), walk(a) (the
// prologue and the walk), the keys unpacked into val and idx.  The walk's
// table offsets are 32-bit: (n_pat + ydim) Bp elements
template <class Walk>
int separable_step(const StepArgs& a, int wxa_bf16, float* val, int* idx, Walk walk) {
  const int Bp = round_up(a.B, 64);
  if (a.noc <= 0 || a.D <= 0 || dp_of(a.D) == 0 || a.B <= 0 || a.Bn <= 0 || a.xdim <= 0 ||
      !a.xs || (wxa_bf16 && !a.gaussian) || (reinterpret_cast<uintptr_t>(a.xs) & 15) != 0 ||
      (int64_t)(2 * a.xdim + (a.noc + a.xdim - 1) / a.xdim) * Bp > INT_MAX)
    return (int)cudaErrorInvalidValue;
  int rc = wxa_bf16 ? launch_tables<float, true>(a, Bp) : launch_tables<float>(a, Bp);
  if (!rc) rc = walk(a);
  if (rc) return rc;
  unpack_keys<<<(a.Bn + 255) / 256, 256, 0, a.stream>>>(a.keys, a.Bn, val, idx);
  return (int)cudaGetLastError();
}

}  // namespace
