// K7 on Hopper: K SOM training steps in one persistent launch, for D <= 128
// (wider D: som_vmem_steps.cu's mma.sync kernel, the route
// ops.som_vmem.k7_route names), each step K3's Hopper walk
// (fused_step_sm90.cuh) on the codebook rows its tile keeps on chip.
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_vmem_steps_kernel (:1449,
// wrapper som_vmem_train_steps :1525), as som_vmem_steps.cu does past D 128.
//
// What bounds it on H100: the two contractions of each step, W.X and the
// scores, 4 noc B D FLOPs a step as split TF32 (12 noc B D K TF32 FLOPs at
// 495 TFLOP/s: 0.1041 ms at 4096 rows, B 512, D 64, K 32); beside them K3's
// W values (noc B a step, each a grid distance, an expf, a split and a wsum
// add, on every rank of a tile) and the step's grid barrier.  A map this
// path takes has few rows (4096 rows are 32 tiles of 128 for 132 SMs) and
// each step walks its whole batch in order, so a step is latency-bound.
//
// The design.  One cooperative launch of K steps: CTA (tile, rank) keeps its
// tile's 128 rows, split into TF32 hi and lo in the swizzled K-major layout
// of K3's winners, in shared memory for the whole launch, and the float32
// rows stay in the codebook (in L2: each tile's rows are read and written
// only by its CTAs); one grid-wide barrier ends each step.  A prologue
// (split_steps_kernel) splits all K + 1 batches of the launch once, each
// batch as the update's transposed planes (DP, Bp) and as the winners' rows
// (Bp, DP) (split_sm90_kernel's two forms).  Step s, per CTA:
//   * a producer warp streams by TMA the step's 32-sample update chunks of
//     batch s, then its share of batch s + 1's 64-sample winner chunks, into
//     K3's ring, and writes K3's per-sample table of each update chunk (BMU
//     grid x and row, alpha) into its slot from bmu0 (s = 0) or from the
//     keys step s - 1 folded, once the grid barrier has passed (it polls the
//     barrier's generation); it goes on from step s's winner chunks straight
//     into step s + 1's first ring-full of update chunks, so those loads are
//     in flight while the CTAs wait at the barrier;
//   * the two consumer warpgroups run K3's update walk (update_walk with
//     ClosedFormW90, TF32 wgmma) on the rank's slab of features, wsum in
//     K3's order, then the guarded blend of the slab into the codebook
//     (without a cluster, blend_pass_tc's: the tile split and ||m||^2 summed
//     as the slab blends);
//   * after a cluster barrier (the ranks' slabs written), each rank reads
//     the tile's rows back (its own slab from its registers, the others'
//     from L2), splits them into the tile and takes ||m||^2 in K3's order
//     (blend_rows_tc's), then runs K3's winner walk (winner_walk,
//     argmin_fold) on its share of batch s + 1's chunks against all 128
//     rows, folding each sample's packed (value, row) key across CTAs;
//   * the grid barrier.
// The keys rotate over three buffers, as the mma.sync K7's.
//
// The split.  A 128-row tile's work goes to a thread-block cluster of c CTAs
// (1; 2 past D 32; 4 past D 64): rank r updates and blends features r DP /
// c.. over the whole batch (its own W: the same floats in every rank; in
// passes of F = 64 features where DP / c is 128, since the walk's
// accumulators and W's two fragment sets at 128 beside the step loop's
// state spilled) and scores its contiguous share of the winner chunks.  Neither
// changes a float: a component's sum runs over the batch alone, and a
// sample's score is a sum over the features of one row.  So the codebook
// and winners are K chained K3 steps' bit for bit at every c
// (ops.som_vmem.k7_rows picks c from the tiles and the card; chip_smoke.py
// holds every c to the K3 chain), and two runs are bit-equal.  The grid
// (tiles x c CTAs, one an SM) must be resident at once for the grid
// barrier: the launch is cooperative, with the cluster dimension beside it,
// and returns cudaErrorCooperativeLaunchTooLarge where it cannot be
// (nothing falls back).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "argmin_keys.cuh"
#include "fused_step_sm90.cuh"
#include "fused_step_tc.cuh"  // blend_rows_tc, wsum_lanes, m2_lanes

namespace {

using namespace fs90;

// Shared memory of a CTA of K7's walk whose update takes F of the tile's DP
// features a pass: K3's layout (Layout: the tile, m2s, winner items of
// both planes) with update slots of F feature rows of 32 samples of both
// planes, then K3's table (32 float4)
template <int DP, int F>
struct VmemLayout : Layout<DP, 2, false> {
  using Base = Layout<DP, 2, false>;
  static constexpr int UPD_PLANE = F * UC * 4;
  static constexpr int TABLE = 2 * UPD_PLANE;
  static constexpr int UPD = TABLE + UC * 16;
  static constexpr int SLOT = round_up(max_of(UPD, Base::WIN), ALIGN);
  static constexpr int STAGES = min_of(MAX_STAGES, (SMEM_MAX - Base::FIXED) / SLOT);
  static constexpr int BYTES = Base::FIXED + STAGES * SLOT;
  static_assert(STAGES >= 2, "the ring needs two slots");
};

// The launch's arguments, one kernel parameter
struct VmemArgs {
  float* codes;  // (noc, D) float32, updated in place
  int noc, D, K, B;
  const int* bmu0;       // (B,) winners of batch 0
  const float* alphas;   // (K, B)
  const float* radii;    // (K,)
  int xdim, hexa, gaussian;
  unsigned long long* keys;  // (3, B) key buffers
  unsigned int* bar;         // grid barrier: count, generation
  int* bmu_out;              // (B,) winners of the tail
};

// The prologue: every batch of the launch split once into TF32 hi and lo,
// the update's form of batches 0..K-1, then the winners' form of batches
// 1..K (batch K: the tail): xT, batch t's plane p (DP, Bp) at rows (2 t + p)
// DP of a (2 K DP, Bp) array; then xr, batch t's plane p (Bp, DP) at rows
// (2 (t - 1) + p) Bp of a (2 K Bp, DP) array; zeros past D and past B.  One
// thread an entry of both planes
__global__ void split_steps_kernel(const float* __restrict__ batches, int K, int B,
                                   const float* __restrict__ tail, int D, int DP, int Bp,
                                   float* __restrict__ xs) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t plane = (int64_t)DP * Bp, half = (int64_t)K * plane;
  if (e >= 2 * half) return;
  const bool rows = e >= half;
  const int64_t i = rows ? e - half : e;
  const int t = (int)(i / plane);
  const int64_t w = i - t * plane;
  const int b = rows ? (int)(w / DP) : (int)(w % Bp);
  const int k = rows ? (int)(w % DP) : (int)(w / Bp);
  const float* x = !rows ? batches + (size_t)t * B * D
                         : t + 1 < K ? batches + (size_t)(t + 1) * B * D : tail;
  const float v = (b < B && k < D) ? x[(size_t)b * D + k] : 0.f;
  float* dst = xs + (rows ? 2 * half : 0) + 2 * t * plane + w;
  split_tf32(v, dst[0], dst[plane]);
}

// Grid-wide barrier of the consumer threads (the producer warp does not take
// part; it reads the generation): bar[0] counts arrivals, bar[1] is the
// generation, read by thread 0 before it arrives (it cannot move before
// every CTA has).  The last CTA to arrive resets the count and starts the
// next generation; the others wait for it.  Valid because the cooperative
// launch keeps every CTA resident.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  sm90::bar_sync(1, ALL);
  if (threadIdx.x == 0) {
    volatile unsigned int* vgen = bar + 1;
    const unsigned int gen = *vgen;
    __threadfence();  // this CTA's writes before its arrival
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*vgen == gen) __nanosleep(32);
    }
    __threadfence();
  }
  sm90::bar_sync(1, ALL);
}

// The producer warp (every lane): for each step s, the CTA's NP passes of nu
// update chunks of batch s (pass p: the F-feature slab f0 + p F of both
// planes by lane 0's TMA, then K3's table of the chunk's 32 samples, one a
// lane), then the rank's winner chunks w0.. of batch s + 1 in NSLAB items.
// A slot's fill completes with the 32 lanes' arrivals and the copies'
// bytes.  A step's first ring-full of update chunks is copied before its
// table can be written (the keys of batch s are final once the grid barrier
// of step s - 1 has passed: generation s + 1), so those copies run while
// the CTAs wait at the barrier.  Each lane loads its sample's winner and
// alpha LA chunks ahead of the chunk it writes, so the L2's latency stays
// off the ring (LA 2: at 4 the walk's DP 128 instance spilled).  With a
// cluster (NC > 1) the warp joins each step's cluster barrier after its
// first ring-full of winner items, in slots the update walk frees before
// the consumers reach that barrier.
template <class L, int DP, int F, int NC, int NP>
__device__ __forceinline__ void produce_steps(Ring r, const CUtensorMap* xt,
                                              const CUtensorMap* xr, const VmemArgs& a,
                                              int f0, int w0, int nw) {
  constexpr int LA = 2;
  const int lane = threadIdx.x & 31;
  const int B = a.B, Bp = round_up(B, 64), nu = (B + UC - 1) / UC, nt = NP * nu;
  const int first = min(nt, L::STAGES), items = nw * L::NSLAB;
  const bool hexa = a.hexa != 0;
  // update chunk i (pass i / nu, chunk i % nu) of batch s into r's slot
  auto load_x = [&](int i, int s) {
    sm90::mbar_wait(&r.empty[r.s], r.phase ^ 1);
    if (lane == 0) {
      sm90::mbar_expect_tx(&r.full[r.s], 2 * L::UPD_PLANE);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        sm90::tma_load_2d(r.slot() + p * L::UPD_PLANE, xt, &r.full[r.s], (i % nu) * UC,
                          (2 * s + p) * DP + f0 + (i / nu) * F);
    }
    r.advance();
  };
  for (int s = 0; s < a.K; ++s) {
    Ring q = r;  // the slot whose table comes next
    for (int i = 0; i < first; ++i) load_x(i, s);
    if (s > 0) {  // the grid barrier of step s - 1 passed
      while (*reinterpret_cast<volatile unsigned int*>(a.bar + 1) < (unsigned int)(s + 1))
        __nanosleep(64);
      __threadfence();
    }
    // the lane's sample of update chunk i: its winner (bmu0 at s = 0, else
    // the key step s - 1 folded; -1 past B) and alpha, into register j
    const unsigned long long* kc = a.keys + (size_t)(s % 3) * B;
    const float* al = a.alphas + (size_t)s * B;
    int bm[LA];
    float aw[LA];
    auto fetch = [&](int i, int j) {
      const int b = (i % nu) * UC + lane;
      const bool on = i < nt && b < B;
      bm[j] = !on      ? -1
              : s == 0 ? a.bmu0[b]
                       : (int)(unsigned int)(__ldcg(kc + b) & 0xffffffffull);
      aw[j] = on ? al[b] : 0.f;
    };
#pragma unroll
    for (int j = 0; j < LA; ++j) fetch(j, j);
    for (int i0 = 0; i0 < nt; i0 += LA) {
#pragma unroll
      for (int j = 0; j < LA; ++j) {
        const int i = i0 + j;
        if (i < nt) {
          if (i >= first) load_x(i, s);
          // split_sm90_kernel's float4, then the lane's arrival
          const int m = bm[j];
          reinterpret_cast<float4*>(q.slot() + L::TABLE)[lane] =
              m >= 0 ? make_float4(grid_x(m % a.xdim, m / a.xdim, hexa), (float)(m / a.xdim),
                                   aw[j], 0.f)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
          sm90::fence_proxy_async();
          sm90::mbar_arrive(&q.full[q.s]);
          q.advance();
          fetch(i + LA, j);
        }
      }
    }
    for (int i = 0; i < items; ++i) {
      if (NC > 1 && i == L::STAGES) sm90::cluster_sync();
      const int n = w0 + i / L::NSLAB, sl = i % L::NSLAB;
      sm90::mbar_wait(&r.empty[r.s], r.phase ^ 1);
      if (lane == 0) {
        sm90::mbar_expect_tx(&r.full[r.s], L::WIN);
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int kc = 0; kc < L::KCW; ++kc)
            sm90::tma_load_2d(r.slot() + (p * L::KCW + kc) * L::WIN_CHUNK, xr, &r.full[r.s],
                              sl * L::WS + kc * CHUNK, (2 * s + p) * Bp + n * WC);
      }
      sm90::mbar_arrive(&r.full[r.s]);
      r.advance();
    }
    if (NC > 1 && items <= L::STAGES) sm90::cluster_sync();
  }
}

// The update's slab width of the walk at DP features over NC CTAs a tile:
// DP / NC, at most 64 (at 128 a thread's accumulators and W's two fragment
// sets beside the step loop's state spilled), and the passes a CTA runs
// over its DP / NC features
__host__ __device__ constexpr int slab_of(int DP, int NC) { return min_of(64, DP / NC); }

// CTA blockIdx.x: rank blockIdx.x % NC of tile blockIdx.x / NC
template <int DP, int NC>
__global__ void __launch_bounds__(THREADS, 1)
som_vmem_steps_sm90_kernel(const __grid_constant__ CUtensorMap xt_map,
                           const __grid_constant__ CUtensorMap xr_map,
                           const __grid_constant__ VmemArgs a) {
  constexpr int F = slab_of(DP, NC), NP = DP / (NC * F), NTF = F / 8, NTD = DP / 8;
  static_assert(NC == 1 || NP == 1, "a cluster's rank takes one slab");
  using L = VmemLayout<DP, F>;
  unsigned char* tile;
  float* m2s;
  Ring ring = setup<L, 32>(tile, m2s);
  const int rank = NC > 1 ? (int)(blockIdx.x % NC) : 0;
  const int r0 = (int)(blockIdx.x / NC) * TN;
  const int noc = a.noc, D = a.D, B = a.B;
  const int nu = (B + UC - 1) / UC, nw_all = (B + WC - 1) / WC;
  const int w0 = rank * nw_all / NC, nw = (rank + 1) * nw_all / NC - w0;
  if (threadIdx.x >= ALL) {  // the producer warpgroup: one warp
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < ALL + 32)
      produce_steps<L, DP, F, NC, NP>(ring, &xt_map, &xr_map, a, rank * F, w0, nw);
    return;
  }
  sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* codes = a.codes;
  // the key buffer k reset by the grid's consumer threads
  auto reset = [&](int k) {
    for (int b = blockIdx.x * ALL + threadIdx.x; b < B; b += gridDim.x * ALL)
      a.keys[(size_t)k * B + b] = ~0ull;
  };
  reset(1);  // step 0 folds into buffer 1
  grid_barrier(a.bar);

  for (int s = 0; s < a.K; ++s) {
    reset((s + 2) % 3);
    float sq[2] = {0.f, 0.f};  // this thread's part of ||m||^2, blend_rows_tc's
    float nc[NC > 1 ? NTF : 1][4];
#pragma unroll 1
    for (int p = 0; p < NP; ++p) {
      // ---- update of the slab: acc = W.X, wsum = W.1 ---------------------------
      ClosedFormW90<L::TABLE> wb;
      wb.init(r0 + 16 * warp + g, a.xdim, a.hexa != 0, a.gaussian != 0, a.radii[s]);
      float acc[NTF][4];
      update_walk<F, 2>(acc, wb, ring, nu, consumer_wg(), lane);
      wsum_lanes(wb.wsum);

      // ---- the blend in place; without a cluster the tile split as it goes --
      if constexpr (NC == 1) {
        // K3's blend_rows_tc over the passes: the columns p F.., ||m||^2
        // summed on in order
        blend_pass_tc<NTF, 2 * CONSUMERS * 4>(
            acc, wb.wsum, codes, noc, D, p * F, r0, sq, [&](int r, int k, float v) {
              float hi, lo;
              split_tf32(v, hi, lo);
              *reinterpret_cast<float*>(tile + tile_offset<DP>(0, r, p * F + k)) = hi;
              *reinterpret_cast<float*>(tile + tile_offset<DP>(1, r, p * F + k)) = lo;
            });
      } else {
        // the rank's slab, c0 (row g, component 2t), c1 (g, 2t + 1), c2, c3:
        // row g + 8; 0 past D and past noc, as blend_pass_tc's
#pragma unroll
        for (int j = 0; j < NTF; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int u = r0 + 16 * warp + g + 8 * (q >> 1);
            const int k = rank * F + 8 * j + 2 * t + (q & 1);
            float v = 0.f;
            if (k < D && u < noc) {
              float* cp = codes + (size_t)u * D + k;
              v = guarded_blend(*cp, acc[j][q], wb.wsum[q >> 1]);
              *cp = v;
            }
            nc[j][q] = v;
          }
      }
    }
    if constexpr (NC > 1) {
      __threadfence();
      sm90::cluster_sync();  // every rank's slab written
      // the tile's rows, each thread's values in blend_pass_tc's order, and
      // ||m||^2 from them as blend_rows_tc sums it
#pragma unroll
      for (int j = 0; j < NTD; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = q >> 1, r = 16 * warp + g + 8 * h, k = 8 * j + 2 * t + (q & 1);
          const int u = r0 + r;
          float v;
          if (j / NTF == rank)
            v = nc[j % NTF][q];
          else
            v = (k < D && u < noc) ? __ldcg(codes + (size_t)u * D + k) : 0.f;
          sq[h] += v * v;
          float hi, lo;
          split_tf32(v, hi, lo);
          *reinterpret_cast<float*>(tile + tile_offset<DP>(0, r, k)) = hi;
          *reinterpret_cast<float*>(tile + tile_offset<DP>(1, r, k)) = lo;
        }
    }
    m2_lanes(sq, m2s);
    // ||m||^2 +inf past noc: such a row's d is +inf, and a row below noc
    // comes first on equal values
    if (t == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (16 * warp + g + 8 * h >= noc - r0) m2s[16 * warp + g + 8 * h] = INFINITY;
    }
    sm90::fence_proxy_async();
    sm90::bar_sync(1, ALL);  // the tile and m2s written

    // ---- batch s + 1's winners (the rank's share) against the tile ---------
    unsigned long long* kn = a.keys + (size_t)((s + 1) % 3) * B;
    winner_walk<L, 2>(ring, tile, nw, consumer_wg(), lane, [&](float (&S)[64], int n0) {
      argmin_fold(S, w0 * WC + n0, m2s, kn, B, r0, warp, lane);
    });

    // ---- every CTA's fold done before any decodes it ---------------------
    grid_barrier(a.bar);
  }
  const unsigned long long* kf = a.keys + (size_t)(a.K % 3) * B;
  for (int b = blockIdx.x * ALL + threadIdx.x; b < B; b += gridDim.x * ALL)
    a.bmu_out[b] = (int)(unsigned int)(__ldcg(kf + b) & 0xffffffffull);
}

// The clusters of NC CTAs (NC 1: CTAs) of the walk at DP resident at once
template <int DP, int NC>
int resident(int& out) {
  using L = VmemLayout<DP, slab_of(DP, NC)>;
  const auto kernel = som_vmem_steps_sm90_kernel<DP, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  if constexpr (NC == 1) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, L::BYTES);
    out = per_sm * sms;
  } else {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = NC;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(NC);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = L::BYTES;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&out, kernel, &cfg);
  }
  return (int)err;
}

// The tensor maps of the prologue's arrays, the residency check, then the
// cooperative launch (with the cluster dimension at NC > 1)
template <int DP, int NC>
int launch_steps(const VmemArgs& a, const float* xs, cudaStream_t stream) {
  constexpr int F = slab_of(DP, NC);
  using L = VmemLayout<DP, F>;
  const int Bp = round_up(a.B, 64), tiles = (a.noc + TN - 1) / TN;
  CUtensorMap xt, xr;
  int rc = sm90::encode_map(&xt, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, xs, 2 * a.K * DP, Bp, UC,
                            F, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!rc)
    rc = sm90::encode_map(&xr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                          xs + (size_t)2 * a.K * DP * Bp, 2 * a.K * Bp, DP, CHUNK, WC,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  int fit = 0;
  rc = resident<DP, NC>(fit);
  if (rc) return rc;
  if (fit < tiles) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = NC;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * NC);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = NC > 1 ? 2 : 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, som_vmem_steps_sm90_kernel<DP, NC>, xt, xr, a);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The walk's instances: DP for D features, NC = `cluster` CTAs a tile (a
// rank's slab F = slab_of(DP, NC) at least 32 features); CALL(DP, NC) on
// the instance, or cudaErrorInvalidValue for a cluster that is not built
// at this D
#define K7_DISPATCH(D, cluster, CALL)                 \
  switch (dp_of(D) * 8 + (cluster)) {                 \
    case 32 * 8 + 1: return CALL(32, 1);              \
    case 64 * 8 + 1: return CALL(64, 1);              \
    case 64 * 8 + 2: return CALL(64, 2);              \
    case 128 * 8 + 1: return CALL(128, 1);            \
    case 128 * 8 + 2: return CALL(128, 2);            \
    case 128 * 8 + 4: return CALL(128, 4);            \
    default: return (int)cudaErrorInvalidValue;       \
  }

int smem_bytes(int D, int cluster) {
#define K7_BYTES(DP, NC) VmemLayout<DP, slab_of(DP, NC)>::BYTES
  K7_DISPATCH(D, cluster, K7_BYTES)
#undef K7_BYTES
}

}  // namespace

// past D 128, the mma.sync kernel's count (som_vmem_steps.cu)
extern "C" int somvq_vmem_mma_smem_bytes(int rows, int B, int D);

// The shared memory (bytes) of K7's CTA: up to D 128 the walk's at
// `cluster` CTAs a 128-row tile (`rows` 128; its resident split rows, the
// ring and ||m||^2, whatever B), past it the mma.sync kernel's CTA of
// `rows` rows owning one tile at B samples (cluster 1); -1 for a shape that
// is not built.  ops.som_vmem.k7_rows passes over one that does not fit
extern "C" int somvq_vmem_smem_bytes(int rows, int cluster, int B, int D) {
  if (B <= 0 || D <= 0) return -1;
  if (dp_of(D) == 0) return cluster == 1 ? somvq_vmem_mma_smem_bytes(rows, B, D) : -1;
  if (rows != TN) return -1;
  const int bytes = smem_bytes(D, cluster);
  return bytes == (int)cudaErrorInvalidValue ? -1 : bytes;
}

// K7's walk at D (<= 128) and `cluster` CTAs a tile: into *out the
// clusters of that size (CTAs at cluster 1) resident at once
extern "C" int somvq_vmem_sm90_clusters(int D, int cluster, int* out) {
  if (D <= 0 || !out) return (int)cudaErrorInvalidValue;
#define K7_RESIDENT(DP, NC) resident<DP, NC>(*out)
  K7_DISPATCH(D, cluster, K7_RESIDENT)
#undef K7_RESIDENT
}

// K7 for D <= 128: codes (noc, D) float32, updated in place; batches (K, B,
// D), tail (B, D): the winners' last batch; cluster: CTAs a 128-row tile (1;
// 2 past D 32; 4 past D 64: ops.som_vmem.k7_clusters); xs: scratch for the split batches, 16-byte
// aligned, 4 K Bp DP floats (B rounded up to a multiple of 64, DP = 32, 64
// or 128, the smallest that covers D); keys: (3 B) u64; bar: two zeroed
// words; bmu_out (B,) the tail's winners
extern "C" int somvq_som_vmem_steps_sm90(float* codes, int noc, int D, const float* batches,
                                         int K, int B, const int* bmu0, const float* alphas,
                                         const float* radii, const float* tail, int xdim,
                                         int hexa, int gaussian, int cluster, float* xs,
                                         unsigned long long* keys, unsigned int* bar,
                                         int* bmu_out, cudaStream_t stream) {
  if (noc <= 0 || D <= 0 || dp_of(D) == 0 || K <= 0 || B <= 0 || xdim <= 0 || !xs ||
      (reinterpret_cast<uintptr_t>(xs) & 15) != 0 ||
      (int64_t)2 * K * round_up(B, 64) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int DP = dp_of(D), Bp = round_up(B, 64);
  const int64_t n = (int64_t)2 * K * DP * Bp;
  split_steps_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(batches, K, B, tail, D,
                                                                       DP, Bp, xs);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const VmemArgs a{codes, noc,  D,    K,        B,    bmu0, alphas,
                   radii, xdim, hexa, gaussian, keys, bar,  bmu_out};
#define K7_LAUNCH(DP, NC) launch_steps<DP, NC>(a, xs, stream)
  K7_DISPATCH(D, cluster, K7_LAUNCH)
#undef K7_LAUNCH
}
