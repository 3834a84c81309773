// K SOM training steps in one launch, the codebook resident on chip
// throughout, for D > 128: a persistent cooperative kernel on K3's
// tensor-core step body.  Up to D 128 K7 runs K3's Hopper walk instead
// (som_vmem_steps_sm90.cu, the route ops.som_vmem.k7_route names); this
// kernel keeps its NT 32 instances (D 129-256, and the feature passes past
// 256).
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_vmem_steps_kernel (wrapper
// som_vmem_train_steps).  The TPU kernel keeps the whole codebook (up to
// 4 MB) in one core's VMEM and runs its grid of K steps in order.  One SM's
// shared memory (227 KB) cannot hold that, so here the codebook is spread
// over the grid: CTA c owns the T consecutive R-row tiles c*T .. c*T+T-1,
// loads them into shared memory once, keeps them there for all K steps, and
// writes them back once after the last.  The grid is at most what can be
// resident at once (occupancy x SM count), launched with
// cudaLaunchCooperativeKernel; a codebook that does not fit returns
// cudaErrorCooperativeLaunchTooLarge (the wrapper raises; nothing falls
// back).
//
// Before the cooperative launch, split_group_kernel splits all K + 1
// batches of the launch (the K batches and the tail, the winners' last
// batch) into TF32 hi and lo once, as K3's split_batches_kernel splits its
// two per step.  Step s, in every CTA:
//   1. the step's W table: per sample of batch s its BMU's grid x and row and
//      its alpha (the float4 K3's ClosedFormW stages per chunk), from bmu0 at
//      s = 0, else from the packed (value, row) keys step s-1 folded;
//   2. for each owned tile, K3's update (group_update: split-TF32 mma.sync
//      per 32-sample chunk added into float32 registers, the fixed-order
//      wsum), then K3's guarded blend into the RESIDENT tile, and ||m||^2
//      per row in K3's order;
//   3. batch s+1's winners against the resident rows, as K3's winner half
//      scores them (A fragments split from the float32 rows into hi and lo,
//      the floats K3 stages; split-TF32 mma.sync per 64-sample chunk, two
//      chunks double-buffered; d = ||m||^2 - 2 S), the (min, first row) over
//      the CTA's rows folded across CTAs into a packed-u64 key per sample
//      (argmin_keys.cuh's order; atomicMin: the smallest value, then the
//      lowest row, in any CTA order);
//   4. wait at a grid-wide barrier.
// The key buffers rotate over three: step s decodes buffer s%3, folds into
// (s+1)%3 and resets (s+2)%3, which every CTA finished decoding before the
// previous barrier; so one barrier per step suffices.  The barrier is a
// generation counter on a global word, valid because the cooperative launch
// guarantees that every CTA is resident.
//
// One launch computes what K chained K3 launches (som_fused_step.cu)
// compute, bit for bit: every float of a row is K3's.  W[row, sample] is
// ClosedFormW's arithmetic on the same staged values; each (row, column) of
// W.X is summed over the same 32-sample chunks and k-steps in the mma, the
// chunks added in batch order; wsum and ||m||^2 are summed in K3's order by
// one warp of the row's m-tile; the scores take the same operands in the
// same k-step order; and the lexicographic (value, row) minimum does not
// depend on the order rows are merged in.
//
// What bounds it on H100: the two contractions of each step, W.X (noc x B x
// D) and the scores (noc x B x D), as split-TF32 mma.sync: 12 noc B D K TF32
// FLOPs against the 495 TFLOP/s peak.  Device memory sees one codebook read
// and write per launch and the split batches, which stay in L2.  A map has
// few rows for 132 SMs (a 4096-row map is 256 m-tiles of 16 rows), and each
// step walks the whole batch in order (B / 32 update chunks, B / 64 winner
// chunks), so K3's layout, one warp per m-tile doing every column, left one
// to four warps per SM, each a long serial chain per chunk: the time did
// not move with the CTA height (PERF.md).  Here each m-tile's work is split
// over CG warps (up to 4): the update's columns (W built once, its k-steps
// split over the CG warps one chunk ahead and shared through shared memory)
// and the winner chunk's samples, so a step runs on up to 16 warps per
// 64-row CTA.  The grid barrier per step costs a few microseconds.
//
// Layout.  A CTA owns R = 16 MT rows (ops.som_vmem.k7_rows picks R from the
// card's times): MT m-tiles of 16 rows and CG column groups, warp cg MT + mt
// for m-tile mt and group cg, each holding the mma's C fragments of its
// m-tile for its n-tiles of the features (update) or of the chunk's samples
// (winners).
//
// Past 256 features (NT 32) a step runs in n_passes(D) feature passes of
// 256, as fused_step_tc.cuh's do: the resident rows are whole (the slabs side
// by side, row stride DTF = stride_nk(256 NP)); pass s updates slab s of the
// tile from the split batch's slab s (W rebuilt, the same floats every pass);
// ||m||^2 runs over every column in order; each winner chunk's scores are
// summed in the mma over the slabs in order, the chunk's slab of x' staged
// for each (no double buffer).  Rows per CTA shrink where whole rows do not
// fit (ops.som_vmem.k7_rows).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "fused_step_tc.cuh"

namespace {

// The launch's arguments, one kernel parameter
struct VmemArgs {
  float* codes;           // (noc, D) float32, updated in place
  int noc, D;
  const float* xs;        // the K + 1 split batches (split_group_kernel)
  int K, B;
  const int* bmu0;        // (B,) winners of batch 0
  const float* alphas;    // (K, B)
  const float* radii;     // (K,)
  int xdim, hexa, gaussian;
  int T;                  // tiles per CTA
  unsigned long long* keys;  // (3, B) key buffers
  unsigned int* bar;      // grid barrier: count, generation
  int* bmu_out;           // (B,) winners of the tail
};

// K3's W (ClosedFormW's values, bit for bit) from a table of the step's
// whole batch staged once per step: per sample its BMU's grid x and row and
// its alpha (float4: x, row, alpha, 0; zero where bmu < 0 and past B), the
// float4 ClosedFormW stages per chunk, so the update's chunks stage nothing
// of their own.  The table is found from the dynamic shared array and an
// offset.
struct GroupW {
  int xdim;
  bool hexa, gaussian;
  float r2, den;
  int tab;              // the table's offset in the shared array (floats)
  float lx[2], fur[2];  // this thread's two rows: grid x and row


  __device__ __forceinline__ const float4* smp() const {
    extern __shared__ __align__(16) float smem[];
    return reinterpret_cast<const float4*>(smem + tab);
  }
  // the thread's rows g and g + 8 of the m-tile from row r0
  __device__ __forceinline__ void init(int r0, int g) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = r0 + g + 8 * h;
      lx[h] = grid_x(u % xdim, u / xdim, hexa);
      fur[h] = (float)(u / xdim);
    }
  }
  // ClosedFormW::w: fragment register q of k-step ks of chunk c, row g +
  // 8 (q & 1), sample 8 ks + t + 4 (q >> 1)
  __device__ __forceinline__ float w(int c, int q, int ks) const {
    const int t = threadIdx.x & 3;
    const float4 sm = smp()[c * kBC + 8 * ks + t + 4 * (q >> 1)];
    const int h = q & 1;
    return weight_of_d2(grid_d2_at(lx[h], fur[h], sm.x, sm.y, hexa), sm.z, gaussian,
                        r2, den);
  }
};

// The CTA: MT m-tiles of 16 rows (R = 16 MT rows) and CG column groups, one
// warp each (warp = cg * MT + mt).  CG = min(4, NT, 16 / MT): the 4 k-steps
// of an update chunk split over at most 4 groups, every group at least one
// 8-feature n-tile, at most 16 warps.
__host__ __device__ constexpr int k7_cg(int NT, int MT) {
  return NT < 4 ? (NT < 16 / MT ? NT : 16 / MT) : (4 < 16 / MT ? 4 : 16 / MT);
}

// Shared memory (floats) of a CTA owning T tiles: the step region, the
// update's staging, x [2 buffers][hi, lo][kBC][DSU] | W [2 buffers][MT][4
// k-steps][32 lanes][4], or after the update two winner chunks x' [2][hi,
// lo][BW][DW] | redv, redi [MT][BW]; then tiles [T][R][DTF] (float32) |
// m2s [T][R] | wsum [R] | the step's W table (float4) [Bc], Bc = B rounded
// up to a multiple of kBC.  DTF, a resident row: DT, or past 256 features
// (the feature passes' instantiation) stride_nk(256 n_passes(D)) (dtf)
template <int NT, int MT>
struct VmemSmem {
  static constexpr int CG = k7_cg(NT, MT), WARPS = MT * CG, R = 16 * MT;
  static constexpr int DP = 8 * NT, BW = k3_bw(NT);
  static constexpr int DSU = stride_kn(DP), DT = stride_nk(DP), DW = DT;
  static constexpr size_t kX = 2 * 2 * (size_t)kBC * DSU;
  static constexpr size_t kUpdate = kX + 2 * (size_t)MT * 4 * 32 * 4;
  static constexpr size_t kWinner = 4 * (size_t)BW * DW + 2 * (size_t)MT * BW;
  static constexpr size_t kStep = kUpdate > kWinner ? kUpdate : kWinner;
  __host__ __device__ static int dtf(int D) { return stride_nk(DP * n_passes(D)); }
  __host__ __device__ static size_t table(int T, int DTF) {
    return kStep + (size_t)T * R * (DTF + 1) + R;
  }
  static size_t bytes(int T, int B, int DTF) {
    return sizeof(float) * (table(T, DTF) + 4 * (size_t)((B + kBC - 1) / kBC * kBC));
  }
};

// Every batch of the launch split once, split_batches_kernel's split per
// batch: batch t (batches[t] for t < K, the tail for t = K) at xs + 2 NP t
// P, slab s (features s DP.., NP n_passes slabs, 1 up to 256 features) at
// + 2 s P, its hi plane then its lo plane, P = Bp DP floats each (Bp: B
// rounded up to a multiple of 64), zero past B and D; one thread per entry
__global__ void split_group_kernel(const float* __restrict__ batches, int K, int B,
                                   const float* __restrict__ tail, int D, int DP, int NP,
                                   int Bp, float* __restrict__ xs) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t plane = (int64_t)Bp * DP, W = (int64_t)NP * DP;
  if (e >= (int64_t)(K + 1) * Bp * W) return;
  const int t = (int)(e / (Bp * W));
  const int64_t i = e - t * Bp * W;
  const int b = (int)(i / W), f = (int)(i % W);
  const float* x = t < K ? batches + (size_t)t * B * D : tail;
  const float v = (b < B && f < D) ? x[(size_t)b * D + f] : 0.f;
  float* hi = xs + 2 * ((int64_t)t * NP + f / DP) * plane + (int64_t)b * DP + f % DP;
  split_tf32(v, hi[0], hi[plane]);
}

// Grid-wide barrier: bar[0] counts arrivals, bar[1] is the generation.  The
// last CTA to arrive resets the count and starts the next generation; the
// others wait for it.  `gen` is the caller's count of barriers passed.
__device__ __forceinline__ void grid_barrier(unsigned int* bar, unsigned int& gen) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* vgen = bar + 1;
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
  ++gen;
  __syncthreads();
}

// K3's update of the rows r0.. of m-tile mt, columns of group cg (n-tiles
// cg NTW .. cg NTW + NTW - 1): acc = W.X in the mma's C layout, and with cg
// 0 wsum[h] = W.1 of row g + 8h over every lane of the row.  Each (row,
// column) is summed as fused_update_tc sums it: per 32-sample chunk in the
// mma over the chunk's 4 k-steps, each chunk's sums added into float32
// registers in batch order; each W value is built by one thread of the
// m-tile (k-steps split over the groups, one chunk ahead) and read by all
// from shared memory, wsum summed from the same values in K3's order (chunk,
// k-step, sample t then t + 4, then a fixed xor tree).  Leaves the step
// region to be read by other threads: the caller synchronizes before reusing
// it.
template <int NT, int MT>
__device__ __forceinline__ void group_update(float (&acc)[NT / k7_cg(NT, MT)][4],
                                             float (&wsum)[2],
                                             const float* __restrict__ xb_hi,
                                             const float* __restrict__ xb_lo, int B,
                                             int r0, GroupW& wp) {
  using L = VmemSmem<NT, MT>;
  constexpr int CG = L::CG, NTW = NT / CG, DP = L::DP, DSU = L::DSU;
  constexpr int THREADS = 32 * L::WARPS, KS = kBC / 8;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp % MT, cg = warp / MT;
  float* xbuf = smem;  // [buffer][hi, lo][kBC][DSU]
  float4* wbuf = reinterpret_cast<float4*>(smem + L::kX);  // [buffer][MT][KS][32]
  wp.init(r0 + 16 * mt, lane >> 2);

#pragma unroll
  for (int j = 0; j < NTW; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  wsum[0] = 0.f;
  wsum[1] = 0.f;

  // this thread's share of chunk c's W fragments: k-steps cg, cg + CG, ...
  auto build_w = [&](int c, int buf) {
#pragma unroll
    for (int ks = cg; ks < KS; ks += CG)
      wbuf[((buf * MT + mt) * KS + ks) * 32 + lane] =
          make_float4(wp.w(c, 0, ks), wp.w(c, 1, ks), wp.w(c, 2, ks), wp.w(c, 3, ks));
  };

  const int nchunks = (B + kBC - 1) / kBC;
  copy_rows<DP>(xbuf, DSU, xb_hi, kBC, tid, THREADS);
  copy_rows<DP>(xbuf + kBC * DSU, DSU, xb_lo, kBC, tid, THREADS);
  cp_async_commit();
  build_w(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    const float* xhi = xbuf + (c & 1) * 2 * kBC * DSU;
    const float* xlo = xhi + kBC * DSU;
    cp_async_wait_all();
    __syncthreads();  // chunk c's rows and W landed; chunk c - 1's all read
    if (c + 1 < nchunks) {  // its buffers were last read by chunk c - 1
      const size_t o = (size_t)(c + 1) * kBC * DP;
      float* nx = xbuf + ((c + 1) & 1) * 2 * kBC * DSU;
      copy_rows<DP>(nx, DSU, xb_hi + o, kBC, tid, THREADS);
      copy_rows<DP>(nx + kBC * DSU, DSU, xb_lo + o, kBC, tid, THREADS);
      cp_async_commit();
      build_w(c + 1, (c + 1) & 1);
    }
    float part[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[j][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      // A fragment: a0 (row g, sample t), a1 (g + 8, t), a2 (g, t + 4),
      // a3 (g + 8, t + 4)
      const float4 wv = wbuf[(((c & 1) * MT + mt) * KS + ks) * 32 + lane];
      const float w[4] = {wv.x, wv.y, wv.z, wv.w};
      if (cg == 0) {
        wsum[0] += w[0];
        wsum[0] += w[2];
        wsum[1] += w[1];
        wsum[1] += w[3];
      }
      float ahi[4], alo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(w[q], ahi[q], alo[q]);
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        float bhi[2], blo[2];
        load_b_kn(bhi, xhi, DSU, 8 * ks, 8 * (cg * NTW + j), lane);
        load_b_kn(blo, xlo, DSU, 8 * ks, 8 * (cg * NTW + j), lane);
        mma_tf32x3(part[j], ahi, alo, bhi, blo);
      }
    }
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] += part[j][q];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    wsum[h] += __shfl_xor_sync(0xffffffffu, wsum[h], 1);
    wsum[h] += __shfl_xor_sync(0xffffffffu, wsum[h], 2);
  }
}

// up to 128 registers a thread; kPasses: the feature passes (NT 32, D > 256),
// an instantiation of its own so that the one-pass kernels keep their code
template <int NT, int MT, bool kPasses>
__global__ void __launch_bounds__(32 * VmemSmem<NT, MT>::WARPS, 16 / VmemSmem<NT, MT>::WARPS)
som_vmem_steps_kernel(const VmemArgs a) {
  using L = VmemSmem<NT, MT>;
  constexpr int CG = L::CG, NTW = NT / CG, DP = L::DP, R = L::R, BW = L::BW;
  constexpr int DW = L::DW, NTH = 32 * L::WARPS;
  constexpr int NW = BW / 8 / CG;  // a warp's n-tiles of a winner chunk
  extern __shared__ __align__(16) float smem[];
  float* xw = smem;  // winner chunk buffers: [buffer][hi, lo][BW][DW]
  float* redv = xw + 4 * BW * DW;
  int* redi = reinterpret_cast<int*>(redv + MT * BW);
  const int noc = a.noc, D = a.D, B = a.B;
  // the feature passes (kPasses); DT: a resident row's stride
  const int np = kPasses ? n_passes(D) : 1;
  const int DT = kPasses ? L::dtf(D) : L::DT;
  float* tiles = smem + L::kStep;
  float* m2s = tiles + (size_t)a.T * R * DT;
  float* wsm = m2s + a.T * R;
  float4* tab = reinterpret_cast<float4*>(smem + L::table(a.T, DT));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mt = warp % MT, cg = warp / MT;
  const int ntiles = (noc + R - 1) / R;
  const int tile0 = blockIdx.x * a.T;
  const int nt = min(a.T, ntiles - tile0);  // >= 1 by the grid's size
  const int row0 = tile0 * R;
  const int gtid = blockIdx.x * NTH + tid;
  const int gsz = gridDim.x * NTH;
  const size_t plane = (size_t)((B + 63) / 64 * 64) * DP;  // one split plane
  unsigned int gen = 0;

  // the owned rows, once, features padded with zeros; rows beyond noc are 0
  for (int e = tid; e < nt * R * DT; e += NTH) {
    const int u = row0 + e / DT, k = e % DT;
    tiles[e] = (u < noc && k < D) ? a.codes[(size_t)u * D + k] : 0.f;
  }
  // step 0 folds into buffer 1
  for (int b = gtid; b < B; b += gsz) a.keys[(size_t)B + b] = ~0ull;
  grid_barrier(a.bar, gen);

  const bool hexa = a.hexa != 0;
  for (int s = 0; s < a.K; ++s) {
    // ---- 1. the W table of batch s from its winners: bmu0 at s = 0, else
    // the keys step s-1 folded (read by the update after its first barrier)
    const unsigned long long* kc = a.keys + (size_t)(s % 3) * B;
    const float* al = a.alphas + (size_t)s * B;
    for (int b = tid; b < (B + kBC - 1) / kBC * kBC; b += NTH) {
      int bm = -1;
      if (b < B)
        bm = s == 0 ? a.bmu0[b] : (int)(unsigned int)(__ldcg(kc + b) & 0xffffffffull);
      // ClosedFormW::stage's float4: 0 where bmu < 0 or past B
      tab[b] = bm >= 0 ? make_float4(grid_x(bm % a.xdim, bm / a.xdim, hexa),
                                     (float)(bm / a.xdim), al[b], 0.f)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    unsigned long long* kr = a.keys + (size_t)((s + 2) % 3) * B;
    for (int b = gtid; b < B; b += gsz) kr[b] = ~0ull;
    unsigned long long* kn = a.keys + (size_t)((s + 1) % 3) * B;
    // batch s's slabs, then batch s + 1's: slab p's hi plane at + 2 p plane
    const float* xb_hi = a.xs + 2 * (size_t)np * s * plane;
    const float* xn_hi = xb_hi + 2 * (size_t)np * plane;
    const float radius = a.radii[s];
    GroupW wp;
    wp.xdim = a.xdim;
    wp.hexa = hexa;
    wp.gaussian = a.gaussian != 0;
    wp.r2 = radius * radius;
    wp.den = 2.0f * radius * radius;
    wp.tab = (int)L::table(a.T, DT);
    __syncthreads();  // the table written before the first chunk's W

    // ---- 2. K3's update, then its blend into the resident tile ------------
    for (int tt = 0; tt < nt; ++tt) {
      const int r0 = row0 + tt * R;
      float* tile = tiles + (size_t)tt * R * DT;
      for (int p = 0; p < np; ++p) {
        float acc[NTW][4];
        float wsum[2];
        group_update<NT, MT>(acc, wsum, xb_hi + 2 * p * plane, xb_hi + (2 * p + 1) * plane, B,
                             r0, wp);
        if (cg == 0 && t4 == 0) {
          wsm[16 * mt + g] = wsum[0];
          wsm[16 * mt + g + 8] = wsum[1];
        }
        __syncthreads();  // every fragment read: the step region is free; wsum
        if (np == 1 && tt == nt - 1) {  // the first winner chunk lands while the tile blends
          copy_rows<DP>(xw, DW, xn_hi, BW, tid, NTH);
          copy_rows<DP>(xw + BW * DW, DW, xn_hi + plane, BW, tid, NTH);
          cp_async_commit();
        }
        const float ws[2] = {wsm[16 * mt + g], wsm[16 * mt + g + 8]};
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // c0 (g, 2t), c1 (g, 2t + 1), c2, c3: g + 8
            const int h = q >> 1, r = 16 * mt + g + 8 * h;
            const int k = p * DP + 8 * (cg * NTW + j) + 2 * t4 + (q & 1);
            float nc = 0.f;
            if (k < D && r0 + r < noc) nc = guarded_blend(tile[r * DT + k], acc[j][q], ws[h]);
            tile[r * DT + k] = nc;
          }
        }
        __syncthreads();  // the slab blended
      }
      // ||m||^2 in K3's order: per thread over n-tiles (every pass's) then
      // c0..c3, then the four lanes of a row
      if (cg == 0) {
        float sq[2] = {0.f, 0.f};
        for (int j0 = 0; j0 < np * NT; j0 += NT) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int h = q >> 1;
              const float nc =
                  tile[(16 * mt + g + 8 * h) * DT + 8 * (j0 + j) + 2 * t4 + (q & 1)];
              sq[h] += nc * nc;
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 1);
          sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 2);
          if (t4 == 0) m2s[tt * R + 16 * mt + g + 8 * h] = sq[h];
        }
      }
    }

    // ---- 3. batch s+1's winners against the resident rows -----------------
    // per (sample 8 n + 2 t + q) the best (value, row) of this lane's rows:
    // rows ascend (tile, then g, then g + 8), so strict < keeps the first
    float bv[NW][2];
    int bi[NW][2];
    // S = this warp's m-tile of tile tt against the staged chunk (whi, wlo),
    // features from `col` of the resident rows, added to S
    auto scores = [&](float (&S)[NW][4], const float* tile, const float* whi,
                      const float* wlo, int col) {
#pragma unroll 2
      for (int ks = 0; ks < NT; ++ks) {
        float av[4], ahi[4], alo[4];
        load_a(av, tile + col, DT, 16 * mt, 8 * ks, lane);
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(av[q], ahi[q], alo[q]);
#pragma unroll
        for (int n = 0; n < NW; ++n) {
          float bhi[2], blo[2];
          load_b_nk(bhi, whi, DW, 8 * (cg * NW + n), 8 * ks, lane);
          load_b_nk(blo, wlo, DW, 8 * (cg * NW + n), 8 * ks, lane);
          mma_tf32x3(S[n], ahi, alo, bhi, blo);
        }
      }
    };
    // tile tt's scores folded into (bv, bi)
    auto fold = [&](const float (&S)[NW][4], int tt) {
      const int ra = row0 + tt * R + 16 * mt + g, rb = ra + 8;
      const float m2a = m2s[tt * R + 16 * mt + g], m2b = m2s[tt * R + 16 * mt + g + 8];
#pragma unroll
      for (int n = 0; n < NW; ++n) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (ra < noc) {
            const float d = m2a - 2.f * S[n][q];
            if (d < bv[n][q]) {
              bv[n][q] = d;
              bi[n][q] = ra;
            }
          }
          if (rb < noc) {
            const float d = m2b - 2.f * S[n][2 + q];
            if (d < bv[n][q]) {
              bv[n][q] = d;
              bi[n][q] = rb;
            }
          }
        }
      }
    };
    // chunk i in buffer i & 1; chunk i + 1 copied while chunk i is scored
    // (one pass; past 256 features each slab of the chunk is staged in
    // buffer 0 in turn); warp (mt, cg) scores m-tile mt against the chunk's
    // n-tiles cg NW ..
    for (int n0 = 0; n0 < B; n0 += BW) {
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          bv[n][q] = INFINITY;
          bi[n][q] = INT_MAX;
        }
      if (np == 1) {
        const float* whi = xw + ((n0 / BW) & 1) * 2 * BW * DW;
        const float* wlo = whi + BW * DW;
        cp_async_wait_all();
        __syncthreads();  // chunk landed; tiles, m2s and the last chunk's reads done
        if (n0 + BW < B) {
          const size_t o = (size_t)(n0 + BW) * DP;
          float* nhi = xw + (((n0 / BW) & 1) ^ 1) * 2 * BW * DW;
          copy_rows<DP>(nhi, DW, xn_hi + o, BW, tid, NTH);
          copy_rows<DP>(nhi + BW * DW, DW, xn_hi + plane + o, BW, tid, NTH);
          cp_async_commit();
        }
        for (int tt = 0; tt < nt; ++tt) {
          float S[NW][4];
#pragma unroll
          for (int n = 0; n < NW; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) S[n][q] = 0.f;
          scores(S, tiles + (size_t)tt * R * DT, whi, wlo, 0);
          fold(S, tt);
        }
      } else {
        for (int tt = 0; tt < nt; ++tt) {
          float S[NW][4];
#pragma unroll
          for (int n = 0; n < NW; ++n)
#pragma unroll
            for (int q = 0; q < 4; ++q) S[n][q] = 0.f;
          for (int p = 0; p < np; ++p) {
            __syncthreads();  // the last slab's fragments read (and tiles, m2s written)
            const float* src = xn_hi + 2 * p * plane + (size_t)n0 * DP;
            copy_rows<DP>(xw, DW, src, BW, tid, NTH);
            copy_rows<DP>(xw + BW * DW, DW, src + plane, BW, tid, NTH);
            cp_async_commit();
            cp_async_wait_all();
            __syncthreads();  // the slab landed
            scores(S, tiles + (size_t)tt * R * DT, xw, xw + BW * DW, p * DP);
          }
          fold(S, tt);
        }
      }
#pragma unroll
      for (int n = 0; n < NW; ++n) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float v = bv[n][q];
          int vi = bi[n][q];
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {  // the 8 lanes g of a sample
            const float ov = __shfl_xor_sync(0xffffffffu, v, off);
            const int oi = __shfl_xor_sync(0xffffffffu, vi, off);
            if (lex_less(ov, oi, v, vi)) {
              v = ov;
              vi = oi;
            }
          }
          if (g == 0) {
            const int smp = 8 * (cg * NW + n) + 2 * t4 + q;
            redv[mt * BW + smp] = v;
            redi[mt * BW + smp] = vi;
          }
        }
      }
      __syncthreads();  // every warp's candidates written
      for (int i = tid; i < BW; i += NTH) {  // a one-warp CTA takes two each
        float v = INFINITY;
        int vi = INT_MAX;
        for (int m = 0; m < MT; ++m) {
          const float ov = redv[m * BW + i];
          const int oi = redi[m * BW + i];
          if (lex_less(ov, oi, v, vi)) {
            v = ov;
            vi = oi;
          }
        }
        // fold_key without its read: the atomic's result is not waited for
        const int b = n0 + i;
        if (b < B && vi != INT_MAX) atomicMin(kn + b, pack_key(v, vi));
      }
    }

    // ---- 4. every CTA's fold done before anyone decodes it -----------------
    grid_barrier(a.bar, gen);
  }

  for (int e = tid; e < nt * R * DT; e += NTH) {
    const int u = row0 + e / DT, k = e % DT;
    if (u < noc && k < D) a.codes[(size_t)u * D + k] = tiles[e];
  }
  const unsigned long long* kf = a.keys + (size_t)(a.K % 3) * B;
  for (int b = gtid; b < B; b += gsz)
    a.bmu_out[b] = (int)(unsigned int)(__ldcg(kf + b) & 0xffffffffull);
}

// the fewest tiles per CTA whose grid can be resident at once, then the
// cooperative launch
template <int NT, int MT, bool kPasses>
int launch_vmem(VmemArgs a, cudaStream_t stream) {
  using L = VmemSmem<NT, MT>;
  int dev = 0, sms = 0, coop = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  void (*kern)(const VmemArgs) = som_vmem_steps_kernel<NT, MT, kPasses>;
  const int ntiles = (a.noc + L::R - 1) / L::R;
  const int dtf = kPasses ? L::dtf(a.D) : L::DT;
  for (int T = 1; T <= ntiles; ++T) {
    const size_t smem = L::bytes(T, a.B, dtf);
    if (smem > (size_t)max_smem) break;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 32 * L::WARPS,
                                                        smem);
    if (err != cudaSuccess) return (int)err;
    if ((long long)per_sm * sms * T < ntiles) continue;
    a.T = T;
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel((const void*)kern, dim3((ntiles + T - 1) / T),
                                      dim3(32 * L::WARPS), args, smem, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorCooperativeLaunchTooLarge;
}

// R = rows per CTA: 16, 32 or 64
template <bool kPasses>
int launch_rows(int rows, const VmemArgs& a, cudaStream_t stream) {
  if (rows == 16) return launch_vmem<32, 1, kPasses>(a, stream);
  if (rows == 32) return launch_vmem<32, 2, kPasses>(a, stream);
  if (rows == 64) return launch_vmem<32, 4, kPasses>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// VmemSmem<NT, MT>::bytes of one tile a CTA at `rows` rows, B samples and D
// features (the feature passes' instantiation past 256); -1 for a height
// that is not built
template <class L>
int one_tile_bytes(int B, int D) {
  return (int)L::bytes(1, B, n_passes(D) > 1 ? L::dtf(D) : (int)L::DT);
}

int smem_rows(int rows, int B, int D) {
  if (rows == 16) return one_tile_bytes<VmemSmem<32, 1>>(B, D);
  if (rows == 32) return one_tile_bytes<VmemSmem<32, 2>>(B, D);
  if (rows == 64) return one_tile_bytes<VmemSmem<32, 4>>(B, D);
  return -1;
}

}  // namespace

// The shared memory (bytes) of this kernel's CTA of `rows` rows owning one
// tile, at B samples and D features (> 128; the feature passes'
// instantiation past 256), for som_vmem_steps_sm90.cu's
// somvq_vmem_smem_bytes; -1 for a shape that is not built
extern "C" int somvq_vmem_mma_smem_bytes(int rows, int B, int D) {
  if (B <= 0 || D <= 128) return -1;
  return smem_rows(rows, B, D);
}

// codes (noc, D) float32, updated in place; batches (K, B, D), tail (B, D):
// the winners' last batch; rows: R; xs: scratch for the split batches,
// 2 (K + 1) Bp W floats (B rounded up to a multiple of 64, W =
// ops.som_step.split_width(D): 8 times the power of two of 8-feature steps
// that covers D, 256 n_passes(D) past 256); keys: (3 B) u64; bar: two zeroed
// words
extern "C" int somvq_som_vmem_steps(float* codes, int noc, int D,
                                    const float* batches, int K, int B,
                                    const int* bmu0, const float* alphas,
                                    const float* radii, const float* tail,
                                    int xdim, int hexa, int gaussian, int rows,
                                    float* xs, unsigned long long* keys,
                                    unsigned int* bar, int* bmu_out,
                                    cudaStream_t stream) {
  if (noc <= 0 || D <= 128 || K <= 0 || B <= 0 || xdim <= 0 || !xs)
    return (int)cudaErrorInvalidValue;
  const int DP = 256, NP = n_passes(D), Bp = (B + 63) / 64 * 64;
  const int64_t n = (int64_t)(K + 1) * Bp * DP * NP;
  split_group_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      batches, K, B, tail, D, DP, NP, Bp, xs);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const VmemArgs a{codes, noc,  D,     xs,       K,        B,       bmu0,
                   alphas, radii, xdim, hexa,    gaussian, 0,       keys,
                   bar,    bmu_out};
  return NP > 1 ? launch_rows<true>(rows, a, stream) : launch_rows<false>(rows, a, stream);
}
