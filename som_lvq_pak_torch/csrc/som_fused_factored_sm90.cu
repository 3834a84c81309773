// K13 on Hopper: the separable fused SOM step (W = Wx(column, row parity) *
// Wy(row) from the step's tables) for D <= 128, on K3's Hopper walk (wider D:
// som_fused_factored.cu's mma.sync kernel, the route ops.som_step.k13_route
// names).
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_fused_factored_kernel
// (:743), as som_fused_factored.cu does for wider D; the entry
// somvq_som_fused_factored_sm90 below runs the step's table launch
// (separable_w.cuh: factored_tables_kernel, K13's, unchanged; it also sets
// the winner keys), then this kernel.
//
// What bounds it on H100: the two contractions, 4 noc B D FLOPs as split
// TF32 (12 noc B D TF32 FLOPs at 495 TFLOP/s), and the L2 reads of both split
// batches and of the tables by every CTA.  K13's W is a product (gaussian) or
// a sum and a compare (bubble) of two table entries, a handful of
// instructions against K3's 27 a value: the walk's products and their feed,
// not W, should set its time.
//
// The design is fused_step_sm90.cuh's walk, as K3 (fused_step_sm90.cu) runs
// it, with K13's three parts:
//   * W (SeparableW90): each thread's two rows' x-pattern and y-factor table
//     entries for its eight samples of a 32-sample chunk (and, on a bubble
//     map, the samples' alpha) read from L2 with __ldg, the tables written by
//     the table launch just before, in rows padded to Bp with samples of
//     alpha 0; W = Wx * Wy (gaussian) or (Wx + Wy <= r r) ? alpha : 0
//     (bubble), separable_w.cuh's float operations, +0 past the batch with no
//     test (no branch on a lane's value while a wgmma is in flight: that made
//     ptxas serialize K3's wgmma); split into
//     TF32 hi and lo as the A fragments, chunk c + 1's built while chunk c's
//     products run; wsum in update_chunk_tc's order.  The update slot holds
//     the chunk's X planes alone (no per-sample table).
//   * The rows: fused_step_tc.cuh's blend_rows_tc, the blended float32 rows
//     stored split for the winners, as K3's.
//   * The fold: K3's (fs90::argmin_fold), in distance form, ||m||^2 - 2
//     x'.m, which is -2 fl(x'.m - ||m||^2 / 2) exactly: K13's max-score
//     value bit for bit.
// Every W value and wsum is som_fused_factored.cu's float, and the walk's
// sums are mma.sync's (K3's walk is bit-equal to K3's mma.sync kernel), so
// the codebook, winners and values are the mma.sync K13's bit for bit
// (tools/fused_step_ab.py's digests), and two runs are bit-equal.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "fused_step_sm90.cuh"
#include "fused_step_tc.cuh"  // blend_rows_tc, wsum_lanes
#include "separable_w.cuh"    // StepArgs

namespace {

using namespace fs90;

// W from the separable tables: pat (n_pat, Bp), ytab (ydim, Bp), aw (Bp,)
// as the table launch wrote them, rows of Bp (B rounded up to 64) entries,
// the samples past B written with alpha 0, so that every chunk reads whole
// with no test: their W is +0, the mma.sync K13's 0 past the batch.  Built a
// chunk at a time for the thread's rows g and g + 8 (their x-pattern and
// y-factor rows at element offsets po, yo; a row past noc reads row noc - 1's,
// and its sums are never blended or scored) and samples 8 ks + t + 4 e of
// the chunk.  With a test per value and per row the DP 128 walk spilled
template <bool kGauss>
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
      for (int q = 0; q < 4; ++q) split_tf32(w[ks][q], hi[ks][q], lo[ks][q]);
    }
  }
};

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
  using L = Layout<DP, 2, false>;
  constexpr int NT = DP / 8;
  unsigned char* tile;
  float* m2s;
  Ring ring = setup<L>(tile, m2s);
  const int nu = (B + UC - 1) / UC, nw = (Bn + WC - 1) / WC;
  if (threadIdx.x >= ALL) {  // the producer warpgroup: one thread
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == ALL)
      produce<L, 2>(ring, &xt_map, &xn_map, nullptr, nu, nw, round_up(Bn, 64));
    return;
  }
  sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * TN;

  // ---- update: acc = W.X, wsum = W.1 ----------------------------------------
  SeparableW90<kGauss> wb;
  wb.pat = pat;
  wb.ytab = ytab;
  wb.aw = aw;
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
  update_walk<DP, 2>(acc, wb, ring, nu, consumer_wg(), lane);
  wsum_lanes(wb.wsum);

  // ---- the blend, written in place; the tile kept split ---------------------
  blend_rows_tc<NT, 2 * CONSUMERS * 4>(
      acc, wb.wsum, codes, noc, D, r0, m2s, [&](int r, int k, float nc) {
        float hi, lo;
        split_tf32(nc, hi, lo);
        *reinterpret_cast<float*>(tile + tile_offset<DP>(0, r, k)) = hi;
        *reinterpret_cast<float*>(tile + tile_offset<DP>(1, r, k)) = lo;
      });
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

  // ---- next batch's winners against the updated tile ------------------------
  winner_walk<L, 2>(ring, tile, nw, consumer_wg(), lane, [&](float (&S)[64], int n0) {
    argmin_fold(S, n0, m2s, keys, Bn, r0, warp, lane);
  });
}

template <int DP, bool kGauss, typename CT>
int launch_walk(const StepArgs& a) {
  using L = Layout<DP, 2, false>;
  CUtensorMap xt, xnr;
  const int rc = encode_maps<2>(&xt, &xnr, nullptr, a.xs, a.B, a.Bn, DP);
  if (rc) return rc;
  const auto kernel = som_fused_factored_sm90_kernel<DP, kGauss, CT>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<(a.noc + TN - 1) / TN, THREADS, L::BYTES, a.stream>>>(
      xt, xnr, static_cast<CT*>(a.codes), a.noc, a.D, a.B, a.Bn, a.xdim, a.hexa, a.radius,
      static_cast<const float*>(a.pat), a.ytab, a.aw, a.keys);
  return (int)cudaGetLastError();
}

// the prologue (the batches split, no per-sample table), then the walk at the
// batch width DP
template <typename CT>
int k13_walk(const StepArgs& a) {
  const int DP = dp_of(a.D);
  const int rc = split_sm90<float, 2, false>(a.xb, a.B, a.xn, a.Bn, a.D, DP, a.xs, nullptr,
                                             nullptr, a.xdim, a.hexa, a.stream);
  if (rc) return rc;
#define K13_WALK(W)                                                  \
  if (DP == W)                                                       \
    return a.gaussian ? launch_walk<W, true, CT>(a) : launch_walk<W, false, CT>(a);
  K13_WALK(32)
  K13_WALK(64)
  K13_WALK(128)
#undef K13_WALK
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K13 for D <= 128 on K3's Hopper walk: the table launch (which sets the
// winner keys), then the walk.  Arguments as som_fused_factored.cu's
// somvq_som_fused_factored's, with xs the walk's prologue scratch, 16-byte
// aligned: 2 DP (Bp + Bnp) floats (ops.som_step.sm90_scratch without K3's
// table; DP = 32, 64 or 128, the smallest that covers D), and the tables'
// rows Bp entries long (aw Bp, ytab ceil(noc / xdim) Bp, pat n_pat Bp floats;
// Bp: B rounded up to 64)
extern "C" int somvq_som_fused_factored_sm90(
    void* codes, int codes_bf16, int noc, int D, const float* xb, const int* bmu,
    const float* alpha, int B, const float* xn, int Bn, int xdim, int hexa, int gaussian,
    float radius, float* xs, void* pat, float* ytab, float* aw, unsigned long long* keys,
    float* val, int* idx, cudaStream_t stream) {
  // the walk's table offsets are 32-bit: (n_pat + ydim) Bp elements
  if (noc <= 0 || D <= 0 || dp_of(D) == 0 || B <= 0 || Bn <= 0 || xdim <= 0 || !xs ||
      (reinterpret_cast<uintptr_t>(xs) & 15) != 0 ||
      (int64_t)(2 * xdim + (noc + xdim - 1) / xdim) * round_up(B, 64) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const StepArgs a{codes,  noc,     D,    xb, bmu,  alpha, B,
                   xn,     nullptr, nullptr, Bn, xdim, hexa,  gaussian,
                   radius, 0,       128,  xs, pat,  ytab,  aw,
                   keys,   nullptr, stream};
  int rc = launch_tables<float>(a, round_up(B, 64));
  if (!rc) rc = codes_bf16 ? k13_walk<__nv_bfloat16>(a) : k13_walk<float>(a);
  if (rc) return rc;
  unpack_keys<<<(Bn + 255) / 256, 256, 0, stream>>>(keys, Bn, val, idx);
  return (int)cudaGetLastError();
}
