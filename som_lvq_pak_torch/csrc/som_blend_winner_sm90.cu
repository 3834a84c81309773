// K12 on Hopper: pass B of the mixed data x model fused SOM step for D <= 128
// (wider D: som_blend_winner.cu's mma.sync kernel, the route
// ops.som_blend.k12_route names): the guarded blend of the summed
// accumulators into a codebook shard, then the next batch's winners against
// the blended rows, in one pass over the shard.
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_blend_winner_kernel (:401,
// wrapper som_blend_winner :470), as som_blend_winner.cu does past D 128.
//
// What bounds it on H100: the scores tile.X'^T (n_local x B' x D), 2 n_local
// B' D FLOPs as split TF32 (6 n_local B' D TF32 FLOPs at 495 TFLOP/s: 0.0521
// ms at 32768 rows, B' 2048, D 64); device memory moves the shard's codes,
// acc and wsum in and the codes out once (about 24 MB there, 7 us), the
// split next batch read from L2 by every CTA.
//
// The design is K3's Hopper walk (fused_step_sm90.cuh) without the update:
// K3's prologue (split_sm90_kernel) splits the next batch x' alone into TF32
// hi and lo rows (Bnp, DP); per 128-row CTA the consumer warpgroups read
// their rows' acc and wsum from device memory in the C layout they hold in
// K3 (row 16 warp + g + 8 h, column 8 j + 2 t + (q & 1)), apply the guarded
// blend in place and store the blended rows split into the swizzled tile
// with ||m||^2 in K3's order (blend_rows_tc), then run K3's winner walk
// (winner_walk, argmin_fold: each sample's packed (value, local row) key
// folded across CTAs, the lowest row among equal values) on the next batch's
// 64-sample chunks, which the producer warpgroup streams by TMA into the
// ring.  So K11 then K12 on a shard give K3's rows, values and winners on
// that shard bit for bit (K11 is K3's update walk with the sums written
// out), as the mma.sync K12 did, and two runs are bit-equal.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "argmin_keys.cuh"
#include "fused_step_sm90.cuh"
#include "fused_step_tc.cuh"  // blend_rows_tc

namespace {

using namespace fs90;

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
som_blend_winner_sm90_kernel(const __grid_constant__ CUtensorMap xn_map,
                             float* __restrict__ codes, int n_local, int D,
                             const float* __restrict__ acc_in,
                             const float* __restrict__ wsum_in, int Bn,
                             unsigned long long* __restrict__ keys) {
  using L = Layout<DP, 2, false>;
  constexpr int NT = DP / 8;
  unsigned char* tile;
  float* m2s;
  Ring ring = setup<L>(tile, m2s);
  const int nw = (Bn + WC - 1) / WC;
  if (threadIdx.x >= ALL) {  // the producer warpgroup: one thread, winner items only
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == ALL)
      produce<L, 2>(ring, nullptr, &xn_map, nullptr, 0, nw, round_up(Bn, 64));
    return;
  }
  sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * TN;

  // ---- the rows' sums in K3's C layout, then the blend in place -------------
  float acc[NT][4];
  float wsum[2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // c0 (g, 2t), c1 (g, 2t + 1), c2, c3: g + 8
      const int u = r0 + 16 * warp + g + 8 * (q >> 1), k = 8 * j + 2 * t + (q & 1);
      acc[j][q] = (k < D && u < n_local) ? acc_in[(size_t)u * D + k] : 0.f;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = r0 + 16 * warp + g + 8 * h;
    wsum[h] = u < n_local ? wsum_in[u] : 0.f;
  }
  blend_rows_tc<NT, 2 * CONSUMERS * 4>(
      acc, wsum, codes, n_local, D, r0, m2s, [&](int r, int k, float nc) {
        float hi, lo;
        split_tf32(nc, hi, lo);
        *reinterpret_cast<float*>(tile + tile_offset<DP>(0, r, k)) = hi;
        *reinterpret_cast<float*>(tile + tile_offset<DP>(1, r, k)) = lo;
      });
  // ||m||^2 +inf past n_local: such a row's d is +inf, and a row of the CTA
  // below n_local comes first on equal values
  const int rows = n_local - r0;
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (16 * warp + g + 8 * h >= rows) m2s[16 * warp + g + 8 * h] = INFINITY;
  }
  sm90::fence_proxy_async();
  sm90::bar_sync(1, ALL);  // the tile and m2s written

  // ---- next batch's winners against the blended tile ------------------------
  winner_walk<L, 2>(ring, tile, nw, consumer_wg(), lane, [&](float (&S)[64], int n0) {
    argmin_fold(S, n0, m2s, keys, Bn, r0, warp, lane);
  });
}

template <int DP>
int launch_walk(float* codes, int n_local, int D, const float* acc, const float* wsum,
                int Bn, const float* xs, unsigned long long* keys, cudaStream_t stream) {
  using L = Layout<DP, 2, false>;
  CUtensorMap xnr;
  const int rc = sm90::encode_map(&xnr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, xs,
                                  2 * round_up(Bn, 64), DP, CHUNK, WC,
                                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  const auto kernel = som_blend_winner_sm90_kernel<DP>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<(n_local + TN - 1) / TN, THREADS, L::BYTES, stream>>>(xnr, codes, n_local, D, acc,
                                                                  wsum, Bn, keys);
  return (int)cudaGetLastError();
}

}  // namespace

// K12 for D <= 128: codes (n_local, D) float32 updated in place; acc
// (n_local, D), wsum (n_local,); xs scratch for the split next batch, 16-byte
// aligned: 2 Bnp DP floats (Bn rounded up to 64, DP = 32, 64 or 128, the
// smallest that covers D); keys: (Bn,) u64 scratch; val gets the partial
// distance ||m||^2 - 2 x.m, idx the local row
extern "C" int somvq_som_blend_winner_sm90(float* codes, int n_local, int D, const float* acc,
                                           const float* wsum, const float* xn, int Bn,
                                           float* xs, unsigned long long* keys, float* val,
                                           int* idx, cudaStream_t stream) {
  if (n_local <= 0 || D <= 0 || dp_of(D) == 0 || Bn <= 0 || !xs ||
      (reinterpret_cast<uintptr_t>(xs) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int DP = dp_of(D);
  init_keys<<<(Bn + 255) / 256, 256, 0, stream>>>(keys, Bn);
  int rc = (int)cudaGetLastError();
  if (!rc)  // x' alone: (Bnp, DP) rows, hi then lo
    rc = split_sm90<float, 2, false>(nullptr, 0, xn, Bn, D, DP, xs, nullptr, nullptr, 1, 0,
                                     stream);
  if (!rc)
    rc = DP == 32   ? launch_walk<32>(codes, n_local, D, acc, wsum, Bn, xs, keys, stream)
         : DP == 64 ? launch_walk<64>(codes, n_local, D, acc, wsum, Bn, xs, keys, stream)
                    : launch_walk<128>(codes, n_local, D, acc, wsum, Bn, xs, keys, stream);
  if (rc) return rc;
  unpack_keys<<<(Bn + 255) / 256, 256, 0, stream>>>(keys, Bn, val, idx);
  return (int)cudaGetLastError();
}
