// Pass B of the mixed data x model fused SOM step for D > 128: the guarded
// blend of the summed accumulators into a codebook shard, then the next
// batch's winners against the blended rows, in one pass over the shard.  Up
// to D 128 K12 runs K3's Hopper walk instead (som_blend_winner_sm90.cu, the
// route ops.som_blend.k12_route names); this kernel keeps its NT 32
// instances (D 129-256, and the feature passes past 256).
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_blend_winner_kernel
// (wrapper som_blend_winner).
//
// K12 is the blend-and-winner half of K3 (fused_step_tc.cuh:
// fused_blend_winners_tc) on accumulators read from device memory, as K11 is
// its update half with them written out.  Each thread loads its rows' acc in
// the mma's C layout (row 16 w + g + 8 h, column 8 j + 2 t + (q & 1) of
// n-tile j) and its two rows' wsum, then runs K3's half: c + min(wsum, 1) *
// (acc / max(wsum, 1e-30) - c) (guarded_blend) written IN PLACE, the blended
// rows split into TF32 hi and lo in shared memory with their ||m||^2 (fixed
// order), the next batch (split once by K3's split_batches_kernel) scored in
// 64-sample chunks (32 past D 128) by split-TF32 mma.sync, d = ||m||^2 - 2 S,
// each sample's (min, first row) over the CTA's rows folded across CTAs by
// the packed-u64 atomicMin (argmin_keys.cuh): the lowest local row among
// equal values, in any CTA order.  d is -2 fl(S - ||m||^2 / 2) exactly, the
// TPU kernel's max-score value.  K3's CTA height (128 rows, 64 past D 128):
// K11 then K12 on a shard give K3's rows, values and winners on that shard
// bit for bit, and two runs are bit-equal.
//
// What bounds it on H100: the scores tile.X'^T (n_local x B' x D), 2 n_local
// B' D FLOPs, issued as three TF32 products each (6 n_local B' D at 495
// TFLOP/s).  Device memory traffic is the shard's codes, acc and wsum read
// and the codes written once, the split next batch read from L2 by every CTA.

#include <cuda_runtime.h>

#include "fused_step_tc.cuh"

namespace {

template <int NT, bool kPasses>
__global__ void __launch_bounds__(32 * k3_warps(NT), NT <= 8 ? 2 : 1)
som_blend_winner_kernel(float* __restrict__ codes, int n_local, int D,
                        const float* __restrict__ acc_in,
                        const float* __restrict__ wsum_in,
                        const float* __restrict__ xs, int Bn,
                        unsigned long long* __restrict__ keys) {
  constexpr int WARPS = k3_warps(NT), DP = 8 * NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * 16 * WARPS;
  float acc[NT][4];
  float wsum[2];
  if constexpr (kPasses) {  // NT 32, D > 256, an instantiation of its own:
    // feature passes (fused_step_tc.cuh), each slab blended, then the winners
    // over the slabs
    extern __shared__ __align__(16) float smem[];
    using L = FusedSmem<NT, WARPS>;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = r0 + 16 * warp + g + 8 * h;
      wsum[h] = u < n_local ? wsum_in[u] : 0.f;
    }
    const int np = n_passes(D);
    float sq[2] = {0.f, 0.f};
    for (int s = 0; s < np; ++s) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int u = r0 + 16 * warp + g + 8 * (q >> 1), k = s * DP + 8 * j + 2 * t + (q & 1);
          acc[j][q] = (k < D && u < n_local) ? acc_in[(size_t)u * D + k] : 0.f;
        }
      }
      blend_pass_tc<NT, WARPS>(acc, wsum, codes, n_local, D, s * DP, r0, sq,
                               [](int, int, float) {});
    }
    m2_lanes(sq, smem + L::P * L::TN * L::DT + L::P * L::BW * L::DW);
    winners_passes_tc<NT, WARPS, false>(codes, n_local, D, np, xs, Bn, keys, r0);
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // c0 (g, 2t), c1 (g, 2t + 1), c2, c3: g + 8
        const int u = r0 + 16 * warp + g + 8 * (q >> 1), k = 8 * j + 2 * t + (q & 1);
        acc[j][q] = (k < D && u < n_local) ? acc_in[(size_t)u * D + k] : 0.f;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = r0 + 16 * warp + g + 8 * h;
      wsum[h] = u < n_local ? wsum_in[u] : 0.f;
    }
    const size_t Bnp = (Bn + 63) / 64 * 64;
    fused_blend_winners_tc<NT, WARPS, false>(acc, wsum, codes, n_local, D, xs,
                                             xs + Bnp * DP, Bn, keys, r0);
  }
}

// the next batch split once (into xs), then the blend and winners
template <int NT, bool kPasses = false>
int launch_blend(float* codes, int n_local, int D, const float* acc,
                 const float* wsum, const float* xn, int Bn, float* xs,
                 unsigned long long* keys, cudaStream_t stream) {
  using L = FusedSmem<NT, k3_warps(NT)>;
  const size_t smem = sizeof(float) * L::winner_floats();
  cudaError_t err = cudaFuncSetAttribute(
      som_blend_winner_kernel<NT, kPasses>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rc = split_batches(nullptr, 0, xn, Bn, D, L::DP, xs, stream);
  if (rc) return rc;
  som_blend_winner_kernel<NT, kPasses>
      <<<(n_local + L::TN - 1) / L::TN, 32 * k3_warps(NT), smem, stream>>>(
          codes, n_local, D, acc, wsum, xs, Bn, keys);
  return (int)cudaGetLastError();
}

int launch_any(float* codes, int n_local, int D, const float* acc, const float* wsum,
               const float* xn, int Bn, float* xs, unsigned long long* keys,
               cudaStream_t stream) {
  if (D > kPassD)
    return launch_blend<32, true>(codes, n_local, D, acc, wsum, xn, Bn, xs, keys, stream);
  return launch_blend<32>(codes, n_local, D, acc, wsum, xn, Bn, xs, keys, stream);
}

}  // namespace

// codes (n_local, D) updated in place; acc (n_local, D), wsum (n_local,);
// xs scratch for the split next batch: 2 Bnp W floats (Bn rounded up to a
// multiple of 64, W = ops.som_step.split_width(D), the passes' slabs past
// 256); keys: (Bn,) u64 scratch; val gets the partial distance ||m||^2 - 2 x.m
// (-2 * the best score), idx the local row
extern "C" int somvq_som_blend_winner(float* codes, int n_local, int D,
                                      const float* acc, const float* wsum,
                                      const float* xn, int Bn, float* xs,
                                      unsigned long long* keys, float* val,
                                      int* idx, cudaStream_t stream) {
  if (n_local <= 0 || D <= 128 || Bn <= 0 || !xs)
    return (int)cudaErrorInvalidValue;
  init_keys<<<(Bn + 255) / 256, 256, 0, stream>>>(keys, Bn);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = launch_any(codes, n_local, D, acc, wsum, xn, Bn, xs, keys, stream);
  if (rc) return rc;
  unpack_keys<<<(Bn + 255) / 256, 256, 0, stream>>>(keys, Bn, val, idx);
  return (int)cudaGetLastError();
}
