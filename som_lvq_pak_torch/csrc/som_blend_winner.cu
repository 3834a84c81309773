// Pass B of the mixed data x model fused SOM step: the guarded blend of the
// summed accumulators into a codebook shard, then the next batch's winners
// against the blended rows, in one pass over the shard.
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_blend_winner_kernel
// (wrapper som_blend_winner).
//
// Blend.  One CTA owns TN rows: c' = c + min(wsum, 1) * (acc / max(wsum,
// 1e-30) - c) (som_grid.cuh's guarded_blend, as K3), written IN PLACE and
// kept in shared memory; each CTA reads and writes only its own rows.
//
// Winners, in the max-score form of the TPU kernel: score = x.m - ||m||^2 / 2
// with ||m||^2 over the row's D columns (the port never pads D, so these are
// the TPU kernel's d_real lanes), strict > over rows in ascending order, and
// the reported value is -2 * score.  Across CTAs each sample's (-2 * score,
// local row) pair is folded with K3's packed-u64 atomicMin
// (argmin_keys.cuh): -2 * score is an exact, order-reversing scaling, so the
// smallest key is the largest score with the lowest row on ties; -0 is
// folded to +0.  The next batch is walked in BC-sample chunks, so any B'
// works (the TPU wrapper's 2048-lane batch chunk is a VMEM device, not
// needed here).
//
// What bounds it on H100: FP32 FMA issue and shared-memory loads (no tensor
// cores); device memory traffic is the shard's codes, acc and wsum read and
// the codes written once, the next batch re-read from L2 by every CTA.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "argmin_keys.cuh"
#include "som_grid.cuh"

namespace {

// Shared memory: tile[TN][D] | xs[BC][DS] | m2h[TN] | redv[THREADS] |
//                redi[THREADS]
size_t smem_bytes(int D) {
  const int DS = D | 1;
  return sizeof(float) * ((size_t)TN * D + (size_t)BC * DS + TN + THREADS) +
         sizeof(int) * THREADS;
}

template <int NJ>
__global__ void __launch_bounds__(THREADS)
som_blend_winner_kernel(float* __restrict__ codes, int n_local, int D,
                        const float* __restrict__ acc,
                        const float* __restrict__ wsum,
                        const float* __restrict__ xn, int Bn,
                        unsigned long long* __restrict__ keys) {
  extern __shared__ float smem[];
  const int DS = D | 1;
  float* tile = smem;
  float* xs = tile + TN * D;
  float* m2h = xs + BC * DS;
  float* redv = m2h + TN;
  int* redi = reinterpret_cast<int*>(redv + THREADS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * TN;

  // ---- guarded blend, written in place and kept in shared memory ---------
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 4 + i, u = r0 + r;
    const float ws = (u < n_local) ? wsum[u] : 0.f;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = lane + 32 * j;
      if (k < D) {
        float nc = 0.f;
        if (u < n_local) {
          const size_t g = (size_t)u * D + k;
          nc = guarded_blend(codes[g], acc[g], ws);
          codes[g] = nc;
        }
        tile[r * D + k] = nc;
        sq += nc * nc;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    if (lane == 0) m2h[r] = 0.5f * sq;
  }

  // ---- next batch's max-score winners against the blended tile -----------
  // thread (warp, lane): rows 4 warp..4 warp+3 against sample lane
  for (int s0 = 0; s0 < Bn; s0 += BC) {
    __syncthreads();  // tile/m2h written; previous chunk's reduction read
    for (int e = tid; e < BC * D; e += THREADS) {
      const int s = e / D, k = e % D;
      xs[s * DS + k] = (s0 + s < Bn) ? xn[(size_t)(s0 + s) * D + k] : 0.f;
    }
    __syncthreads();
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < D; ++k) {
      const float xv = xs[lane * DS + k];
#pragma unroll
      for (int i = 0; i < 4; ++i) dot[i] += tile[(warp * 4 + i) * D + k] * xv;
    }
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i;
      if (r0 + r < n_local) {
        const float s = dot[i] - m2h[r];
        if (s > bv) {  // rows ascend with i: strict > keeps the first
          bv = s;
          bi = r0 + r;
        }
      }
    }
    redv[warp * 32 + lane] = bv;
    redi[warp * 32 + lane] = bi;
    __syncthreads();
    if (warp == 0) {
      for (int w = 1; w < THREADS / 32; ++w) {  // rows ascend with w
        const float v = redv[w * 32 + lane];
        if (v > bv) {
          bv = v;
          bi = redi[w * 32 + lane];
        }
      }
      const int b = s0 + lane;
      if (b < Bn && bi != INT_MAX) fold_key(keys + b, -2.f * bv, bi);
    }
  }
}

template <int NJ>
int launch_blend(float* codes, int n_local, int D, const float* acc,
                 const float* wsum, const float* xn, int Bn,
                 unsigned long long* keys, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      som_blend_winner_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  som_blend_winner_kernel<NJ><<<(n_local + TN - 1) / TN, THREADS, smem, stream>>>(
      codes, n_local, D, acc, wsum, xn, Bn, keys);
  return (int)cudaGetLastError();
}

}  // namespace

// codes (n_local, D) updated in place; acc (n_local, D), wsum (n_local,);
// keys: (Bn,) u64 scratch; val gets -2 * best score, idx the local row
extern "C" int somvq_som_blend_winner(float* codes, int n_local, int D,
                                      const float* acc, const float* wsum,
                                      const float* xn, int Bn,
                                      unsigned long long* keys, float* val,
                                      int* idx, cudaStream_t stream) {
  if (n_local <= 0 || D <= 0 || D > MAX_D || Bn <= 0)
    return (int)cudaErrorInvalidValue;
  init_keys<<<(Bn + 255) / 256, 256, 0, stream>>>(keys, Bn);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int nj = (D + 31) / 32;
  if (nj <= 1)
    rc = launch_blend<1>(codes, n_local, D, acc, wsum, xn, Bn, keys, stream);
  else if (nj <= 2)
    rc = launch_blend<2>(codes, n_local, D, acc, wsum, xn, Bn, keys, stream);
  else if (nj <= 4)
    rc = launch_blend<4>(codes, n_local, D, acc, wsum, xn, Bn, keys, stream);
  else
    rc = launch_blend<8>(codes, n_local, D, acc, wsum, xn, Bn, keys, stream);
  if (rc) return rc;
  unpack_keys<<<(Bn + 255) / 256, 256, 0, stream>>>(keys, Bn, val, idx);
  return (int)cudaGetLastError();
}
