// K SOM training steps in one launch, the codebook resident on chip
// throughout: a persistent cooperative kernel.
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_vmem_steps_kernel (wrapper
// som_vmem_train_steps).  The TPU kernel keeps the whole codebook (up to
// 4 MB) in one core's VMEM and runs its grid of K steps in order.  One SM's
// shared memory (227 KB) cannot hold that, so here the codebook is spread
// over the grid: CTA c owns the T consecutive TN-row tiles c*T .. c*T+T-1
// (som_grid.cuh), loads them into shared memory once, keeps them there for
// all K steps, and writes them back once after the last.  The grid is at
// most what can be resident at once (occupancy x SM count), launched with
// cudaLaunchCooperativeKernel; a codebook that does not fit returns
// cudaErrorCooperativeLaunchTooLarge (the wrapper raises; nothing falls
// back).
//
// Step t, in every CTA:
//   1. read bmu_t: bmu0 at t = 0, else decode the packed (value, row) keys
//      that step t-1 folded for batch t;
//   2. update each owned tile with batch t: acc = W.X and wsum = W.1 by
//      som_grid.cuh's accumulate_update, then the guarded blend, in shared
//      memory (the same code and operation order as K3);
//   3. batch t+1's (min, first argmin) over the owned rows, folded across
//      CTAs into a packed-u64 key per sample with argmin_keys.cuh's fold_key
//      (atomicMin: the smallest value, then the lowest row, whatever order
//      the CTAs run in);
//   4. wait at a grid-wide barrier.
// The key buffers rotate over three: step t decodes buffer t%3, folds into
// (t+1)%3 and resets (t+2)%3, which every CTA finished decoding before the
// previous barrier; so one barrier per step suffices.  The barrier is a
// generation counter on a global word, valid because the cooperative launch
// guarantees that every CTA is resident.
//
// One launch computes what K chained K3 launches compute, with the same
// arithmetic in the same order.  What bounds it on H100: FP32 FMA throughput
// and shared-memory loads (no tensor cores), as in K3, plus the barrier per
// step; device memory sees one codebook read and write per launch and the
// batches, which stay in L2.  A small codebook leaves SMs idle (one CTA per
// 32 rows).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "argmin_keys.cuh"
#include "som_grid.cuh"

namespace {

// Shared memory: tiles[T][TN][D] | m2s[T][TN] | xs[BC][DS] | ws[TN][BC] |
//                redv[THREADS] | redi[THREADS] | bms[B]
size_t vmem_smem_bytes(int D, int T, int B) {
  const int DS = D | 1;
  return sizeof(float) * ((size_t)T * TN * D + (size_t)T * TN +
                          (size_t)BC * DS + TN * BC + THREADS) +
         sizeof(int) * ((size_t)THREADS + B);
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

template <int NJ>
__global__ void __launch_bounds__(THREADS)
som_vmem_steps_kernel(float* __restrict__ codes, int noc, int D,
                      const float* __restrict__ batches, int K, int B,
                      const int* __restrict__ bmu0,
                      const float* __restrict__ alphas,
                      const float* __restrict__ radii,
                      const float* __restrict__ tail, int xdim, int hexa,
                      int gaussian, int T, unsigned long long* keys,
                      unsigned int* bar, int* __restrict__ bmu_out) {
  extern __shared__ float smem[];
  const int DS = D | 1;
  float* tiles = smem;
  float* m2s = tiles + (size_t)T * TN * D;
  float* xs = m2s + T * TN;
  float* ws = xs + BC * DS;
  float* redv = ws + TN * BC;
  int* redi = reinterpret_cast<int*>(redv + THREADS);
  int* bms = redi + THREADS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (noc + TN - 1) / TN;
  const int tile0 = blockIdx.x * T;
  const int nt = min(T, ntiles - tile0);  // >= 1 by the grid's size
  const int row0 = tile0 * TN;
  const int gtid = blockIdx.x * THREADS + tid;
  const int gsz = gridDim.x * THREADS;
  unsigned int gen = 0;

  // the owned rows, once; rows beyond noc are 0
  for (int e = tid; e < nt * TN * D; e += THREADS) {
    const int u = row0 + e / D;
    tiles[e] = (u < noc) ? codes[(size_t)u * D + e % D] : 0.f;
  }
  // step 0 folds into buffer 1
  for (int b = gtid; b < B; b += gsz) keys[(size_t)B + b] = ~0ull;
  grid_barrier(bar, gen);

  for (int t = 0; t < K; ++t) {
    // ---- 1. winners of batch t --------------------------------------------
    if (t == 0) {
      for (int b = tid; b < B; b += THREADS) bms[b] = bmu0[b];
    } else {
      const unsigned long long* kc = keys + (size_t)(t % 3) * B;
      for (int b = tid; b < B; b += THREADS)
        bms[b] = (int)(unsigned int)(__ldcg(kc + b) & 0xffffffffull);
    }
    unsigned long long* kr = keys + (size_t)((t + 2) % 3) * B;
    for (int b = gtid; b < B; b += gsz) kr[b] = ~0ull;
    unsigned long long* kn = keys + (size_t)((t + 1) % 3) * B;

    const float* xb = batches + (size_t)t * B * D;
    const float* xn = (t + 1 < K) ? batches + (size_t)(t + 1) * B * D : tail;
    const float* al = alphas + (size_t)t * B;
    const float radius = radii[t];

    // ---- 2. update of the owned tiles (accumulate_update syncs first) -----
    for (int tt = 0; tt < nt; ++tt) {
      float acc[4][NJ];
      float wsum[4];
      const int r0 = row0 + tt * TN;
      accumulate_update<NJ>(acc, wsum, xs, ws, r0, noc, D, xb, bms, al, B, xdim,
                            hexa != 0, gaussian != 0, radius);
      float* tile = tiles + (size_t)tt * TN * D;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp * 4 + i, u = r0 + r;
        float sq = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int k = lane + 32 * j;
          if (k < D) {
            float nc = 0.f;
            if (u < noc) nc = guarded_blend(tile[r * D + k], acc[i][j], wsum[i]);
            tile[r * D + k] = nc;
            sq += nc * nc;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
        if (lane == 0) m2s[tt * TN + r] = sq;
      }
    }

    // ---- 3. batch t+1's winners against the updated rows -------------------
    // thread (warp, lane): rows 4 warp..4 warp+3 of each owned tile against
    // sample lane; a thread's rows ascend, so strict < keeps the first
    for (int s0 = 0; s0 < B; s0 += BC) {
      __syncthreads();  // tiles/m2s written; previous chunk's reduction read
      for (int e = tid; e < BC * D; e += THREADS) {
        const int s = e / D, k = e % D;
        xs[s * DS + k] = (s0 + s < B) ? xn[(size_t)(s0 + s) * D + k] : 0.f;
      }
      __syncthreads();
      float bv = INFINITY;
      int bi = INT_MAX;
      for (int tt = 0; tt < nt; ++tt) {
        const float* tile = tiles + (size_t)tt * TN * D;
        float dot[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < D; ++k) {
          const float xv = xs[lane * DS + k];
#pragma unroll
          for (int i = 0; i < 4; ++i) dot[i] += tile[(warp * 4 + i) * D + k] * xv;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = warp * 4 + i, u = row0 + tt * TN + r;
          if (u < noc) {
            const float d = m2s[tt * TN + r] - 2.f * dot[i];
            if (d < bv) {
              bv = d;
              bi = u;
            }
          }
        }
      }
      redv[warp * 32 + lane] = bv;
      redi[warp * 32 + lane] = bi;
      __syncthreads();
      if (warp == 0) {
        // warps' rows interleave across tiles: compare (value, row)
        for (int w = 1; w < THREADS / 32; ++w) {
          const float v = redv[w * 32 + lane];
          const int vi = redi[w * 32 + lane];
          if (v < bv || (v == bv && vi < bi)) {
            bv = v;
            bi = vi;
          }
        }
        const int b = s0 + lane;
        if (b < B && bi != INT_MAX) fold_key(kn + b, bv, bi);
      }
    }

    // ---- 4. every CTA's fold done before anyone decodes it -----------------
    grid_barrier(bar, gen);
  }

  for (int e = tid; e < nt * TN * D; e += THREADS) {
    const int u = row0 + e / D;
    if (u < noc) codes[(size_t)u * D + e % D] = tiles[e];
  }
  const unsigned long long* kf = keys + (size_t)(K % 3) * B;
  for (int b = gtid; b < B; b += gsz)
    bmu_out[b] = (int)(unsigned int)(__ldcg(kf + b) & 0xffffffffull);
}

template <int NJ>
int launch_vmem(float* codes, int noc, int D, const float* batches, int K,
                int B, const int* bmu0, const float* alphas, const float* radii,
                const float* tail, int xdim, int hexa, int gaussian,
                unsigned long long* keys, unsigned int* bar, int* bmu_out,
                cudaStream_t stream) {
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
  void (*kern)(float*, int, int, const float*, int, int, const int*,
               const float*, const float*, const float*, int, int, int, int,
               unsigned long long*, unsigned int*, int*) =
      som_vmem_steps_kernel<NJ>;
  const int ntiles = (noc + TN - 1) / TN;
  // the fewest tiles per CTA whose grid can be resident at once
  for (int T = 1; T <= ntiles; ++T) {
    const size_t smem = vmem_smem_bytes(D, T, B);
    if (smem > (size_t)max_smem) break;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if ((long long)per_sm * sms * T < ntiles) continue;
    const int grid = (ntiles + T - 1) / T;
    void* args[] = {&codes, &noc,   &D,    &batches, &K,        &B,
                    &bmu0,  &alphas, &radii, &tail,   &xdim,     &hexa,
                    &gaussian, &T,  &keys, &bar,     &bmu_out};
    err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(THREADS),
                                      args, smem, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace

extern "C" int somvq_som_vmem_steps(float* codes, int noc, int D,
                                    const float* batches, int K, int B,
                                    const int* bmu0, const float* alphas,
                                    const float* radii, const float* tail,
                                    int xdim, int hexa, int gaussian,
                                    unsigned long long* keys, unsigned int* bar,
                                    int* bmu_out, cudaStream_t stream) {
  if (noc <= 0 || D <= 0 || D > MAX_D || K <= 0 || B <= 0 || xdim <= 0)
    return (int)cudaErrorInvalidValue;
  const int nj = (D + 31) / 32;
  if (nj <= 1)
    return launch_vmem<1>(codes, noc, D, batches, K, B, bmu0, alphas, radii,
                          tail, xdim, hexa, gaussian, keys, bar, bmu_out, stream);
  if (nj <= 2)
    return launch_vmem<2>(codes, noc, D, batches, K, B, bmu0, alphas, radii,
                          tail, xdim, hexa, gaussian, keys, bar, bmu_out, stream);
  if (nj <= 4)
    return launch_vmem<4>(codes, noc, D, batches, K, B, bmu0, alphas, radii,
                          tail, xdim, hexa, gaussian, keys, bar, bmu_out, stream);
  return launch_vmem<8>(codes, noc, D, batches, K, B, bmu0, alphas, radii,
                        tail, xdim, hexa, gaussian, keys, bar, bmu_out, stream);
}
