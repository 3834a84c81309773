// One SOM training step in one pass over the codebook: the neighbourhood
// update of batch t, then batch t+1's winners against the updated rows.
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_fused_step_kernel (wrapper
// som_fused_train_step).  The wrapper takes it where the JAX trainer takes
// that kernel: a geometry the separable kernels reject (256x256 at B >= 2048
// among the port's cells), a model-axis shard, or factored=False.  The
// separable and batch-chunked TPU kernels are K13/K14
// (som_fused_factored.cu).
//
// Update (tile-local).  One CTA owns TN codebook rows.  It walks the batch in
// BC-sample chunks staged in shared memory, builds the neighbourhood weight
// W[row, sample] from flat unit indices with the exact-f32 algebra of
// _neighborhood_w (dx from columns and 0.5 offsets, hexa dy^2 as
// rowdiff^2 * 0.75; bubble d2 <= r*r; gaussian alpha * expf(-d2 / (2 r r));
// 0 where bmu < 0), and accumulates acc = W.X and wsum = W.1 in registers.
// The guarded blend c + min(wsum, 1) * (acc / max(wsum, 1e-30) - c) is then
// written back IN PLACE: each CTA reads and writes only its own rows, and no
// other CTA reads them, so the in-place write is race-free.  The update's
// device code is shared with K5/K6 (som_grid.cuh).
//
// A model-axis shard of a larger map passes unit_offset, the global unit of
// its row 0 (0 on a whole map): W is evaluated at unit unit_offset + row,
// while the winners stay local rows, as the TPU wrapper reports them.
//
// Winners.  The updated tile stays in shared memory; for each next-batch
// sample the CTA takes the tile's (min, first argmin) of ||m||^2 - 2 m.x.
// Across CTAs the pair is packed as (order-preserving u32 of the float,
// u32 row) into a u64 and combined with atomicMin, which keeps the lowest
// index among equal values, the reference's tie rule (argmin_keys.cuh, shared
// with K4).
//
// The codebook is float32 or bf16 (SOMTrainer(bf16=True)): rows are read
// and upcast, blended in float32 and written back rounded to nearest even;
// the winners are taken against the float32 blended rows, as in the TPU
// kernel.
//
// What bounds it on H100: FP32 FMA issue and shared-memory loads (no tensor
// cores), plus one expf per (row, sample) for the gaussian.  Device memory
// traffic is one codebook read and write per step; the batch is re-read from
// L2 by every CTA.  Rows beyond noc (noc % TN != 0) are masked, never padded.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "argmin_keys.cuh"
#include "som_grid.cuh"

namespace {

// Shared memory: tile[TN][D] | xs[BC][DS] | ws[TN][BC] | m2s[TN] |
//                redv[THREADS] | redi[THREADS]
size_t smem_bytes(int D) {
  const int DS = D | 1;  // odd stride: per-sample rows hit distinct banks
  return sizeof(float) * ((size_t)TN * D + (size_t)BC * DS + TN * BC + TN +
                          THREADS) +
         sizeof(int) * THREADS;
}

template <int NJ, typename CT>
__global__ void __launch_bounds__(THREADS)
som_fused_step_kernel(CT* __restrict__ codes, int noc, int D,
                      const float* __restrict__ xb, const int* __restrict__ bmu,
                      const float* __restrict__ alpha, int B,
                      const float* __restrict__ xn, int Bn, int xdim, int hexa,
                      int gaussian, float radius, int unit_offset,
                      unsigned long long* __restrict__ keys) {
  extern __shared__ float smem[];
  const int DS = D | 1;
  float* tile = smem;
  float* xs = tile + TN * D;
  float* ws = xs + BC * DS;
  float* m2s = ws + TN * BC;
  float* redv = m2s + TN;
  int* redi = reinterpret_cast<int*>(redv + THREADS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * TN;

  // ---- update: acc = W.X, wsum = W.1 over the whole batch ----------------
  float acc[4][NJ];
  float wsum[4][1];
  accumulate_update<NJ, false>(acc, wsum, xs, nullptr, ws, r0, noc, D, xb,
                               nullptr, bmu, alpha, B, xdim, hexa != 0,
                               gaussian != 0, radius, unit_offset);

  // ---- guarded blend, written in place and kept in shared memory ---------
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
          const float c = load_f32(codes + (size_t)u * D + k);
          nc = guarded_blend(c, acc[i][j], wsum[i][0]);
          store_f32(codes + (size_t)u * D + k, nc);
        }
        tile[r * D + k] = nc;
        sq += nc * nc;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    if (lane == 0) m2s[r] = sq;
  }

  // ---- next batch's winners against the updated tile ---------------------
  // thread (warp, lane): rows 4 warp..4 warp+3 against sample lane
  for (int s0 = 0; s0 < Bn; s0 += BC) {
    __syncthreads();  // tile/m2s written; previous chunk's reduction read
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
    float bv = INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i;
      if (r0 + r < noc) {
        const float d = m2s[r] - 2.f * dot[i];
        if (d < bv) {  // rows ascend with i: strict < keeps the first
          bv = d;
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
        if (v < bv) {
          bv = v;
          bi = redi[w * 32 + lane];
        }
      }
      const int b = s0 + lane;
      if (b < Bn && bi != INT_MAX) fold_key(keys + b, bv, bi);
    }
  }
}

template <int NJ, typename CT>
int launch_step(CT* codes, int noc, int D, const float* xb, const int* bmu,
                const float* alpha, int B, const float* xn, int Bn, int xdim,
                int hexa, int gaussian, float radius, int unit_offset,
                unsigned long long* keys, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      som_fused_step_kernel<NJ, CT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  som_fused_step_kernel<NJ, CT><<<(noc + TN - 1) / TN, THREADS, smem, stream>>>(
      codes, noc, D, xb, bmu, alpha, B, xn, Bn, xdim, hexa, gaussian, radius,
      unit_offset, keys);
  return (int)cudaGetLastError();
}

template <typename CT>
int launch_any(CT* codes, int noc, int D, const float* xb, const int* bmu,
               const float* alpha, int B, const float* xn, int Bn, int xdim,
               int hexa, int gaussian, float radius, int unit_offset,
               unsigned long long* keys, cudaStream_t stream) {
  const int nj = (D + 31) / 32;
  if (nj <= 1)
    return launch_step<1>(codes, noc, D, xb, bmu, alpha, B, xn, Bn, xdim, hexa,
                          gaussian, radius, unit_offset, keys, stream);
  if (nj <= 2)
    return launch_step<2>(codes, noc, D, xb, bmu, alpha, B, xn, Bn, xdim, hexa,
                          gaussian, radius, unit_offset, keys, stream);
  if (nj <= 4)
    return launch_step<4>(codes, noc, D, xb, bmu, alpha, B, xn, Bn, xdim, hexa,
                          gaussian, radius, unit_offset, keys, stream);
  return launch_step<8>(codes, noc, D, xb, bmu, alpha, B, xn, Bn, xdim, hexa,
                        gaussian, radius, unit_offset, keys, stream);
}

}  // namespace

// codes (noc, D) float32, or bf16 with codes_bf16, updated in place
extern "C" int somvq_som_fused_step(void* codes, int codes_bf16, int noc, int D,
                                    const float* xb, const int* bmu,
                                    const float* alpha, int B, const float* xn,
                                    int Bn, int xdim, int hexa, int gaussian,
                                    float radius, int unit_offset,
                                    unsigned long long* keys, float* val,
                                    int* idx, cudaStream_t stream) {
  if (noc <= 0 || D <= 0 || D > MAX_D || B <= 0 || Bn <= 0 || xdim <= 0 ||
      unit_offset < 0)
    return (int)cudaErrorInvalidValue;
  init_keys<<<(Bn + 255) / 256, 256, 0, stream>>>(keys, Bn);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = codes_bf16
           ? launch_any(static_cast<__nv_bfloat16*>(codes), noc, D, xb, bmu,
                        alpha, B, xn, Bn, xdim, hexa, gaussian, radius,
                        unit_offset, keys, stream)
           : launch_any(static_cast<float*>(codes), noc, D, xb, bmu, alpha, B,
                        xn, Bn, xdim, hexa, gaussian, radius, unit_offset, keys,
                        stream);
  if (rc) return rc;
  unpack_keys<<<(Bn + 255) / 256, 256, 0, stream>>>(keys, Bn, val, idx);
  return (int)cudaGetLastError();
}
