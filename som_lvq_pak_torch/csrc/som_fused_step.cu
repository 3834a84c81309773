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
// What bounds it on H100: the two contractions, acc = W.X (noc x B x D) and
// the scores tile.X'^T (noc x B' x D).  On CUDA cores they ran at 10 FP32
// TFLOP/s (the matmul-only skeleton K17, then on CUDA cores too, took 90% of
// that step), so both now run on the tensor cores as split-TF32 mma.sync
// (tf32x3.cuh; K17 since runs the same route without the W generation, the
// blend and the argmin, fused_skeleton.cu): three TF32 products per float32
// product, float32 accumulators, float32 accuracy (about 2^-21 relative per
// product), a 495 / 3 = 165 TFLOP/s ceiling.
// mma.sync itself issues TF32 at two thirds of that peak on an H100
// (mma_probe.py), and the step reaches about 30% of what it issues
// (chip_smoke.py's route_pct, about a fifth of the peak, at 256x256 B
// 4096): the staging, the W values' division and expf and the scoring
// share the SM with the mma between barriers (wgmma fed from shared memory
// by a producer warp is the next step).
//
// Layout.  One CTA owns TN = 16 WARPS rows (128; 64 for D > 128); warp w
// owns the 16-row m-tile 16w.. and every feature column, so each W value is
// generated once per CTA and the batch is read from L2 once per 128 rows.
// Features are padded to DP = 8 NT (a power of two) with zeros in shared
// memory only.
//
// Update.  The batch is walked in BC-sample chunks: cp.async copies chunk
// c + 1 into one half of a double buffer while chunk c, split once into hi
// and lo arrays, feeds the mma.  Each sample's BMU grid x and row and its
// alpha (0 where bmu < 0 or past B) are staged once per chunk, each row's
// grid x and row once per CTA, so no (row, sample) pair pays an integer
// division.  Each thread builds the W values of its A fragments straight in
// registers with som_grid.cuh's weight_of_d2(grid_d2_at(...)), the float
// operations of neighborhood_w in the same order (W bit-identical to it;
// the rows enter as exact floats).  wsum is the float32 sum of the same W
// values: per thread in a fixed order (chunk, k-step, sample t then t + 4),
// then over the four lanes of a row by a fixed xor tree.  acc is a
// split-TF32 mma against the staged X, summed in the mma's accumulators
// over one chunk only, then added into float32
// registers with round-to-nearest adds: the tensor core's own accumulation
// loses low bits, and summed there over a whole batch of 4096 the blended
// rows drifted far enough from the plain step's to fail its bf16-codebook
// gate.  chip_smoke.py records both codebooks' distance from the blend taken
// in float64.
//
// Blend.  c + min(wsum, 1) * (acc / max(wsum, 1e-30) - c) (guarded_blend) is
// written back IN PLACE: each CTA reads and writes only its own rows.  A
// bf16 codebook is read upcast and written rounded to nearest even.  The
// float32 blended rows stay in shared memory, split into hi and lo, with
// their ||m||^2 (per-thread then xor-tree sums, fixed order) for the winners.
// Rows beyond noc are masked, never padded.
//
// Winners.  For each BW-sample chunk of the next batch (split once into hi
// and lo), S = tile.X'^T on the same split-TF32 mma, d = ||m||^2 - 2 S, the
// (min, first row) per sample over the CTA's rows by a lexicographic (value,
// row) merge, folded across CTAs as a packed u64 with atomicMin
// (argmin_keys.cuh): the lowest row among equal values, in any CTA order.
//
// Determinism.  Every sum runs in a fixed order inside one CTA: no split of
// the batch across CTAs, no float atomics.  A row's arithmetic depends only
// on its own data and its global unit (unit_offset + row), not on the tile
// or shard that holds it, so model-axis shards give the unsharded rows bit
// for bit and two runs are bit-equal.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "argmin_keys.cuh"
#include "som_grid.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kBC = 32;  // update: batch samples per chunk (4 k-steps)

// warps per CTA (16 rows each) and next-batch samples per winner chunk
// (8 n-tiles; 4 for D > 128, where 8 would not fit in 227 KB of shared
// memory)
__host__ __device__ constexpr int k3_warps(int NT) { return NT <= 16 ? 8 : 4; }
__host__ __device__ constexpr int k3_bw(int NT) { return NT <= 16 ? 64 : 32; }

// Shared memory (floats), two regions that are never live together:
// update: raw[2][kBC * D] | xhi, xlo [kBC][DSU] | smp[kBC] (float4: bmu
//         grid x, bmu row, alpha, 0)
// winner: thi, tlo [TN][DT] | whi, wlo [BW][DW] | m2s[TN] | redv, redi
//         [WARPS][BW]
template <int NT>
struct K3Smem {
  static constexpr int DP = 8 * NT, WARPS = k3_warps(NT), TN = 16 * WARPS,
                       BW = k3_bw(NT);
  static constexpr int DSU = stride_kn(DP), DT = stride_nk(DP), DW = DT;
  static size_t update_floats(int D) {
    return 2 * (size_t)kBC * D + 2 * (size_t)kBC * DSU + 4 * kBC;
  }
  static constexpr size_t winner_floats() {
    return 2 * (size_t)TN * DT + 2 * (size_t)BW * DW + TN + 2 * WARPS * BW;
  }
  static size_t bytes(int D) {
    const size_t u = update_floats(D), w = winner_floats();
    return sizeof(float) * (u > w ? u : w);
  }
};

template <int NT, typename CT>
__global__ void __launch_bounds__(32 * k3_warps(NT), NT <= 8 ? 2 : 1)
som_fused_step_kernel(CT* __restrict__ codes, int noc, int D,
                      const float* __restrict__ xb, const int* __restrict__ bmu,
                      const float* __restrict__ alpha, int B,
                      const float* __restrict__ xn, int Bn, int xdim, int hexa_i,
                      int gaussian_i, float radius, int unit_offset,
                      unsigned long long* __restrict__ keys) {
  using L = K3Smem<NT>;
  constexpr int DP = L::DP, WARPS = L::WARPS, TN = L::TN, BW = L::BW;
  constexpr int THREADS = 32 * WARPS;
  extern __shared__ __align__(16) float smem[];
  const bool hexa = hexa_i != 0, gaussian = gaussian_i != 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * TN;
  const float r2 = radius * radius;
  const float den = 2.0f * radius * radius;

  // ---- update: acc = W.X (split-TF32 mma), wsum = W.1 -----------------------
  float* raw0 = smem;
  float* raw1 = raw0 + kBC * D;
  float* xhi = raw1 + kBC * D;
  float* xlo = xhi + kBC * L::DSU;
  float4* smp = reinterpret_cast<float4*>(xlo + kBC * L::DSU);

  // this thread's two rows: 16 warp + g and + 8, at their global units
  float lx[2], fur[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = unit_offset + r0 + 16 * warp + g + 8 * h;
    lx[h] = grid_x(u % xdim, u / xdim, hexa);
    fur[h] = (float)(u / xdim);
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  float wsum[2] = {0.f, 0.f};

  const int nchunks = (B + kBC - 1) / kBC;
  cp_async_floats(raw0, xb, min(kBC, B) * D, tid, THREADS);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int s0 = c * kBC, nb = min(kBC, B - s0);
    float* raw = (c & 1) ? raw1 : raw0;
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; chunk c - 1's fragments all read
    if (c + 1 < nchunks) {  // its buffer was last read by chunk c - 1's split
      cp_async_floats((c & 1) ? raw0 : raw1, xb + (size_t)(s0 + kBC) * D,
                      min(kBC, B - s0 - kBC) * D, tid, THREADS);
      cp_async_commit();
    }
    for (int e = tid; e < kBC * DP; e += THREADS) {
      const int s = e / DP, k = e % DP;
      float hi, lo;
      split_tf32((s < nb && k < D) ? raw[s * D + k] : 0.f, hi, lo);
      xhi[s * L::DSU + k] = hi;
      xlo[s * L::DSU + k] = lo;
    }
    if (tid < kBC) {
      const int b = s0 + tid;
      const int bm = b < B ? bmu[b] : -1;
      // weight_of_d2 with alpha 0 is +0, neighborhood_w's 0 for bmu < 0
      smp[tid] = bm >= 0 ? make_float4(grid_x(bm % xdim, bm / xdim, hexa),
                                       (float)(bm / xdim), alpha[b], 0.f)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    float part[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[j][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kBC / 8; ++ks) {
      // A fragment: a0 (row g, sample t), a1 (g + 8, t), a2 (g, t + 4),
      // a3 (g + 8, t + 4)
      float w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 sm = smp[8 * ks + t + 4 * (q >> 1)];
        const int h = q & 1;
        w[q] = weight_of_d2(grid_d2_at(lx[h], fur[h], sm.x, sm.y, hexa), sm.z,
                            gaussian, r2, den);
      }
      wsum[0] += w[0];
      wsum[0] += w[2];
      wsum[1] += w[1];
      wsum[1] += w[3];
      float ahi[4], alo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(w[q], ahi[q], alo[q]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float bhi[2], blo[2];
        load_b_kn(bhi, xhi, L::DSU, 8 * ks, 8 * j, lane);
        load_b_kn(blo, xlo, L::DSU, 8 * ks, 8 * j, lane);
        mma_tf32x3(part[j], ahi, alo, bhi, blo);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] += part[j][q];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    wsum[h] += __shfl_xor_sync(0xffffffffu, wsum[h], 1);
    wsum[h] += __shfl_xor_sync(0xffffffffu, wsum[h], 2);
  }
  __syncthreads();  // every fragment read: the update region is free

  // ---- guarded blend, written in place; the tile kept split ---------------
  float* thi = smem;
  float* tlo = thi + TN * L::DT;
  float* whi = tlo + TN * L::DT;
  float* wlo = whi + BW * L::DW;
  float* m2s = wlo + BW * L::DW;
  float* redv = m2s + TN;
  int* redi = reinterpret_cast<int*>(redv + WARPS * BW);

  float sq[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // c0 (g, 2t), c1 (g, 2t + 1), c2, c3: g + 8
      const int h = q >> 1, r = 16 * warp + g + 8 * h, k = 8 * j + 2 * t + (q & 1);
      const int u = r0 + r;
      float nc = 0.f;
      if (k < D && u < noc) {
        CT* p = codes + (size_t)u * D + k;
        nc = guarded_blend(load_f32(p), acc[j][q], wsum[h]);
        store_f32(p, nc);
      }
      sq[h] += nc * nc;
      float hi, lo;
      split_tf32(nc, hi, lo);
      thi[r * L::DT + k] = hi;
      tlo[r * L::DT + k] = lo;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 1);
    sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 2);
    if (t == 0) m2s[16 * warp + g + 8 * h] = sq[h];
  }

  // ---- next batch's winners against the updated tile ---------------------
  for (int n0 = 0; n0 < Bn; n0 += BW) {
    __syncthreads();  // tile and m2s written; the previous chunk all read
    for (int e = tid; e < BW * DP; e += THREADS) {
      const int s = e / DP, k = e % DP;
      float hi, lo;
      split_tf32((n0 + s < Bn && k < D) ? xn[(size_t)(n0 + s) * D + k] : 0.f, hi,
                 lo);
      whi[s * L::DW + k] = hi;
      wlo[s * L::DW + k] = lo;
    }
    __syncthreads();
    float S[BW / 8][4];
#pragma unroll
    for (int n = 0; n < BW / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) S[n][q] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < NT; ++ks) {
      float ahi[4], alo[4];
      load_a(ahi, thi, L::DT, 16 * warp, 8 * ks, lane);
      load_a(alo, tlo, L::DT, 16 * warp, 8 * ks, lane);
#pragma unroll
      for (int n = 0; n < BW / 8; ++n) {
        float bhi[2], blo[2];
        load_b_nk(bhi, whi, L::DW, 8 * n, 8 * ks, lane);
        load_b_nk(blo, wlo, L::DW, 8 * n, 8 * ks, lane);
        mma_tf32x3(S[n], ahi, alo, bhi, blo);
      }
    }
    const int ra = r0 + 16 * warp + g, rb = ra + 8;
    const float m2a = m2s[16 * warp + g], m2b = m2s[16 * warp + g + 8];
#pragma unroll
    for (int n = 0; n < BW / 8; ++n) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // sample 8 n + 2 t + q: rows ra, then rb
        float bv = INFINITY;
        int bi = INT_MAX;
        if (ra < noc) {
          bv = m2a - 2.f * S[n][q];
          bi = ra;
        }
        if (rb < noc) {
          const float d = m2b - 2.f * S[n][2 + q];
          if (d < bv) {
            bv = d;
            bi = rb;
          }
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {  // the 8 lanes g of sample
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (lex_less(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (g == 0) {
          redv[warp * BW + 8 * n + 2 * t + q] = bv;
          redi[warp * BW + 8 * n + 2 * t + q] = bi;
        }
      }
    }
    __syncthreads();
    if (tid < BW) {
      float bv = INFINITY;
      int bi = INT_MAX;
      for (int w = 0; w < WARPS; ++w) {
        const float v = redv[w * BW + tid];
        const int i = redi[w * BW + tid];
        if (lex_less(v, i, bv, bi)) {
          bv = v;
          bi = i;
        }
      }
      const int b = n0 + tid;
      if (b < Bn && bi != INT_MAX) fold_key(keys + b, bv, bi);
    }
  }
}

template <int NT, typename CT>
int launch_step(CT* codes, int noc, int D, const float* xb, const int* bmu,
                const float* alpha, int B, const float* xn, int Bn, int xdim,
                int hexa, int gaussian, float radius, int unit_offset,
                unsigned long long* keys, cudaStream_t stream) {
  using L = K3Smem<NT>;
  const size_t smem = L::bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      som_fused_step_kernel<NT, CT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  som_fused_step_kernel<NT, CT>
      <<<(noc + L::TN - 1) / L::TN, 32 * L::WARPS, smem, stream>>>(
          codes, noc, D, xb, bmu, alpha, B, xn, Bn, xdim, hexa, gaussian, radius,
          unit_offset, keys);
  return (int)cudaGetLastError();
}

template <typename CT>
int launch_any(CT* codes, int noc, int D, const float* xb, const int* bmu,
               const float* alpha, int B, const float* xn, int Bn, int xdim,
               int hexa, int gaussian, float radius, int unit_offset,
               unsigned long long* keys, cudaStream_t stream) {
  const int k8 = (D + 7) / 8;  // 8-feature steps, padded up to a power of two
#define K3_LAUNCH(NT)                                                          \
  if (k8 <= NT)                                                              \
    return launch_step<NT>(codes, noc, D, xb, bmu, alpha, B, xn, Bn, xdim,   \
                           hexa, gaussian, radius, unit_offset, keys, stream);
  K3_LAUNCH(1)
  K3_LAUNCH(2)
  K3_LAUNCH(4)
  K3_LAUNCH(8)
  K3_LAUNCH(16)
  K3_LAUNCH(32)
#undef K3_LAUNCH
  return (int)cudaErrorInvalidValue;
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
