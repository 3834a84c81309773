// The separable fused SOM step: batch t's neighbourhood update and batch
// t+1's winners against the updated rows, in one pass over the codebook, with
// the neighbourhood weight factored as W = Wx(column, row parity) * Wy(row).
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_fused_factored_kernel (K13)
// and _som_fused_factored_chunked_kernel (K14); both run one body under
// their own names, from the one entry somvq_som_fused_factored, and the
// wrapper som_fused_train_step routes to them as the TPU wrapper does.
//
// What they compute, with the TPU kernels' float32 algebra kept as it is:
// s = 1 / (2 r r); dx from columns and 0.5 offsets, hexa dy^2 = rowdiff^2 *
// 0.75 (exact in float32, so the bubble boundary is exact);
//   gaussian  Wx = alpha * expf(-dx^2 s), Wy = expf(-dy^2 s), W = Wx * Wy;
//   bubble    Wx = dx^2, Wy = dy^2, W = (Wx + Wy <= r r) ? alpha : 0;
// W = 0 where bmu < 0; acc = W.X, wsum = W.1 and the guarded blend; then the
// next batch's winners in max-score form, score = x.m - ||m||^2 / 2, reported
// as -2 * score, the lowest row on ties.
//
// K14 adds the batch-chunked kernel's bf16 options.  wxa_bf16 (gaussian
// only) keeps Wx rounded to bf16.  batch_bf16 rounds x and x' to bf16, rounds
// W to bf16 before its product with x (wsum keeps the unrounded W), and
// rounds the updated row to bf16 for the winners' dot products (||m||^2 from
// the float32 row).  A product of two bf16 values is exact in float32, so
// FP32 FMAs over the rounded operands give the MXU's products; only the order
// of the additions differs.  The TPU kernel's batch chunk is a VMEM device:
// here every launch walks the batch through shared memory in chunks anyway,
// so it has no counterpart in the kernel.
//
// The x-pattern.  The TPU kernels build the (pattern rows, B) table of Wx at
// grid step 0 into scratch that every later grid step reads, which holds only
// because the TPU grid runs in order.  Here a first small launch writes Wx,
// indexed by (row parity, column), Wy, indexed by grid row, and alpha (0 where
// bmu < 0) into buffers the wrapper allocates, and the main launch reads them
// (12 MB at 256x256 hexa, B 4096: L2-resident).  The TPU kernels' 0/1
// "expand" matmul that spreads Wy over a tile's rows (a relayout device) is
// the index Wy[u / xdim].
//
// The main launch has K3's structure (som_fused_step.cu): one CTA per 32
// codebook rows, the batch staged in shared memory 32 samples at a time, the
// chunk's weights built from the tables, FP32 FMAs into registers; the blend
// is written in place and the updated rows kept in shared memory for the
// winners.  Across CTAs each sample's (-2 * score, row) pair is folded with
// the packed-u64 atomicMin of argmin_keys.cuh, as K12 does: -2 * score is an
// exact, order-reversing scaling, so the smallest key is the largest score
// with the lowest row; -0 is folded to +0.
//
// The codebook is float32 or bf16 (SOMTrainer(bf16=True)): rows are read and
// upcast, blended in float32 and written back rounded to nearest even; the
// winners are taken against the float32 blended rows (rounded to bf16 only
// under batch_bf16), as in the TPU kernels.
//
// What bounds it on H100: FP32 FMA issue and shared-memory loads (no tensor
// cores), 4 noc B D FLOPs per step.  The exponentials drop from noc B (K3) to
// (pattern rows + grid rows) B, in the table launch.  Device memory traffic
// is one codebook read and write; the batches and the tables are re-read from
// L2 by every CTA.  Rows beyond noc (noc % 32 != 0) are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "argmin_keys.cuh"
#include "som_grid.cuh"

namespace {

__device__ __forceinline__ float to_pattern(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_pattern(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// The tables of one step, one thread per sample b.  pat[p][b] with p = parity
// * xdim + column (parity 0 only on a rect map): gaussian alpha_b *
// expf(-dx^2 s), stored as PT (bf16 rounds it), bubble dx^2; ytab[y][b] for
// grid row y: gaussian expf(-dy^2 s), bubble dy^2; aw[b]: alpha_b, 0 where
// bmu_b < 0.  Grid rows of the launch walk the n_pat + ydim table rows; the
// first also sets the Bn winner keys to their start value (init_keys).
template <typename PT>
__global__ void factored_tables_kernel(const int* __restrict__ bmu,
                                       const float* __restrict__ alpha, int B,
                                       int Bn, int xdim, int hexa, int gaussian,
                                       float radius, int n_pat, int ydim,
                                       PT* __restrict__ pat,
                                       float* __restrict__ ytab,
                                       float* __restrict__ aw,
                                       unsigned long long* __restrict__ keys) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.y == 0 && b < Bn) keys[b] = ~0ull;
  if (b >= B) return;
  const int bm = bmu[b];
  const bool none = bm < 0;
  const int bmc = none ? 0 : bm;
  const int bcol = bmc % xdim, brow = bmc / xdim;
  const float a = none ? 0.f : alpha[b];
  const float s = 1.0f / (2.0f * radius * radius);
  const float bx = hexa ? (float)bcol + 0.5f * (float)(brow & 1) : (float)bcol;
  if (blockIdx.y == 0) aw[b] = a;
  for (int p = blockIdx.y; p < n_pat + ydim; p += gridDim.y) {
    if (p < n_pat) {
      const int col = p % xdim, par = p / xdim;
      const float xq = hexa ? (float)col + 0.5f * (float)par : (float)col;
      const float dx = xq - bx;
      const float dx2 = dx * dx;
      pat[(size_t)p * B + b] = to_pattern(gaussian ? a * expf(-dx2 * s) : dx2, pat);
    } else {
      const int y = p - n_pat;
      const float rd = (float)(y - brow);
      const float dy2 = hexa ? (rd * rd) * 0.75f : rd * rd;
      ytab[(size_t)y * B + b] = gaussian ? expf(-dy2 * s) : dy2;
    }
  }
}

// Shared memory: tile[TN][D] | xs[BC][DS] | ws[TN][BC] | m2h[TN] |
//                redv[THREADS] | redi[THREADS]
size_t smem_bytes(int D) {
  const int DS = D | 1;  // odd stride: per-sample rows hit distinct banks
  return sizeof(float) * ((size_t)TN * D + (size_t)BC * DS + TN * BC + TN +
                          THREADS) +
         sizeof(int) * THREADS;
}

// One step on rows blockIdx.x * TN ..; kBatchBf16: 8c's batch_bf16
template <int NJ, typename CT, typename PT, bool kBatchBf16>
__device__ __forceinline__ void factored_step(
    CT* __restrict__ codes, int noc, int D, const float* __restrict__ xb,
    const float* __restrict__ aw, int B, const float* __restrict__ xn, int Bn,
    int xdim, int hexa, int gaussian, float radius, const PT* __restrict__ pat,
    const float* __restrict__ ytab, unsigned long long* __restrict__ keys) {
  extern __shared__ float smem[];
  const int DS = D | 1;
  float* tile = smem;
  float* xs = tile + TN * D;
  float* ws = xs + BC * DS;
  float* m2h = ws + TN * BC;
  float* redv = m2h + TN;
  int* redi = reinterpret_cast<int*>(redv + THREADS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * TN;
  const float r2 = radius * radius;

  // ---- update: acc = W.X, wsum = W.1 over the whole batch ----------------
  // thread (warp, lane): rows 4 warp..4 warp+3, columns lane + 32 j
  float acc[4][NJ];
  float wsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wsum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  for (int s0 = 0; s0 < B; s0 += BC) {
    __syncthreads();  // previous chunk fully consumed
    for (int e = tid; e < BC * D; e += THREADS) {
      const int s = e / D, k = e % D;
      float xv = (s0 + s < B) ? xb[(size_t)(s0 + s) * D + k] : 0.f;
      if (kBatchBf16) xv = bf16_round(xv);
      xs[s * DS + k] = xv;
    }
    for (int e = tid; e < TN * BC; e += THREADS) {
      const int r = e / BC, s = e % BC;
      const int u = r0 + r, b = s0 + s;
      float w = 0.f;
      if (u < noc && b < B) {
        const int row = u / xdim, col = u - row * xdim;
        const int p = (hexa ? (row & 1) * xdim : 0) + col;
        const float wx = load_f32(pat + (size_t)p * B + b);
        const float wy = ytab[(size_t)row * B + b];
        w = gaussian ? wx * wy : (wx + wy <= r2 ? aw[b] : 0.f);
      }
      ws[r * BC + s] = w;
    }
    __syncthreads();
    const int nb = min(BC, B - s0);
    for (int s = 0; s < nb; ++s) {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = ws[(warp * 4 + i) * BC + s];
        wsum[i] += w[i];
        if (kBatchBf16) w[i] = bf16_round(w[i]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int k = lane + 32 * j;
        const float xv = (k < D) ? xs[s * DS + k] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += w[i] * xv;
      }
    }
  }

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
          const size_t g = (size_t)u * D + k;
          nc = guarded_blend(load_f32(codes + g), acc[i][j], wsum[i]);
          store_f32(codes + g, nc);
        }
        tile[r * D + k] = kBatchBf16 ? bf16_round(nc) : nc;
        sq += nc * nc;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    if (lane == 0) m2h[r] = 0.5f * sq;
  }

  // ---- next batch's max-score winners against the updated tile -----------
  // thread (warp, lane): rows 4 warp..4 warp+3 against sample lane
  for (int s0 = 0; s0 < Bn; s0 += BC) {
    __syncthreads();  // tile/m2h written; previous chunk's reduction read
    for (int e = tid; e < BC * D; e += THREADS) {
      const int s = e / D, k = e % D;
      float xv = (s0 + s < Bn) ? xn[(size_t)(s0 + s) * D + k] : 0.f;
      if (kBatchBf16) xv = bf16_round(xv);
      xs[s * DS + k] = xv;
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
      if (r0 + r < noc) {
        const float sc = dot[i] - m2h[r];
        if (sc > bv) {  // rows ascend with i: strict > keeps the first
          bv = sc;
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

// K13: the separable step (float32 x-pattern and batches)
template <int NJ, typename CT>
__global__ void __launch_bounds__(THREADS)
som_fused_factored_kernel(CT* __restrict__ codes, int noc, int D,
                          const float* __restrict__ xb,
                          const float* __restrict__ aw, int B,
                          const float* __restrict__ xn, int Bn, int xdim,
                          int hexa, int gaussian, float radius,
                          const float* __restrict__ pat,
                          const float* __restrict__ ytab,
                          unsigned long long* __restrict__ keys) {
  factored_step<NJ, CT, float, false>(codes, noc, D, xb, aw, B, xn, Bn, xdim,
                                      hexa, gaussian, radius, pat, ytab, keys);
}

// K14: the batch-chunked step with its bf16 x-pattern (PT) and bf16 batches
template <int NJ, typename CT, typename PT, bool kBatchBf16>
__global__ void __launch_bounds__(THREADS)
som_fused_factored_chunked_kernel(CT* __restrict__ codes, int noc, int D,
                                  const float* __restrict__ xb,
                                  const float* __restrict__ aw, int B,
                                  const float* __restrict__ xn, int Bn,
                                  int xdim, int hexa, int gaussian,
                                  float radius, const PT* __restrict__ pat,
                                  const float* __restrict__ ytab,
                                  unsigned long long* __restrict__ keys) {
  factored_step<NJ, CT, PT, kBatchBf16>(codes, noc, D, xb, aw, B, xn, Bn, xdim,
                                        hexa, gaussian, radius, pat, ytab,
                                        keys);
}

// One step's arguments, as the C entry takes them
struct StepArgs {
  void* codes;
  int noc, D;
  const float* xb;
  const int* bmu;
  const float* alpha;
  int B;
  const float* xn;
  int Bn, xdim, hexa, gaussian;
  float radius;
  void* pat;
  float* ytab;
  float* aw;
  unsigned long long* keys;
  cudaStream_t stream;
};

// The main launch under K13's name (kChunked false) or K14's
template <int NJ, typename CT, typename PT, bool kBatchBf16, bool kChunked>
int launch_main(const StepArgs& a) {
  const size_t smem = smem_bytes(a.D);
  const unsigned grid = (a.noc + TN - 1) / TN;
  CT* codes = static_cast<CT*>(a.codes);
  const PT* pat = static_cast<const PT*>(a.pat);
  cudaError_t err;
  if constexpr (kChunked) {
    const auto kernel = som_fused_factored_chunked_kernel<NJ, CT, PT, kBatchBf16>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, smem, a.stream>>>(
        codes, a.noc, a.D, a.xb, a.aw, a.B, a.xn, a.Bn, a.xdim, a.hexa,
        a.gaussian, a.radius, pat, a.ytab, a.keys);
  } else {
    const auto kernel = som_fused_factored_kernel<NJ, CT>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, smem, a.stream>>>(
        codes, a.noc, a.D, a.xb, a.aw, a.B, a.xn, a.Bn, a.xdim, a.hexa,
        a.gaussian, a.radius, pat, a.ytab, a.keys);
  }
  return (int)cudaGetLastError();
}

// The table launch, then the main launch for D's register width
template <typename CT, typename PT, bool kBatchBf16, bool kChunked>
int run_step(const StepArgs& a) {
  const int n_pat = a.hexa ? 2 * a.xdim : a.xdim;
  const int ydim = (a.noc + a.xdim - 1) / a.xdim;
  const int trows = n_pat + ydim < 65535 ? n_pat + ydim : 65535;
  const dim3 tgrid(((a.B > a.Bn ? a.B : a.Bn) + 255) / 256, trows);
  factored_tables_kernel<PT><<<tgrid, 256, 0, a.stream>>>(
      a.bmu, a.alpha, a.B, a.Bn, a.xdim, a.hexa, a.gaussian, a.radius, n_pat,
      ydim, static_cast<PT*>(a.pat), a.ytab, a.aw, a.keys);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int nj = (a.D + 31) / 32;
  if (nj <= 1) return launch_main<1, CT, PT, kBatchBf16, kChunked>(a);
  if (nj <= 2) return launch_main<2, CT, PT, kBatchBf16, kChunked>(a);
  if (nj <= 4) return launch_main<4, CT, PT, kBatchBf16, kChunked>(a);
  return launch_main<8, CT, PT, kBatchBf16, kChunked>(a);
}

template <typename CT>
int run_flags(const StepArgs& a, int chunked, int wxa_bf16, int batch_bf16) {
  if (!chunked) return run_step<CT, float, false, false>(a);
  if (wxa_bf16 && batch_bf16) return run_step<CT, __nv_bfloat16, true, true>(a);
  if (wxa_bf16) return run_step<CT, __nv_bfloat16, false, true>(a);
  if (batch_bf16) return run_step<CT, float, true, true>(a);
  return run_step<CT, float, false, true>(a);
}

}  // namespace

// K13 (chunked 0) or K14 (chunked 1, with 8c's options wxa_bf16, gaussian
// only, and batch_bf16).  codes (noc, D) float32, or bf16 with codes_bf16,
// updated in place; xb (B, D), bmu (B,), alpha (B,), xn (Bn, D).  Scratch
// from the wrapper: keys (Bn,) u64; aw (B,), ytab (ceil(noc / xdim), B)
// float32 and pat (n_pat, B), n_pat = 2 xdim (hexa) or xdim, bf16 under
// wxa_bf16, else float32.  val gets -2 * the best score, idx its row.
extern "C" int somvq_som_fused_factored(
    void* codes, int codes_bf16, int noc, int D, const float* xb,
    const int* bmu, const float* alpha, int B, const float* xn, int Bn,
    int xdim, int hexa, int gaussian, float radius, int chunked, int wxa_bf16,
    int batch_bf16, void* pat, float* ytab, float* aw,
    unsigned long long* keys, float* val, int* idx, cudaStream_t stream) {
  if (noc <= 0 || D <= 0 || D > MAX_D || B <= 0 || Bn <= 0 || xdim <= 0 ||
      (!chunked && (wxa_bf16 || batch_bf16)) || (wxa_bf16 && !gaussian))
    return (int)cudaErrorInvalidValue;
  const StepArgs a{codes, noc, D,        xb,     bmu, alpha, B,    xn,    Bn,
                   xdim,  hexa, gaussian, radius, pat, ytab,  aw,   keys, stream};
  const int rc = codes_bf16
                     ? run_flags<__nv_bfloat16>(a, chunked, wxa_bf16, batch_bf16)
                     : run_flags<float>(a, chunked, wxa_bf16, batch_bf16);
  if (rc) return rc;
  unpack_keys<<<(Bn + 255) / 256, 256, 0, stream>>>(keys, Bn, val, idx);
  return (int)cudaGetLastError();
}
