// One SOM training step in one pass over the codebook: the neighbourhood
// update of batch t, then batch t+1's winners against the updated rows.
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_fused_step_kernel (wrapper
// som_fused_train_step).  The factored and batch-chunked TPU kernels compute
// the same function and are also stood in for by this one.
//
// Update (tile-local).  One CTA owns TN codebook rows.  It walks the batch in
// BC-sample chunks staged in shared memory, builds the neighbourhood weight
// W[row, sample] from flat unit indices with the exact-f32 algebra of
// _neighborhood_w (dx from columns and 0.5 offsets, hexa dy^2 as
// rowdiff^2 * 0.75; bubble d2 <= r*r; gaussian alpha * expf(-d2 / (2 r r));
// 0 where bmu < 0), and accumulates acc = W.X and wsum = W.1 in registers.
// The guarded blend c + min(wsum, 1) * (acc / max(wsum, 1e-30) - c) is then
// written back IN PLACE: each CTA reads and writes only its own rows, and no
// other CTA reads them, so the in-place write is race-free.
//
// Winners.  The updated tile stays in shared memory; for each next-batch
// sample the CTA takes the tile's (min, first argmin) of ||m||^2 - 2 m.x.
// Across CTAs the pair is packed as (order-preserving u32 of the float,
// u32 row) into a u64 and combined with atomicMin, which keeps the lowest
// index among equal values, the reference's tie rule.  Initialising and
// unpacking the u64 keys are two small kernels in this file.
//
// What bounds it on H100: FP32 FMA issue and shared-memory loads (no tensor
// cores), plus one expf per (row, sample) for the gaussian.  Device memory
// traffic is one codebook read and write per step; the batch is re-read from
// L2 by every CTA.  Rows beyond noc (noc % TN != 0) are masked, never padded.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int TN = 32;        // codebook rows per CTA (8 warps x 4 rows)
constexpr int BC = 32;        // batch samples staged per chunk
constexpr int THREADS = 256;
constexpr int MAX_D = 256;    // 32 lanes x NJ (<= 8) columns

__device__ __forceinline__ unsigned int order_bits(float f) {
  unsigned int u = __float_as_uint(f == 0.f ? 0.f : f);  // -0 -> +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unorder_bits(unsigned int o) {
  const unsigned int u = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(u);
}

__global__ void init_keys(unsigned long long* keys, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) keys[i] = ~0ull;
}

__global__ void unpack_keys(const unsigned long long* __restrict__ keys, int n,
                            float* __restrict__ val, int* __restrict__ idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    const unsigned long long k = keys[i];
    val[i] = unorder_bits((unsigned int)(k >> 32));
    idx[i] = (int)(unsigned int)(k & 0xffffffffull);
  }
}

// exact-f32 squared grid distance between unit u and BMU bm
__device__ __forceinline__ float grid_d2(int u, int bm, int xdim, bool hexa) {
  const int uc = u % xdim, ur = u / xdim;
  const int bc = bm % xdim, br = bm / xdim;
  const float rd = (float)(ur - br);
  if (hexa) {
    const float lx = (float)uc + 0.5f * (float)(ur & 1);
    const float bx = (float)bc + 0.5f * (float)(br & 1);
    const float dx = lx - bx;
    return dx * dx + (rd * rd) * 0.75f;
  }
  const float dx = (float)uc - (float)bc;
  return dx * dx + rd * rd;
}

// Shared memory: tile[TN][D] | xs[BC][DS] | ws[TN][BC] | m2s[TN] |
//                redv[THREADS] | redi[THREADS]
size_t smem_bytes(int D) {
  const int DS = D | 1;  // odd stride: per-sample rows hit distinct banks
  return sizeof(float) * ((size_t)TN * D + (size_t)BC * DS + TN * BC + TN +
                          THREADS) +
         sizeof(int) * THREADS;
}

template <int NJ>
__global__ void __launch_bounds__(THREADS)
som_fused_step_kernel(float* __restrict__ codes, int noc, int D,
                      const float* __restrict__ xb, const int* __restrict__ bmu,
                      const float* __restrict__ alpha, int B,
                      const float* __restrict__ xn, int Bn, int xdim, int hexa,
                      int gaussian, float radius,
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
  const float r2 = radius * radius;
  const float den = 2.0f * radius * radius;

  // ---- update: acc = W.X, wsum = W.1 over the whole batch ----------------
  // warp w owns rows 4w..4w+3; lane owns columns lane + 32 j
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
      xs[s * DS + k] = (s0 + s < B) ? xb[(size_t)(s0 + s) * D + k] : 0.f;
    }
    for (int e = tid; e < TN * BC; e += THREADS) {
      const int r = e / BC, s = e % BC;
      const int u = r0 + r, b = s0 + s;
      float w = 0.f;
      if (b < B && u < noc) {
        const int bm = bmu[b];
        if (bm >= 0) {
          const float d2 = grid_d2(u, bm, xdim, hexa != 0);
          w = gaussian ? alpha[b] * expf(-d2 / den) : (d2 <= r2 ? alpha[b] : 0.f);
        }
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
    const float safe = fmaxf(wsum[i], 1e-30f);
    const float blend = fminf(wsum[i], 1.0f);
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int k = lane + 32 * j;
      if (k < D) {
        float nc = 0.f;
        if (u < noc) {
          const float c = codes[(size_t)u * D + k];
          nc = c + blend * (acc[i][j] / safe - c);
          codes[(size_t)u * D + k] = nc;
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
      if (b < Bn && bi != INT_MAX) {
        const unsigned long long key =
            ((unsigned long long)order_bits(bv) << 32) | (unsigned int)bi;
        // keys only decrease, so a stale read can only cost a spare atomic
        if (key < __ldcg(keys + b)) atomicMin(keys + b, key);
      }
    }
  }
}

template <int NJ>
int launch_step(float* codes, int noc, int D, const float* xb, const int* bmu,
                const float* alpha, int B, const float* xn, int Bn, int xdim,
                int hexa, int gaussian, float radius, unsigned long long* keys,
                cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      som_fused_step_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  som_fused_step_kernel<NJ><<<(noc + TN - 1) / TN, THREADS, smem, stream>>>(
      codes, noc, D, xb, bmu, alpha, B, xn, Bn, xdim, hexa, gaussian, radius,
      keys);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int somvq_som_fused_step(float* codes, int noc, int D,
                                    const float* xb, const int* bmu,
                                    const float* alpha, int B, const float* xn,
                                    int Bn, int xdim, int hexa, int gaussian,
                                    float radius, unsigned long long* keys,
                                    float* val, int* idx, cudaStream_t stream) {
  if (noc <= 0 || D <= 0 || D > MAX_D || B <= 0 || Bn <= 0 || xdim <= 0)
    return (int)cudaErrorInvalidValue;
  init_keys<<<(Bn + 255) / 256, 256, 0, stream>>>(keys, Bn);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int nj = (D + 31) / 32;
  if (nj <= 1)
    rc = launch_step<1>(codes, noc, D, xb, bmu, alpha, B, xn, Bn, xdim, hexa,
                        gaussian, radius, keys, stream);
  else if (nj <= 2)
    rc = launch_step<2>(codes, noc, D, xb, bmu, alpha, B, xn, Bn, xdim, hexa,
                        gaussian, radius, keys, stream);
  else if (nj <= 4)
    rc = launch_step<4>(codes, noc, D, xb, bmu, alpha, B, xn, Bn, xdim, hexa,
                        gaussian, radius, keys, stream);
  else
    rc = launch_step<8>(codes, noc, D, xb, bmu, alpha, B, xn, Bn, xdim, hexa,
                        gaussian, radius, keys, stream);
  if (rc) return rc;
  unpack_keys<<<(Bn + 255) / 256, 256, 0, stream>>>(keys, Bn, val, idx);
  return (int)cudaGetLastError();
}
