// K17 on Hopper: the fused step's skeleton, the matmul-only twin of K3
// (fused_step_sm90.cu), for D <= 128 (wider D: fused_skeleton.cu's mma.sync
// kernel, the route ops.skeleton.k17_route names).
//
// Replaces bench.py:_skeleton_kernel (:505, K17 fused_step_skeleton), as
// fused_skeleton.cu does for wider D; that file's header says what the
// function is: out[u] = codes[u] + scale * sum_b w[u % T, b] x[b] and
// vmax[b] = max_u out[u] . x'[b], out rounded to x''s type first.
//
// What bounds it on H100: the two contractions as every CTA runs them, W.X
// for its own rows included (4 N B D FLOPs), as split TF32 for float32
// operands (three TF32 products) and one TF32 product for bf16 ones (a bf16
// value is exact in TF32), at 495 TFLOP/s.
//
// The design is K3's walk (fused_step_sm90.cuh) with K17's parts, so that
// chip_smoke.py's attainable_pct compares two kernels on one route:
//   * W (BlockW): read, not built.  The consumers load their rows' W values
//     (row (r0 + r) % T of the block) from global memory one chunk ahead and
//     split them in registers into wgmma's A fragments; the mma.sync
//     kernel's k index is kept (lane t's columns t and t + 4 of k step ks are
//     samples 8 t + 2 ks and + 1), the prologue writing the transposed batch
//     in that order (split_sm90_kernel's kPerm), so the update's sums are
//     that kernel's bit for bit.
//   * The rows: out = codes + scale * acc written, the rows rounded to x''s
//     type kept split (one plane for bf16) for the winners.
//   * The fold: the maximum of a thread's 32 valid rows for each of its two
//     samples, then over the sample's four lanes, then across CTAs by
//     atomicMax on the order-preserving image of the float (-0 to +0), read
//     back by a second launch: the maximum whatever the order, so vmax is
//     the mma.sync kernel's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "argmin_keys.cuh"
#include "fused_step_sm90.cuh"
#include "skeleton_w.cuh"

namespace {

using namespace fs90;

// W read from the block: this thread's rows 16 warp + g and + 8, samples
// 8 t.. 8 t + 7 of each chunk, loaded one chunk ahead
template <typename T, int P>
struct BlockW {
  const T* wrow[2];
  int B;
  bool vec;
  float wv[2][8];

  __device__ __forceinline__ void build(float (&hi)[4][4], float (&lo)[4][4],
                                        const unsigned char*, int c) {
    // a0 (row g, sample 8 t + 2 ks), a1 (g + 8), a2 (g, next sample), a3
#pragma unroll
    for (int ks = 0; ks < UC / 8; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split_route<P == 2>(wv[q & 1][2 * ks + (q >> 1)], hi[ks][q], lo[ks][q]);
    // the next chunk's values; the vector loads where the whole chunk lies
    // below B (a condition the warp shares: no divergent path while the
    // products run), element by element where it does not
    const int s = (c + 1) * UC + 8 * (threadIdx.x & 3);
    if ((c + 2) * UC <= B && vec) {
#pragma unroll
      for (int h = 0; h < 2; ++h) load_w8(wv[h], wrow[h], s, B, true);
    } else if ((c + 1) * UC < B) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 8; ++i) {  // a clamped load, then a select
          const float v = load_f32(wrow[h] + min(s + i, B - 1));
          wv[h][i] = s + i < B ? v : 0.f;
        }
    }
  }
};

template <int DP, typename T>
__global__ void __launch_bounds__(THREADS, 1)
fused_skeleton_sm90_kernel(const __grid_constant__ CUtensorMap xt_map,
                           const __grid_constant__ CUtensorMap xn_map,
                           const float* __restrict__ codes, int N, int D,
                           const T* __restrict__ w, int T_rows, int B, int Bn, float scale,
                           float* __restrict__ out, unsigned int* __restrict__ vkeys) {
  constexpr int P = std::is_same<T, float>::value ? 2 : 1;
  using L = Layout<DP, P, false>;
  constexpr int NT = DP / 8;
  unsigned char* tile;
  float* m2s;
  Ring ring = setup<L>(tile, m2s);
  const int nu = (B + UC - 1) / UC, nw = (Bn + WC - 1) / WC;
  if (threadIdx.x >= ALL) {  // the producer warpgroup: one thread
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == ALL) produce<L, P>(ring, &xt_map, &xn_map, nullptr, nu, nw,
                                          round_up(Bn, 64));
    return;
  }
  sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * TN;

  // ---- update: acc = W.X over the whole batch -------------------------------
  BlockW<T, P> wb;
  wb.B = B;
  wb.vec = (reinterpret_cast<uintptr_t>(w) & 15) == 0 && B % (int)(16 / sizeof(T)) == 0;
  // rows past N read a valid W row; they are never written or scored
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    wb.wrow[h] = w + (size_t)((r0 + 16 * warp + g + 8 * h) % T_rows) * B;
    load_w8(wb.wv[h], wb.wrow[h], 8 * t, B, wb.vec);
  }
  float acc[NT][4];
  update_walk<DP, P>(acc, wb, ring, nu, consumer_wg(), lane);

  // ---- out = codes + scale * acc; the rows kept as x''s type, split ---------
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // c0 (g, 2t), c1 (g, 2t + 1), c2, c3: g + 8
      const int r = 16 * warp + g + 8 * (q >> 1), k = 8 * j + 2 * t + (q & 1);
      const int u = r0 + r;
      float o = 0.f;
      if (k < D && u < N) {
        const size_t gi = (size_t)u * D + k;
        o = codes[gi] + __fmul_rn(acc[j][q], scale);
        out[gi] = o;
      }
      float hi, lo;
      split_route<P == 2>(round_as(o, static_cast<const T*>(nullptr)), hi, lo);
      *reinterpret_cast<float*>(tile + tile_offset<DP>(0, r, k)) = hi;
      if constexpr (P == 2) *reinterpret_cast<float*>(tile + tile_offset<DP>(1, r, k)) = lo;
    }
  }
  sm90::fence_proxy_async();
  sm90::bar_sync(1, ALL);  // the tile written
  // this thread's rows 8 j + 2 t + e that lie below N: bit 2 j + e (all,
  // but in the last CTA)
  const int rows = N - r0;
  uint32_t valid = 0u;
#pragma unroll
  for (int c = 0; c < 32; ++c)
    if (8 * (c >> 1) + 2 * t + (c & 1) < rows) valid |= 1u << c;

  // ---- vmax[b] = max over the CTA's rows of row . x'[b] ----------------------
  winner_walk<L, P>(ring, tile, nw, consumer_wg(), lane, [&](float (&S)[64], int n0) {
    // the two samples' keys as folded so far, read first: the loads run
    // under the trees below
    unsigned int* key[2];
    unsigned int cur[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      key[h] = vkeys + min(n0 + 16 * (warp & 3) + g + 8 * h, Bn - 1);
      cur[h] = __ldcg(key[h]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m[16];
      if (rows >= TN) {  // the CTA's rows all lie below N
#pragma unroll
        for (int i = 0; i < 16; ++i) m[i] = fmaxf(S[4 * i + 2 * h], S[4 * i + 2 * h + 1]);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {  // rows 8 i + 2 t and + 1
          const float a = (valid >> (2 * i)) & 1u ? S[4 * i + 2 * h] : -INFINITY;
          const float b = (valid >> (2 * i + 1)) & 1u ? S[4 * i + 2 * h + 1] : -INFINITY;
          m[i] = fmaxf(a, b);
        }
      }
#pragma unroll
      for (int w8 = 8; w8 >= 1; w8 >>= 1)
#pragma unroll
        for (int i = 0; i < w8; ++i) m[i] = fmaxf(m[i], m[i + w8]);
      float bv = m[0];
      bv = fmaxf(bv, __shfl_xor_sync(0xffffffffu, bv, 1));
      bv = fmaxf(bv, __shfl_xor_sync(0xffffffffu, bv, 2));
      const int b = n0 + 16 * (warp & 3) + g + 8 * h;
      fold_max_u32(key[h], order_bits(bv), cur[h], t == 0 && b < Bn);
    }
  });
}

template <int DP, typename T>
int launch_walk(const float* codes, int N, int D, const T* w, int T_rows, int B, int Bn,
                float scale, const float* xs, float* out, unsigned int* vkeys,
                cudaStream_t stream) {
  constexpr int P = std::is_same<T, float>::value ? 2 : 1;
  using L = Layout<DP, P, false>;
  CUtensorMap xt, xnr;
  const int rc = encode_maps<P>(&xt, &xnr, nullptr, xs, B, Bn, DP);
  if (rc) return rc;
  const auto kernel = fused_skeleton_sm90_kernel<DP, T>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<(N + TN - 1) / TN, THREADS, L::BYTES, stream>>>(xt, xnr, codes, N, D, w, T_rows,
                                                           B, Bn, scale, out, vkeys);
  return (int)cudaGetLastError();
}

// the prologue (x in the mma.sync kernel's k order), then the walk
template <typename T>
int skeleton(const float* codes, int N, int D, const T* w, int T_rows, const T* x, int B,
             const T* xn, int Bn, float scale, float* xs, float* out, unsigned int* vkeys,
             cudaStream_t stream) {
  constexpr int P = std::is_same<T, float>::value ? 2 : 1;
  const int DP = dp_of(D);
  const int rc = split_sm90<T, P, true>(x, B, xn, Bn, D, DP, xs, nullptr, nullptr, 1, 0,
                                        stream);
  if (rc) return rc;
  if (DP == 32)
    return launch_walk<32>(codes, N, D, w, T_rows, B, Bn, scale, xs, out, vkeys, stream);
  if (DP == 64)
    return launch_walk<64>(codes, N, D, w, T_rows, B, Bn, scale, xs, out, vkeys, stream);
  return launch_walk<128>(codes, N, D, w, T_rows, B, Bn, scale, xs, out, vkeys, stream);
}

__global__ void skeleton_sm90_unorder(const unsigned int* __restrict__ keys, int n,
                                      float* __restrict__ vmax) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) vmax[i] = unorder_bits(keys[i]);
}

}  // namespace

// K17 for D <= 128: codes (N, D) float32; w (T_rows, B), x (B, D), xn (Bn,
// D) all float32, or all bf16 with bf16; out (N, D) float32 gets codes +
// scale * W.X row by row (W row u % T_rows); vkeys (Bn,) u32 set to 0 by the
// wrapper; vmax (Bn,) gets max_u out[u] . xn[b], out rounded to xn's type;
// xs scratch for the prologue, 16-byte aligned: P DP (Bp + Bnp) floats (P 2
// for float32, 1 for bf16; B and Bn rounded up to 64; DP = 32, 64 or 128)
extern "C" int somvq_fused_skeleton_sm90(const float* codes, int N, int D, const void* w,
                                         int T_rows, const void* x, int B, const void* xn,
                                         int Bn, int bf16, float scale, float* out,
                                         unsigned int* vkeys, float* vmax, float* xs,
                                         cudaStream_t stream) {
  if (N <= 0 || D <= 0 || dp_of(D) == 0 || T_rows <= 0 || B <= 0 || Bn <= 0 || !xs ||
      (reinterpret_cast<uintptr_t>(xs) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int rc =
      bf16 ? skeleton(codes, N, D, static_cast<const __nv_bfloat16*>(w), T_rows,
                      static_cast<const __nv_bfloat16*>(x), B,
                      static_cast<const __nv_bfloat16*>(xn), Bn, scale, xs, out, vkeys, stream)
           : skeleton(codes, N, D, static_cast<const float*>(w), T_rows,
                      static_cast<const float*>(x), B, static_cast<const float*>(xn), Bn,
                      scale, xs, out, vkeys, stream);
  if (rc) return rc;
  skeleton_sm90_unorder<<<(Bn + 255) / 256, 256, 0, stream>>>(vkeys, Bn, vmax);
  return (int)cudaGetLastError();
}
