// The fused step's skeleton: the matmul-only twin of the fused SOM step, the
// yardstick of how much of a fused step's time its two contractions take.
// This mma.sync kernel takes D > 128 (NT 32 only; past 256 in feature passes
// of 256, as fused_step_tc.cuh's kernels), K3's mma.sync route; up to D 128 K17 runs K3's Hopper walk (fused_skeleton_sm90.cu,
// bit-equal to this kernel; ops.skeleton.k17_route).
//
// Replaces bench.py:_skeleton_kernel (K17 fused_step_skeleton, called at
// bench.py:556).  Per 256-row tile the TPU kernel accumulates acc = W(256, B)
// . X(B, D), writes codes + acc * 1e-30, and folds the running max over tiles
// of out . x'^T into a (1, B) row, with no weight generation, no blend and no
// argmax.  One W block serves every tile (bench.py:561), so row u of the
// output is codes[u] + scale * sum_b w[u % T, b] x[b], T = w's rows (256 in
// the bench), and vmax[b] = max_u out[u] . x'[b], out rounded to x''s type
// first (bench.py:529).  W, X and X' are all float32 or all bf16
// (bench.py:585-587); every sum is float32.  `scale` (1e-30 in the bench,
// below the ulp of every code) is an argument only so that a check can see
// the accumulation.
//
// The kernel stays the step's twin: like bench.py's kernel and K3
// (som_fused_step.cu), every CTA runs both contractions for its own rows,
// W.X included (4 N B D FLOPs where W.X once would be 2 T B D + 2 N B D),
// so chip_smoke.py's attainable_pct compares two kernels that do the same
// work on the same route.
//
// What bounds it on H100: the two contractions.  Both run on the tensor
// cores as K3's do (tf32x3.cuh): float32 operands as split TF32, three
// mma.sync.m16n8k8 products per float32 product (about 2^-21 relative per
// product, a 495 / 3 = 165 TFLOP/s ceiling); bf16 operands as ONE TF32
// product, since a bf16 value (8 significant bits) is exact in TF32 (11),
// so hi * hi is already the exact product and lo is zero (the bf16-rounded
// rows against a bf16 x' alike).  A BF16 m16n8k16 route would halve the
// k-steps of the bf16 twin; one TF32 pass was built because it shares every
// fragment layout and loop with the float32 route.
//
// Layout.  One CTA owns TN = 16 WARPS rows (128; 64 for D > 128); warp w
// owns the 16-row m-tile 16w.. and every feature column.  Features are
// padded to DP = 8 NT (a power of two) with zeros in shared memory only.
// Each thread's two fragment values of one k-step sit next to each other in
// shared memory, so a fragment is one 8-byte load (conflict-free strides):
//
// Update.  The batch is walked in 32-sample chunks, in batch order.  The
// mma's k index is permuted (it only has to agree between A and B): lane
// (g, t) takes samples 8t + 2ks and 8t + 2ks + 1 as its A columns t and
// t + 4 of k-step ks, so its W values of a chunk are 8 contiguous floats of
// each of its two rows w[u % T], read from global memory (the W block, T x
// B, sits in L2) into registers one chunk ahead.  The X chunk is copied by
// cp.async into one half of a double buffer while the previous one is used,
// then split once into hi and lo arrays of sample pairs, (x[2p][n],
// x[2p+1][n]) per float2.  The mma sums one chunk only; its sums are then
// added into float32 registers with round-to-nearest adds (K3's lesson: the
// tensor core's own accumulation drops low bits over a 4096-sample sum).
//
// Rows.  out = codes + scale * acc is written; the rows, rounded to x''s
// type, stay in shared memory split into hi and lo, features in the order
// t, t + 4 within each group of 8.  Rows beyond N are zero and masked.
//
// Winners.  For each BW-sample chunk of x' (split once the same way), S =
// rows.x'^T on the same mma; the maximum over the CTA's rows by a fixed
// xor tree and a pass over the warps, folded across CTAs by atomicMax on
// the order-preserving unsigned image of the float (argmin_keys.cuh, -0
// folded to +0), read back by a second launch.  Every sum runs in a fixed
// order, so two runs are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "argmin_keys.cuh"
#include "skeleton_w.cuh"
#include "som_grid.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kSBC = 32;  // update: batch samples per chunk (4 k-steps)

// warps per CTA (16 rows each) and x' samples per winner chunk, K3's sizes
__host__ __device__ constexpr int sk_warps(int NT) { return NT <= 16 ? 8 : 4; }
__host__ __device__ constexpr int sk_bw(int NT) { return NT <= 16 ? 64 : 32; }

// feature k's place in shared memory: within each group of 8, feature t at
// 2t and t + 4 at 2t + 1, a lane's two fragment columns side by side
__device__ __forceinline__ int kperm(int k) {
  return (k & ~7) | ((k & 3) << 1) | ((k >> 2) & 1);
}

// Shared memory, two regions never live together (P = 2 parts, hi and lo,
// for float32 operands; 1 for bf16):
// update: raw[2][kSBC * D] (T) | xp[P][kSBC / 2][S2] (float2: a sample pair)
// winner: tile[P][TN][DT] | xs[P][BW][DT] | redv[WARPS][BW]
template <int NT, typename T>
struct SkSmem {
  static constexpr bool kSplit = std::is_same<T, float>::value;
  static constexpr int P = kSplit ? 2 : 1;
  static constexpr int DP = 8 * NT, WARPS = sk_warps(NT), TN = 16 * WARPS,
                       BW = sk_bw(NT);
  static constexpr int S2 = DP + 1;        // float2 per pair row: 1 mod 4
  static constexpr int DT = stride_kn(DP);  // floats per row: 8 mod 32
  __host__ __device__ static size_t raw_bytes(int D) {
    return 2 * (size_t)kSBC * D * sizeof(T);
  }
  static size_t update_bytes(int D) {
    return raw_bytes(D) + sizeof(float2) * P * (kSBC / 2) * S2;
  }
  static constexpr size_t winner_bytes() {
    return sizeof(float) * (P * ((size_t)TN * DT + (size_t)BW * DT) + WARPS * BW);
  }
  static size_t bytes(int D) {
    const size_t u = update_bytes(D), w = winner_bytes();
    return u > w ? u : w;
  }
};

// Copy n elements from global to shared with cp.async (bf16 as 4-byte
// words, a last odd element or an unaligned source by plain copies)
template <typename T>
__device__ __forceinline__ void stage_async(T* dst, const T* src, int n, int tid,
                                            int nthreads) {
  if constexpr (sizeof(T) == 4) {
    cp_async_floats(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src),
                    n, tid, nthreads);
  } else {
    if (reinterpret_cast<uintptr_t>(src) & 3) {
      for (int i = tid; i < n; i += nthreads) dst[i] = src[i];
      return;
    }
    cp_async_floats(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src),
                    n / 2, tid, nthreads);
    if ((n & 1) && tid == 0) dst[n - 1] = src[n - 1];
  }
}

// d += a b: three TF32 products on split operands, one on exact ones
template <bool kSplit>
__device__ __forceinline__ void mma_route(float (&d)[4], const float (&ahi)[4],
                                          const float (&alo)[4], const float (&bhi)[2],
                                          const float (&blo)[2]) {
  if constexpr (kSplit) {
    mma_tf32x3(d, ahi, alo, bhi, blo);
  } else {
    mma_tf32(d, ahi, bhi);
  }
}

// Stage chunk rows s0..s0 + nb - 1 of x into raw: whole rows (RS == D) in
// one piece, or features f0..f0 + width - 1 of each row into rows of RS
// (the feature passes): float32 by cp.async (16-byte pieces where aligned),
// bf16 by plain copies (seen after the next barrier)
template <typename T>
__device__ __forceinline__ void stage_slab(T* raw, const T* __restrict__ x, int s0, int nb,
                                           int D, int f0, int width, int RS, int tid,
                                           int nthreads) {
  const size_t off = (size_t)s0 * D;
  if (RS == D) {
    stage_async(raw, x + off, nb * D, tid, nthreads);
    return;
  }
  if constexpr (sizeof(T) == 4) {
    const bool v16 = (D & 3) == 0 && (width & 3) == 0 && (f0 & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    if (v16) {
      const int q = width / 4;
      for (int e = tid; e < nb * q; e += nthreads) {
        const int r = e / q, k = 4 * (e - r * q);
        cp_async16(raw + r * RS + k, x + off + (size_t)r * D + f0 + k);
      }
      return;
    }
    for (int e = tid; e < nb * width; e += nthreads) {
      const int r = e / width, k = e - r * width;
      cp_async4(raw + r * RS + k, x + off + (size_t)r * D + f0 + k);
    }
  } else {
    for (int e = tid; e < nb * width; e += nthreads) {
      const int r = e / width, k = e - r * width;
      raw[r * RS + k] = x[off + (size_t)r * D + f0 + k];
    }
  }
}

// Past 256 features (NT 32) the kernel runs n_passes(D) feature passes of
// 256: pass s stages slab s of each chunk's rows alone, takes its W.X (W
// read again: the same floats each pass) and writes its columns of out; the
// winners then sum each chunk's scores in the mma over the slabs in order,
// each slab of out read back (through L2: this CTA's own rows, written
// before a barrier) and rounded to x''s type, beside the chunk's slab of x'.
template <int NT, typename T>
__global__ void __launch_bounds__(32 * sk_warps(NT), NT <= 8 ? 2 : 1)
fused_skeleton_kernel(const float* __restrict__ codes, int N, int D,
                      const T* __restrict__ w, int T_rows, const T* __restrict__ x,
                      int B, const T* __restrict__ xn, int Bn, float scale,
                      float* out, unsigned int* __restrict__ vkeys) {
  using L = SkSmem<NT, T>;
  constexpr bool kSplit = L::kSplit;
  constexpr int DP = L::DP, WARPS = L::WARPS, TN = L::TN, BW = L::BW;
  constexpr int THREADS = 32 * WARPS, S2 = L::S2, DT = L::DT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * TN;
  const int np = NT == 32 ? n_passes(D) : 1;
  const int RS = np > 1 ? DP : D;  // a staged row: whole, or one slab

  // ---- update: acc = W.X over the whole batch ------------------------------
  T* raw0 = reinterpret_cast<T*>(smem_raw);
  T* raw1 = raw0 + kSBC * RS;
  float2* xhi = reinterpret_cast<float2*>(smem_raw + L::raw_bytes(RS));
  float2* xlo = xhi + (kSBC / 2) * S2;  // float32 operands only

  // this thread's two W rows, 16 warp + g and + 8 (rows past N read a valid
  // W row; they are never written or scored)
  const T* wrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    wrow[h] = w + (size_t)((r0 + 16 * warp + g + 8 * h) % T_rows) * B;
  const bool wvec = (reinterpret_cast<uintptr_t>(w) & 15) == 0 &&
                    B % (int)(16 / sizeof(T)) == 0;

  float* thi = reinterpret_cast<float*>(smem_raw);
  float* tlo = thi + TN * DT;                  // float32 operands only
  float* whi = thi + L::P * TN * DT;
  float* wlo = whi + BW * DT;                  // float32 operands only
  float* redv = whi + L::P * BW * DT;

  for (int ps = 0; ps < np; ++ps) {
    const int f0 = ps * DP, width = min(DP, D - f0);
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

    const int nchunks = (B + kSBC - 1) / kSBC;
    float wv[2][8];  // this thread's W values of the next chunk
#pragma unroll
    for (int h = 0; h < 2; ++h) load_w8(wv[h], wrow[h], 8 * t, B, wvec);
    stage_slab(raw0, x, 0, min(kSBC, B), D, f0, width, RS, tid, THREADS);
    cp_async_commit();
    for (int c = 0; c < nchunks; ++c) {
      const int s0 = c * kSBC, nb = min(kSBC, B - s0);
      const T* raw = (c & 1) ? raw1 : raw0;
      cp_async_wait_all();
      __syncthreads();  // chunk c landed; chunk c - 1's fragments all read
      if (c + 1 < nchunks) {  // its buffer was last read by chunk c - 1's split
        stage_slab((c & 1) ? raw0 : raw1, x, s0 + kSBC, min(kSBC, B - s0 - kSBC), D, f0,
                   width, RS, tid, THREADS);
        cp_async_commit();
      }
      // X chunk c as sample pairs (2p, 2p + 1), split
      for (int e = tid; e < (kSBC / 2) * DP; e += THREADS) {
        const int p = e / DP, n = e % DP;
        float v0 = 0.f, v1 = 0.f;
        if (n < width) {
          if (2 * p < nb) v0 = load_f32(raw + 2 * p * RS + n);
          if (2 * p + 1 < nb) v1 = load_f32(raw + (2 * p + 1) * RS + n);
        }
        float2 hi, lo;
        split_route<kSplit>(v0, hi.x, lo.x);
        split_route<kSplit>(v1, hi.y, lo.y);
        xhi[p * S2 + n] = hi;
        if constexpr (kSplit) xlo[p * S2 + n] = lo;
      }
      // chunk c's A fragments from the W values loaded one chunk ahead:
      // k-step ks, columns t and t + 4 are samples 8t + 2ks and 8t + 2ks + 1;
      // a0 (row g), a1 (g + 8), a2 (g, next sample), a3 (g + 8, next sample)
      float ahi[4][4], alo[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_route<kSplit>(wv[q & 1][2 * ks + (q >> 1)], ahi[ks][q], alo[ks][q]);
      if (c + 1 < nchunks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) load_w8(wv[h], wrow[h], s0 + kSBC + 8 * t, B, wvec);
      }
      __syncthreads();  // the split chunk is in shared memory
      // b0 (sample 8t + 2ks, feature 8j + g), b1 (the next sample): one float2
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int a = (4 * t + ks) * S2 + 8 * j + g;
          const float2 h2 = xhi[a];
          const float bhi[2] = {h2.x, h2.y};
          float blo[2] = {0.f, 0.f};
          if constexpr (kSplit) {
            const float2 l2 = xlo[a];
            blo[0] = l2.x;
            blo[1] = l2.y;
          }
          mma_route<kSplit>(part, ahi[ks], alo[ks], bhi, blo);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] += part[q];
      }
    }
    __syncthreads();  // every fragment read: the update region is free

    // ---- out = codes + scale * acc; the rows kept as x''s type, split -------
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // c0 (g, 2t), c1 (g, 2t + 1), c2, c3: g + 8
        const int r = 16 * warp + g + 8 * (q >> 1), k = 8 * j + 2 * t + (q & 1);
        const int u = r0 + r;
        float o = 0.f;
        if (k < width && u < N) {
          const size_t gi = (size_t)u * D + f0 + k;
          o = codes[gi] + __fmul_rn(acc[j][q], scale);
          out[gi] = o;
        }
        if (np == 1) {
          float hi, lo;
          split_route<kSplit>(round_as(o, xn), hi, lo);
          thi[r * DT + kperm(k)] = hi;
          if constexpr (kSplit) tlo[r * DT + kperm(k)] = lo;
        }
      }
    }
  }

  // ---- vmax[b] = max over the CTA's rows of row . x'[b] --------------------
  const int ra = r0 + 16 * warp + g, rb = ra + 8;
  // x' chunk n0's features f0.. (one slab, or the whole row), split
  auto load_x = [&](int n0, int f0) {
    for (int e = tid; e < BW * DP; e += THREADS) {
      const int s = e / DP, k = e % DP;
      float hi, lo;
      split_route<kSplit>((n0 + s < Bn && f0 + k < D)
                              ? load_f32(xn + (size_t)(n0 + s) * D + f0 + k)
                              : 0.f,
                          hi, lo);
      whi[s * DT + kperm(k)] = hi;
      if constexpr (kSplit) wlo[s * DT + kperm(k)] = lo;
    }
  };
  // S += the tile's rows . the staged chunk
  auto scores = [&](float (&S)[BW / 8][4]) {
#pragma unroll 2
    for (int ks = 0; ks < NT; ++ks) {
      // a0, a2 (row g, features t, t + 4) and a1, a3 (row g + 8)
      const int ia = (16 * warp + g) * DT + 8 * ks + 2 * t, ib = ia + 8 * DT;
      float ahi[4], alo[4] = {0.f, 0.f, 0.f, 0.f};
      {
        const float2 p = *reinterpret_cast<const float2*>(thi + ia);
        const float2 q = *reinterpret_cast<const float2*>(thi + ib);
        ahi[0] = p.x; ahi[2] = p.y; ahi[1] = q.x; ahi[3] = q.y;
      }
      if constexpr (kSplit) {
        const float2 p = *reinterpret_cast<const float2*>(tlo + ia);
        const float2 q = *reinterpret_cast<const float2*>(tlo + ib);
        alo[0] = p.x; alo[2] = p.y; alo[1] = q.x; alo[3] = q.y;
      }
#pragma unroll
      for (int n = 0; n < BW / 8; ++n) {
        // b0, b1: sample 8n + g, features t and t + 4
        const int ibn = (8 * n + g) * DT + 8 * ks + 2 * t;
        const float2 h2 = *reinterpret_cast<const float2*>(whi + ibn);
        const float bhi[2] = {h2.x, h2.y};
        float blo[2] = {0.f, 0.f};
        if constexpr (kSplit) {
          const float2 l2 = *reinterpret_cast<const float2*>(wlo + ibn);
          blo[0] = l2.x;
          blo[1] = l2.y;
        }
        mma_route<kSplit>(S[n], ahi, alo, bhi, blo);
      }
    }
  };
  for (int n0 = 0; n0 < Bn; n0 += BW) {
    float S[BW / 8][4];
#pragma unroll
    for (int n = 0; n < BW / 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) S[n][q] = 0.f;
    for (int ps = 0; ps < np; ++ps) {
      __syncthreads();  // rows written; the previous slab's or chunk's fragments and redv read
      if (np > 1) {  // slab ps of the CTA's rows of out, read back and split
        const int f0 = ps * DP;
        for (int e = tid; e < TN * DP; e += THREADS) {
          const int r = e / DP, k = e % DP, u = r0 + r;
          float hi, lo;
          split_route<kSplit>(
              round_as((u < N && f0 + k < D) ? __ldcg(out + (size_t)u * D + f0 + k) : 0.f, xn),
              hi, lo);
          thi[r * DT + kperm(k)] = hi;
          if constexpr (kSplit) tlo[r * DT + kperm(k)] = lo;
        }
      }
      load_x(n0, ps * DP);
      __syncthreads();
      scores(S);
    }
#pragma unroll
    for (int n = 0; n < BW / 8; ++n) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // sample 8n + 2t + q: rows ra, then rb
        float bv = -INFINITY;
        if (ra < N) bv = S[n][q];
        if (rb < N) bv = fmaxf(bv, S[n][2 + q]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)  // the 8 lanes g of the sample
          bv = fmaxf(bv, __shfl_xor_sync(0xffffffffu, bv, off));
        if (g == 0) redv[warp * BW + 8 * n + 2 * t + q] = bv;
      }
    }
    __syncthreads();
    if (tid < BW) {
      float bv = redv[tid];
      for (int v = 1; v < WARPS; ++v) bv = fmaxf(bv, redv[v * BW + tid]);
      const int b = n0 + tid;
      if (b < Bn) {
        const unsigned int o = order_bits(bv);
        if (o > __ldcg(vkeys + b)) atomicMax(vkeys + b, o);  // keys only grow
      }
    }
  }
}

__global__ void skeleton_unorder(const unsigned int* __restrict__ keys, int n,
                                 float* __restrict__ vmax) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) vmax[i] = unorder_bits(keys[i]);
}

template <int NT, typename T>
int launch_skeleton(const float* codes, int N, int D, const void* w, int T_rows,
                    const void* x, int B, const void* xn, int Bn, float scale,
                    float* out, unsigned int* vkeys, cudaStream_t stream) {
  using L = SkSmem<NT, T>;
  const size_t smem = L::bytes(NT == 32 && n_passes(D) > 1 ? L::DP : D);
  const auto kernel = fused_skeleton_kernel<NT, T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(N + L::TN - 1) / L::TN, 32 * L::WARPS, smem, stream>>>(
      codes, N, D, static_cast<const T*>(w), T_rows, static_cast<const T*>(x), B,
      static_cast<const T*>(xn), Bn, scale, out, vkeys);
  return (int)cudaGetLastError();
}

// D > 128: the one width this kernel takes, in feature passes past 256
// (fused_skeleton_sm90.cu takes D <= 128)
template <typename T>
int run_skeleton(const float* codes, int N, int D, const void* w, int T_rows,
                 const void* x, int B, const void* xn, int Bn, float scale,
                 float* out, unsigned int* vkeys, cudaStream_t stream) {
  if (D <= 128) return (int)cudaErrorInvalidValue;
  return launch_skeleton<32, T>(codes, N, D, w, T_rows, x, B, xn, Bn, scale, out, vkeys,
                                stream);
}

}  // namespace

// K17 for D > 128: codes (N, D) float32; w (T_rows, B), x (B, D),
// xn (Bn, D) all float32,
// or all bf16 with bf16; out (N, D) float32 gets codes + scale * W.X row by
// row (W row u % T_rows); vkeys (Bn,) u32 set to 0 by the wrapper; vmax (Bn,)
// float32 gets max_u out[u] . xn[b], out rounded to xn's type.
extern "C" int somvq_fused_skeleton(const float* codes, int N, int D, const void* w,
                                    int T_rows, const void* x, int B, const void* xn,
                                    int Bn, int bf16, float scale, float* out,
                                    unsigned int* vkeys, float* vmax,
                                    cudaStream_t stream) {
  if (N <= 0 || D <= 0 || T_rows <= 0 || B <= 0 || Bn <= 0)
    return (int)cudaErrorInvalidValue;
  const int rc = bf16 ? run_skeleton<__nv_bfloat16>(codes, N, D, w, T_rows, x, B, xn,
                                                    Bn, scale, out, vkeys, stream)
                      : run_skeleton<float>(codes, N, D, w, T_rows, x, B, xn, Bn,
                                            scale, out, vkeys, stream);
  if (rc) return rc;
  skeleton_unorder<<<(Bn + 255) / 256, 256, 0, stream>>>(vkeys, Bn, vmax);
  return (int)cudaGetLastError();
}
