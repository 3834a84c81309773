// The SOM neighbourhood update of the two-kernel step: winners come from a
// separate dist_argmin launch, these kernels apply
//
//   codes <- guarded_blend(codes, W.X, W.1)        (K5, unmasked)
//   codes <- guarded_blend(codes, W.(X o K), W.K)  (K6, masked: per-(unit,
//                                                   component) weight mass)
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_update_kernel (K5) and
// _som_update_masked_kernel (K6), wrapper som_neighborhood_update_idx.  A
// sample's masked components leave every unit's matching component untouched
// (adapt_vector skips masked components, lvq_pak.c:349-356), which is why K6
// carries the weight mass per component.  Both write the guarded blend IN
// PLACE: each CTA reads and writes only its own rows.  Both take any D: K5
// in passes of 256 features past 256 (fused_step_tc.cuh), K6 in its slabs
// of 128 on gridDim.y, staging each slab's columns alone where whole rows do
// not fit in shared memory.
//
// The TPU grid walks batch tiles in order and carries acc/wsum in scratch
// across them.  Here one CTA owns a tile of codebook rows and loops over the
// whole batch in 32-sample chunks in a fixed order, so the sums stay in
// registers and the result is deterministic, with no atomics and no cross-CTA
// step.
//
// K5 (som_update_kernel) is the update half of K3 (fused_step_tc.cuh:
// fused_update_tc) with K3's closed-form W (ClosedFormW) at unit offset 0,
// exactly as K11 (som_accum.cu) runs it, then the guarded blend of each
// (row, component) from the mma's registers, in place, as K3 blends: the
// batch split into TF32 hi and lo once per call (split_batches_kernel, into
// the wrapper's scratch), walked in 32-sample chunks through a cp.async
// double buffer, W built in registers (bit-identical to neighborhood_w; 0
// where bmu < 0), W.X by split-TF32 mma.sync summed per chunk and added into
// float32 registers, wsum in a fixed order; K3's CTA height (128 rows, 64
// past D 128).  A row's arithmetic is K3's, so the codebook equals K3's rows
// for the same (codes, batch, winners, alpha, radius) bit for bit, and two
// runs are bit-equal.
//
// K6 (som_update_masked_kernel) runs on the tensor cores, K3's update design
// (som_fused_step.cu) with the mask:
//   * CTAs of 128 rows (8 warps of one 16-row m-tile each) and a slab of up to
//     128 features: D > 128 is split across gridDim.y, which is exact because
//     a component's blend needs only its own acc and mass;
//   * each sample's BMU grid x and row and its alpha (0 where bmu < 0 or past
//     B) are staged once per chunk, each row's grid x and row once per CTA;
//     each thread builds the W values of its A fragments in registers with
//     weight_of_d2(grid_d2_at(...)), the float operations of neighborhood_w
//     in the same order (W bit-identical to it), split into hi and lo;
//   * cp.async double-buffers 32-sample chunks of X and of the uint8 mask;
//     each chunk is staged as X o K (masked components zeroed) split into hi
//     and lo, and K (0 or 1, exact in TF32, its lo part 0);
//   * acc += W.(X o K) by three TF32 products (tf32x3.cuh, small terms first)
//     and mass += W.K by two (W_lo.K, then W_hi.K), both summed in the mma
//     over one chunk only, then added into float32 registers with
//     round-to-nearest adds (the tensor core's own accumulation over a whole
//     batch drops low bits); the mass lands in acc's fragment layout
//     (row, component), so the blend reads both from the same thread.
// Rows beyond noc are masked, never padded; features are padded with zeros in
// shared memory only.  Every sum runs in a fixed order: two runs are
// bit-equal.
//
// What bounds them on H100: the contractions, W.X (2 noc B D FLOPs, issued
// as 6 noc B D TF32 FLOPs) for K5 and W.(X o K) with W.K (4 noc B D, issued
// as 10 noc B D) for K6, against the 495 TFLOP/s peak; W's expf and the
// chunk staging share the SM with the mma between barriers.  Device memory
// traffic is one codebook read and write; the batch (and mask) are re-read
// from L2 by every CTA.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_step_tc.cuh"

namespace {

// ---- K5: K3's update half, then the blend ------------------------------------

template <int NT>
__global__ void __launch_bounds__(32 * k3_warps(NT), NT <= 8 ? 2 : 1)
som_update_kernel(float* __restrict__ codes, int noc, int D,
                  const float* __restrict__ xs, const int* __restrict__ bmu,
                  const float* __restrict__ alpha, int B, int xdim, int hexa,
                  int gaussian, float radius) {
  constexpr int WARPS = k3_warps(NT), DP = 8 * NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * 16 * WARPS;
  ClosedFormW wp = closed_form_w(bmu, alpha, B, xdim, hexa, gaussian, radius, 0);
  const size_t plane = (size_t)(B + 63) / 64 * 64 * DP;
  // feature passes past 8 NT (NT 32, D > 256): slab s's update, then its
  // columns' blend (fused_step_tc.cuh); one pass otherwise
  const int np = NT == 32 ? n_passes(D) : 1;
  for (int s = 0; s < np; ++s) {
    float acc[NT][4];
    float wsum[2];
    fused_update_tc<NT, WARPS, false>(acc, wsum, xs + 2 * s * plane, xs + (2 * s + 1) * plane,
                                      B, r0, wp);
    // guarded blend, per (row, component), in place: c0 (g, 2t), c1 (g,
    // 2t + 1), c2, c3: g + 8
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int u = r0 + 16 * warp + g + 8 * (q >> 1), k = s * DP + 8 * j + 2 * t + (q & 1);
        if (k < D && u < noc) {
          float* p = codes + (size_t)u * D + k;
          *p = guarded_blend(*p, acc[j][q], wsum[q >> 1]);
        }
      }
    }
    if (s + 1 < np) __syncthreads();  // the slab's fragments read: the buffers are free
  }
}

// the batch split once (into xs), then the update
template <int NT>
int launch_update(float* codes, int noc, int D, const float* xb, const int* bmu,
                  const float* alpha, int B, int xdim, int hexa, int gaussian,
                  float radius, float* xs, cudaStream_t stream) {
  using L = FusedSmem<NT, k3_warps(NT)>;
  const size_t smem = sizeof(float) * L::update_floats(ClosedFormW::floats());
  cudaError_t err = cudaFuncSetAttribute(
      som_update_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rc = split_batches(xb, B, nullptr, 0, D, L::DP, xs, stream);
  if (rc) return rc;
  som_update_kernel<NT><<<(noc + L::TN - 1) / L::TN, 32 * k3_warps(NT), smem, stream>>>(
      codes, noc, D, xs, bmu, alpha, B, xdim, hexa, gaussian, radius);
  return (int)cudaGetLastError();
}

// ---- K6: split-TF32 mma.sync -------------------------------------------------

constexpr int kChunk = 32;             // batch samples per chunk (4 k-steps)
constexpr int kWarps6 = 8;             // one 16-row m-tile each
constexpr int kRows6 = 16 * kWarps6;   // codebook rows per CTA
constexpr int kThreads6 = 32 * kWarps6;
constexpr int kSlabNT = 16;            // at most 128 features per CTA

// NT 8-feature n-tiles per slab (SW = 8 NT features).  Shared memory:
// raw[2][kChunk * RS] floats | xhi, xlo, kf [kChunk][DS] floats | smp[kChunk]
// float4 (bmu grid x, bmu row, alpha, 0) | m8[2][kChunk * RS] bytes; every
// region starts 16-byte aligned.  RS, the staged row: D (whole rows, copied
// in one piece) where that fits in shared memory, else SW (the CTA's slab of
// each row alone, k6_row_stride)
template <int NT>
struct K6Smem {
  static constexpr int SW = 8 * NT, DS = stride_kn(SW);
  static size_t bytes(int RS) {
    return sizeof(float) * (2 * (size_t)kChunk * RS + 3 * (size_t)kChunk * DS +
                            4 * kChunk) +
           2 * (size_t)kChunk * RS;
  }
};

// Copy n bytes from global src to shared dst: 16-byte cp.async pieces where
// both ends are 16-byte aligned, the rest by plain loads and stores (seen by
// the CTA after its next __syncthreads), by all threads of the CTA.
__device__ __forceinline__ void copy_bytes_async(unsigned char* dst,
                                                 const unsigned char* src, int n,
                                                 int tid, int nthreads) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) ==
      0) {
    const int n16 = n >> 4;
    for (int i = tid; i < n16; i += nthreads) cp_async16(dst + 16 * i, src + 16 * i);
    done = 16 * n16;
  }
  for (int i = done + tid; i < n; i += nthreads) dst[i] = src[i];
}

// K6's staged row for D features: whole rows up to the widest that fits in
// 227 KB of shared memory (about 560 features), the slab alone past it
template <int NT>
int k6_row_stride(int D) {
  return K6Smem<NT>::bytes(D) <= 232448 ? D : K6Smem<NT>::SW;
}

// Stage chunk rows s0..s0 + nb - 1 of x and of the mask: whole rows (RS ==
// D) in one piece, or (RS == SW) features f0..f0 + width - 1 of each row
// into rows of RS, 16-byte cp.async pieces where aligned, else 4-byte ones
// (the mask's bytes by plain stores), committed by the caller
__device__ __forceinline__ void stage_rows6(float* raw, unsigned char* m8,
                                            const float* __restrict__ xb,
                                            const unsigned char* __restrict__ mask, int s0,
                                            int nb, int D, int f0, int width, int RS,
                                            int tid, int nthreads) {
  const size_t off = (size_t)s0 * D;
  if (RS == D) {
    cp_async_floats(raw, xb + off, nb * D, tid, nthreads);
    copy_bytes_async(m8, mask + off, nb * D, tid, nthreads);
    return;
  }
  const bool v16 = (D & 3) == 0 && (width & 3) == 0 && (f0 & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(xb) & 15) == 0;
  if (v16) {
    const int q = width / 4;
    for (int e = tid; e < nb * q; e += nthreads) {
      const int r = e / q, k = 4 * (e - r * q);
      cp_async16(raw + r * RS + k, xb + off + (size_t)r * D + f0 + k);
    }
  } else {
    for (int e = tid; e < nb * width; e += nthreads) {
      const int r = e / width, k = e - r * width;
      cp_async4(raw + r * RS + k, xb + off + (size_t)r * D + f0 + k);
    }
  }
  for (int e = tid; e < nb * width; e += nthreads) {
    const int r = e / width, k = e - r * width;
    m8[r * RS + k] = mask[off + (size_t)r * D + f0 + k];
  }
}

template <int NT>
__global__ void __launch_bounds__(kThreads6, NT <= 8 ? 2 : 1)
som_update_masked_kernel(float* __restrict__ codes, int noc, int D,
                         const float* __restrict__ xb,
                         const unsigned char* __restrict__ mask,
                         const int* __restrict__ bmu,
                         const float* __restrict__ alpha, int B, int xdim,
                         int hexa_i, int gaussian_i, float radius, int RS) {
  using L = K6Smem<NT>;
  constexpr int SW = L::SW, DS = L::DS, KS = kChunk / 8;
  extern __shared__ __align__(16) float smem6[];
  float* raw0 = smem6;
  float* raw1 = raw0 + kChunk * RS;
  float* xhi = raw1 + kChunk * RS;
  float* xlo = xhi + kChunk * DS;
  float* kf = xlo + kChunk * DS;
  float4* smp = reinterpret_cast<float4*>(kf + kChunk * DS);
  unsigned char* m80 = reinterpret_cast<unsigned char*>(smp + kChunk);
  unsigned char* m81 = m80 + kChunk * RS;

  const bool hexa = hexa_i != 0, gaussian = gaussian_i != 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kRows6;
  const int f0 = blockIdx.y * SW;  // this CTA's feature slab
  const int width = min(SW, D - f0);
  const int roff = RS == D ? f0 : 0;  // the slab's first column in a staged row
  const float r2 = radius * radius;
  const float den = 2.0f * radius * radius;

  // this thread's two rows: 16 warp + g and + 8
  float lx[2], fur[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = r0 + 16 * warp + g + 8 * h;
    lx[h] = grid_x(u % xdim, u / xdim, hexa);
    fur[h] = (float)(u / xdim);
  }

  // c0 (row g, component 2t), c1 (g, 2t + 1), c2, c3: row g + 8
  float acc[NT][4], mass[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = mass[j][q] = 0.f;

  const int nchunks = (B + kChunk - 1) / kChunk;
  stage_rows6(raw0, m80, xb, mask, 0, min(kChunk, B), D, f0, width, RS, tid, kThreads6);
  cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int s0 = c * kChunk, nb = min(kChunk, B - s0);
    const float* raw = (c & 1) ? raw1 : raw0;
    const unsigned char* m8 = (c & 1) ? m81 : m80;
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; chunk c - 1's fragments all read
    if (c + 1 < nchunks) {  // its buffers were last read by chunk c - 1's split
      stage_rows6((c & 1) ? raw0 : raw1, (c & 1) ? m80 : m81, xb, mask, s0 + kChunk,
                  min(kChunk, B - s0 - kChunk), D, f0, width, RS, tid, kThreads6);
      cp_async_commit();
    }
    // X o K split into hi and lo, and K; zero past the batch and the slab
    for (int e = tid; e < kChunk * SW; e += kThreads6) {
      const int s = e / SW, k = e % SW;
      float v = 0.f, kv = 0.f;
      if (s < nb && k < width && m8[s * RS + roff + k] == 0) {
        v = raw[s * RS + roff + k];
        kv = 1.f;
      }
      float hi, lo;
      split_tf32(v, hi, lo);
      xhi[s * DS + k] = hi;
      xlo[s * DS + k] = lo;
      kf[s * DS + k] = kv;
    }
    if (tid < kChunk) {
      const int b = s0 + tid;
      const int bm = b < B ? bmu[b] : -1;
      // weight_of_d2 with alpha 0 is +0, neighborhood_w's 0 for bmu < 0
      smp[tid] = bm >= 0 ? make_float4(grid_x(bm % xdim, bm / xdim, hexa),
                                       (float)(bm / xdim), alpha[b], 0.f)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    // the chunk's A fragments of W, split: a0 (row g, sample t), a1 (g + 8,
    // t), a2 (g, t + 4), a3 (g + 8, t + 4) of each k-step
    float whi[KS][4], wlo[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 sm = smp[8 * ks + t + 4 * (q >> 1)];
        const int h = q & 1;
        split_tf32(weight_of_d2(grid_d2_at(lx[h], fur[h], sm.x, sm.y, hexa), sm.z,
                                gaussian, r2, den),
                   whi[ks][q], wlo[ks][q]);
      }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float p[4] = {0.f, 0.f, 0.f, 0.f}, m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        float bhi[2], blo[2], bk[2];
        load_b_kn(bhi, xhi, DS, 8 * ks, 8 * j, lane);
        load_b_kn(blo, xlo, DS, 8 * ks, 8 * j, lane);
        load_b_kn(bk, kf, DS, 8 * ks, 8 * j, lane);
        mma_tf32x3(p, whi[ks], wlo[ks], bhi, blo);
        mma_tf32(m, wlo[ks], bk);
        mma_tf32(m, whi[ks], bk);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[j][q] += p[q];
        mass[j][q] += m[q];
      }
    }
  }

  // guarded blend, per (row, component), in place
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int u = r0 + 16 * warp + g + 8 * (q >> 1);
      const int k = f0 + 8 * j + 2 * t + (q & 1);
      if (u < noc && k < D) {
        float* p = codes + (size_t)u * D + k;
        *p = guarded_blend(*p, acc[j][q], mass[j][q]);
      }
    }
}

template <int NT>
int launch_masked(float* codes, int noc, int D, const float* xb,
                  const unsigned char* mask, const int* bmu, const float* alpha,
                  int B, int xdim, int hexa, int gaussian, float radius,
                  cudaStream_t stream) {
  using L = K6Smem<NT>;
  const int RS = k6_row_stride<NT>(D);
  const size_t smem = L::bytes(RS);
  cudaError_t err = cudaFuncSetAttribute(som_update_masked_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((noc + kRows6 - 1) / kRows6, (D + L::SW - 1) / L::SW);
  som_update_masked_kernel<NT><<<grid, kThreads6, smem, stream>>>(
      codes, noc, D, xb, mask, bmu, alpha, B, xdim, hexa, gaussian, radius, RS);
  return (int)cudaGetLastError();
}

bool bad_args(int noc, int D, int B, int xdim) {
  return noc <= 0 || D <= 0 || B <= 0 || xdim <= 0;
}

}  // namespace

// K5; xs scratch for the split batch: 2 Bp W floats (B rounded up to a
// multiple of 64, W = ops.som_step.split_width(D): 8 times the power of two
// of 8-feature steps that covers D, 256 n_passes(D) past 256, the passes)
extern "C" int somvq_som_update(float* codes, int noc, int D, const float* xb,
                                const int* bmu, const float* alpha, int B,
                                int xdim, int hexa, int gaussian, float radius,
                                float* xs, cudaStream_t stream) {
  if (bad_args(noc, D, B, xdim) || !xs) return (int)cudaErrorInvalidValue;
  const int k8 = (D + 7) / 8;  // 8-feature steps, padded up to a power of two
#define K5_LAUNCH(NT)                                                          \
  if (k8 <= NT || NT == 32)                                                    \
    return launch_update<NT>(codes, noc, D, xb, bmu, alpha, B, xdim, hexa,     \
                             gaussian, radius, xs, stream);
  K5_LAUNCH(1)
  K5_LAUNCH(2)
  K5_LAUNCH(4)
  K5_LAUNCH(8)
  K5_LAUNCH(16)
  K5_LAUNCH(32)
#undef K5_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// K6; mask is (B, D) uint8, nonzero = masked
extern "C" int somvq_som_update_masked(float* codes, int noc, int D,
                                       const float* xb,
                                       const unsigned char* mask,
                                       const int* bmu, const float* alpha,
                                       int B, int xdim, int hexa, int gaussian,
                                       float radius, cudaStream_t stream) {
  if (bad_args(noc, D, B, xdim)) return (int)cudaErrorInvalidValue;
  const int k8 = (D + 7) / 8;  // 8-feature steps, padded up to a power of two
#define K6_LAUNCH(NT)                                                          \
  if (k8 <= NT || NT == kSlabNT)                                               \
    return launch_masked<NT>(codes, noc, D, xb, mask, bmu, alpha, B, xdim,     \
                             hexa, gaussian, radius, stream);
  K6_LAUNCH(1)
  K6_LAUNCH(2)
  K6_LAUNCH(4)
  K6_LAUNCH(8)
  K6_LAUNCH(16)
#undef K6_LAUNCH
  return (int)cudaErrorInvalidValue;
}
