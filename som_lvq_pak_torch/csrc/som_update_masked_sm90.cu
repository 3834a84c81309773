// K6 on Hopper: the masked SOM neighbourhood update of the two-kernel step,
//
//   codes <- guarded_blend(codes, W.(X o K), W.K)
//
// in place, per (unit, component): W (noc, B) from the given winners (0
// where bmu < 0) with a scalar or per-sample alpha, K the keep flags of the
// (B, D) uint8 mask (nonzero = masked).  A sample's masked components leave
// every unit's matching component untouched (adapt_vector skips masked
// components, lvq_pak.c:349-356), hence the weight mass per component.
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_update_masked_kernel (:152,
// wrapper som_neighborhood_update_idx with a mask) -> som_update_masked_sm90_kernel
// (K6), with its prologue split_masked_batch_kernel.
//
// What bounds it on H100: the two contractions W.(X o K) and W.K, 4 noc B D
// FLOPs, as split TF32 (tf32x3.cuh): three TF32 products for W.(X o K), two
// for W.K (K is 0 or 1, exact in TF32): 10 noc B D TF32 FLOPs at 495
// TFLOP/s (0.3471 ms at 256x256, B 4096, D 64); beside them the W values,
// noc B of them per feature slab, each a grid distance, an expf (gaussian)
// and a split on the FP32 and MUFU pipes, and the L2 reads of the split
// batch by every CTA.  Device memory moves the codebook in and out, the
// batch, the mask and the prologue's planes once.
//
// The design is K3's update on its Hopper walk (fused_step_sm90.cuh) with a
// second sum.  The prologue splits the batch once a call into three planes
// of (Dp, Bp), samples contiguous (wgmma takes 32-bit B operands K-major
// only, and K is the sample index): X o K's TF32 hi, its lo, and K as 1.0 or
// 0.0, zeros past D and past the batch (Dp = ops.dist_argmin.split_codes_dp
// (D), whole feature slabs; Bp = B rounded up to 64); then K3's per-sample
// table (BMU grid x, BMU row, alpha; zeros where bmu < 0).  A CTA takes 128
// rows, two consumer warpgroups of 64 (K3's row layout: rows 16 warp + g and
// + 8), and ONE feature slab of F = 32 (D <= 32) or 64 features on
// gridDim.y: a component's blend needs only its own acc and mass, so the
// slabs are exact and the walk takes any D, with two chunk sums and two
// running sums of F / 2 floats a thread beside two sets of W fragments (192
// registers of the consumers' 232 at F 64).  A producer warpgroup's thread
// streams by TMA (SWIZZLE_128B) each 32-sample chunk of the slab's rows of
// the three planes, with the chunk's table slice, into a ring of slots
// behind full and empty mbarriers (fused_step_sm90.cuh's SlabLayout and
// produce_slab, K5's and K11's too).  Per k step of 8 samples a consumer
// issues five wgmma.m64nFk8 with W's fragments as A in registers: X o K lo.W
// hi, hi.W lo, hi.W hi into the chunk acc (mma_tf32x3's order), then K.W
// lo, K.W hi into the chunk mass; both chunk sums start from zero (wgmma's
// scale-d 0) and are added into the float32 running sums once the chunk's
// products are done.  This is the mma.sync K6's order (ops.tf32x3.
// som_update_masked_tf32x3), and wgmma's TF32 sums are mma.sync's where each
// k index maps to the same sample, so the codebook is that kernel's bit for
// bit.  The next chunk's W fragments are built from the table with K3's
// float operations (ClosedFormW90) while this chunk's products run; the two
// warpgroups take turns to issue (fused_step_sm90.cuh's turns).  At the end
// each thread blends its (row, component) values in place from its
// registers.  Nothing a warp does while its products are in flight branches
// on a per-lane value (see fused_step_sm90.cuh).  Every sum runs in a fixed
// order: two runs are bit-equal.

#include <cuda_runtime.h>

#include <cstdint>

#include "fused_step_sm90.cuh"

namespace {

using namespace fs90;

constexpr int PLANES = 3;  // X o K hi, X o K lo, K

// the slab width (a wgmma's N) and the padded feature count for D
__host__ __device__ constexpr int slab_of(int D) { return D <= 32 ? 32 : 64; }
__host__ __device__ constexpr int padded_d(int D) { return D <= 32 ? 32 : (D + 63) / 64 * 64; }

// The prologue: scratch xs = the three planes of (Dp, Bp), element (k, b)
// from x[b][k] and mask[b][k] (X o K split into hi and lo, K), zeros past D
// and B; then K3's table, Bp float4, zeros where bmu < 0 or past B (W = +0
// there, as weight_of_d2 gives for alpha 0).  One thread an element.
__global__ void split_masked_batch_kernel(const float* __restrict__ xb,
                                          const unsigned char* __restrict__ mask, int B,
                                          int D, int Dp, int Bp, float* __restrict__ xs,
                                          const int* __restrict__ bmu,
                                          const float* __restrict__ alpha, int xdim,
                                          int hexa) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t plane = (int64_t)Dp * Bp;
  if (e < plane) {
    const int k = (int)(e / Bp), b = (int)(e % Bp);
    float v = 0.f, kv = 0.f;
    if (b < B && k < D) {
      const size_t i = (size_t)b * D + k;
      if (mask[i] == 0) {
        v = xb[i];
        kv = 1.f;
      }
    }
    split_tf32(v, xs[e], xs[plane + e]);
    xs[2 * plane + e] = kv;
  } else if (e < plane + Bp) {
    const int b = (int)(e - plane);
    const int bm = b < B ? bmu[b] : -1;
    reinterpret_cast<float4*>(xs + PLANES * plane)[b] =
        bm >= 0 ? make_float4(grid_x(bm % xdim, bm / xdim, hexa != 0), (float)(bm / xdim),
                              alpha[b], 0.f)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Issue one chunk's products: part = W.(X o K) and mpart = W.K over the
// slot's 32 samples, per k step X o K lo.W hi, hi.W lo, hi.W hi, then K.W
// lo, K.W hi; each sum's first product does not read it (scale-d 0).
// Commits the group.
template <int F>
__device__ __forceinline__ void issue_masked(float (&part)[F / 2], float (&mpart)[F / 2],
                                             const float (&whi)[4][4],
                                             const float (&wlo)[4][4], uint32_t slot) {
  constexpr int P = SlabLayout<F, PLANES>::UPD_PLANE;
  sm90::fence_operand(part);
  sm90::fence_operand(mpart);
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < UC / 8; ++ks) {
    const uint64_t bh = desc(slot + 32 * ks);
    const uint64_t bl = desc(slot + P + 32 * ks);
    const uint64_t bk = desc(slot + 2 * P + 32 * ks);
    wgmma_update<F>(part, wlo[ks], bh, ks > 0);
    wgmma_update<F>(part, whi[ks], bl);
    wgmma_update<F>(part, whi[ks], bh);
    wgmma_update<F>(mpart, wlo[ks], bk, ks > 0);
    wgmma_update<F>(mpart, whi[ks], bk);
  }
  sm90::wgmma_commit();
}

// The update of the warpgroup's rows over nu chunks, fused_step_sm90.cuh's
// update_walk with the mass beside the sum: acc and mass (the m16n8k8 C
// layout of column block j) = the chunks' sums in chunk order.  Chunk c +
// 1's W is built, on the other set of fragment registers, while chunk c's
// products run; the warpgroups issue each chunk in turn, warpgroup 0 first.
template <int F, typename WB>
__device__ __forceinline__ void masked_update_walk(float (&acc)[F / 8][4],
                                                   float (&mass)[F / 8][4], WB& wb,
                                                   Ring& ring, int nu, int wg, int lane) {
  constexpr int NT = F / 8;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = mass[j][q] = 0.f;
  float part[F / 2] = {}, mpart[F / 2] = {};
  float whi[2][4][4], wlo[2][4][4];
  if (wg == 1) pass_turn(wg);  // warpgroup 0 issues first
  ring.wait_full();
  wb.build(whi[0], wlo[0], ring.slot(), 0);
  // one chunk on fragment set S: issue it, build the next on set S ^ 1, then
  // wait, free the slot and add
  auto chunk = [&](auto set, int c) {
    constexpr int S = decltype(set)::value;
    await_turn(wg);
    issue_masked<F>(part, mpart, whi[S], wlo[S], sm90::smem_u32(ring.slot()));
    if (wg == 0 || c + 1 < nu) pass_turn(wg);
    if (c + 1 < nu) {
      const Ring nx = ring.next();
      nx.wait_full();
      wb.build(whi[S ^ 1], wlo[S ^ 1], nx.slot(), c + 1);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operand(part);
    sm90::fence_operand(mpart);
    // set S stays in its registers until here: its products have read it
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      sm90::fence_operand(whi[S][ks]);
      sm90::fence_operand(wlo[S][ks]);
    }
    ring.release(lane);
    ring.advance();
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[j][q] += part[4 * j + q];
        mass[j][q] += mpart[4 * j + q];
      }
  };
  for (int c = 0; c < nu; c += 2) {
    chunk(Int<0>{}, c);
    if (c + 1 < nu) chunk(Int<1>{}, c + 1);
  }
}

// CTA (blockIdx.x, blockIdx.y): rows blockIdx.x * TN.., features
// blockIdx.y * F.. of the codebook
template <int F>
__global__ void __launch_bounds__(THREADS, 1)
som_update_masked_sm90_kernel(const __grid_constant__ CUtensorMap xt_map,
                              const __grid_constant__ CUtensorMap smp_map,
                              float* __restrict__ codes, int noc, int D, int Dp, int B,
                              int xdim, int hexa, int gaussian, float radius) {
  using L = SlabLayout<F, PLANES>;
  constexpr int NT = F / 8;
  unsigned char* tile;
  float* m2s;
  Ring ring = setup<L>(tile, m2s);
  const int nu = (B + UC - 1) / UC;
  const int f0 = blockIdx.y * F;
  if (threadIdx.x >= ALL) {  // the producer warpgroup: one thread
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == ALL) produce_slab<L, PLANES>(ring, &xt_map, &smp_map, nu, Dp, f0);
    return;
  }
  sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * TN;
  ClosedFormW90<L::TABLE> wb;
  wb.init(r0 + 16 * warp + g, xdim, hexa != 0, gaussian != 0, radius);
  float acc[NT][4], mass[NT][4];
  masked_update_walk<F>(acc, mass, wb, ring, nu, consumer_wg(), lane);
  // the guarded blend, per (row, component), in place: c0 (row g, component
  // 2t), c1 (g, 2t + 1), c2, c3: row g + 8
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

template <int F>
int launch_walk(float* codes, int noc, int D, int B, int xdim, int hexa, int gaussian,
                float radius, const float* xs, cudaStream_t stream) {
  using L = SlabLayout<F, PLANES>;
  const int Dp = padded_d(D), Bp = round_up(B, 64);
  CUtensorMap xt, smp;
  const int rc = encode_slab_maps<F, PLANES>(&xt, &smp, xs, Dp, Bp);
  if (rc) return rc;
  const auto kernel = som_update_masked_sm90_kernel<F>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((noc + TN - 1) / TN, Dp / F);
  kernel<<<grid, THREADS, L::BYTES, stream>>>(xt, smp, codes, noc, D, Dp, B, xdim, hexa,
                                               gaussian, radius);
  return (int)cudaGetLastError();
}

}  // namespace

// K6: codes (noc, D) float32, updated in place; mask (B, D) uint8, nonzero
// = masked; xs scratch for the prologue, 16-byte aligned: 3 Dp Bp + 4 Bp
// floats (Dp = ops.dist_argmin.split_codes_dp(D), Bp = B rounded up to 64)
extern "C" int somvq_som_update_masked(float* codes, int noc, int D, const float* xb,
                                       const unsigned char* mask, const int* bmu,
                                       const float* alpha, int B, int xdim, int hexa,
                                       int gaussian, float radius, float* xs,
                                       cudaStream_t stream) {
  if (noc <= 0 || D <= 0 || B <= 0 || xdim <= 0 || !xs ||
      (reinterpret_cast<uintptr_t>(xs) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int Dp = padded_d(D), Bp = round_up(B, 64);
  const int64_t n = (int64_t)Dp * Bp + Bp;
  split_masked_batch_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      xb, mask, B, D, Dp, Bp, xs, bmu, alpha, xdim, hexa);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  return slab_of(D) == 32
             ? launch_walk<32>(codes, noc, D, B, xdim, hexa, gaussian, radius, xs, stream)
             : launch_walk<64>(codes, noc, D, B, xdim, hexa, gaussian, radius, xs, stream);
}
