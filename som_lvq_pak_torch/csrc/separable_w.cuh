// The separable weight policy of K13 and K14 (fused_step_tc.cuh with W from
// the tables of the table launch below, factored_tables_kernel), one step's
// arguments as the C entries somvq_som_fused_factored and
// somvq_som_fused_factored_sm90 take them, and the main launch of K13 and of
// K14's main form.  K13 lives in som_fused_factored.cu, K14 (its main
// form, and the walk of its stagger and int8_win options) in
// som_fused_chunked_tc.cuh, instantiated for each codebook type in
// som_fused_chunked_tc_{f32,bf16}.cu (the main form),
// som_fused_chunked_walk_{f32,bf16}.cu (stagger, float32 winners) and
// som_fused_chunked_walk_int8_{f32,bf16}.cu (int8_win), one nvcc each,
// compiled side by side.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_step_tc.cuh"

namespace somvq {

// One step's arguments, as the C entry takes them
struct StepArgs {
  void* codes;
  int noc, D;
  const float* xb;
  const int* bmu;
  const float* alpha;
  int B;
  const float* xn;
  const signed char* xq;
  const float* q;
  int Bn, xdim, hexa, gaussian;
  float radius;
  int stagger;  // 0, or the most CTAs of K14's staggered persistent grid
  int rows;     // rows per CTA (K13: 128 or 64, K14: 64 or 32)
  float* xs;    // the split batches (split_batches_kernel)
  void* pat;
  float* ytab;
  float* aw;
  unsigned long long* keys;
  float* rows32;  // past D 256 with a bf16 codebook: its float32 rows (noc, D)
  cudaStream_t stream;
};

// K14's main form on the tensor cores, for a float32 or a bf16 codebook
// (som_fused_chunked_tc_f32.cu, som_fused_chunked_tc_bf16.cu): the main launch
// after the table launch
int k14_tc_f32codes(const StepArgs& a, int wxa_bf16, int batch_bf16);
int k14_tc_bf16codes(const StepArgs& a, int wxa_bf16, int batch_bf16);
// K14's stagger with float32 winners and its int8_win (with or without
// stagger), for each codebook type: the walk's launch after the table launch
int k14_walk_f32codes(const StepArgs& a, int wxa_bf16, int batch_bf16);
int k14_walk_bf16codes(const StepArgs& a, int wxa_bf16, int batch_bf16);
int k14_walk_int8_f32codes(const StepArgs& a, int wxa_bf16, int batch_bf16);
int k14_walk_int8_bf16codes(const StepArgs& a, int wxa_bf16, int batch_bf16);
// K14's main form for D <= 128 on K13's Hopper walk, the batch split across
// a cluster of `cluster` CTAs a tile (separable_sm90.cuh), for a bf16
// codebook (som_fused_chunked_sm90_bf16.cu; the float32 codebook's, and the
// walk's C entries, in som_fused_chunked_sm90_f32.cu): the prologue and the
// walk after the table launch
int k14_sm90_bf16codes(const StepArgs& a, int batch_bf16, int cluster);

}  // namespace somvq

namespace {

using somvq::StepArgs;

__device__ __forceinline__ float to_pattern(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_pattern(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// The tables of one step, one thread per sample b.  pat[p][b] with p = parity
// * xdim + column (parity 0 only on a rect map): gaussian alpha_b *
// expf(-dx^2 s), stored as PT (bf16 rounds it), bubble dx^2; ytab[y][b] for
// grid row y: gaussian expf(-dy^2 s), bubble dy^2; aw[b]: alpha_b, 0 where
// bmu_b < 0.  Rows of ld >= B entries: the samples B..ld - 1 are written as
// samples without a BMU (alpha 0, so every W of theirs is +0; K13's Hopper
// walk reads whole chunks with no test).  Grid rows of the launch walk the
// n_pat + ydim table rows; the first also sets the Bn winner keys to their
// start value (init_keys).  kRound: the x-pattern rounded to bf16 and kept
// as float32 (K14's wxa_bf16 on its Hopper walk, which reads float32 rows;
// the widened bf16 table's values exactly)
template <typename PT, bool kRound = false>
__global__ void factored_tables_kernel(const int* __restrict__ bmu,
                                       const float* __restrict__ alpha, int B, int ld,
                                       int Bn, int xdim, int hexa, int gaussian,
                                       float radius, int n_pat, int ydim,
                                       PT* __restrict__ pat,
                                       float* __restrict__ ytab,
                                       float* __restrict__ aw,
                                       unsigned long long* __restrict__ keys) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.y == 0 && b < Bn) keys[b] = ~0ull;
  if (b >= ld) return;
  const int bm = b < B ? bmu[b] : -1;
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
      const float wx = gaussian ? a * expf(-dx2 * s) : dx2;
      pat[(size_t)p * ld + b] = to_pattern(kRound ? bf16_round(wx) : wx, pat);
    } else {
      const int y = p - n_pat;
      const float rd = (float)(y - brow);
      const float dy2 = hexa ? (rd * rd) * 0.75f : rd * rd;
      ytab[(size_t)y * ld + b] = gaussian ? expf(-dy2 * s) : dy2;
    }
  }
}

// The table launch of one step (it also sets the winner keys), table rows of
// ld >= B entries
template <typename PT, bool kRound = false>
int launch_tables(const StepArgs& a, int ld) {
  const int n_pat = a.hexa ? 2 * a.xdim : a.xdim;
  const int ydim = (a.noc + a.xdim - 1) / a.xdim;
  const int trows = n_pat + ydim < 65535 ? n_pat + ydim : 65535;
  const dim3 tgrid(((ld > a.Bn ? ld : a.Bn) + 255) / 256, trows);
  factored_tables_kernel<PT, kRound><<<tgrid, 256, 0, a.stream>>>(
      a.bmu, a.alpha, a.B, ld, a.Bn, a.xdim, a.hexa, a.gaussian, a.radius, n_pat,
      ydim, static_cast<PT*>(a.pat), a.ytab, a.aw, a.keys);
  return (int)cudaGetLastError();
}

// The separable W: the tables of the table launch, read per chunk into
// shared memory with cp.async beside the batch (double-buffered): for each of
// the CTA's TNR rows its x-pattern row (row parity, column) and for each grid
// row the CTA spans (at most ny) its y-factor row, kBC samples each, and for a
// bubble map the samples' alpha (0 where bmu < 0).  The x-pattern is PT: a
// bf16 table (K14's wxa_bf16) arrives in 16-byte pieces of 8 values and is
// widened (exactly) where W is built.  W is the separable form's float
// operations on them: gaussian Wx * Wy, bubble (Wx + Wy <= r r) ? alpha : 0.
template <int TNR, typename PT = float>
struct SeparableW {
  static constexpr int kWS = kBC + 4;  // row stride (floats): 4 mod 32 banks
  const PT* pat;
  const float* ytab;
  const float* aw;
  int B, noc, xdim, ydim, ny, r0, y0;
  bool hexa, gaussian, vec;
  float r2;
  // [2][TNR][kWS] | [2][ny][kWS] | [2][kBC] | prow[TNR] (int) at this offset;
  // a bf16 x-pattern row takes the first kBC / 2 floats of its row
  int st;
  int rl[2], yi[2];  // this thread's rows: CTA row, staged grid row
  bool ok[2];        // ... and whether they are rows of the map
  static constexpr int kNQ = kBC / 4;    // 16-byte pieces of a chunk's float row
  static constexpr int kPE = 16 / sizeof(PT);  // x-pattern values per piece
  static constexpr int kNQX = kBC / kPE;       // ... and pieces per chunk row

  static size_t floats(int ny) { return 2 * ((size_t)(TNR + ny) * kWS + kBC) + TNR; }
  // everything arrives by cp.async
  static constexpr bool kStage = false;

  // the staged tables, from the dynamic shared array (shared-memory loads)
  __device__ __forceinline__ float* wxs() const {
    extern __shared__ __align__(16) float smem[];
    return smem + st;
  }
  __device__ __forceinline__ PT* wxrow(int c, int r) const {
    return reinterpret_cast<PT*>(wxs() + ((c & 1) * TNR + r) * kWS);
  }
  __device__ __forceinline__ float* wys() const { return wxs() + 2 * TNR * kWS; }
  __device__ __forceinline__ float* aws() const { return wys() + 2 * ny * kWS; }
  // each CTA row's x-pattern row, -1 past the map
  __device__ __forceinline__ int* prow() const {
    return reinterpret_cast<int*>(aws() + 2 * kBC);
  }

  __device__ __forceinline__ void init(int st_, int r0_, int warp, int g) {
    st = st_;
    r0 = r0_;
    y0 = r0 / xdim;
    vec = (B & (kPE - 1)) == 0 && ((reinterpret_cast<uintptr_t>(pat) |
                                    reinterpret_cast<uintptr_t>(ytab) |
                                    reinterpret_cast<uintptr_t>(aw)) & 15) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rl[h] = 16 * warp + g + 8 * h;
      const int u = r0 + rl[h];
      ok[h] = u < noc;
      yi[h] = ok[h] ? u / xdim - y0 : 0;
    }
    // the x-pattern rows of the rows this thread copies in a whole chunk
    // (prefetch): written and read by the same thread, so no barrier
    for (int r = threadIdx.x / kNQX; r < TNR; r += blockDim.x / kNQX) {
      const int u = r0 + r, row = u / xdim, col = u - row * xdim;
      prow()[r] = u < noc ? (hexa ? (row & 1) * xdim : 0) + col : -1;
    }
  }

  // up to 4 floats of a table row (16 bytes when aligned and whole)
  __device__ __forceinline__ void copy4(float* dst, const float* src, int left) const {
    if (vec && left >= 4) {
      cp_async16(dst, src);
    } else {
      for (int k = 0; k < min(4, left); ++k) cp_async4(dst + k, src + k);
    }
  }
  // up to kPE values of an x-pattern row (16 bytes when aligned and whole; a
  // bf16 remainder by plain stores, read after the chunk's barrier)
  __device__ __forceinline__ void copyx(PT* dst, const PT* src, int left) const {
    if constexpr (kPE == 4) {
      copy4(dst, src, left);
    } else if (vec && left >= kPE) {
      cp_async16(dst, src);
    } else {
      for (int k = 0; k < min(kPE, left); ++k) dst[k] = src[k];
    }
  }

  __device__ __forceinline__ void prefetch(int c, int s0, int nb, int tid, int nthr) {
    float* dy = wys() + (c & 1) * ny * kWS;
    if (nb == kBC) {  // a whole chunk: no division per piece
      for (int e = tid; e < TNR * kNQX; e += nthr) {
        const int r = e / kNQX, j = e % kNQX, p = prow()[r];
        if (p >= 0) copyx(wxrow(c, r) + kPE * j, pat + (size_t)p * B + s0 + kPE * j, kPE);
      }
      for (int e = tid; e < ny * kNQ; e += nthr) {
        const int y = e / kNQ, j = e % kNQ;
        if (y0 + y < ydim)
          copy4(dy + y * kWS + 4 * j, ytab + (size_t)(y0 + y) * B + s0 + 4 * j, 4);
      }
      if (!gaussian && tid < kNQ) copy4(aws() + (c & 1) * kBC + 4 * tid, aw + s0 + 4 * tid, 4);
      return;
    }
    const int nqx = (nb + kPE - 1) / kPE;  // x-pattern pieces per row
    for (int e = tid; e < TNR * nqx; e += nthr) {
      const int r = e / nqx, j = e - r * nqx, u = r0 + r;
      if (u >= noc) continue;
      const int row = u / xdim, col = u - row * xdim;
      const int p = (hexa ? (row & 1) * xdim : 0) + col;
      copyx(wxrow(c, r) + kPE * j, pat + (size_t)p * B + s0 + kPE * j, nb - kPE * j);
    }
    const int nq = (nb + 3) >> 2;  // 4-sample pieces per row
    for (int e = tid; e < ny * nq; e += nthr) {
      const int y = e / nq, j = e - y * nq;
      if (y0 + y >= ydim) continue;
      copy4(dy + y * kWS + 4 * j, ytab + (size_t)(y0 + y) * B + s0 + 4 * j, nb - 4 * j);
    }
    if (!gaussian) {
      for (int j = tid; j < nq; j += nthr)
        copy4(aws() + (c & 1) * kBC + 4 * j, aw + s0 + 4 * j, nb - 4 * j);
    }
  }
  __device__ __forceinline__ float w(int c, int q, int ks, int nb) const {
    const int s = 8 * ks + (threadIdx.x & 3) + 4 * (q >> 1), h = q & 1;
    if (!ok[h] || s >= nb) return 0.f;
    const float wx = load_f32(wxrow(c, rl[h]) + s);
    const float wy = wys()[((c & 1) * ny + yi[h]) * kWS + s];
    return gaussian ? wx * wy : (wx + wy <= r2 ? aws()[(c & 1) * kBC + s] : 0.f);
  }
};

// The separable policy of one step, for CTAs of TNR rows (init sets the rows)
template <int TNR, typename PT>
__device__ __forceinline__ SeparableW<TNR, PT> separable_policy(
    const float* __restrict__ aw, int B, int noc, int xdim, int hexa, int gaussian,
    float radius, int ny, const PT* __restrict__ pat, const float* __restrict__ ytab) {
  SeparableW<TNR, PT> wp;
  wp.pat = pat;
  wp.ytab = ytab;
  wp.aw = aw;
  wp.B = B;
  wp.noc = noc;
  wp.xdim = xdim;
  wp.ydim = (noc + xdim - 1) / xdim;
  wp.ny = ny;
  wp.hexa = hexa != 0;
  wp.gaussian = gaussian != 0;
  wp.r2 = radius * radius;
  return wp;
}

// The separable step on the tensor cores, 16 WARPS rows per CTA; xs from
// split_batches_kernel (its kBf16 form under kBf16); kPasses: past D 256 in
// feature passes (rows32: a bf16 codebook's float32 rows)
template <int NT, int WARPS, bool kBf16, bool kPasses, typename CT, typename PT>
__device__ __forceinline__ void separable_step_tc(
    CT* __restrict__ codes, int noc, int D, const float* __restrict__ xs,
    const float* __restrict__ aw, int B, int Bn, int xdim, int hexa, int gaussian,
    float radius, int ny, const PT* __restrict__ pat, const float* __restrict__ ytab,
    unsigned long long* __restrict__ keys, float* rows32) {
  auto wp = separable_policy<16 * WARPS>(aw, B, noc, xdim, hexa, gaussian, radius, ny,
                                         pat, ytab);
  fused_step_tc<NT, WARPS, kBf16, kPasses>(codes, noc, D, xs, B, Bn, keys, wp, rows32);
}

// The main launch of a separable tensor-core kernel (K13, or K14's main
// form): NT 8-feature steps (NT 32 past D 256: the feature passes), WARPS
// warps of 16 rows; the batches split first, into a.xs
template <int NT, int WARPS, bool kBf16, typename CT, typename PT, typename K>
int launch_separable_tc(K kernel, const StepArgs& a) {
  constexpr int TNR = 16 * WARPS;
  const int ydim = (a.noc + a.xdim - 1) / a.xdim;
  const int ny = min((TNR - 1) / a.xdim + 2, ydim);
  const size_t smem =
      FusedSmem<NT, WARPS, kBf16>::bytes(SeparableW<TNR, PT>::floats(ny));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rc =
      split_batches<kBf16>(a.xb, a.B, a.xn, a.Bn, a.D, 8 * NT, a.xs, a.stream);
  if (rc) return rc;
  kernel<<<(a.noc + TNR - 1) / TNR, 32 * WARPS, smem, a.stream>>>(
      static_cast<CT*>(a.codes), a.noc, a.D, a.xs, a.aw, a.B, a.Bn, a.xdim,
      a.hexa, a.gaussian, a.radius, ny, static_cast<const PT*>(a.pat), a.ytab,
      a.keys, a.rows32);
  return (int)cudaGetLastError();
}

}  // namespace
