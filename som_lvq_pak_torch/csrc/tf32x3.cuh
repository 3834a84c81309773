// Split-TF32 ("3xTF32") tensor-core products at float32 accuracy, shared by
// the tensor-core kernels (K1-K14, K16, K17), and the int8 product of K14's
// int8_win winners (mma_s8 below).
//
// A float32 operand a is split as a = hi + lo + r with hi = tf32(a) and
// lo = tf32(a - hi), both rounded to nearest, ties away from zero
// (cvt.rna.tf32.f32); |r| <= 2^-22 |a|.  A product is taken as
// lo*hi + hi*lo + hi*hi on mma.sync.m16n8k8 with float32 accumulators, the
// two small terms first; the dropped lo*lo term is below 2^-22 |a b|.  One
// TF32 pass (hi*hi alone) is off by up to 2^-11 relative per operand, which
// the port's float32 gates do not allow.
//
// Fragment layouts of mma.m16n8k8 with .tf32 operands (PTX ISA), for lane
// = 4 g + t (g = lane >> 2, t = lane & 3):
//   A (16 x 8, row major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)
// Operands are staged in shared memory split once, as separate hi and lo
// arrays, and loaded into fragments with the row strides below.
// Features are padded to a multiple of 8 with zeros in shared memory only.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}

// a = hi + lo (+ a remainder below 2^-22 |a|)
__device__ __forceinline__ void split_tf32(float a, float& hi, float& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - hi);
}

// d += a b on one m16n8k8 TF32 tile
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float (&a)[4],
                                         const float (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}

// d += (a_hi + a_lo)(b_hi + b_lo) without the lo*lo term, small terms first
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const float (&ahi)[4],
                                           const float (&alo)[4],
                                           const float (&bhi)[2],
                                           const float (&blo)[2]) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

// A fragment of rows r0..r0+15, columns k0..k0+7 of a row-major array
__device__ __forceinline__ void load_a(float (&a)[4], const float* s, int stride,
                                       int r0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = s + (r0 + g) * stride + k0 + t;
  a[0] = p[0];
  a[1] = p[8 * stride];
  a[2] = p[4];
  a[3] = p[8 * stride + 4];
}

// B fragment (k0..k0+7) x (n0..n0+7) of an array stored n-major: s[n][k]
__device__ __forceinline__ void load_b_nk(float (&b)[2], const float* s, int stride,
                                          int n0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = s + (n0 + g) * stride + k0 + t;
  b[0] = p[0];
  b[1] = p[4];
}

// B fragment (k0..k0+7) x (n0..n0+7) of an array stored k-major: s[k][n]
__device__ __forceinline__ void load_b_kn(float (&b)[2], const float* s, int stride,
                                          int k0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = s + (k0 + t) * stride + n0 + g;
  b[0] = p[0];
  b[1] = p[4 * stride];
}

// Row strides for the loads above: rows of n floats padded so the 32 lanes
// of one load hit 32 distinct banks (n-major and A loads: stride 4 mod 32;
// k-major loads: 8 mod 32)
__host__ __device__ constexpr int stride_nk(int n) { return (n + 31) / 32 * 32 + 4; }
__host__ __device__ constexpr int stride_kn(int n) { return (n + 31) / 32 * 32 + 8; }

// cp.async: 16 or 4 bytes, global to shared, bypassing registers
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy `n` floats from global `src` to shared `dst` with cp.async (16-byte
// pieces when both ends allow, else 4-byte ones), by all threads of the CTA.
__device__ __forceinline__ void cp_async_floats(float* dst, const float* src, int n,
                                                int tid, int nthreads) {
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  if (vec) {
    const int n4 = n >> 2;
    for (int i = tid; i < n4; i += nthreads) cp_async16(dst + 4 * i, src + 4 * i);
    for (int i = 4 * n4 + tid; i < n; i += nthreads) cp_async4(dst + i, src + i);
  } else {
    for (int i = tid; i < n; i += nthreads) cp_async4(dst + i, src + i);
  }
}

// The int8 product, mma.sync.m16n8k32 with .s8 operands and int32
// accumulators: exact, for |a b| summed below 2^31 (127^2 x 256 features is
// 4.1e6).  Fragments (PTX ISA), four int8 values of consecutive k per 32-bit
// register, lane = 4 g + t:
//   A (16 x 32, row major): a0 (g, 4t..4t+3), a1 (g + 8, 4t..), a2 (g,
//                           16 + 4t..), a3 (g + 8, 16 + 4t..)
//   B (32 x 8, k x n):      b0 (k 4t..4t+3, n g), b1 (k 16 + 4t.., n g)
//   C (16 x 8):             the TF32 tile's: c0 (g, 2t), c1 (g, 2t + 1),
//                           c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// Both operands are staged row by row (A's rows, B's samples) as int8 and
// read as 32-bit words; a row stride of an odd multiple of 4 words puts the 8
// rows g of one load on distinct banks (stride_s8).
__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of rows r0..r0+15, k words kw..kw+7 (32 int8 values) of a
// row-major int8 array read as words, `stride` words a row
__device__ __forceinline__ void load_a_s8(int (&a)[4], const int* s, int stride, int r0,
                                          int kw, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int* p = s + (r0 + g) * stride + kw + t;
  a[0] = p[0];
  a[1] = p[8 * stride];
  a[2] = p[4];
  a[3] = p[8 * stride + 4];
}

// B fragment, k words kw..kw+7 of samples n0..n0+7, stored n-major as int8
// rows of `stride` words
__device__ __forceinline__ void load_b_s8(int (&b)[2], const int* s, int stride, int n0,
                                          int kw, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int* p = s + (n0 + g) * stride + kw + t;
  b[0] = p[0];
  b[1] = p[4];
}

// Row stride (words) of int8 rows of k8 values (a multiple of 32): an odd
// multiple of 4
__host__ __device__ constexpr int stride_s8(int k8) { return k8 / 4 + 4; }

// (value, index) lexicographic order: equal values go to the lower index
__device__ __forceinline__ bool lex_less(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}
__device__ __forceinline__ bool lex_greater(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

}  // namespace
