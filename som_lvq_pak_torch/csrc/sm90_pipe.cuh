// Hopper's asynchronous pipeline in PTX, for kernels that feed warpgroup
// `wgmma` from a ring of shared-memory slots filled by TMA: mbarriers, the
// 1-D and 2-D tensor-map loads and the tensor map's encoder, the warpgroup
// register split (setmaxnreg), a thread-block cluster's barrier and
// distributed shared memory (K14's batch split), the
// shared-memory matrix descriptor of a K-major swizzled operand, the wgmma
// fences, the int8 m64n256k32 product (K15) and the TF32 m64n128k8 (K1, K2,
// K8, K3's and K17's winners), m64n64k8 (K4, their update at D 64) and
// m64n32k8 (their update at D 32) products with A from registers.  Written
// by hand (no CuTe) so that a source including it builds in seconds.  Only
// for sm_90a: wgmma does not exist on plain sm_90.
//
// The pattern: one producer thread waits on a slot's "empty" barrier, arms
// its "full" barrier with the bytes it expects (arrive_expect_tx) and issues
// the TMA copy, which completes the transaction on that barrier; consumers
// wait on "full" with the slot's phase parity, run wgmma on the slot, and
// arrive on "empty" once wgmma_wait says the products have read it.
//
// Swizzled K-major operands (TMA's CU_TENSOR_MAP_SWIZZLE_{64,128}B and a
// descriptor of the same layout): rows of W bytes (W = 64 or 128, the
// swizzle span), the 16-byte chunk c of row r stored at chunk c ^ ((r >> s)
// & (W / 16 - 1)), s = 1 for W 64 and 0 for W 128 (the XOR takes address
// bits 7.. of a tile aligned to 1024 bytes: swizzle_offset below).  Eight
// rows make one core-matrix group, 8 W bytes apart (the descriptor's stride
// byte offset); a k step of 32 bytes inside a row (32 int8 values, 8 TF32
// ones) moves the start address by 32 bytes.

#pragma once

#include <cuda.h>  // CUtensorMap (a type only: libcuda is not linked)
#include <cuda_runtime.h>

#include <cstdint>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after the inits, before any other thread or the TMA unit uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival, and `bytes` more to come from the copies completing on `bar`
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// `bytes` more to come from the copies completing on `bar`, without an
// arrival (a barrier whose arrivals come from other threads, K7's)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// until the phase of parity `parity` has completed (a barrier starts in phase
// 0, so waiting on parity 1 passes at once)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA --------------------------------------------------------------------

// the box at (c0 inner, c1 outer) of `map` into `dst`, completing on `bar`;
// elements outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the box at c0 of the 1-D `map` into `dst`, completing on `bar`; elements
// outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

// shared-memory writes by ordinary stores, made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// named barrier `id` over `count` threads (a multiple of 32): wait for it,
// or arrive without waiting
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ---- thread-block clusters ---------------------------------------------------

// this CTA's rank in its cluster and the cluster's CTA count (0 and 1 in a
// launch without clusters)
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

// every non-exited thread of the cluster past this point: the writes before
// it (shared memory of any CTA of the cluster) seen by the reads after it.
// The aligned form for whole warps, the other for a thread alone
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync_thread() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

// the shared::cluster address of the shared::cta address `addr` in the
// cluster's CTA `rank`, and loads from such an address
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float4 ld_cluster_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// the registers each thread of this warpgroup owns, lowered or raised to R
// (a multiple of 8 in 24..256); every thread of the warpgroup executes it,
// and a raise waits until the pool has the registers
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// ---- wgmma ------------------------------------------------------------------

// byte offset `o` of a K-major tile of W-byte rows, swizzled as TMA writes it
template <int W>
__host__ __device__ constexpr uint32_t swizzle_offset(uint32_t o) {
  static_assert(W == 64 || W == 128, "swizzle span");
  return o ^ (((o >> 7) & (W / 16 - 1)) << 4);
}

// descriptor of the K-major swizzled operand at shared address `addr`:
// start address >> 4 (bits 0-13), leading byte offset 1 (unused for a
// swizzled K-major operand), stride byte offset 8 W >> 4 (bits 32-45), the
// layout (bits 62-63: 1 for 128B, 2 for 64B)
template <int W>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  constexpr uint64_t layout = W == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * W) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// ties the registers to this point: the compiler neither reads them before a
// wgmma_wait nor keeps them past the next product
template <int R>
__device__ __forceinline__ void fence_operand(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SOMVQ_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define SOMVQ_R16(i) SOMVQ_R4(i), SOMVQ_R4(i + 4), SOMVQ_R4(i + 8), SOMVQ_R4(i + 12)
#define SOMVQ_R64(i) SOMVQ_R16(i), SOMVQ_R16(i + 16), SOMVQ_R16(i + 32), SOMVQ_R16(i + 48)

// d (+)= A B, A 64 x 32 and B 32 x 256 int8 from the descriptors, d int32
// (exact): thread l of warp w of the warpgroup holds, for j < 32, d[4j],
// d[4j + 1] at row 16 w + l / 4, columns 8 j + 2 (l % 4) and +1, and d[4j + 2],
// d[4j + 3] at row 16 w + l / 4 + 8, the same columns.  `accumulate` 0 takes
// d = A B.
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : SOMVQ_R64(0), SOMVQ_R64(64)
      : "l"(a), "l"(b), "r"(accumulate));
}

#define SOMVQ_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SOMVQ_F16(i) SOMVQ_F4(i), SOMVQ_F4(i + 4), SOMVQ_F4(i + 8), SOMVQ_F4(i + 12)

// d += A B (d = A B where `accumulate` is 0: wgmma's scale-d), A 64 x 8 TF32
// from registers, B 8 x 128 TF32 from a K-major descriptor, d float32: A as
// mma.m16n8k8's A fragment of rows 16 w.. for warp w of the warpgroup (a0
// (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4), lane = 4 g
// + t); d as in wgmma_s8_n256, 64 values:
// d[4j], d[4j + 1] at row 16 w + g, columns 8 j + 2 t and + 1, d[4j + 2],
// d[4j + 3] at row 16 w + g + 8 (the m16n8k8 C fragment of column block j)
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const float (&a)[4],
                                                uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : SOMVQ_F16(0), SOMVQ_F16(16), SOMVQ_F16(32), SOMVQ_F16(48)
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])), "l"(b), "r"(accumulate));
}

// the same with B 8 x 64 (K4's 64-code tiles): d 32 values, d[4j..4j + 3]
// the C fragment of column block j < 8
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const float (&a)[4],
                                               uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : SOMVQ_F16(0), SOMVQ_F16(16)
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])), "l"(b), "r"(accumulate));
}

// the same with B 8 x 32 (K3's and K17's update at 32 features): d 16
// values, d[4j..4j + 3] the C fragment of column block j < 4
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], const float (&a)[4],
                                               uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : SOMVQ_F16(0)
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])), "l"(b), "r"(accumulate));
}

#undef SOMVQ_F16
#undef SOMVQ_F4
#undef SOMVQ_R64
#undef SOMVQ_R16
#undef SOMVQ_R4

// ---- tensor maps (host) ------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime (no -lcuda);
// null if the driver has none
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a row-major (rows, cols) array at `base` (rank 2; rank 1
// when rows is 0: cols elements), with boxes of (box_cols, box_rows) and
// zeros outside it; cudaErrorSymbolNotFound if libcuda has no encoder,
// cudaErrorInvalidResourceHandle if the encode fails
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                      const void* base, int rows, int cols, int box_cols, int box_rows,
                      CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint32_t rank = rows > 0 ? 2 : 1;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidResourceHandle;
  return 0;
}

}  // namespace sm90
