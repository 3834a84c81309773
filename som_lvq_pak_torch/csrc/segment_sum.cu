// The LVQ steps' segment sum in a fixed order: out[n, c] = the sum of
// rows[b, c] over the samples b with seg[b] == n, added in ascending sample
// order starting from 0.0, and 0 where no sample has segment n.
//
// This replaces no TPU kernel: the JAX package takes its segment sums from
// XLA (jax.ops.segment_sum, som_lvq_pak_tpu/models/fast.py:265-267, :311,
// :355-366), which gives one result per input.  On the CPU, jax.ops.
// segment_sum, np.add.at and torch's index_add_ add each segment's rows in
// ascending sample order from 0.0, bit for bit alike; on CUDA index_add_ adds
// with atomics in no fixed order, so two runs of an LVQ trainer on the card
// differed in the last bits and then in their accuracy.  These kernels give
// the CPU's order on the card.
//
// Design, two launches into the output, zeroed first (cudaMemsetAsync), all
// from one call of the C entry:
//   * segment_runs_kernel, one CTA: the keys (seg << 32) | b, unique, so any
//     sort of them orders each segment's samples by b, bitonic-sorted in
//     shared memory (B <= kSortMax; the wrapper sorts larger batches with a
//     stable torch.sort); it writes the sorted ids, the permutation and, at
//     the first position of each run, the run's end (a binary search in the
//     sorted keys);
//   * segment_sum_kernel: one thread per (sorted position, column) starts
//     only where a run starts, walks the run in order with __fadd_rn from
//     0.0 (no contraction, no atomics) and writes its sum; a segment with no
//     run keeps the output's 0.  The run's bounds are known, so the loads of
//     the walk do not wait on each other.  Neighbouring threads take
//     neighbouring columns, so the row reads and the writes are coalesced.
// Ids outside [0, noc) add nothing.
//
// What bounds it on H100: bytes.  The zeroed output (noc x C float32, 16 MB
// at the olvq1 step's 65,536 x 64) is written once; each input row is read
// once by the threads of its run.  A hot segment's threads add its run one
// row after another, so a run of r rows takes r dependent adds.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSortMax = 4096;  // samples the one-CTA sort takes
constexpr int kSortThreads = 1024;

__global__ void __launch_bounds__(kSortThreads)
segment_runs_kernel(const int64_t* __restrict__ seg, int B, int* __restrict__ sid,
                    int* __restrict__ perm, int* __restrict__ rend) {
  __shared__ unsigned long long key[kSortMax];
  int P = 1;
  while (P < B) P <<= 1;
  for (int i = threadIdx.x; i < P; i += kSortThreads)
    key[i] = i < B ? ((unsigned long long)(uint32_t)seg[i] << 32) | (uint32_t)i
                   : ~0ull;
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += kSortThreads) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long a = key[i], b = key[l];
          if (((i & k) == 0) == (a > b)) {
            key[i] = b;
            key[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < B; i += kSortThreads) {
    const uint32_t n = (uint32_t)(key[i] >> 32);
    sid[i] = (int)n;
    perm[i] = (int)(uint32_t)key[i];
    if (i == 0 || (uint32_t)(key[i - 1] >> 32) != n) {
      int lo = i + 1, hi = B;  // the first position past the run
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((uint32_t)(key[mid] >> 32) == n)
          lo = mid + 1;
        else
          hi = mid;
      }
      rend[i] = lo;
    }
  }
}

__global__ void __launch_bounds__(256)
segment_sum_kernel(const float* __restrict__ rows, const int* __restrict__ sid,
                   const int* __restrict__ perm, const int* __restrict__ rend, int B,
                   int C, int noc, float* __restrict__ out) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)B * C) return;
  const int i = (int)(e / C), c = (int)(e % C);
  const int n = __ldg(sid + i);
  if ((i > 0 && __ldg(sid + i - 1) == n) || n < 0 || n >= noc) return;
  const int end = __ldg(rend + i);
  float s = 0.f;
#pragma unroll 4
  for (int j = i; j < end; ++j)
    s = __fadd_rn(s, __ldg(rows + (size_t)__ldg(perm + j) * C + c));
  out[(size_t)n * C + c] = s;
}

}  // namespace

// rows (B, C) float32, seg (B,) int64; scratch (3, B) int32: the sorted ids,
// the permutation and the run ends, filled here (presorted 0, B <= 4096) or
// by the wrapper (presorted 1: a stable torch.sort, the run ends at each
// position); out (noc, C) float32, zeroed here, then the runs' sums
extern "C" int somvq_segment_sum(const float* rows, const int64_t* seg, int B, int C,
                                 int noc, int presorted, int* scratch, float* out,
                                 cudaStream_t stream) {
  if (B < 0 || C <= 0 || noc <= 0 || (!presorted && B > kSortMax))
    return (int)cudaErrorInvalidValue;
  int rc = (int)cudaMemsetAsync(out, 0, sizeof(float) * (size_t)noc * C, stream);
  if (rc || B == 0) return rc;
  int *sid = scratch, *perm = scratch + B, *rend = scratch + 2 * B;
  if (!presorted) {
    segment_runs_kernel<<<1, kSortThreads, 0, stream>>>(seg, B, sid, perm, rend);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  const int64_t blocks = ((int64_t)B * C + 255) / 256;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<<<(unsigned)blocks, 256, 0, stream>>>(rows, sid, perm, rend, B,
                                                          C, noc, out);
  return (int)cudaGetLastError();
}
