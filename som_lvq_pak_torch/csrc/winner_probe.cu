// The int8 winner-contraction probe (K15): out[b] = max over rows n of
// sum_k m[n, k] x[k, b], m (N, D) int8, x (D, B) int8, into int32.
//
// Replaces tools/int8_probe.py's Pallas kernel `kern` (:95, int8 x int8 ->
// int32, K15 int8_winner_probe), which measured whether an int8 winner
// contraction pays (pallas_som.py:969-970; its use in the fused step is
// K14's int8_win).  Its float32 twin `kern32` (:154, K16 f32_winner_probe)
// runs on the tensor cores on the split-TF32 mma.sync walk
// (dist_argmin_t.cu).  The TPU kernel folds a running max over 256-row tiles
// of an in-order grid into a (1, B) row.
//
// What bounds it on H100: the int8 multiply-adds, 2 N D B operations at
// 1979 TOP/s (17 us at 65536 x 64 x 4096), then the L2 reads of m: every
// CTA walks its share of the codes, so m is read from L2 once per block of
// samples.  Device memory moves only m and x once and the (B,) maxima.
//
// The design (sm90_pipe.cuh): warpgroup wgmma.m64n256k32.s32.s8.s8, with the
// samples on the M side and 256 codes on the N side, so that the fold over
// codes stays in each thread's registers.  A CTA takes 128 samples (two
// consumer warpgroups of 64) and a span of whole 256-code tiles (the
// codebook split `splits` ways, ops.winner_probe.k15_splits, so that the
// grid fills the SMs at B 4096).  One producer warp streams the span's m
// tiles by TMA into a ring of `stages` slots (256 codes x W bytes each, W 64
// up to D 64 and 128 past it, 64B or 128B swizzle; D past W in KC chunks of
// W, one slot each, all of a tile's in the ring together); x's block is
// staged once, transposed to the same K-major swizzled layout by the
// consumers themselves.  Both warpgroups read the same slots and take turns
// to issue a tile's products, so that while one folds its 128 accumulators
// (two samples x 64 codes a thread, __vimax3_s32 into four partial maxima a
// sample) the other's products run: at D 64 a tile's two k steps take
// about as long on the tensor cores as the fold takes to issue.  The quad's
// maxima meet by two shuffles, and the CTAs' by atomicMax into `out`,
// filled with INT_MIN just before: a max over int32 is exact and
// independent of order, so reruns are bit-equal.  Codes past N arrive from
// TMA as zeros and are left out of the fold (a zero would beat a negative
// maximum); samples past B are not written.  An int8 dot is exact in int32
// (512 x 128^2 < 2^31), so the result is bit-equal to a float64 reference.
// The accumulators stay in place across the products (KC a template
// parameter, every loop over chunks unrolled): ptxas otherwise serializes
// the wgmma behind waits of its own.

#include "sm90_pipe.cuh"

#include <climits>

namespace {

constexpr int TN = 256;                 // codes per tile: the wgmma's N
constexpr int CONSUMERS = 2;            // warpgroups of 64 samples
constexpr int BS = 64 * CONSUMERS;      // samples per CTA
constexpr int THREADS = 128 * CONSUMERS + 32;  // and the producer warp
constexpr int SMEM_MAX = 232448;        // a CTA's dynamic shared memory
constexpr int MAX_STAGES = 8;
constexpr int BARRIER_BYTES = 2 * MAX_STAGES * 8;
constexpr int ALIGN = 1024;             // the 128B swizzle's period

// The shared layout (mirrored by ops.winner_probe.k15_layout): the ring,
// x's block, the barriers, after up to ALIGN bytes to align the ring.
struct Layout {
  int W, KC, stages, bytes;
};

Layout layout(int D) {
  Layout l;
  l.W = D <= 64 ? 64 : 128;
  l.KC = (D + l.W - 1) / l.W;
  const int xs = l.KC * BS * l.W, slot = TN * l.W;
  l.stages = (SMEM_MAX - ALIGN - BARRIER_BYTES - xs) / slot;
  if (l.stages > MAX_STAGES) l.stages = MAX_STAGES;
  l.bytes = ALIGN + l.stages * slot + xs + BARRIER_BYTES;
  return l;
}

// x[:, b0:b0 + BS] into xs as BS rows of KC chunks of W bytes (zeros past D
// and B), four k values of one sample a word, swizzled as TMA lays out m
template <int W>
__device__ __forceinline__ void stage_x(const signed char* __restrict__ x, int D, int B,
                                        int b0, int KC, unsigned char* xs) {
  const int words = KC * W / 4 * BS;
  for (int e = threadIdx.x; e < words; e += 128 * CONSUMERS) {
    const int s = e % BS, k = 4 * (e / BS), b = b0 + s;
    uint32_t v = 0u;
    if (b < B) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k + j < D)
          v |= static_cast<uint32_t>(static_cast<unsigned char>(x[(size_t)(k + j) * B + b]))
               << (8 * j);
    }
    const int c = k / W;
    *reinterpret_cast<uint32_t*>(xs + c * BS * W +
                                 sm90::swizzle_offset<W>(s * W + k % W)) = v;
  }
}

// the running maxima of this thread's two samples over the tile's codes
// below `valid` (all 256 but in the last tile)
__device__ __forceinline__ void fold(const int (&d)[128], int valid, int (&p0)[4],
                                     int (&p1)[4]) {
  if (valid >= TN) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      p0[j & 3] = __vimax3_s32(p0[j & 3], d[4 * j], d[4 * j + 1]);
      p1[j & 3] = __vimax3_s32(p1[j & 3], d[4 * j + 2], d[4 * j + 3]);
    }
    return;
  }
  const int col = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int n = 8 * j + col;
    if (n < valid) {
      p0[j & 3] = max(p0[j & 3], d[4 * j]);
      p1[j & 3] = max(p1[j & 3], d[4 * j + 2]);
    }
    if (n + 1 < valid) {
      p0[j & 3] = max(p0[j & 3], d[4 * j + 1]);
      p1[j & 3] = max(p1[j & 3], d[4 * j + 3]);
    }
  }
}

__global__ void fill_int_min(int* __restrict__ out, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) out[b] = INT_MIN;
}

__device__ __forceinline__ void fold_max(int* out, int v) {
  if (v > __ldcg(out)) atomicMax(out, v);  // out only grows
}

// grid (ceil(B / BS), splits); out starts at INT_MIN
template <int W, int KC>
__global__ void __launch_bounds__(THREADS, 1)
int8_winner_probe_kernel(const __grid_constant__ CUtensorMap m_map,
                         const signed char* __restrict__ x, int N, int D, int B,
                         int stages, int* __restrict__ out) {
  const int tiles = (N + TN - 1) / TN, splits = gridDim.y;
  const int t0 = (int)((long long)blockIdx.y * tiles / splits);
  const int t1 = (int)((long long)(blockIdx.y + 1) * tiles / splits);
  if (t0 == t1) return;
  const int b0 = blockIdx.x * BS;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((ALIGN - (sm90::smem_u32(smem_raw) & (ALIGN - 1))) & (ALIGN - 1));
  unsigned char* xs = ring + stages * TN * W;
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + KC * BS * W);
  uint64_t* empty = full + MAX_STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4 * CONSUMERS);  // one arrival per consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * CONSUMERS) {  // the producer warp
    if (threadIdx.x == 128 * CONSUMERS) {
      int s = 0;
      uint32_t phase = 0;  // of slot s's current use
      for (int t = t0; t < t1; ++t) {
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          sm90::mbar_wait(&empty[s], phase ^ 1);
          sm90::mbar_arrive_expect_tx(&full[s], TN * W);
          sm90::tma_load_2d(ring + s * TN * W, &m_map, &full[s], c * W, t * TN);
          if (++s == stages) s = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  stage_x<W>(x, D, B, b0, KC, xs);
  sm90::fence_proxy_async();
  sm90::bar_sync(1, 128 * CONSUMERS);

  const int g = threadIdx.x / 128, lane = threadIdx.x & 31;
  const uint32_t a_base = sm90::smem_u32(xs) + g * 64 * W;
  int d[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) d[j] = 0;
  int p0[4], p1[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) p0[j] = p1[j] = INT_MIN;
  // the warpgroups take turns to issue a tile's products (named barrier 2 +
  // g: g's turn), so that the tensor cores run them one warpgroup after the
  // other and each folds while the other's products run
  constexpr int TURN = 256;  // a turn's barrier: one warpgroup arrives, the next waits
  if (g == CONSUMERS - 1) sm90::bar_arrive(2, TURN);
  // a tile's KC chunks are in slots s, s + 1, ... (mod stages), of phase
  // `phase` up to the ring's end and the next one past it
  int s = 0;
  uint32_t phase = 0;
  for (int t = t0; t < t1; ++t) {
    int slot[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const bool wrap = s + c >= stages;
      slot[c] = wrap ? s + c - stages : s + c;
      sm90::mbar_wait(&full[slot[c]], phase ^ wrap);
    }
    sm90::bar_sync(2 + g, TURN);
    __syncwarp();
    sm90::fence_operand(d);
    sm90::wgmma_fence();
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const uint32_t a = a_base + c * BS * W;
      const uint32_t b = sm90::smem_u32(ring + slot[c] * TN * W);
#pragma unroll
      for (int k = 0; k < W / 32; ++k)
        sm90::wgmma_s8_n256(d, sm90::kmajor_desc<W>(a + 32 * k),
                            sm90::kmajor_desc<W>(b + 32 * k), c | k);
    }
    sm90::wgmma_commit();
    if (g != CONSUMERS - 1 || t + 1 < t1) sm90::bar_arrive(2 + (g + 1) % CONSUMERS, TURN);
    sm90::wgmma_wait<0>();
    sm90::fence_operand(d);
    if (lane == 0)
#pragma unroll
      for (int c = 0; c < KC; ++c) sm90::mbar_arrive(&empty[slot[c]]);
    if ((s += KC) >= stages) s -= stages, phase ^= 1;
    fold(d, N - t * TN, p0, p1);
  }
  int best[2] = {max(max(p0[0], p0[1]), max(p0[2], p0[3])),
                 max(max(p1[0], p1[1]), max(p1[2], p1[3]))};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    best[h] = max(best[h], __shfl_xor_sync(0xffffffffu, best[h], 1));
    best[h] = max(best[h], __shfl_xor_sync(0xffffffffu, best[h], 2));
    const int b = b0 + 64 * g + 16 * ((threadIdx.x / 32) & 3) + lane / 4 + 8 * h;
    if ((lane & 3) == 0 && b < B) fold_max(out + b, best[h]);
  }
}

template <int W, int KC>
int launch(const signed char* m, const signed char* x, int N, int D, int Dp, int B,
           int splits, int* out, cudaStream_t stream) {
  const Layout l = layout(D);
  CUtensorMap map;
  const int enc = sm90::encode_map(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, m, N, Dp, W, TN,
                                   W == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                            : CU_TENSOR_MAP_SWIZZLE_64B);
  if (enc) return enc;
  const cudaError_t attr = cudaFuncSetAttribute(
      int8_winner_probe_kernel<W, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
  if (attr != cudaSuccess) return (int)attr;
  fill_int_min<<<(B + 255) / 256, 256, 0, stream>>>(out, B);
  const dim3 grid((B + BS - 1) / BS, splits);
  int8_winner_probe_kernel<W, KC><<<grid, THREADS, l.bytes, stream>>>(map, x, N, D, B,
                                                                      l.stages, out);
  return (int)cudaGetLastError();
}

}  // namespace

// K15: m (N, Dp) int8 with Dp = D rounded up to 16 (zeros past D) at a
// 16-byte aligned address, x (D, B) int8; out (B,) int32 gets max_n
// m[n].x[:, b] (filled with INT_MIN, then folded into by atomicMax).
// `splits` in [1, ceil(N / 256)].
// A failed encode of m's tensor map returns cudaErrorInvalidResourceHandle
// (cudaErrorSymbolNotFound if libcuda has no encoder).
extern "C" int somvq_int8_winner_probe(const signed char* m, const signed char* x, int N,
                                       int D, int Dp, int B, int splits, int* out,
                                       cudaStream_t stream) {
  if (N <= 0 || D <= 0 || B <= 0 || Dp < D || Dp % 16 != 0 ||
      reinterpret_cast<uintptr_t>(m) % 16 != 0 || splits < 1 ||
      splits > (N + TN - 1) / TN || layout(D).stages < max(2, layout(D).KC))
    return (int)cudaErrorInvalidValue;
  switch (D <= 64 ? 0 : layout(D).KC) {
    case 0: return launch<64, 1>(m, x, N, D, Dp, B, splits, out, stream);
    case 1: return launch<128, 1>(m, x, N, D, Dp, B, splits, out, stream);
    case 2: return launch<128, 2>(m, x, N, D, Dp, B, splits, out, stream);
    case 3: return launch<128, 3>(m, x, N, D, Dp, B, splits, out, stream);
    case 4: return launch<128, 4>(m, x, N, D, Dp, B, splits, out, stream);
    default: return (int)cudaErrorInvalidValue;  // past ops.winner_probe.K15_MAX_D
  }
}
