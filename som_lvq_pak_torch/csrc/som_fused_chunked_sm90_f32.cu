// K14's main form on Hopper for a float32 codebook: separable_sm90.cuh's walk
// with K14's roundings and each tile's batch split across a cluster,
// instantiated here so that nvcc builds it beside the bf16 codebook's
// (som_fused_chunked_sm90_bf16.cu); the cluster occupancy check of its
// launch (the instances share their shared memory and threads per CTA); and
// the two C entries, which need these two sources alone.

#include "separable_sm90.cuh"

namespace {

// the most clusters of `cluster` CTAs of the walk at D (batch_bf16: its
// one-plane instance) the card holds at once, or a negative CUDA error
template <int DP, int P>
int max_clusters(int cluster) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int rc = walk_config<DP, true, P, true, float>(cfg, attr, 1, cluster, nullptr);
  if (rc) return -rc;
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, separable_kernel<DP, true, P, true, float>(), &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

int k14_max_clusters(int D, int batch_bf16, int cluster) {
  const int DP = dp_of(D);
  if (DP == 0 || !(cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8))
    return -(int)cudaErrorInvalidValue;
#define K14_CLUSTERS(W)                                                           \
  if (DP == W) return batch_bf16 ? max_clusters<W, 1>(cluster) : max_clusters<W, 2>(cluster);
  K14_CLUSTERS(32)
  K14_CLUSTERS(64)
  K14_CLUSTERS(128)
#undef K14_CLUSTERS
  return -(int)cudaErrorInvalidValue;
}

}  // namespace

// K14's main form for D <= 128 on separable_sm90.cuh's walk
// (ops.som_step.k14_route), each tile's batch split across a cluster of
// `cluster` CTAs (1, 2, 4 or 8; ops.som_step.k14_cluster): the table launch
// (the x-pattern rounded to bf16 and kept as float32 under wxa_bf16,
// gaussian only), the prologue, the walk.  Arguments as
// somvq_som_fused_factored_sm90's, with xs the prologue's scratch, 16-byte
// aligned: P DP (Bp + Bnp) floats, P 1 under batch_bf16, else 2
// (ops.som_step.sm90_scratch without K3's table), and pat a float32 (n_pat,
// Bp) table
extern "C" int somvq_som_fused_chunked_sm90(
    void* codes, int codes_bf16, int noc, int D, const float* xb, const int* bmu,
    const float* alpha, int B, const float* xn, int Bn, int xdim, int hexa, int gaussian,
    float radius, int wxa_bf16, int batch_bf16, int cluster, float* xs, void* pat,
    float* ytab, float* aw, unsigned long long* keys, float* val, int* idx,
    cudaStream_t stream) {
  const StepArgs a{codes,  noc,     D,    xb, bmu,  alpha, B,
                   xn,     nullptr, nullptr, Bn, xdim, hexa,  gaussian,
                   radius, 0,       128,  xs, pat,  ytab,  aw,
                   keys,   nullptr, stream};
  return separable_step(a, wxa_bf16, val, idx, [&](const StepArgs& s) {
    return codes_bf16 ? somvq::k14_sm90_bf16codes(s, batch_bf16, cluster)
                      : k14_sm90<float>(s, batch_bf16, cluster);
  });
}

// The most clusters of `cluster` CTAs of K14's Hopper walk at D (batch_bf16:
// its one-plane instance) the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out
extern "C" int somvq_som_fused_chunked_sm90_clusters(int D, int batch_bf16, int cluster,
                                                     int* out) {
  const int n = k14_max_clusters(D, batch_bf16, cluster);
  if (n < 0) return -n;
  *out = n;
  return 0;
}
