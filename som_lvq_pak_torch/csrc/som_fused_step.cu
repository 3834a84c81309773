// One SOM training step in one pass over the codebook: the neighbourhood
// update of batch t, then batch t+1's winners against the updated rows, on
// split-TF32 mma.sync, for D > 128: K3's route past the widest D its Hopper
// walk takes (fused_step_sm90.cu, D <= 128, bit-equal to this kernel;
// ops.som_step.k3_route).  Only the NT 32 instantiation is built, and past
// 256 features its feature passes' twin (fused_step_tc.cuh:
// fused_step_passes_tc), an instantiation of its own so that the one-pass
// kernel keeps its code.
//
// Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_fused_step_kernel (wrapper
// som_fused_train_step).  The wrapper takes it where the JAX trainer takes
// that kernel: a geometry the separable kernels reject (256x256 at B >= 2048
// among the port's cells), a model-axis shard, or factored=False.  The
// separable and batch-chunked TPU kernels are K13/K14
// (som_fused_factored.cu).
//
// What bounds it on H100, the layout, the update, the blend, the winners and
// why two runs are bit-equal: fused_step_tc.cuh, the body K3 shares with K13
// and K14 (the separable steps, som_fused_factored.cu), with the batches
// split once per step by its split_batches_kernel (K11, the update half
// alone, and K5, the update with the blend, run K3's Hopper walk at any D:
// som_accum_sm90.cu, som_update_sm90.cu).  K3 builds each W value
// (fused_step_tc.cuh's ClosedFormW) from
// the closed form: each sample's BMU grid x and row and its alpha (0 where
// bmu < 0 or past B) are staged once per chunk, each row's grid x and row
// once per CTA, so no (row, sample) pair pays an integer division; W is
// som_grid.cuh's weight_of_d2(grid_d2_at(...)), the float operations of
// neighborhood_w in the same order (bit-identical to it; the rows enter as
// exact floats), at the row's global unit unit_offset + row: model-axis
// shards give the unsharded rows bit for bit.  One CTA owns 128 rows (64
// for D > 128).

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "fused_step_tc.cuh"

namespace {

template <int NT, typename CT, bool kPasses>
__global__ void __launch_bounds__(32 * k3_warps(NT), NT <= 8 ? 2 : 1)
som_fused_step_kernel(CT* __restrict__ codes, int noc, int D,
                      const float* __restrict__ xs, const int* __restrict__ bmu,
                      const float* __restrict__ alpha, int B, int Bn, int xdim,
                      int hexa_i,
                      int gaussian_i, float radius, int unit_offset,
                      unsigned long long* __restrict__ keys, float* rows32) {
  ClosedFormW wp = closed_form_w(bmu, alpha, B, xdim, hexa_i, gaussian_i, radius,
                                 unit_offset);
  fused_step_tc<NT, k3_warps(NT), false, kPasses>(codes, noc, D, xs, B, Bn, keys, wp,
                                                  rows32);
}

// the batches split once (into xs), then the step (kPasses: the feature
// passes' instantiation, D > 256)
template <int NT, bool kPasses, typename CT>
int launch_step(CT* codes, int noc, int D, const float* xb, const int* bmu,
                const float* alpha, int B, const float* xn, int Bn, int xdim,
                int hexa, int gaussian, float radius, int unit_offset, float* xs,
                unsigned long long* keys, float* rows32, cudaStream_t stream) {
  using L = FusedSmem<NT, k3_warps(NT)>;
  const size_t smem = L::bytes(ClosedFormW::floats());
  cudaError_t err = cudaFuncSetAttribute(
      som_fused_step_kernel<NT, CT, kPasses>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int rc = split_batches(xb, B, xn, Bn, D, L::DP, xs, stream);
  if (rc) return rc;
  som_fused_step_kernel<NT, CT, kPasses>
      <<<(noc + L::TN - 1) / L::TN, 32 * k3_warps(NT), smem, stream>>>(
          codes, noc, D, xs, bmu, alpha, B, Bn, xdim, hexa, gaussian, radius,
          unit_offset, keys, rows32);
  return (int)cudaGetLastError();
}

// D > 128: the one width this kernel takes, in passes past 256
// (fused_step_sm90.cu takes D <= 128)
template <typename CT>
int launch_any(CT* codes, int noc, int D, const float* xb, const int* bmu,
               const float* alpha, int B, const float* xn, int Bn, int xdim,
               int hexa, int gaussian, float radius, int unit_offset, float* xs,
               unsigned long long* keys, float* rows32, cudaStream_t stream) {
  if (D <= 128) return (int)cudaErrorInvalidValue;
  return D > kPassD
             ? launch_step<32, true>(codes, noc, D, xb, bmu, alpha, B, xn, Bn, xdim, hexa,
                                     gaussian, radius, unit_offset, xs, keys, rows32, stream)
             : launch_step<32, false>(codes, noc, D, xb, bmu, alpha, B, xn, Bn, xdim, hexa,
                                      gaussian, radius, unit_offset, xs, keys, rows32,
                                      stream);
}

}  // namespace

// codes (noc, D) float32, or bf16 with codes_bf16, updated in place; xs
// scratch for the split batches: 2 (Bp + Bnp) W floats (B and Bn rounded up
// to a multiple of 64, W = ops.som_step.split_width(D): 256 n_passes(D) past
// 256); rows32: (noc, D) float32 scratch for a bf16 codebook past D 256 (the
// blended rows the winners read), else unread
extern "C" int somvq_som_fused_step(void* codes, int codes_bf16, int noc, int D,
                                    const float* xb, const int* bmu,
                                    const float* alpha, int B, const float* xn,
                                    int Bn, int xdim, int hexa, int gaussian,
                                    float radius, int unit_offset, float* xs,
                                    unsigned long long* keys, float* val,
                                    int* idx, float* rows32, cudaStream_t stream) {
  if (noc <= 0 || D <= 0 || B <= 0 || Bn <= 0 || xdim <= 0 || unit_offset < 0 || !xs ||
      (codes_bf16 && D > kPassD && !rows32))
    return (int)cudaErrorInvalidValue;
  init_keys<<<(Bn + 255) / 256, 256, 0, stream>>>(keys, Bn);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = codes_bf16
           ? launch_any(static_cast<__nv_bfloat16*>(codes), noc, D, xb, bmu,
                        alpha, B, xn, Bn, xdim, hexa, gaussian, radius,
                        unit_offset, xs, keys, rows32, stream)
           : launch_any(static_cast<float*>(codes), noc, D, xb, bmu, alpha, B,
                        xn, Bn, xdim, hexa, gaussian, radius, unit_offset, xs,
                        keys, rows32, stream);
  if (rc) return rc;
  unpack_keys<<<(Bn + 255) / 256, 256, 0, stream>>>(keys, Bn, val, idx);
  return (int)cudaGetLastError();
}
