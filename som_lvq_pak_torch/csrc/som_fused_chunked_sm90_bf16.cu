// K14's main form on Hopper for a bf16 codebook (SOMTrainer(bf16=True)):
// separable_sm90.cuh's walk, instantiated here so that nvcc builds it beside
// the float32 codebook's (som_fused_chunked_sm90_f32.cu).

#include "separable_sm90.cuh"

int somvq::k14_sm90_bf16codes(const StepArgs& a, int batch_bf16, int cluster) {
  return k14_sm90<__nv_bfloat16>(a, batch_bf16, cluster);
}
