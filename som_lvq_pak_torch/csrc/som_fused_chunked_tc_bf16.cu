// K14's main form for a bf16 codebook (SOMTrainer(bf16=True)):
// som_fused_chunked_tc.cuh, instantiated here so that nvcc builds it beside
// the float32 codebook's (som_fused_chunked_tc_f32.cu) and K13
// (som_fused_factored.cu).

#include "som_fused_chunked_tc.cuh"

int somvq::k14_tc_bf16codes(const StepArgs& a, int wxa_bf16, int batch_bf16) {
  return run_k14_tc<__nv_bfloat16>(a, wxa_bf16, batch_bf16);
}
