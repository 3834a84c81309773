// K14's main form for a float32 codebook: som_fused_chunked_tc.cuh,
// instantiated here so that nvcc builds it beside the bf16 codebook's
// (som_fused_chunked_tc_bf16.cu) and K13 (som_fused_factored.cu).

#include "som_fused_chunked_tc.cuh"

int somvq::k14_tc_f32codes(const StepArgs& a, int wxa_bf16, int batch_bf16) {
  return run_k14_tc<float>(a, wxa_bf16, batch_bf16);
}
