// K14's int8_win (with or without stagger) for a float32 codebook: the walk
// of som_fused_chunked_tc.cuh with its int8 winners, instantiated here so that
// nvcc builds it beside the other codebook type's and the float32 winners'
// (som_fused_chunked_walk_*.cu).

#include "som_fused_chunked_tc.cuh"

int somvq::k14_walk_int8_f32codes(const StepArgs& a, int wxa_bf16, int batch_bf16) {
  return run_k14_walk<float, true>(a, wxa_bf16, batch_bf16);
}
