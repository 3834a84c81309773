// K14's stagger with float32 winners for a bf16 codebook (SOMTrainer(bf16=
// True)): the walk of som_fused_chunked_tc.cuh, instantiated here so that nvcc
// builds it beside the other codebook type's and the int8 winners'
// (som_fused_chunked_walk_*.cu).

#include "som_fused_chunked_tc.cuh"

int somvq::k14_walk_bf16codes(const StepArgs& a, int wxa_bf16, int batch_bf16) {
  return run_k14_walk<__nv_bfloat16, false>(a, wxa_bf16, batch_bf16);
}
