// K13 on Hopper: the separable fused SOM step (W = Wx(column, row parity) *
// Wy(row) from the step's tables) for D <= 128 (wider D:
// som_fused_factored.cu's mma.sync kernel, the route ops.som_step.k13_route
// names).  Replaces som_lvq_pak_tpu/ops/pallas_som.py:_som_fused_factored_kernel
// (:743), as som_fused_factored.cu does for wider D.
//
// K13 is separable_sm90.cuh's walk without the split and without K14's
// roundings (som_fused_factored_sm90_kernel: P 2, kSplit false); K14's main
// form is the same walk with them (som_fused_chunked_sm90_{f32,bf16}.cu).
// Its codebook, winners and values are the mma.sync K13's bit for bit
// (tools/fused_step_ab.py's digests), and two runs are bit-equal.

#include "separable_sm90.cuh"

// K13 for D <= 128 on K3's Hopper walk: the table launch (which sets the
// winner keys), the prologue, the walk.  Arguments as som_fused_factored.cu's
// somvq_som_fused_factored's, with xs the walk's prologue scratch, 16-byte
// aligned: 2 DP (Bp + Bnp) floats (ops.som_step.sm90_scratch without K3's
// table; DP = 32, 64 or 128, the smallest that covers D), and the tables'
// rows Bp entries long (aw Bp, ytab ceil(noc / xdim) Bp, pat n_pat Bp floats;
// Bp: B rounded up to 64)
extern "C" int somvq_som_fused_factored_sm90(
    void* codes, int codes_bf16, int noc, int D, const float* xb, const int* bmu,
    const float* alpha, int B, const float* xn, int Bn, int xdim, int hexa, int gaussian,
    float radius, float* xs, void* pat, float* ytab, float* aw, unsigned long long* keys,
    float* val, int* idx, cudaStream_t stream) {
  const StepArgs a{codes,  noc,     D,    xb, bmu,  alpha, B,
                   xn,     nullptr, nullptr, Bn, xdim, hexa,  gaussian,
                   radius, 0,       128,  xs, pat,  ytab,  aw,
                   keys,   nullptr, stream};
  return separable_step(a, 0, val, idx, [&](const StepArgs& s) {
    return codes_bf16 ? separable_sm90<2, false, __nv_bfloat16>(s, 1)
                      : separable_sm90<2, false, float>(s, 1);
  });
}
