// B3 / B4, the sampler megakernels, for bfloat16 weights (the state
// float32, bfloat16 or float16; both bfloat16 make a bfloat16 trunk).  The
// kernels are megastep_body.cuh, built here as a library of its own beside
// megastep.cu (float32 weights) and megastep_f16.cu (float16 weights).
#define REPRO_MEGA_WEIGHT __nv_bfloat16
#include <cuda_bf16.h>
#include "megastep/csrc/megastep_body.cuh"
