// B3 / B4, the sampler megakernels, for float16 weights (the state
// float32, bfloat16 or float16; both float16 make a float16 trunk).  The
// kernels are megastep_body.cuh, built here as a library of its own beside
// megastep.cu (float32 weights) and megastep_bf16.cu (bfloat16 weights),
// so the three compile in parallel.
#define REPRO_MEGA_WEIGHT __half
#include <cuda_fp16.h>
#include "megastep/csrc/megastep_body.cuh"
