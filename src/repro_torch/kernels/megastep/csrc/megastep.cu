// B3 / B4, the sampler megakernels, for float32 weights (the state float32,
// bfloat16 or float16).  The kernels are megastep_body.cuh;
// megastep_bf16.cu and megastep_f16.cu build the same body for bfloat16
// and float16 weights as libraries of their own, so the three compile in
// parallel.
#define REPRO_MEGA_WEIGHT float
#include "megastep/csrc/megastep_body.cuh"
