// B3 / B4, the sampler megakernels, for float32 weights (the state float32
// or bfloat16).  The kernels are megastep_body.cuh; megastep_bf16.cu
// builds the same body for bfloat16 weights as a second library, so the
// two compile in parallel.
#define REPRO_MEGA_WEIGHT float
#include "megastep/csrc/megastep_body.cuh"
