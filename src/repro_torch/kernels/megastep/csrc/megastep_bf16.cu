// B3, K lockstep steps, with 'exact' attention, for bfloat16 weights (the
// state float32, bfloat16 or float16; both bfloat16 make a bfloat16 trunk).
// The kernels are megastep_body.cuh, built as four libraries a weight type
// (megastep_bf16{,_flash}{,_rows}.cu, two kernels each) so that the sixteen
// compile in parallel.
#define REPRO_MEGA_FLASH 0
#define REPRO_MEGA_ROWS 0
#define REPRO_MEGA_WEIGHT __nv_bfloat16
#include <cuda_bf16.h>
#include "megastep/csrc/megastep_body.cuh"
