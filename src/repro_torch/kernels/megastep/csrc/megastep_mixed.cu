// B3, K lockstep steps, with 'exact' attention, for trees whose leaves are of
// more than one of float32, bfloat16 and float16 (the state any of the three;
// every leaf read at its own type, every value rounded at the type JAX's
// promotion gives it, at the sites the wrapper computes).  The kernels are
// megastep_body.cuh, built as four libraries a weight type
// (megastep_mixed{,_flash}{,_rows}.cu, two kernels each) so that the sixteen
// compile in parallel.
#define REPRO_MEGA_MIXED 1
#define REPRO_MEGA_FLASH 0
#define REPRO_MEGA_ROWS 0
#define REPRO_MEGA_WEIGHT float
#include "megastep/csrc/megastep_body.cuh"
