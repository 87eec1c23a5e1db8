// B3, K lockstep steps, with 'flash' attention: megastep_f16.cu's twin.
#define REPRO_MEGA_FLASH 1
#define REPRO_MEGA_ROWS 0
#define REPRO_MEGA_WEIGHT __half
#include <cuda_fp16.h>
#include "megastep/csrc/megastep_body.cuh"
