// B3, K lockstep steps, with 'flash' attention: megastep_mixed.cu's twin.
#define REPRO_MEGA_MIXED 1
#define REPRO_MEGA_FLASH 1
#define REPRO_MEGA_ROWS 0
#define REPRO_MEGA_WEIGHT float
#include "megastep/csrc/megastep_body.cuh"
