// B4, the scheduler tick, with 'flash' attention: megastep.cu's twin.
#define REPRO_MEGA_FLASH 1
#define REPRO_MEGA_ROWS 1
#define REPRO_MEGA_WEIGHT float
#include "megastep/csrc/megastep_body.cuh"
