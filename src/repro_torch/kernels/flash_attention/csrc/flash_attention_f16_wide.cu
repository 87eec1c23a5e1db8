// B5, float16, head widths 160, 192, 224, 256 (head dims 129 to 256; q in
// shared memory).  The kernel and its launcher are flash_launch.cuh /
// flash_mma.cuh.
#include "flash_attention/csrc/flash_launch.cuh"

REPRO_FLASH_ENTRY(__half, 160, 192, 224, 256)
