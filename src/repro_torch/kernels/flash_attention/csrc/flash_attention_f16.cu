// B5, float16, head widths 32, 64, 96, 128 (head dims 1 to 128).  The
// kernel and its launcher are flash_launch.cuh / flash_mma.cuh.
#include "flash_attention/csrc/flash_launch.cuh"

REPRO_FLASH_ENTRY(__half, 32, 64, 96, 128)
