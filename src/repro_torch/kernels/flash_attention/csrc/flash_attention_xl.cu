// B5, float32, head dims past 256 (the output in slices of 256 columns, the
// scores streamed over the depth).  The kernel and its launcher are
// flash_xl.cuh.
#include "flash_attention/csrc/flash_xl.cuh"

REPRO_FLASH_XL_ENTRY(float)
