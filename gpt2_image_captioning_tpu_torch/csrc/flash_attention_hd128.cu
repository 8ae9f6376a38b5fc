// flash_attention.cuh's kernel at head dim 128, in a translation unit of its
// own so that nvcc builds it beside the others.
#include "flash_attention.cuh"

GIC_FLASH_INSTANTIATE(float, 128)
GIC_FLASH_INSTANTIATE(__nv_bfloat16, 128)
