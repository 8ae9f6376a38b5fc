// flash_attention.cuh's float32 kernel at head dim 208 (GPT-2 XL's mapper heads
// of 200, zero-padded by ops/attention.py), in a translation unit of its own
// so that nvcc builds it beside the others.
#include "flash_attention.cuh"

GIC_FLASH_INSTANTIATE(float, 208)
