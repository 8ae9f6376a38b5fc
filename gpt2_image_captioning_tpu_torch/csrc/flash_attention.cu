// Flash-attention forward: the dispatch on the head dim and the C entry.
// The kernel, its design and its bound are in flash_attention.cuh; hd 64 and
// 96 are instantiated here, 128, 160 and 208 in files of their own.
//
// Replaces: gpt2_image_captioning_tpu/ops/attention.py::_flash_kernel (:40).
#include "flash_attention.cuh"

GIC_FLASH_INSTANTIATE(float, 64)
GIC_FLASH_INSTANTIATE(__nv_bfloat16, 64)
GIC_FLASH_INSTANTIATE(float, 96)
GIC_FLASH_INSTANTIATE(__nv_bfloat16, 96)
GIC_FLASH_EXTERN(float, 128)
GIC_FLASH_EXTERN(__nv_bfloat16, 128)
GIC_FLASH_EXTERN(float, 160)
GIC_FLASH_EXTERN(__nv_bfloat16, 160)
GIC_FLASH_EXTERN(float, 208)
GIC_FLASH_EXTERN(__nv_bfloat16, 208)

namespace gic {
namespace flash {

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, const int* key_mask, int B,
             int H, int Tq, int Tk, int hd, int scale_hd, const long long* st, int causal,
             int q_offset, int q_tiles, cudaStream_t stream) {
  Args<T> a;
  a.out = static_cast<T*>(out);
  a.v = static_cast<const T*>(v);
  a.key_mask = key_mask;
  a.vs = {st[6], st[7], st[8]};
  a.os = {st[9], st[10], st[11]};
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.hd = hd;
  a.causal = causal;
  a.q_offset = q_offset;
  a.q_tiles = q_tiles;
  a.items = B * H * q_tiles;
  a.scale_log2 = (float)(1.4426950408889634 / sqrt((double)scale_hd));
  switch (hd) {
    case 64: return launch<T, 64>(q, k, a, B, st, stream);
    case 96: return launch<T, 96>(q, k, a, B, st, stream);
    case 128: return launch<T, 128>(q, k, a, B, st, stream);
    case 160: return launch<T, 160>(q, k, a, B, st, stream);
    case 208: return launch<T, 208>(q, k, a, B, st, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int layout_of(int hd, int* out) {
  switch (hd) {
    case 64: return layout<T, 64>(out);
    case 96: return layout<T, 96>(out);
    case 128: return layout<T, 128>(out);
    case 160: return layout<T, 160>(out);
    case 208: return layout<T, 208>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace flash
}  // namespace gic

// q, k, v: (B, H, Tq or Tk, hd) in the element type, any strides with a unit
// stride on hd, 16-byte aligned rows; out: (B, H, Tq, hd), likewise.
// strides: 12 host int64s, (batch, head, position) for q, k, v and out, in
// elements.  key_mask: (B, Tk) int32 contiguous, or null.  hd, the head dim
// of the tensors, must be 64, 96, 128, 160 or 208; scale_hd (1 <= scale_hd
// <= hd) is the head dim whose 1/sqrt scales the scores: hd itself, or the
// true head dim of rows the wrapper zero-padded to hd (200 -> 208, GPT-2
// XL's mapper: the zero columns add nothing to q.k or to the output's
// kept columns).  q_tiles, the wrapper's split of Tq
// (ops/attention.py::flash_plan), must be ceil(Tq / 64): the kernel's work
// items are (batch row, head, 64 query rows); its key tile, ring and shared
// memory follow from the element type and hd (flash_attention.cuh::Cfg).  A
// row with no valid key writes the mean of v (zeros if Tk == 0).  Returns
// cudaGetLastError() of the launch, or the error that refused it.
extern "C" int gic_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                   void* out, const int* key_mask, int B, int H, int Tq, int Tk,
                                   int hd, int scale_hd, const long long* strides, int causal,
                                   int q_offset, int q_tiles, void* stream) {
  using namespace gic;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk < 0 || scale_hd < 1 || scale_hd > hd ||
      q_tiles != (Tq + flash::BM - 1) / flash::BM ||
      (long long)B * H * q_tiles > 0x7fffffffLL ||
      (hd != 64 && hd != 96 && hd != 128 && hd != 160 && hd != 208))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return flash::dispatch<__nv_bfloat16>(q, k, v, out, key_mask, B, H, Tq, Tk, hd, scale_hd,
                                          strides, causal, q_offset, q_tiles, s);
  if (dtype == kF32)
    return flash::dispatch<float>(q, k, v, out, key_mask, B, H, Tq, Tk, hd, scale_hd, strides,
                                  causal, q_offset, q_tiles, s);
  return (int)cudaErrorInvalidValue;
}

// The layout and the build of the (dtype, hd) instantiation: out[0..7] =
// shared bytes a block, keys a tile, ring stages, Q buffers, threads a
// block, blocks an SM (or minus the error that refuses the launch), numRegs
// and local (spill) bytes a thread.  Returns 0 or a cudaError_t.
extern "C" int gic_flash_layout(int dtype, int hd, int* out) {
  using namespace gic;
  if (dtype == kBF16) return flash::layout_of<__nv_bfloat16>(hd, out);
  if (dtype == kF32) return flash::layout_of<float>(hd, out);
  return (int)cudaErrorInvalidValue;
}
