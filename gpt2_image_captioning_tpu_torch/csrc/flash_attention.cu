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
             int q_offset, int warps, cudaStream_t stream) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.out = static_cast<T*>(out);
  a.key_mask = key_mask;
  a.qs = {st[0], st[1], st[2]};
  a.ks = {st[3], st[4], st[5]};
  a.vs = {st[6], st[7], st[8]};
  a.os = {st[9], st[10], st[11]};
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.causal = causal;
  a.q_offset = q_offset;
  a.scale_log2 = (float)(1.4426950408889634 / sqrt((double)scale_hd));
  switch (hd) {
    case 64: return launch<T, 64>(a, B, warps, stream);
    case 96: return launch<T, 96>(a, B, warps, stream);
    case 128: return launch<T, 128>(a, B, warps, stream);
    case 160: return launch<T, 160>(a, B, warps, stream);
    case 208: return launch<T, 208>(a, B, warps, stream);
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
// kept columns).  warps (1-8: 16 query rows each) is the wrapper's split of
// Tq (ops/attention.py::flash_plan); the ring and the shared memory follow
// from Tk and hd here.  A row with no valid key writes the mean of v (zeros
// if Tk == 0).  Returns cudaGetLastError() of the launch.
extern "C" int gic_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                   void* out, const int* key_mask, int B, int H, int Tq, int Tk,
                                   int hd, int scale_hd, const long long* strides, int causal,
                                   int q_offset, int warps, void* stream) {
  using namespace gic;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk < 0 || scale_hd < 1 || scale_hd > hd ||
      (hd != 64 && hd != 96 && hd != 128 && hd != 160 && hd != 208))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return flash::dispatch<__nv_bfloat16>(q, k, v, out, key_mask, B, H, Tq, Tk, hd, scale_hd,
                                          strides, causal, q_offset, warps, s);
  if (dtype == kF32)
    return flash::dispatch<float>(q, k, v, out, key_mask, B, H, Tq, Tk, hd, scale_hd, strides,
                                  causal, q_offset, warps, s);
  return (int)cudaErrorInvalidValue;
}
