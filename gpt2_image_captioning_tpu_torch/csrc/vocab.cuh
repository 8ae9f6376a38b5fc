// Shared pieces of the four vocabulary kernels (logits_argmax.cu, logits.cu,
// logits_topk.cu, logits_sample.cu): the LN_f pre-pass by operand type, the
// dispatch on the element and weight types, and the (value, index) order.
//
// Each of them ends the decode step of gpt2_image_captioning_tpu/ops/
// decode_step.py::_step_kernel (:112; greedy :552-568, emit_logits
// :617-640, topk :569-616, sample :641): LN_f of the float32 residual
// stream, then logits = LN_f(x) @ wte^T over the (V, D) tied embedding, on
// the walk of vocab_walk.cuh (TMA ring, wgmma; float32 on wgmma TF32) in
// every operand type.  They differ only in what each tile's logits become:
// a (max, argmax) pair, a float32 store, a partial top-k with a partial
// logsumexp, or a draw.  Bound on the H100: wte's bytes (bf16 77.2 MB, 23 us at 3.35
// TB/s; int8 38.6 MB) at the greedy and sampled paths' B 128, the products
// at B 512 and in float32 (the kernels' headers).  With an int8 wte and its
// (V,) float32 scales (W8A8, :555-563) the pre-pass is rowquant.cu's LN
// variant — LN_f, the cast to the compute dtype, the per-row int8
// quantization — and the products are int8, whose logits are acc * sx * sw;
// the float32 walk's pre-pass writes each row as its TF32 hi and lo parts.
#pragma once

#include "common.cuh"

#include <climits>
#include <math_constants.h>

namespace gic {

// (v, i) beats (bv, bi): larger value, or equal value and smaller index
// (jnp.argmax / torch.argmax / lax.top_k order)
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The best (value, index) pair of the warp, in every lane.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Internal linkage, as ln_rows_kernel (common.cuh).
namespace {

// Pass 0 by operand type: T rows of LN_f for a float wte
// (common.cuh::ln_rows_kernel; normalising once matters: with the LN inside
// the product, each column block would recompute its rows' statistics), or,
// for an int8 wte (E = int8_t), int8 rows in xf and their scales in sx.
// With xl (float rows), xf and xl take the rows' TF32 hi and lo parts.
template <typename T, typename E>
void launch_prepass(cudaStream_t s, const float* x, const float* lns, const float* lnb, float eps,
                    int M, int K, void* xf, float* sx, float* xl = nullptr) {
  if constexpr (std::is_same<E, int8_t>::value) {
    launch_rowquant<T, true>(s, x, K, lns, lnb, eps, M, K, static_cast<int8_t*>(xf), K, sx);
  } else {
    launch_ln_rows(s, x, lns, lnb, eps, M, K, static_cast<T*>(xf), xl);
  }
}

}  // namespace

template <typename TT, typename EE>
struct Types {
  using T = TT;  // the compute dtype (LN_f's output)
  using E = EE;  // the operand type of the walk: T, or int8_t
};

// Calls f(Types<T, E>{}) for the element type code and the weights' kind;
// false for an unknown code.
template <typename F>
bool with_types(int dtype, bool int8_weights, F&& f) {
  if (dtype == kBF16) {
    if (int8_weights) f(Types<__nv_bfloat16, int8_t>{});
    else f(Types<__nv_bfloat16, __nv_bfloat16>{});
  } else if (dtype == kF32) {
    if (int8_weights) f(Types<float, int8_t>{});
    else f(Types<float, float>{});
  } else {
    return false;
  }
  return true;
}

}  // namespace gic
