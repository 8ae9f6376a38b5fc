// Shared pieces of the four vocabulary kernels (logits_argmax.cu, logits.cu,
// logits_topk.cu, logits_sample.cu): the LN_f pre-pass by operand type, the
// dispatch on the element and weight types, and the (value, index) order.
//
// Each of them ends the decode step of gpt2_image_captioning_tpu/ops/
// decode_step.py::_step_kernel: LN_f of the float32 residual stream, then
// logits = LN_f(x) @ wte^T over the (V, D) tied embedding, walked in the
// 64 x 32 tiles of common.cuh.  They differ only in what each tile's logits
// become: a (max, argmax) pair, a float32 store, a partial top-k with a
// partial logsumexp, or a draw.  With an int8 wte and its (V,) float32
// scales (W8A8, :555-563) the pre-pass is rowquant.cu's LN variant — LN_f,
// the cast to the compute dtype, the per-row int8 quantization — and the
// walk is the int8 tile, whose logits are acc * sx * sw.
#pragma once

#include "common.cuh"

#include <climits>
#include <math_constants.h>

namespace gic {

static_assert(BN == 32, "the vocabulary kernels give one warp lane to each tile column");

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
// the tile, each of the 1,571 column blocks would recompute its rows'
// statistics), or, for an int8 wte (E = int8_t), int8 rows in xf and their
// scales in sx.
template <typename T, typename E>
void launch_prepass(cudaStream_t s, const float* x, const float* lns, const float* lnb, float eps,
                    int M, int K, void* xf, float* sx) {
  if constexpr (std::is_same<E, int8_t>::value) {
    launch_rowquant<T, true>(s, x, K, lns, lnb, eps, M, K, static_cast<int8_t*>(xf), K, sx);
  } else {
    ln_rows_kernel<T><<<(M + kLnRowsPerBlock - 1) / kLnRowsPerBlock, 32 * kLnRowsPerBlock, 0,
                        s>>>(x, lns, lnb, eps, M, K, static_cast<T*>(xf));
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
