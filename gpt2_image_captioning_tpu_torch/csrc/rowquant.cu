// Per-row symmetric int8 quantization of the activations: the A side of the
// W8A8 decode step.
//
// Replaces: rowquant of gpt2_image_captioning_tpu/ops/decode_step.py::
// _step_kernel (:234-240), with the LayerNorm and the cast to the compute
// dtype that precede it there (:529-530, :546, :553), and the quantizing
// append of the int8 KV cache (:311-323).  Per row:
//   v  = x, or LN(x) rounded to the compute dtype T
//   sx = max(max|v| * float32(1/127), 1e-12)
//   q  = rint(v / sx)        (IEEE division, round half to even)
// exactly as the TPU kernel and ops/quant.py::rowquant_plain compute it.
// Four uses in a layer of the int8 step — LN1 -> qkv and LN2 -> fc (where
// it replaces the LN statistics pre-pass), the attention output -> proj,
// gelu(h) -> cproj — one before the vocabulary (LN_f), and the new K and V
// rows of the int8 cache, each quantized over its whole D.
//
// Bound on the H100: the bytes, one read of the row (4 bytes an element with
// the LN, 2 in bf16) and one int8 write: ~0.5 MB at B 128, D 768 with LN,
// ~0.15 us; at these sizes the launch itself costs more.
//
// Design: one warp per row, as ln_rows_kernel (vocab.cuh): the two-pass LN
// statistics, a pass for max|v|, a pass that quantizes; v is recomputed
// rather than kept (K up to 3072 would not fit a lane's registers).
#include "common.cuh"

namespace gic {

constexpr int kRowsPerBlock = 4;  // one warp per row

template <typename T, bool LN>
__global__ void rowquant_kernel(const void* x, int ld, const float* ln_s, const float* ln_b,
                                float eps, int M, int K, int8_t* q, int ldq, float* sx) {
  const int m = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (m >= M) return;
  const int lane = threadIdx.x % 32;
  using XT = typename std::conditional<LN, float, T>::type;
  const XT* row = static_cast<const XT*>(x) + (size_t)m * ld;
  float mean = 0.f, rstd = 0.f;
  if constexpr (LN) row_mean_rstd(row, K, eps, mean, rstd);
  auto value = [&](int k) -> float {
    if constexpr (LN) return to_f32(ln_value<T>(row[k], mean, rstd, ln_s[k], ln_b[k]));
    else return to_f32(row[k]);
  };
  float mx = 0.f;
  for (int k = lane; k < K; k += 32) mx = fmaxf(mx, fabsf(value(k)));
  const float s = fmaxf(warp_max(mx) * kInv127, kMinScale);
  int8_t* out = q + (size_t)m * ldq;
  for (int k = lane; k < K; k += 32) out[k] = (int8_t)rintf(__fdiv_rn(value(k), s));
  if (lane == 0) sx[m] = s;
}

template <typename T, bool LN>
void launch_rowquant(cudaStream_t s, const void* x, int ld, const float* ln_s, const float* ln_b,
                     float eps, int M, int K, int8_t* q, int ldq, float* sx) {
  rowquant_kernel<T, LN><<<(M + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, s>>>(
      x, ld, ln_s, ln_b, eps, M, K, q, ldq, sx);
}

template void launch_rowquant<float, false>(cudaStream_t, const void*, int, const float*,
                                            const float*, float, int, int, int8_t*, int, float*);
template void launch_rowquant<float, true>(cudaStream_t, const void*, int, const float*,
                                           const float*, float, int, int, int8_t*, int, float*);
template void launch_rowquant<__nv_bfloat16, false>(cudaStream_t, const void*, int, const float*,
                                                    const float*, float, int, int, int8_t*, int,
                                                    float*);
template void launch_rowquant<__nv_bfloat16, true>(cudaStream_t, const void*, int, const float*,
                                                   const float*, float, int, int, int8_t*, int,
                                                   float*);

}  // namespace gic

// x: (M, K) contiguous, float32 when ln != 0 (the residual stream, with
// ln_s/ln_b (K,) float32), else the element type; q: (M, K) int8; sx: (M,)
// float32.  One launch; returns cudaGetLastError().
extern "C" int gic_rowquant(int dtype, int ln, const void* x, const void* ln_s, const void* ln_b,
                            float eps, void* q, void* sx, int M, int K, void* stream) {
  using namespace gic;
  if (M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lns = static_cast<const float*>(ln_s);
  const float* lnb = static_cast<const float*>(ln_b);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(sx);
  if (dtype == kBF16) {
    if (ln) launch_rowquant<__nv_bfloat16, true>(s, x, K, lns, lnb, eps, M, K, qp, K, sp);
    else launch_rowquant<__nv_bfloat16, false>(s, x, K, lns, lnb, eps, M, K, qp, K, sp);
  } else if (dtype == kF32) {
    if (ln) launch_rowquant<float, true>(s, x, K, lns, lnb, eps, M, K, qp, K, sp);
    else launch_rowquant<float, false>(s, x, K, lns, lnb, eps, M, K, qp, K, sp);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
