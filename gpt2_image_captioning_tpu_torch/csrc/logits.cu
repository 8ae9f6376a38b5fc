// Final LayerNorm + tied-embedding logits of the decode step, stored in
// float32: the sampled-decode tail's input.
//
// Replaces: the emit_logits mode of gpt2_image_captioning_tpu/ops/decode_step.py::
// _step_kernel (:617-640): LN_f of the float32 residual stream, then
// logits = LN_f(x) @ wte^T tile by tile, each tile written to a (B, V)
// float32 tensor (the TPU kernel streams (NT_v, B, VW) tiles and the wrapper
// slices them to (B, V); here the store is (B, V) directly).
//
// Bound on the H100: the bytes.  At B = 128 in bf16, wte is 77.2 MB read and
// the logits 25.7 MB written, ~31 us at 3.35 TB/s; the products are 9.9 GFLOP,
// ~10 us on the tensor cores.
//
// Design: logits_argmax.cu with its (max, index) reduction replaced by the
// store.  Pass 0 normalises each row once (vocab.cuh); pass 1 is the
// common.cuh tile over wte in its natural (V, D) layout, and each block
// writes its 64 x 32 float tile, one warp lane per column, so a warp stores
// one row's 32 consecutive logits (128 bytes).  Columns >= V are not stored.
// With an int8 wte (W8A8) pass 0 quantizes the rows too and pass 1 runs the
// int8 tile: 38.6 MB of wte read, the same 25.7 MB of logits written.
#include "vocab.cuh"

namespace gic {

template <typename T>
__global__ void __launch_bounds__(THREADS)
logits_store_kernel(const T* xf, const T* wte, int M, int K, int V, float* logits,
                    const float* sx, const float* sw) {
  __shared__ TileSmem<T> sm;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  tile_product<T, false>(sm, xf, nullptr, nullptr, nullptr, wte, M, K, V, m0, n0, sx, sw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = n0 + lane;
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int m = m0 + r;
    if (m >= M) break;  // warp-uniform; rows only grow
    if (n < V) logits[(size_t)m * V + n] = sm.cs[r][lane];
  }
}

template <typename T, typename E>
static void launch_passes(cudaStream_t s, const float* x, const float* lns, const float* lnb,
                          float eps, const void* wte, const float* wte_scale, int M, int K, int V,
                          void* xf, float* sx, float* logits) {
  launch_prepass<T, E>(s, x, lns, lnb, eps, M, K, xf, sx);
  const dim3 grid((V + BN - 1) / BN, (M + BM - 1) / BM);
  logits_store_kernel<E><<<grid, THREADS, 0, s>>>(static_cast<const E*>(xf),
                                                  static_cast<const E*>(wte), M, K, V, logits, sx,
                                                  wte_scale);
}

}  // namespace gic

// x32: (M, K) float32 residual stream; wte: (V, K) element type, or int8
// when wte_scale ((V,) float32) is given; xf: (M, K) element-type scratch
// for the normalised rows (int8 rows with an int8 wte, their scales in sx,
// (M,) float32 scratch); logits: (M, V) float32.  K must be a multiple of
// the 16-byte vector width.  Returns cudaGetLastError() after the two
// launches.
extern "C" int gic_logits(int dtype, const void* x32, const void* ln_s, const void* ln_b,
                          float eps, const void* wte, const void* wte_scale, int M, int K, int V,
                          void* xf, void* sx, void* logits, void* stream) {
  using namespace gic;
  if (M <= 0 || K <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(x32);
  const float* lns = static_cast<const float*>(ln_s);
  const float* lnb = static_cast<const float*>(ln_b);
  float* out = static_cast<float*>(logits);
  const float* ws = static_cast<const float*>(wte_scale);
  float* sq = static_cast<float*>(sx);
  if (!with_types(dtype, ws != nullptr, [&](auto t) {
        using Ty = decltype(t);
        launch_passes<typename Ty::T, typename Ty::E>(s, x, lns, lnb, eps, wte, ws, M, K, V, xf,
                                                      sq, out);
      }))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
