// Final LayerNorm + tied-embedding logits + greedy argmax of the decode step.
//
// Replaces: the greedy vocab walk of gpt2_image_captioning_tpu/ops/decode_step.py::
// _step_kernel (:552-568 and :805-821): LN_f of the float32 residual stream,
// logits = LN_f(x) @ wte^T tile by tile, and a running (max, argmax) per row in
// which a larger logit wins and, on equal logits, the smaller token id wins
// (jnp.argmax / torch.argmax order).  The (B, V) logits never reach device
// memory.
//
// Bound on the H100: the bytes of wte (50257 x 768 bf16 = 77 MB, ~23 us at
// 3.35 TB/s); at B = 128 it is the same ~128 flops/byte as fused_linear.cu.
//
// Design: three launches.  Pass 0 normalises the float32 stream once, one
// warp per row, into (B, D) rows of the compute dtype (the LN_f output the
// step kernel feeds its vocab walk).  Pass 1 is the fused_linear tile
// (common.cuh) over wte in its natural (V, D) layout; instead of storing its
// 64 x 32 logits tile, each block reduces every row of it to (max, first
// column of the max) — one warp lane per column — and writes that pair to a
// (B, ceil(V/32)) scratch.  Columns >= V are masked to -inf.  Pass 2 reduces
// each row's pairs with one warp, under the same order.  The blocks of pass 1
// run in no order, so the tie rule is applied to (value, index) pairs and
// never depends on which block finished first.  Normalising once matters:
// with the LN inside the tile, each of the 3,142 blocks recomputed its rows'
// statistics, ~1.8 GB of L2 reads per call against 77 MB of wte.  With an
// int8 wte (W8A8) pass 0 quantizes the rows too and pass 1 runs the int8
// tile: 38.6 MB of wte, ~12 us.
#include "vocab.cuh"

namespace gic {

template <typename T>
__global__ void __launch_bounds__(THREADS)
logits_tile_kernel(const T* xf, const T* wte, int M, int K, int V, float* part_val,
                   int* part_idx, const float* sx, const float* sw) {
  __shared__ TileSmem<T> sm;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nblk = gridDim.x;
  tile_product<T, false>(sm, xf, nullptr, nullptr, nullptr, wte, M, K, V, m0, n0, sx, sw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int m = m0 + r;
    if (m >= M) break;  // warp-uniform; rows only grow
    const int n = n0 + lane;
    float v = n < V ? sm.cs[r][lane] : -CUDART_INF_F;
    int i = n;
    warp_argmax(v, i);
    if (lane == 0) {
      part_val[(size_t)m * nblk + blockIdx.x] = v;
      part_idx[(size_t)m * nblk + blockIdx.x] = i;
    }
  }
}

__global__ void argmax_reduce_kernel(const float* part_val, const int* part_idx, int M, int nblk,
                                     int* tok) {
  const int m = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;
  float v = -CUDART_INF_F;
  int i = INT_MAX;
  for (int j = lane; j < nblk; j += 32) {
    const float pv = part_val[(size_t)m * nblk + j];
    const int pi = part_idx[(size_t)m * nblk + j];
    if (better(pv, pi, v, i)) {
      v = pv;
      i = pi;
    }
  }
  warp_argmax(v, i);
  if (lane == 0) tok[m] = i;
}

template <typename T, typename E>
static void launch_passes(cudaStream_t s, const float* x, const float* lns, const float* lnb,
                          float eps, const void* wte, const float* wte_scale, int M, int K, int V,
                          void* xf, float* sx, float* pv, int* pi) {
  launch_prepass<T, E>(s, x, lns, lnb, eps, M, K, xf, sx);
  const dim3 grid((V + BN - 1) / BN, (M + BM - 1) / BM);
  logits_tile_kernel<E><<<grid, THREADS, 0, s>>>(static_cast<const E*>(xf),
                                                 static_cast<const E*>(wte), M, K, V, pv, pi, sx,
                                                 wte_scale);
}

}  // namespace gic

// x32: (M, K) float32 residual stream; wte: (V, K) element type, or int8
// when wte_scale ((V,) float32) is given; xf: (M, K) element-type scratch
// for the normalised rows (their int8 quantization with an int8 wte, the
// row scales then in sx, (M,) float32 scratch); part_val/part_idx:
// (M, ceil(V/32)) scratch; tok: (M,) int32.  K must be a multiple of the
// 16-byte vector width.  Returns cudaGetLastError() after the three launches.
extern "C" int gic_logits_argmax(int dtype, const void* x32, const void* ln_s, const void* ln_b,
                                 float eps, const void* wte, const void* wte_scale, int M, int K,
                                 int V, void* xf, void* sx, void* part_val, void* part_idx,
                                 void* tok, void* stream) {
  using namespace gic;
  if (M <= 0 || K <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  const int nblk = (V + BN - 1) / BN;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(x32);
  const float* lns = static_cast<const float*>(ln_s);
  const float* lnb = static_cast<const float*>(ln_b);
  float* pv = static_cast<float*>(part_val);
  int* pi = static_cast<int*>(part_idx);
  const float* ws = static_cast<const float*>(wte_scale);
  float* sq = static_cast<float*>(sx);
  if (!with_types(dtype, ws != nullptr, [&](auto t) {
        using Ty = decltype(t);
        launch_passes<typename Ty::T, typename Ty::E>(s, x, lns, lnb, eps, wte, ws, M, K, V, xf,
                                                      sq, pv, pi);
      }))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows_per_block = 4;  // one warp per row
  argmax_reduce_kernel<<<(M + rows_per_block - 1) / rows_per_block, 32 * rows_per_block, 0, s>>>(
      pv, pi, M, nblk, static_cast<int*>(tok));
  return (int)cudaGetLastError();
}
