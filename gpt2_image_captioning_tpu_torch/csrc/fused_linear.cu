// Fused linear layer of the greedy decode step:
//   y = epilogue(prologue(x) @ W + b)
//
// Replaces: the weight stream of gpt2_image_captioning_tpu/ops/decode_step.py::
// _step_kernel — stream_matmul (:242), _ln (:70) and _gelu_new (:76) as the
// step applies them (:529-550).  One call serves each of the four projections
// of a GPT-2 layer:
//   QKV       768 -> 2304  prologue LN1, epilogue cast to the compute dtype
//   attn proj 768 ->  768  no prologue,  epilogue residual add (float32 stream)
//   MLP fc    768 -> 3072  prologue LN2, epilogue gelu_new then cast
//   MLP proj 3072 ->  768  no prologue,  epilogue residual add
//
// Bound on the H100: weight bytes.  At batch 128 a call does 2*128 = 256
// flops per weight element, about 128 flops per byte in bf16, below the
// card's ~295 flops/byte ridge, so the weights' trip from device memory sets
// the floor (QKV: 3.5 MB, ~1 us at 3.35 TB/s).
//
// Design: a block computes a 64-row x 32-column tile (common.cuh) and walks K
// in 64-deep shared-memory stages; bf16 runs on the tensor cores (WMMA),
// float32 on them too as the three-term TF32 split (common.cuh).  Row tiling re-reads W: at B = 128 the grid has
// ceil(128 / 64) = 2 row blocks, so every weight tile is fetched twice, the
// second time mostly from L2 since both row blocks of a column run together.
// With the LayerNorm prologue a first launch computes every row's (mean,
// rstd) once, one warp per row; the tile kernel then normalises each element
// on its way into shared memory.  (Computed inside each column block, the
// statistics cost the QKV and MLP fc roles most of their time.)  Each
// thread issues a stage's loads as 16-byte vectors, all before it stores any
// to shared memory, and issues the next stage's loads before this stage's
// MMAs: one stage in flight per block.  At these grids (48 to 192 blocks, one
// per SM) that is still far from enough bytes in flight to reach the card's
// bandwidth; deeper cp.async/TMA pipelines, wgmma and split-K for the
// 768-wide outputs are later work.
//
// W8A8 (the step kernel's quant mode, stream_matmul :262-287): with int8
// weights and their (N,) float32 per-column scales, the call's first launch
// is rowquant.cu — the LN (when the role has one), the cast to the compute
// dtype and the per-row int8 quantization — and the second the int8 tile
// (common.cuh), dequantized as acc * sx * sw before the same epilogues.  The
// weights' bytes halve (1.8 MB for QKV); the bound stays the bytes.
#include "common.cuh"

namespace gic {

constexpr int kEpiCast = 0;
constexpr int kEpiGelu = 1;
constexpr int kEpiResidual = 2;

// (mean, rstd) of each float32 row, one warp per row.
__global__ void ln_stats_kernel(const float* x, int M, int K, float eps, float* stats) {
  const int m = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (m >= M) return;
  float mean, rstd;
  row_mean_rstd(x + (size_t)m * K, K, eps, mean, rstd);
  if (threadIdx.x % 32 == 0) {
    stats[2 * (size_t)m] = mean;
    stats[2 * (size_t)m + 1] = rstd;
  }
}

// T: the compute dtype of the output; E: the operand type of the product
// (T, or int8_t with the row scales sx and the column scales sw).
template <typename T, typename E, bool LN, int EPI>
__global__ void __launch_bounds__(THREADS)
fused_linear_kernel(const void* x, const float* stats, const float* ln_s, const float* ln_b,
                    const E* w, const float* bias, void* out, int M, int K, int N,
                    const float* sx, const float* sw) {
  __shared__ TileSmem<E> sm;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  tile_product<E, LN>(sm, x, stats, ln_s, ln_b, w, M, K, N, m0, n0, sx, sw);
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const float y = sm.cs[r][c] + bias[n];
    const size_t o = (size_t)m * N + n;
    if (EPI == kEpiCast) {
      static_cast<T*>(out)[o] = from_f32<T>(y);
    } else if (EPI == kEpiGelu) {
      static_cast<T*>(out)[o] = from_f32<T>(gelu_new(y));
    } else {
      static_cast<float*>(out)[o] += y;  // the float32 residual stream, in place
    }
  }
}

template <typename T, typename E>
static void launch(int ln, int epi, dim3 grid, cudaStream_t s, const void* x, const float* stats,
                   const float* ln_s, const float* ln_b, const E* w, const float* bias, void* out,
                   int M, int K, int N, const float* sx, const float* sw) {
#define GIC_LAUNCH(LNV, EPIV)                                                         \
  fused_linear_kernel<T, E, LNV, EPIV><<<grid, THREADS, 0, s>>>(x, stats, ln_s, ln_b, w, bias, \
                                                                 out, M, K, N, sx, sw)
  if constexpr (!std::is_same<E, int8_t>::value) {
    if (ln) {
      if (epi == kEpiCast) GIC_LAUNCH(true, kEpiCast);
      else if (epi == kEpiGelu) GIC_LAUNCH(true, kEpiGelu);
      else GIC_LAUNCH(true, kEpiResidual);
      return;
    }
  }
  if (epi == kEpiCast) GIC_LAUNCH(false, kEpiCast);
  else if (epi == kEpiGelu) GIC_LAUNCH(false, kEpiGelu);
  else GIC_LAUNCH(false, kEpiResidual);
#undef GIC_LAUNCH
}

// int8 weights: quantize the rows (with the LN when the role has one), then
// the int8 product
template <typename T>
static void launch_int8(int ln, int epi, dim3 grid, cudaStream_t s, const void* x,
                        const float* ln_s, const float* ln_b, float eps, const int8_t* w,
                        const float* w_scale, const float* bias, void* out, int8_t* xq, float* sx,
                        int M, int K, int N) {
  if (ln) launch_rowquant<T, true>(s, x, K, ln_s, ln_b, eps, M, K, xq, K, sx);
  else launch_rowquant<T, false>(s, x, K, ln_s, ln_b, eps, M, K, xq, K, sx);
  launch<T, int8_t>(0, epi, grid, s, xq, nullptr, nullptr, nullptr, w, bias, out, M, K, N, sx,
                    w_scale);
}

}  // namespace gic

// x: (M, K) float32 when ln != 0, else the element type; w: (N, K) in the
// element type, or int8 when w_scale ((N,) float32) is given; bias: (N,)
// float32; out: (M, N) in the element type, or the float32 residual stream
// (read and written) when epi is the residual add; stats: (M, 2) float32
// scratch, used when ln != 0 with float weights; xq (M, K) int8 and sx (M,)
// float32 scratch, used with int8 weights.  Returns cudaGetLastError().
extern "C" int gic_fused_linear(int dtype, int ln, int epi, const void* x, const void* ln_s,
                                const void* ln_b, float eps, const void* w, const void* w_scale,
                                const void* bias, void* out, void* stats, void* xq, void* sx,
                                int M, int K, int N, void* stream) {
  using namespace gic;
  if (M <= 0 || K <= 0 || N <= 0 || epi < kEpiCast || epi > kEpiResidual)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lns = static_cast<const float*>(ln_s);
  const float* lnb = static_cast<const float*>(ln_b);
  const float* b = static_cast<const float*>(bias);
  float* st = static_cast<float*>(stats);
  if (dtype != kBF16 && dtype != kF32) return (int)cudaErrorInvalidValue;
  if (w_scale) {
    const int8_t* wq = static_cast<const int8_t*>(w);
    const float* ws = static_cast<const float*>(w_scale);
    int8_t* q = static_cast<int8_t*>(xq);
    float* sq = static_cast<float*>(sx);
    if (dtype == kBF16)
      launch_int8<__nv_bfloat16>(ln, epi, grid, s, x, lns, lnb, eps, wq, ws, b, out, q, sq, M, K,
                                 N);
    else
      launch_int8<float>(ln, epi, grid, s, x, lns, lnb, eps, wq, ws, b, out, q, sq, M, K, N);
    return (int)cudaGetLastError();
  }
  if (ln) {
    constexpr int kRowsPerBlock = 4;  // one warp per row
    ln_stats_kernel<<<(M + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, s>>>(
        static_cast<const float*>(x), M, K, eps, st);
  }
  if (dtype == kBF16)
    launch<__nv_bfloat16, __nv_bfloat16>(ln, epi, grid, s, x, st, lns, lnb,
                                         static_cast<const __nv_bfloat16*>(w), b, out, M, K, N,
                                         nullptr, nullptr);
  else
    launch<float, float>(ln, epi, grid, s, x, st, lns, lnb, static_cast<const float*>(w), b, out,
                         M, K, N, nullptr, nullptr);
  return (int)cudaGetLastError();
}

extern "C" const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
