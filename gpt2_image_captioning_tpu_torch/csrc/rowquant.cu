// Per-row symmetric int8 quantization of the activations: the A side of the
// W8A8 decode step.
//
// Replaces: rowquant of gpt2_image_captioning_tpu/ops/decode_step.py::
// _step_kernel (:234-240), with the LayerNorm and the cast to the compute
// dtype that precede it there (:529-530, :546, :553).  Per row:
//   v  = x, or LN(x) rounded to the compute dtype T
//   sx = max(max|v| * float32(1/127), 1e-12)
//   q  = rint(v / sx)        (IEEE division, round half to even)
// exactly as the TPU kernel and ops/quant.py::rowquant_plain compute it.
// In the int8 step it runs where a LayerNorm comes first: LN1 -> qkv and
// LN2 -> fc (in place of the bf16 step's LN pre-pass) and LN_f before the
// vocabulary (the four vocabulary kernels' int8 routes launch it inside
// their calls), 25 launches a step at 12 layers.  The rows without a
// LayerNorm, the attention output -> proj and gelu(h) -> cproj, are
// quantized inside their product (fused_linear.cu, the int8 route's folded
// quantization); the int8 KV cache's new rows inside decode attention.
//
// Bound on the H100: the bytes, one read of the row (4 bytes an element with
// the LN, 2 in bf16) and one int8 write: ~0.5 MB at B 128, D 768 with LN,
// ~0.15 us; at these sizes a launch's latency is the cost.
//
// Design: a block of four warps a row, so the 128 rows of a request run as
// 512 warps on 128 SMs and each thread's share of the work, the chain of
// dependent instructions that sets a launch's time, is short.  A row of
// whole 16-byte vectors (up to 2,048 float32 or 4,096 bf16 elements, every
// GPT-2 width) is read once into registers, all of a thread's loads in
// flight together; the LayerNorm statistics (float64, each sum in a fixed
// order, rounded once, as common.cuh::ln_rows_kernel), the normalised
// values, max|v| and the quantized bytes all come from there, stored 4 or 8
// bytes a thread; rint(v / s) from one multiply by 1 / s, the division only
// where the two could round apart (common.cuh::quant_pack4_fast and
// quant_pack4_exact: the same integers).  Other rows take the first
// version's walk (one warp: the statistics, then a pass for max|v| and one
// to quantize, v recomputed).  The first version (one warp a row, four walks
// of the row) took 5.8 us a launch at B 128 with the LN on an H100.
#include "common.cuh"

namespace gic {

namespace {

// The first version's walk, for rows that are not whole aligned vectors or
// do not fit a lane's registers.
template <typename T, bool LN>
__device__ void rowquant_walk(const void* x, const float* ln_s, const float* ln_b, float eps,
                              int K, int8_t* out, float* sx) {
  const int lane = threadIdx.x % 32;
  using XT = typename std::conditional<LN, float, T>::type;
  const XT* row = static_cast<const XT*>(x);
  float mean = 0.f, rstd = 0.f;
  if constexpr (LN) row_mean_rstd(row, K, eps, mean, rstd);
  auto value = [&](int k) -> float {
    if constexpr (LN) return to_f32(ln_value<T>(row[k], mean, rstd, ln_s[k], ln_b[k]));
    else return to_f32(row[k]);
  };
  float mx = 0.f;
  for (int k = lane; k < K; k += 32) mx = fmaxf(mx, fabsf(value(k)));
  const float s = fmaxf(warp_max(mx) * kInv127, kMinScale);
  for (int k = lane; k < K; k += 32) out[k] = (int8_t)rintf(__fdiv_rn(value(k), s));
  if (lane == 0) *sx = s;
}

constexpr int kRowThreads = kLnThreads;  // a row's threads: 4 warps (common.cuh::block_sum)
constexpr int kRowVectors = 4;           // 16-byte vectors a thread: rows of <= 512 vectors

template <typename T, bool LN>
__global__ void __launch_bounds__(kRowThreads)
rowquant_kernel(const void* x, int ld, const float* ln_s, const float* ln_b, float eps, int M,
                int K, int8_t* q, int ldq, float* sx) {
  const int m = blockIdx.x;
  if (m >= M) return;
  using XT = typename std::conditional<LN, float, T>::type;
  constexpr int EPV = 16 / (int)sizeof(XT);  // elements of a 16-byte vector
  const XT* row = static_cast<const XT*>(x) + (size_t)m * ld;
  int8_t* out = q + (size_t)m * ldq;
  const bool vec = K % EPV == 0 && K <= kRowThreads * kRowVectors * EPV &&
                   reinterpret_cast<uintptr_t>(row) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % EPV == 0 &&
                   (!LN || (reinterpret_cast<uintptr_t>(ln_s) % 16 == 0 &&
                            reinterpret_cast<uintptr_t>(ln_b) % 16 == 0));
  if (!vec) {
    if (threadIdx.x < 32) rowquant_walk<T, LN>(row, ln_s, ln_b, eps, K, out, sx + m);
    return;
  }
  __shared__ double red[kRowThreads / 32];
  __shared__ float red_max[kRowThreads / 32];
  const int nv = K / EPV;  // the row's vectors; thread t holds t, t + 128, ..
  float4 v[kRowVectors];
#pragma unroll
  for (int i = 0; i < kRowVectors; ++i) {
    const int j = threadIdx.x + kRowThreads * i;
    v[i] = j < nv ? reinterpret_cast<const float4*>(row)[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the row's values as float32, EPV a vector
  float val[kRowVectors][EPV];
#pragma unroll
  for (int i = 0; i < kRowVectors; ++i) {
    const XT* e = reinterpret_cast<const XT*>(&v[i]);
#pragma unroll
    for (int k = 0; k < EPV; ++k) val[i][k] = to_f32(e[k]);
  }
  if constexpr (LN) {
    // row_mean_rstd's statistics in float64, rounded once; then each value
    // normalised and rounded to T (ln_value)
    double sum = 0.0;
#pragma unroll
    for (int i = 0; i < kRowVectors; ++i)
      sum += ((double)val[i][0] + (double)val[i][1]) + ((double)val[i][2] + (double)val[i][3]);
    const double mu = block_sum(sum, red) / K;
    double var = 0.0;
#pragma unroll
    for (int i = 0; i < kRowVectors; ++i) {
      if (threadIdx.x + kRowThreads * i < nv) {
        const double a = val[i][0] - mu, b = val[i][1] - mu, c = val[i][2] - mu,
                     d = val[i][3] - mu;
        var += (a * a + b * b) + (c * c + d * d);
      }
    }
    const float mean = (float)mu;
    const float rstd = (float)(1.0 / sqrt(block_sum(var, red) / K + (double)eps));
#pragma unroll
    for (int i = 0; i < kRowVectors; ++i) {
      const int j = threadIdx.x + kRowThreads * i;
      if (j < nv) {
        const float4 s = reinterpret_cast<const float4*>(ln_s)[j];
        const float4 b = reinterpret_cast<const float4*>(ln_b)[j];
        val[i][0] = to_f32(ln_value<T>(val[i][0], mean, rstd, s.x, b.x));
        val[i][1] = to_f32(ln_value<T>(val[i][1], mean, rstd, s.y, b.y));
        val[i][2] = to_f32(ln_value<T>(val[i][2], mean, rstd, s.z, b.z));
        val[i][3] = to_f32(ln_value<T>(val[i][3], mean, rstd, s.w, b.w));
      } else {
        val[i][0] = val[i][1] = val[i][2] = val[i][3] = 0.f;
      }
    }
  }
  float mx = 0.f;  // zeros past nv
#pragma unroll
  for (int i = 0; i < kRowVectors; ++i)
#pragma unroll
    for (int k = 0; k < EPV; ++k) mx = fmaxf(mx, fabsf(val[i][k]));
  mx = warp_max(mx);
  if (threadIdx.x % 32 == 0) red_max[threadIdx.x / 32] = mx;
  __syncthreads();
  mx = fmaxf(fmaxf(red_max[0], red_max[1]), fmaxf(red_max[2], red_max[3]));
  const float s = fmaxf(mx * kInv127, kMinScale), inv = __frcp_rn(s);
  // every vector's fast path first, without a branch, so their latencies
  // overlap; then the rare fix-ups (quant_pack4_exact) and the stores
  constexpr int WPV = EPV / 4;  // packed words a vector
  uint32_t w[kRowVectors][WPV];
  bool near[kRowVectors][WPV];
#pragma unroll
  for (int i = 0; i < kRowVectors; ++i) {
#pragma unroll
    for (int h = 0; h < WPV; ++h) {
      const float q[4] = {val[i][4 * h], val[i][4 * h + 1], val[i][4 * h + 2], val[i][4 * h + 3]};
      near[i][h] = false;
      w[i][h] = quant_pack4_fast(q, inv, near[i][h]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRowVectors; ++i) {
    const int j = threadIdx.x + kRowThreads * i;
    if (j >= nv) continue;
#pragma unroll
    for (int h = 0; h < WPV; ++h)
      if (__builtin_expect(near[i][h], 0))
        w[i][h] = quant_pack4_exact(val[i][4 * h], val[i][4 * h + 1], val[i][4 * h + 2],
                                    val[i][4 * h + 3], s);
    if constexpr (WPV == 1) reinterpret_cast<uint32_t*>(out)[j] = w[i][0];  // float32 values
    else reinterpret_cast<uint2*>(out)[j] = make_uint2(w[i][0], w[i][1]);   // bf16
  }
  if (threadIdx.x == 0) sx[m] = s;
}

}  // namespace

template <typename T, bool LN>
void launch_rowquant(cudaStream_t s, const void* x, int ld, const float* ln_s, const float* ln_b,
                     float eps, int M, int K, int8_t* q, int ldq, float* sx) {
  rowquant_kernel<T, LN><<<M, kRowThreads, 0, s>>>(x, ld, ln_s, ln_b, eps, M, K, q, ldq, sx);
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
