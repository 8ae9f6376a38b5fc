// GPT-2 prefill of a fresh prefix: all L blocks over B images of T tokens.
//
// Replaces: gpt2_image_captioning_tpu/ops/prefill_step.py::_prefill_kernel
// (:87) as fused_prefill (:287) calls it — LN1, QKV, causal attention inside
// each image, the projection with its residual, LN2, the gelu_new MLP with
// its residual, every layer's K/V rows written for the cache.  The caller
// takes LN_f of the last position and one product with wte (the reference
// leaves that outside its kernel too).
//
// Numerics follow the TPU kernel: matmul inputs in the compute dtype,
// float32 accumulation, a float32 residual stream across all layers (x32,
// :166-245), float32 LayerNorm and softmax.  Q, K and V are rounded to the
// compute dtype (:170); the attention output is normalised in float32 and
// rounded once before the projection (:225-228).
//
// Design for Hopper.  On the TPU one call runs all 12 layers, each grid
// block owning whole images and streaming every layer's weights through
// VMEM.  Copied here, each block would re-read the 170 MB of bf16 weights
// and only B*T/rows-per-block blocks would be busy.  So gic_prefill runs a
// per-layer sequence of launches, rows = B*T image-major (row g*T + t):
//   1. prefill_layernorm_kernel — LN1 of every float32 row, one warp a row,
//      rounded to the compute dtype where the TPU kernel rounds it (:168);
//   2. prefill_linear_kernel<QKV> — the tile product of common.cuh and an
//      epilogue that writes Q to a (rows, D) scratch and K and V straight
//      into the cache's (T, B, D) rows of layer l, in place of the TPU
//      kernel's K/V DMA and the caller's transpose (:394-396);
//   3. prefill_attention_kernel — one block per (image, head): the image's T
//      keys and values (T <= 32) in shared memory, one warp per query row, a
//      lane per key; row t attends keys [0, t] of its own image
//      (:195-224);
//   4. prefill_linear_kernel<RESIDUAL> — the projection added into x32;
//   5. LN2, 6. prefill_linear_kernel<GELU>, 7. prefill_linear_kernel<RESIDUAL>
//      (the MLP's down-projection).
// Seven launches a layer, 84 for GPT-2 124M, from one C call.  The LayerNorm
// is its own pass, not the tile's prologue as in the decode step: at 1,920
// rows every column block would normalise the same rows again (72 times for
// QKV), and the prologue tiles ran at a third of the plain tile's rate.
//
// Bound on the H100: operations.  At B 128, T 15 (1,920 rows) a layer does
// 2 * 1,920 * 7.08 M flops in its four products, 326 GFLOP over 12 layers:
// 0.33 ms at 989 TFLOP/s in bf16, against 0.05 ms for the 170 MB of weights.
// An admission of 8 images (120 rows) is weight-bound (0.05 ms).  The tile
// is the decode step's (64 x 32, one stage in flight, WMMA), far from
// either bound; wgmma and deeper pipelines are later work.
#include "common.cuh"

namespace gic {

constexpr int kPreQKV = 0;
constexpr int kPreGelu = 1;
constexpr int kPreResidual = 2;
constexpr int kPreMaxT = 32;     // keys of one image: one lane each
constexpr int kPreMaxHd = 96;    // head dim: the three (T, hd + 1) float tiles stay under 48 KB
constexpr int kAttnWarps = 4;

// y = LN(x) in T for each float32 row of K, one warp per row.
template <typename T>
__global__ void prefill_layernorm_kernel(const float* x, const float* ln_s, const float* ln_b,
                                         int M, int K, float eps, T* y) {
  const int m = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (m >= M) return;
  const float* row = x + (size_t)m * K;
  float mean, rstd;
  row_mean_rstd(row, K, eps, mean, rstd);
  for (int k = threadIdx.x % 32; k < K; k += 32)
    y[(size_t)m * K + k] = ln_value<T>(row[k], mean, rstd, ln_s[k], ln_b[k]);
}

// y = epilogue(prologue(x) @ W^T + bias) for rows m0.., columns n0...
// QKV: N = 3D; columns [0, D) go to q (M, D), [D, 2D) and [2D, 3D) to the
// layer's K and V cache rows: row m = g*T + t lands at (t * cache_b + g) * D.
template <typename T, int EPI>
__global__ void __launch_bounds__(THREADS)
prefill_linear_kernel(const T* x, const T* w, const float* bias, void* out, int M, int K, int N,
                      T* k_cache, T* v_cache, int tg, int cache_b) {
  __shared__ TileSmem<T> sm;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  tile_product<T, false>(sm, x, nullptr, nullptr, nullptr, w, M, K, N, m0, n0);
  const int d = N / 3;
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const float y = sm.cs[r][c] + bias[n];
    if (EPI == kPreQKV) {
      if (n < d) {
        static_cast<T*>(out)[(size_t)m * d + n] = from_f32<T>(y);
      } else {
        const int g = m / tg, t = m % tg;
        T* cache = n < 2 * d ? k_cache : v_cache;
        cache[((size_t)t * cache_b + g) * d + (n % d)] = from_f32<T>(y);
      }
    } else if (EPI == kPreGelu) {
      static_cast<T*>(out)[(size_t)m * N + n] = from_f32<T>(gelu_new(y));
    } else {
      static_cast<float*>(out)[(size_t)m * N + n] += y;  // the float32 residual stream
    }
  }
}

// Causal attention inside each image: block (g, h); q (M, D) rows g*T..,
// K/V from the layer's cache rows (t * cache_b + g); out (M, D) in T.
template <typename T>
__global__ void __launch_bounds__(32 * kAttnWarps)
prefill_attention_kernel(const T* q, const T* k_cache, const T* v_cache, T* out, int tg, int D,
                         int hd, int cache_b, float scale) {
  extern __shared__ float att_smem[];
  const int pitch = hd + 1;  // lanes read rows j = lane: an odd pitch spreads the banks
  float* qs = att_smem;
  float* ks = qs + tg * pitch;
  float* vs = ks + tg * pitch;
  const int g = blockIdx.x, h = blockIdx.y;
  for (int i = threadIdx.x; i < tg * hd; i += blockDim.x) {
    const int t = i / hd, e = i % hd;
    const size_t c = ((size_t)t * cache_b + g) * D + (size_t)h * hd + e;
    qs[t * pitch + e] = to_f32(q[((size_t)g * tg + t) * D + (size_t)h * hd + e]);
    ks[t * pitch + e] = to_f32(k_cache[c]);
    vs[t * pitch + e] = to_f32(v_cache[c]);
  }
  __syncthreads();
  __shared__ float ps[kAttnWarps][kPreMaxT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < tg; t += kAttnWarps) {
    float s = __int_as_float(0xff800000);  // -inf
    if (lane <= t) {
      float acc = 0.f;
      for (int e = 0; e < hd; ++e) acc = fmaf(qs[t * pitch + e], ks[lane * pitch + e], acc);
      s = acc * scale;
    }
    const float m = warp_max(s);  // lane 0 <= t always holds a score
    const float p = lane <= t ? expf(s - m) : 0.f;
    const float inv = 1.f / warp_sum(p);
    if (lane < kPreMaxT) ps[warp][lane] = p;
    __syncwarp();
    for (int e = lane; e < hd; e += 32) {
      float acc = 0.f;
      for (int j = 0; j <= t; ++j) acc = fmaf(ps[warp][j], vs[j * pitch + e], acc);
      out[((size_t)g * tg + t) * D + (size_t)h * hd + e] = from_f32<T>(acc * inv);
    }
    __syncwarp();  // ps is rewritten by this warp's next row
  }
}

template <typename T, int EPI>
static void linear(cudaStream_t s, const T* x, const T* w, const float* bias, void* out, int M,
                   int K, int N, T* k_cache = nullptr, T* v_cache = nullptr, int tg = 1,
                   int cache_b = 1) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  prefill_linear_kernel<T, EPI><<<grid, THREADS, 0, s>>>(x, w, bias, out, M, K, N, k_cache,
                                                          v_cache, tg, cache_b);
}

template <typename T>
static void layernorm(cudaStream_t s, const float* x, const float* ln_s, const float* ln_b, int M,
                      int K, float eps, T* y) {
  constexpr int kRowsPerBlock = 4;  // one warp per row
  prefill_layernorm_kernel<T><<<(M + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0,
                                s>>>(x, ln_s, ln_b, M, K, eps, y);
}

template <typename T>
static int run(cudaStream_t s, int L, int B, int tg, int D, int H, float eps, float* x32,
               const T* qkvw, const T* projw, const T* fcw, const T* cprojw, const float* attnb,
               const float* projb, const float* fcb, const float* cprojb, const float* ln1s,
               const float* ln1b, const float* ln2s, const float* ln2b, T* k_cache, T* v_cache,
               int cache_t, T* qbuf, T* abuf, T* hbuf) {
  const int M = B * tg, F = 4 * D, hd = D / H;
  const size_t smem = 3 * (size_t)tg * (hd + 1) * sizeof(float);
  const float scale = 1.f / sqrtf((float)hd);
  for (int l = 0; l < L; ++l) {
    T* kl = k_cache + (size_t)l * cache_t * B * D;
    T* vl = v_cache + (size_t)l * cache_t * B * D;
    // abuf holds LN1's rows, then the attention output, then LN2's rows
    layernorm(s, x32, ln1s + (size_t)l * D, ln1b + (size_t)l * D, M, D, eps, abuf);
    linear<T, kPreQKV>(s, abuf, qkvw + (size_t)l * 3 * D * D, attnb + (size_t)l * 3 * D, qbuf, M,
                       D, 3 * D, kl, vl, tg, B);
    prefill_attention_kernel<T><<<dim3(B, H), 32 * kAttnWarps, smem, s>>>(qbuf, kl, vl, abuf, tg,
                                                                         D, hd, B, scale);
    linear<T, kPreResidual>(s, abuf, projw + (size_t)l * D * D, projb + (size_t)l * D, x32, M, D,
                            D);
    layernorm(s, x32, ln2s + (size_t)l * D, ln2b + (size_t)l * D, M, D, eps, abuf);
    linear<T, kPreGelu>(s, abuf, fcw + (size_t)l * F * D, fcb + (size_t)l * F, hbuf, M, D, F);
    linear<T, kPreResidual>(s, hbuf, cprojw + (size_t)l * D * F, cprojb + (size_t)l * D, x32, M,
                            F, D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace gic

// x32: (B*T, D) float32 residual stream, image-major, read and written in
// place (the input embeddings with positions on entry, the stream after the
// last block on exit); qkvw (L, 3D, D), projw (L, D, D), fcw (L, 4D, D),
// cprojw (L, D, 4D) in the element type, output-major (the decode pack);
// biases (L, N) and LN scale/bias (L, D) float32; k_cache/v_cache (L,
// cache_t, B, D) in the element type, rows [0, T) of each layer written;
// qbuf/abuf (B*T, D) and hbuf (B*T, 4D) scratch in the element type.
// Returns the first cudaGetLastError() that is not 0.
extern "C" int gic_prefill(int dtype, int L, int B, int T, int D, int H, float eps, void* x32,
                           const void* qkvw, const void* projw, const void* fcw,
                           const void* cprojw, const void* attnb, const void* projb,
                           const void* fcb, const void* cprojb, const void* ln1s,
                           const void* ln1b, const void* ln2s, const void* ln2b, void* k_cache,
                           void* v_cache, int cache_t, void* qbuf, void* abuf, void* hbuf,
                           void* stream) {
  using namespace gic;
  if (L <= 0 || B <= 0 || T <= 0 || T > kPreMaxT || T > cache_t || H <= 0 || D % H ||
      D / H > kPreMaxHd)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* x = static_cast<float*>(x32);
#define GIC_PREFILL(TYPE)                                                                     \
  run<TYPE>(s, L, B, T, D, H, eps, x, static_cast<const TYPE*>(qkvw),                         \
            static_cast<const TYPE*>(projw), static_cast<const TYPE*>(fcw),                    \
            static_cast<const TYPE*>(cprojw), f(attnb), f(projb), f(fcb), f(cprojb), f(ln1s), \
            f(ln1b), f(ln2s), f(ln2b), static_cast<TYPE*>(k_cache),                            \
            static_cast<TYPE*>(v_cache), cache_t, static_cast<TYPE*>(qbuf),                    \
            static_cast<TYPE*>(abuf), static_cast<TYPE*>(hbuf))
  if (dtype == kBF16) return GIC_PREFILL(__nv_bfloat16);
  if (dtype == kF32) return GIC_PREFILL(float);
#undef GIC_PREFILL
  return (int)cudaErrorInvalidValue;
}
