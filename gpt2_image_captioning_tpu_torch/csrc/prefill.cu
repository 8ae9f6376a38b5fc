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
//   1. LN1 of every float32 row (common.cuh::ln_rows_kernel: four warps a
//      row, the row read once into registers, float64 statistics rounded
//      once), rounded to the compute dtype where the TPU kernel rounds it
//      (:168);
//   2. the QKV product into a (rows, 3D) scratch, cast to the compute dtype;
//   3. prefill_attention_kernel — one block per (image, head): the image's T
//      queries, keys and values (T <= 32) from the QKV rows into shared
//      memory, 16 bytes a load, K and V also stored into the cache's (T, B,
//      D) rows of layer l as they pass (in place of the TPU kernel's K/V DMA
//      and the caller's transpose, :394-396); one warp per query row, a lane
//      per key; row t attends keys [0, t] of its own image (:195-224);
//   4. the projection added into x32;
//   5. LN2, 6. the MLP fc with gelu_new (float64, rounded once), 7. its
//      down-projection added into x32.
// Seven launches a layer, 84 for GPT-2 124M, from one C call.  The four
// products run on fused_linear.cu's linear_wgmma_kernel (a TMA ring, the
// cluster split-K; bf16 on wgmma m64nBNk16, float32 on wgmma m64nBNk8 .tf32
// as the three-term split, its header's float32 paragraph), in the split
// ops/decode_step.py::linear_plan gives at B*T rows, which the wrapper
// passes in (bf16 at 1,920 rows: 128-column tiles, one K-slice for QKV and
// fc, two for the others; at an admission's 120 the decode step's splits).
// In float32 the LayerNorms write their rows as the TF32 pair (abuf is then
// (2 B*T, D): the hi rows, then the lo rows), which QKV and fc read split;
// the attention output and gelu(h) reach the products unsplit, and the
// product's converter warps split them.  The cache rows are written by the
// attention kernel rather than by a fourth epilogue of the product: the
// attention reads each image's K and V anyway, and the decode step's
// product kernel keeps its three epilogues.  The LayerNorm is its own pass, not a prologue
// of the product: every column tile would normalise the same rows again.
//
// Bound on the H100: operations.  At B 128, T 15 (1,920 rows) a layer does
// 2 * 1,920 * 7.08 M flops in its four products, 326 GFLOP over 12 layers:
// 0.33 ms at 989 TFLOP/s in bf16, against 0.05 ms for the 170 MB of weights.
// An admission of 8 images (120 rows) is weight-bound (0.05 ms).  On an
// H100 (700 W) the bf16 call takes 2.2 ms at b 128 (4.0 with the first
// version's 64 x 32 WMMA tile): the products run at 200-300 TFLOP/s, by
// estimate bound by their operands' traffic from L2 (a 128 x 128 tile
// reads both operands once a 64-deep step); gelu_new in float64 adds 0.40
// ms, the attention 0.25.  An admission takes 0.53 ms (1.27 before).  In
// float32 the products run three TF32 products each: 0.33 x 3 x 2 = 1.98 ms
// at 495 TFLOP/s over 12 layers.
#include "common.cuh"

namespace gic {

constexpr int kPreMaxT = 32;     // keys of one image: one lane each
constexpr int kPreMaxHd = 96;    // head dim: the three (T, hd + 1) float tiles stay under 48 KB
constexpr int kAttnWarps = 8;

// Causal attention inside each image: block (g, h); q, k, v from the QKV
// product's (M, 3D) rows g*T.. (columns [0, D), [D, 2D), [2D, 3D)); the
// image's K and V head rows also go to the layer's cache rows (t * cache_b
// + g), as the loads bring them; out (M, D) in T.  16-byte loads and
// stores where hd is a multiple of the vector, else an element a thread.
template <typename T>
__global__ void __launch_bounds__(32 * kAttnWarps)
prefill_attention_kernel(const T* qkv, T* k_cache, T* v_cache, T* out, int tg, int D, int hd,
                         int cache_b, float scale) {
  extern __shared__ float att_smem[];
  const int pitch = hd + 1;  // lanes read rows j = lane: an odd pitch spreads the banks
  float* qs = att_smem;
  float* ks = qs + tg * pitch;
  float* vs = ks + tg * pitch;
  const int g = blockIdx.x, h = blockIdx.y;
  constexpr int EPV = 16 / (int)sizeof(T);
  const int step = hd % EPV == 0 ? EPV : 1;  // elements a thread moves at once
  const int per_row = hd / step;
  for (int i = threadIdx.x; i < tg * per_row; i += blockDim.x) {
    const int t = i / per_row, e = (i % per_row) * step;
    const T* src = qkv + ((size_t)g * tg + t) * 3 * D + (size_t)h * hd + e;
    const size_t c = ((size_t)t * cache_b + g) * D + (size_t)h * hd + e;
    if (step == EPV) {
      const uint4 q4 = *reinterpret_cast<const uint4*>(src);
      const uint4 k4 = *reinterpret_cast<const uint4*>(src + D);
      const uint4 v4 = *reinterpret_cast<const uint4*>(src + 2 * D);
      *reinterpret_cast<uint4*>(k_cache + c) = k4;
      *reinterpret_cast<uint4*>(v_cache + c) = v4;
      const T* qe = reinterpret_cast<const T*>(&q4);
      const T* ke = reinterpret_cast<const T*>(&k4);
      const T* ve = reinterpret_cast<const T*>(&v4);
#pragma unroll
      for (int j = 0; j < EPV; ++j) {
        qs[t * pitch + e + j] = to_f32(qe[j]);
        ks[t * pitch + e + j] = to_f32(ke[j]);
        vs[t * pitch + e + j] = to_f32(ve[j]);
      }
    } else {
      k_cache[c] = src[D];
      v_cache[c] = src[2 * D];
      qs[t * pitch + e] = to_f32(src[0]);
      ks[t * pitch + e] = to_f32(src[D]);
      vs[t * pitch + e] = to_f32(src[2 * D]);
    }
  }
  __syncthreads();
  __shared__ float ps[kAttnWarps][kPreMaxT];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < tg; t += kAttnWarps) {
    float s = __int_as_float(0xff800000);  // -inf
    if (lane <= t) {
      // four partial sums, so the FMAs' latencies overlap
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const float* qr = qs + t * pitch;
      const float* kr = ks + lane * pitch;
      int e = 0;
#pragma unroll 4
      for (; e + 4 <= hd; e += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] = fmaf(qr[e + u], kr[e + u], acc[u]);
      }
      for (; e < hd; ++e) acc[0] = fmaf(qr[e], kr[e], acc[0]);
      s = ((acc[0] + acc[1]) + (acc[2] + acc[3])) * scale;
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

// One product of a layer on fused_linear.cu's TMA ring and wgmma, in the
// split plan (bn, splits, kslice): bf16, or float32 on TF32, whose rows x
// come as their TF32 pair where x_split is set (the LayerNorms' rows).
static int product(cudaStream_t s, const __nv_bfloat16* x, int, const __nv_bfloat16* w,
                   const float* bias, void* out, int epi, int M, int K, int N, const int* plan) {
  return linear_wgmma_bf16(x, w, bias, out, epi, M, N, K, plan[0], plan[1], plan[2], s);
}
static int product(cudaStream_t s, const float* x, int x_split, const float* w, const float* bias,
                   void* out, int epi, int M, int K, int N, const int* plan) {
  return linear_wgmma_f32(x, x_split, w, bias, static_cast<float*>(out), epi, M, N, K, plan[0],
                          plan[1], plan[2], s);
}

// The LayerNorm's TF32 lo rows: in float32 after the M hi rows of abuf, in
// bf16 none.
static float* pair_lo(float* abuf, size_t n) { return abuf + n; }
static float* pair_lo(__nv_bfloat16*, size_t) { return nullptr; }

template <typename T>
static int run(cudaStream_t s, int L, int B, int tg, int D, int H, float eps, float* x32,
               const T* qkvw, const T* projw, const T* fcw, const T* cprojw, const float* attnb,
               const float* projb, const float* fcb, const float* cprojb, const float* ln1s,
               const float* ln1b, const float* ln2s, const float* ln2b, T* k_cache, T* v_cache,
               int cache_t, T* qkvbuf, T* abuf, T* hbuf, const int* plans) {
  const int M = B * tg, F = 4 * D, hd = D / H;
  const size_t smem = 3 * (size_t)tg * (hd + 1) * sizeof(float);
  const float scale = 1.f / sqrtf((float)hd);
  float* lo = pair_lo(abuf, (size_t)M * D);
  const int split = lo != nullptr;
  for (int l = 0; l < L; ++l) {
    T* kl = k_cache + (size_t)l * cache_t * B * D;
    T* vl = v_cache + (size_t)l * cache_t * B * D;
    // abuf holds LN1's rows, then the attention output, then LN2's rows
    launch_ln_rows(s, x32, ln1s + (size_t)l * D, ln1b + (size_t)l * D, eps, M, D, abuf, lo);
    int err = product(s, abuf, split, qkvw + (size_t)l * 3 * D * D, attnb + (size_t)l * 3 * D,
                      qkvbuf, kEpiCast, M, D, 3 * D, plans);
    if (!err) {
      prefill_attention_kernel<T><<<dim3(B, H), 32 * kAttnWarps, smem, s>>>(qkvbuf, kl, vl, abuf,
                                                                           tg, D, hd, B, scale);
      err = product(s, abuf, 0, projw + (size_t)l * D * D, projb + (size_t)l * D, x32,
                    kEpiResidual, M, D, D, plans + 3);
    }
    if (!err) {
      launch_ln_rows(s, x32, ln2s + (size_t)l * D, ln2b + (size_t)l * D, eps, M, D, abuf, lo);
      err = product(s, abuf, split, fcw + (size_t)l * F * D, fcb + (size_t)l * F, hbuf, kEpiGelu,
                    M, D, F, plans + 6);
    }
    if (!err)
      err = product(s, hbuf, 0, cprojw + (size_t)l * D * F, cprojb + (size_t)l * D, x32,
                    kEpiResidual, M, F, D, plans + 9);
    if (err) return err;
    const cudaError_t last = cudaGetLastError();
    if (last != cudaSuccess) return (int)last;
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
// qkvbuf (B*T, 3D), abuf (B*T, D) — (2 B*T, D) in float32, the LayerNorms'
// TF32 pair — and hbuf (B*T, 4D) scratch in the element type; plans: host
// memory, 12 ints, the products' splits (bn, splits, kslice of QKV, proj,
// fc, cproj: ops/decode_step.py::linear_plan at B*T rows).  Returns the
// first error that is not 0.
extern "C" int gic_prefill(int dtype, int L, int B, int T, int D, int H, float eps, void* x32,
                           const void* qkvw, const void* projw, const void* fcw,
                           const void* cprojw, const void* attnb, const void* projb,
                           const void* fcb, const void* cprojb, const void* ln1s,
                           const void* ln1b, const void* ln2s, const void* ln2b, void* k_cache,
                           void* v_cache, int cache_t, void* qkvbuf, void* abuf, void* hbuf,
                           const int* plans, void* stream) {
  using namespace gic;
  if (L <= 0 || B <= 0 || T <= 0 || T > kPreMaxT || T > cache_t || H <= 0 || D % H ||
      D / H > kPreMaxHd || !plans)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* x = static_cast<float*>(x32);
#define GIC_PREFILL(TYPE)                                                                     \
  run<TYPE>(s, L, B, T, D, H, eps, x, static_cast<const TYPE*>(qkvw),                         \
            static_cast<const TYPE*>(projw), static_cast<const TYPE*>(fcw),                    \
            static_cast<const TYPE*>(cprojw), f(attnb), f(projb), f(fcb), f(cprojb), f(ln1s), \
            f(ln1b), f(ln2s), f(ln2b), static_cast<TYPE*>(k_cache),                            \
            static_cast<TYPE*>(v_cache), cache_t, static_cast<TYPE*>(qkvbuf),                  \
            static_cast<TYPE*>(abuf), static_cast<TYPE*>(hbuf), plans)
  if (dtype == kBF16) return GIC_PREFILL(__nv_bfloat16);
  if (dtype == kF32) return GIC_PREFILL(float);
#undef GIC_PREFILL
  return (int)cudaErrorInvalidValue;
}
