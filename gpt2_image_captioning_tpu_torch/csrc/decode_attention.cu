// Single-token decode attention over the valid prefix of one layer's KV cache,
// fused with the cache append, optionally reading each position's row
// through a beam-ancestry map, or over a per-row window [start_r, idx).
//
// Replaces: gpt2_image_captioning_tpu/ops/decode_attention.py::_decode_kernel
// (:68) and the attention() of ops/decode_step.py::_step_kernel (:292-517),
// with its beam mode (origin + gather_start, :134-138, :371-456, :488-503).
// Each (batch row, head) attends cache rows [0, idx) walked in 16-row chunks
// with an online softmax, then folds in this step's own K/V row
// straight from its inputs (decode_attention.py:157-172); the new K/V row is
// written into row idx of the (T, B, D) caches in place.  idx = 0 attends the
// new row alone.  With an origin map (T, B) int32, row r reads position t
// from cache row origin[t, r] for gather_start <= t < idx (beam search: the
// history a beam inherited from its ancestors), and from row r below
// gather_start (the image prefix every beam of a group shares).  With a
// (B,) int32 start vector (continuous batching: the step kernel's start and
// blk_c0, :113-119, :226-229, :462-465), row r attends only [start_r, idx)
// and its own new row; start_r == idx is a dead row that attends its new row
// alone.
//
// Bound on the H100: reading the cache, 2 * idx * B * D elements per layer
// (25 MB in bf16 at idx 64, B 128, D 768 — more than the layer's weights;
// 63 MB at idx 40, B 512 in beam search); with start, 2 * (idx - start_r) * D
// per row (continuous serving reads only the live windows); int8 caches
// read half those bytes plus a 4-byte scale per row read.
//
// Design: one warp per (batch row, head), the head's hd <= 128 elements
// spread over the lanes (lane + 32 e).  A chunk's 16 rows are loaded before
// any of them is reduced, so each lane keeps 16 independent loads in flight;
// a row of one head is hd contiguous elements (128 bytes in bf16 at hd 64).
// Rows >= idx inside the last chunk are never loaded.  The TPU kernel's
// head-sum matrices and DMA double-buffering are not carried over: the lanes
// hold the head dimension, so the per-head sum is a warp shuffle reduction.
// The ancestry map is one indexed load per (position, row): the TPU's
// one-hot permutation matmul and shifted selects existed because a TPU
// kernel cannot gather rows; a warp can read any row.  The kernel is a
// template on whether a map is given, so greedy decoding carries no map
// lookups.  The start window is the Hopper form of both start and blk_c0:
// each warp begins its walk at the chunk holding its own row's start_r and
// masks the positions below it, so every (row, head) skips its own dead
// history; the TPU's per-batch-block first live chunk has no separate
// counterpart.
//
// Numerics: the scores, the softmax and the p·v sums run in float64 and the
// output is rounded once, to float32 and then to the compute dtype.  The
// result is then that of exact arithmetic on the rounded inputs to within
// ~1e-16, whatever the order of the sums, so the plain twin
// (ops/decode_attention.py::_decode_attention_plain), which computes it in
// float64 too, rounds to the same value.  In the int8 step a one-ulp
// difference in the attention output crosses a quantization step now and
// then, and the step's later layers carry that on (0.06 of a logit in one
// step at GPT-2 124M, b 128); the float32 form of the TPU kernel parts from
// any other order so.  float64 on the H100 runs at half the float32 rate,
// and this walk is bound by its loads and its latency, not by its math.
//
// int8 KV cache (the step kernel's cache_quant mode, :311-323, :404-409):
// the caches hold int8 rows with a float32 scale per (position, batch row)
// in (T, B) arrays.  The new K and V rows are quantized over their whole D,
// all heads together, so one warp per (row, head) cannot scale them alone:
// the call's first two launches are rowquant.cu on k_new and v_new, writing
// the int8 rows into row idx of the caches and their scales into row idx of
// the scale arrays.  The walk then reads int8 rows and each position's scale
// (through the ancestry map's row too) and dequantizes as the TPU kernel
// does, in the compute dtype: to_cdt(float(q) * to_cdt(scale)).  The new
// row's own term still uses the exact k_new / v_new from registers.  The
// cache bytes halve (12.6 MB at idx 64, B 128, D 768) plus 4 bytes a row
// for the scales.
#include "common.cuh"

namespace gic {

constexpr int kChunk = 16;        // cache rows per step of the walk (ops/decode_attention.CHUNK_T)
static_assert(kChunk == 16, "the score reduction leaves position c in lanes 2c and 2c + 1");
constexpr int kMaxPerLane = 4;    // head dim up to 4 * 32 = 128
constexpr int kWarpsPerBlock = 4;
constexpr float kNegInf = -3.4028234663852886e38f;  // float32 minimum, the mask value

// A cache element as the walk uses it: C = T as stored, C = int8_t
// dequantized with its row's scale ``s``, already rounded to T.
template <typename T, typename C>
__device__ __forceinline__ float cache_value(C x, float s) {
  if constexpr (std::is_same<C, int8_t>::value) return to_f32(from_f32<T>((float)x * s));
  else return to_f32(x);
}

// T: the compute dtype; C: the cache element type (T, or int8_t with the
// (T, B) scale arrays ks / vs).
template <typename T, typename C, bool kOrigin>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
decode_attention_kernel(const T* q, const T* kn, const T* vn, int in_stride, C* kc, C* vc, T* out,
                        int B, int D, int H, int idx, double scale, const int* origin,
                        int gather_start, const int* start, const float* ks, const float* vs) {
  constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pair = blockIdx.x * kWarpsPerBlock + warp;
  if (pair >= B * H) return;
  const int b = pair / H, h = pair % H;
  const int hd = D / H;
  const size_t trow = (size_t)B * D;  // elements between consecutive time rows of a cache
  const size_t off = (size_t)b * D + (size_t)h * hd;
  const size_t hoff = (size_t)h * hd;
  const size_t in_off = (size_t)b * in_stride + (size_t)h * hd;

  float qv[kMaxPerLane], knv[kMaxPerLane], vnv[kMaxPerLane];
  double acc[kMaxPerLane];
#pragma unroll
  for (int e = 0; e < kMaxPerLane; ++e) {
    const int j = lane + 32 * e;
    const bool in = j < hd;
    qv[e] = in ? to_f32(q[in_off + j]) : 0.f;
    knv[e] = in ? to_f32(kn[in_off + j]) : 0.f;
    vnv[e] = in ? to_f32(vn[in_off + j]) : 0.f;
    acc[e] = 0.0;
    if constexpr (!kInt8) {  // int8 caches: appended by the call's quantizing launches
      if (in) {  // the append: only rows < idx are read below, so no warp races it
        kc[(size_t)idx * trow + off + j] = kn[in_off + j];
        vc[(size_t)idx * trow + off + j] = vn[in_off + j];
      }
    }
  }

  // this row's window [lo, idx); the walk starts at the chunk holding lo, so
  // every chunk it visits holds at least one live position
  const int lo = start ? min(max(start[b], 0), idx) : 0;
  const int first = lo < idx ? lo / kChunk * kChunk : idx;
  double m = kNegInf, l = 0.0;
  for (int t0 = first; t0 < idx; t0 += kChunk) {
    double s[kChunk];
    size_t roff[kChunk];  // offset of the cache row position t0 + c is read from
    float kcs[kChunk], vcs[kChunk];  // int8: that row's scales, rounded to T
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int t = t0 + c;
      int src = b;
      if (kOrigin && t >= gather_start && t < idx) src = origin[(size_t)t * B + b];
      roff[c] = (size_t)src * D + hoff;
      kcs[c] = vcs[c] = 0.f;
      if constexpr (kInt8) {
        if (t < idx) {
          kcs[c] = to_f32(from_f32<T>(ks[(size_t)t * B + src]));
          vcs[c] = to_f32(from_f32<T>(vs[(size_t)t * B + src]));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int t = t0 + c;
      double d = 0.0;
      if (t >= lo && t < idx) {
        const C* krow = kc + (size_t)t * trow + roff[c];
#pragma unroll
        for (int e = 0; e < kMaxPerLane; ++e) {
          const int j = lane + 32 * e;
          if (j < hd) d = fma((double)qv[e], (double)cache_value<T, C>(krow[j], kcs[c]), d);
        }
      }
      s[c] = d;
    }
    // the chunk's 16 sums over the lanes, halving the values a lane holds
    // at each step: afterwards lanes 2c and 2c + 1 hold position c's score,
    // so each lane takes one exp a chunk, not 16
#pragma unroll
    for (int half = kChunk / 2; half >= 1; half /= 2) {
      const bool upper = lane & (2 * half);
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const double send = upper ? s[i] : s[i + half];
        s[i] = (upper ? s[i + half] : s[i]) + __shfl_xor_sync(0xffffffffu, send, 2 * half);
      }
    }
    const int mine = lane >> 1;
    const bool live = t0 + mine >= lo && t0 + mine < idx;
    const double score = (s[0] + __shfl_xor_sync(0xffffffffu, s[0], 1)) * scale;
    double cmax = live ? score : kNegInf;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cmax = fmax(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
    const double m_new = fmax(m, cmax);
    const double alpha = exp(m - m_new);
    const double p_mine = live ? exp(score - m_new) : 0.0;
    l *= alpha;
#pragma unroll
    for (int e = 0; e < kMaxPerLane; ++e) acc[e] *= alpha;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int t = t0 + c;
      const double p = __shfl_sync(0xffffffffu, p_mine, 2 * c);
      if (t >= lo && t < idx) {
        l += p;
        const C* vrow = vc + (size_t)t * trow + roff[c];
#pragma unroll
        for (int e = 0; e < kMaxPerLane; ++e) {
          const int j = lane + 32 * e;
          if (j < hd) acc[e] = fma(p, (double)cache_value<T, C>(vrow[j], vcs[c]), acc[e]);
        }
      }
    }
    m = m_new;
  }

  // epilogue: this step's own row, from registers
  double d = 0.0;
#pragma unroll
  for (int e = 0; e < kMaxPerLane; ++e) d = fma((double)qv[e], (double)knv[e], d);
  const double s_new = warp_sum(d) * scale;
  const double m_f = fmax(m, s_new);
  const double p_new = exp(s_new - m_f);
  const double alpha = exp(m - m_f);
  l = l * alpha + p_new;
#pragma unroll
  for (int e = 0; e < kMaxPerLane; ++e) {
    const int j = lane + 32 * e;
    if (j < hd)
      out[(size_t)b * D + (size_t)h * hd + j] =
          from_f32<T>((float)((acc[e] * alpha + p_new * vnv[e]) / l));
  }
}

}  // namespace gic

namespace gic {

template <typename T, typename C, bool kOrigin>
static void launch(const void* q, const void* kn, const void* vn, int in_stride, void* kc,
                   void* vc, void* out, int B, int D, int H, int idx, const int* origin,
                   int gather_start, const int* start, const float* ks, const float* vs,
                   cudaStream_t s) {
  const double scale = 1.0 / sqrt((double)(D / H));
  const int blocks = (B * H + kWarpsPerBlock - 1) / kWarpsPerBlock;
  decode_attention_kernel<T, C, kOrigin><<<blocks, 32 * kWarpsPerBlock, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn), static_cast<const T*>(vn), in_stride,
      static_cast<C*>(kc), static_cast<C*>(vc), static_cast<T*>(out), B, D, H, idx, scale, origin,
      gather_start, start, ks, vs);
}

template <typename T, typename C>
static void dispatch_map(const void* q, const void* kn, const void* vn, int in_stride, void* kc,
                         void* vc, void* out, int B, int D, int H, int idx, const int* origin,
                         int gather_start, const int* start, const float* ks, const float* vs,
                         cudaStream_t s) {
  if (origin)
    launch<T, C, true>(q, kn, vn, in_stride, kc, vc, out, B, D, H, idx, origin, gather_start,
                       nullptr, ks, vs, s);
  else
    launch<T, C, false>(q, kn, vn, in_stride, kc, vc, out, B, D, H, idx, nullptr, 0, start, ks,
                        vs, s);
}

template <typename T>
static void dispatch(const void* q, const void* kn, const void* vn, int in_stride, void* kc,
                     void* vc, void* out, int B, int D, int H, int idx, const int* origin,
                     int gather_start, const int* start, float* ks, float* vs, cudaStream_t s) {
  if (!ks) {
    dispatch_map<T, T>(q, kn, vn, in_stride, kc, vc, out, B, D, H, idx, origin, gather_start,
                       start, nullptr, nullptr, s);
    return;
  }
  // the int8 append: each new row quantized over its D into row idx
  const size_t row = (size_t)idx * B;
  launch_rowquant<T, false>(s, kn, in_stride, nullptr, nullptr, 0.f, B, D,
                            static_cast<int8_t*>(kc) + row * D, D, ks + row);
  launch_rowquant<T, false>(s, vn, in_stride, nullptr, nullptr, 0.f, B, D,
                            static_cast<int8_t*>(vc) + row * D, D, vs + row);
  dispatch_map<T, int8_t>(q, kn, vn, in_stride, kc, vc, out, B, D, H, idx, origin, gather_start,
                          start, ks, vs, s);
}

}  // namespace gic

// q/k_new/v_new: (B, D) rows with row stride in_stride (elements), unit
// column stride; k_cache/v_cache: (T, B, D) contiguous, row idx < T is
// written; out: (B, D).  All in the element type.  origin: (T, B) int32
// contiguous with entries in [0, B), or null; gather_start: the first
// position read through it.  start: (B,) int32 first live position of each
// row (<= idx), or null for 0; never together with origin.  k_scale /
// v_scale: null, or the (T, B) float32 per-row scales of int8 caches, whose
// row idx the call writes (three launches then, one otherwise).  Returns
// cudaGetLastError().
extern "C" int gic_decode_attention(int dtype, const void* q, const void* kn, const void* vn,
                                    int in_stride, void* kc, void* vc, void* out, int B, int D,
                                    int H, int idx, const void* origin, int gather_start,
                                    const void* start, void* k_scale, void* v_scale,
                                    void* stream) {
  using namespace gic;
  if (B <= 0 || H <= 0 || D % H != 0 || D / H > 32 * kMaxPerLane || idx < 0 || gather_start < 0 ||
      (origin && start) || (!k_scale != !v_scale))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(origin);
  const int* st = static_cast<const int*>(start);
  float* ks = static_cast<float*>(k_scale);
  float* vs = static_cast<float*>(v_scale);
  if (dtype == kBF16)
    dispatch<__nv_bfloat16>(q, kn, vn, in_stride, kc, vc, out, B, D, H, idx, o, gather_start, st,
                            ks, vs, s);
  else if (dtype == kF32)
    dispatch<float>(q, kn, vn, in_stride, kc, vc, out, B, D, H, idx, o, gather_start, st, ks, vs,
                    s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
