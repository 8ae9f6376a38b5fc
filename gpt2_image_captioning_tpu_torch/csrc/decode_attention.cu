// Single-token decode attention over the valid prefix of one layer's KV cache,
// fused with the cache append, optionally reading each position's row
// through a beam-ancestry map, or over a per-row window [start_r, idx).
//
// Replaces: gpt2_image_captioning_tpu/ops/decode_attention.py::_decode_kernel
// (:68) and the attention() of ops/decode_step.py::_step_kernel (:292-517),
// with its beam mode (origin + gather_start, :134-138, :371-456, :488-503).
// Each (batch row, head) attends cache rows [0, idx) with an online softmax,
// then folds in this step's own K/V row straight from its inputs
// (decode_attention.py:157-172); the new K/V row is written into row idx of
// the (T, B, D) caches in place.  idx = 0 attends the new row alone.  With
// an origin map (T, B) int32, row r reads position t from cache row
// origin[t, r] for gather_start <= t < idx (beam search: the history a beam
// inherited from its ancestors), and from row r below gather_start (the
// image prefix every beam of a group shares).  With a (B,) int32 start
// vector (continuous batching: the step kernel's start and blk_c0,
// :113-119, :226-229, :462-465), row r attends only [start_r, idx) and its
// own new row; start_r == idx is a dead row that attends its new row alone.
//
// Bound on the H100: reading the cache, 2 * idx * B * D elements per layer
// (25 MB in bf16 at idx 64, B 128, D 768 — more than the layer's weights;
// 63 MB at idx 40, B 512 in beam search); with start, 2 * (idx - start_r) * D
// per row (continuous serving reads only the live windows); int8 caches
// read half those bytes plus a 4-byte scale per row read.
//
// Design: one block of kWarps warps per (batch row, head).  A head's cache
// row is hd contiguous elements (128 bytes in bf16 at hd 64), read whole in
// vectors of VB = 16 bytes (8 in int8, so that a lane keeps 8 float64 sums,
// not 16): a group of lpp = hd * sizeof(C) / VB lanes holds one position (8
// lanes in bf16 and int8, 16 in float32 at hd 64), so one warp load
// instruction covers 32 / lpp positions, and a position's score is a
// log2(lpp)-step xor reduction inside its group.  The block's warps deal
// the window's positions out in turn, kGroups loads a warp a pass: every K
// and V row of a pass (and its int8 scales) is loaded before any is
// reduced, so a pass costs one memory latency, not a K trip and then a V
// trip, and a lane keeps 2 * kGroups 16-byte loads in flight.  A warp keeps
// one online softmax: each pass's scores are maximised over the whole warp,
// each lane group sums its positions' l and acc (over its lane's elements)
// against that shared max, and the groups of a warp merge by xor-shuffled
// sums, the warps through shared memory, where the block's first threads
// fold in the new row.  So a lane takes one float64 exp a position and one
// a pass, and none to merge.  The ancestry
// map is read once per (position, row): by the lanes of that position's
// group, in one load.  The start window is the Hopper form of both start and
// blk_c0: each row's walk begins at its own start_r, so a row skips its
// whole dead history.  Head rows that miss the vector (hd * sizeof(C) not a
// multiple of VB, e.g. hd 42; GPT-2's hd 64 and the tiny configs' hd 16
// and 64 are multiples) take the same walk with one element a lane and a
// position a warp load.
//
// Numerics: the scores, the softmax, the p·v sums and the merges of the
// groups and warps run in float64 (in bf16 each q·k product is exact in
// float32 and only summed in float64), and the output is rounded once, to
// float32 and then to the compute dtype.  The result is then that of exact
// arithmetic on the rounded inputs to within ~1e-16, whatever the order of
// the sums, so the plain twin (ops/decode_attention.py::
// _decode_attention_plain), which computes it in float64 too, rounds to the
// same value.  In the int8 step a one-ulp difference in the attention
// output crosses a quantization step now and then, and the step's later
// layers carry that on (0.06 of a logit in one step at GPT-2 124M, b 128);
// a float32 sum in any order but the twin's parts from it so.  float64 on
// the H100 runs at half the float32 rate, and this walk is bound by its
// loads, not by its math, as long as the per-element conversions stay off
// the quarter-rate converter: one float-to-double a cache element (int8
// bytes and the bf16 rounding of the dequantized value are done with
// integer and float32 ops).
//
// int8 KV cache (the step kernel's cache_quant mode, :311-323, :404-409):
// the caches hold int8 rows with a float32 scale per (position, batch row)
// in (T, B) arrays.  The new K and V rows are quantized over their whole D,
// all heads together, as csrc/rowquant.cu does (scale max(max|v| / 127,
// 1e-12), q = rint(v / scale)): each head's block reads the whole new row
// (D elements, from L2), takes its absmax, and writes its own head's int8
// elements into row idx; head 0's block writes the row's scale.  The walk
// reads int8 rows and each position's scale (through the ancestry map's row
// too) and dequantizes as the TPU kernel does, in the compute dtype:
// to_cdt(float(q) * to_cdt(scale)).  The new row's own term uses the exact
// k_new / v_new.  The cache bytes halve (12.6 MB at idx 64, B 128, D 768)
// plus 4 bytes a row for the scales, and the call is one launch.
#include "common.cuh"

namespace gic {

constexpr int kWarps = 4;         // warps per (batch row, head)
constexpr int kThreads = 32 * kWarps;
// blocks an SM the registers must allow: 6 (80 registers a thread, a few
// bytes spilled in the int8 and float32 walks) read the B 512 modes faster
// on an H100 than the 4 that 100-170 registers allow, and the rest no slower
constexpr int kMinBlocks = 6;
constexpr int kMaxHd = 128;       // head dim up to 128
// bytes a lane loads at once in the vector walk: 16 (8 bf16, 4 float32), 8
// for int8 caches, whose 8 elements a lane keep the float64 sums (16 of
// them) in registers
template <typename C> constexpr int kVectorBytes = std::is_same<C, int8_t>::value ? 8 : 16;
constexpr double kNegInf = -3.4028234663852886e38;  // float32 minimum, the mask value

template <int VB> struct Vec;
template <> struct Vec<16> { using type = uint4; };
template <> struct Vec<8> { using type = uint2; };
template <> struct Vec<4> { using type = uint32_t; };
template <> struct Vec<2> { using type = uint16_t; };
template <> struct Vec<1> { using type = uint8_t; };

// The E cache elements of one loaded vector as the walk uses them: C = T
// as stored; C = int8_t dequantized with its row's scale ``s`` (already
// rounded to T) as the TPU kernel does, to_cdt(float(q) * s).  In the
// vector walk a byte q becomes float exactly as the bits 0x4B0000uu, u = q
// + 128, less 2^23 + 128 (a byte permute and an add), and a pair of
// products rounds to bf16 in one cvt.rn.bf16x2, read back by two shifts:
// the quarter-rate converter and the integer pipe stay off the walk's
// critical path.
template <typename T, typename C, int VB>
__device__ __forceinline__ void cache_values(const typename Vec<VB>::type& v, float s,
                                             float (&x)[VB / sizeof(C)]) {
  constexpr int E = VB / sizeof(C);
  if constexpr (std::is_same<C, int8_t>::value && VB >= 4) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const uint32_t bits = __byte_perm(w[e / 4] ^ 0x80808080u, 0x4B000000u, 0x7540u | (e % 4));
      x[e] = __fsub_rn(__uint_as_float(bits), 8388736.f) * s;
    }
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
      for (int e = 0; e < E; e += 2) {
        const __nv_bfloat162 r = __floats2bfloat162_rn(x[e], x[e + 1]);
        const uint32_t u = *reinterpret_cast<const uint32_t*>(&r);
        x[e] = __uint_as_float(u << 16);
        x[e + 1] = __uint_as_float(u & 0xFFFF0000u);
      }
    }
  } else {
    const C* c = reinterpret_cast<const C*>(&v);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if constexpr (std::is_same<C, int8_t>::value) x[e] = to_f32(from_f32<T>((float)c[e] * s));
      else x[e] = to_f32(c[e]);
    }
  }
}

// T: the compute dtype; C: the cache element type (T, or int8_t with the
// (T, B) scale arrays ks / vs); VB: bytes a lane loads at once, kVectorBytes
// for the vector walk, sizeof(C) for one element.
template <typename T, typename C, bool kOrigin, int VB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_attention_kernel(const T* q, const T* kn, const T* vn, int in_stride, C* kc, C* vc, T* out,
                        int B, int D, int H, int idx, double scale, const int* origin,
                        int gather_start, const int* start, float* ks, float* vs) {
  constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  constexpr bool kVector = VB > (int)sizeof(C);
  constexpr int E = VB / (int)sizeof(C);            // elements a lane loads at once
  constexpr int NV = kVector ? 1 : kMaxHd / 32;     // loads a lane makes a row
  constexpr int kGroups = kVector && E <= 8 ? 4 : 2;  // warp loads a pass
  using V = typename Vec<VB>::type;

  __shared__ double s_acc[kWarps][kMaxHd];
  __shared__ double s_m[kWarps], s_l[kWarps];
  __shared__ double s_new;  // this step's own score

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hd = D / H;
  const size_t trow = (size_t)B * D;  // elements between consecutive time rows of a cache
  const size_t hoff = (size_t)h * hd;
  const size_t in_off = (size_t)b * in_stride + hoff;
  const size_t row_idx = (size_t)idx * trow + (size_t)b * D + hoff;  // the appended head row

  // the new row's own score, by warp 0
  if (warp == 0) {
    double d = 0.0;
    for (int j = lane; j < hd; j += 32)
      d = fma((double)to_f32(q[in_off + j]), (double)to_f32(kn[in_off + j]), d);
    d = warp_sum(d);
    if (lane == 0) s_new = d * scale;
  }
  // the append of the new K row (warp 1) and V row (warp 2); only rows < idx
  // are read, so no block races it
  auto append = [&]() {
    if (warp != 1 && warp != 2) return;
    const T* x = warp == 1 ? kn : vn;
    C* cache = warp == 1 ? kc : vc;
    if constexpr (kInt8) {
      // rowquant.cu's formula over the row's whole D, this head's elements
      // written; the row read in 16-byte vectors where it is aligned
      const T* row = x + (size_t)b * in_stride;
      constexpr int RE = 16 / sizeof(T);
      float mx = 0.f;
      if (D % RE == 0 && reinterpret_cast<uintptr_t>(row) % 16 == 0) {
        for (int k = lane * RE; k < D; k += 32 * RE) {
          const uint4 v = *reinterpret_cast<const uint4*>(row + k);
          const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
          for (int i = 0; i < RE; ++i) mx = fmaxf(mx, fabsf(to_f32(e[i])));
        }
      } else {
        for (int k = lane; k < D; k += 32) mx = fmaxf(mx, fabsf(to_f32(row[k])));
      }
      const float s = fmaxf(warp_max(mx) * kInv127, kMinScale);
      for (int j = lane; j < hd; j += 32)
        cache[row_idx + j] = (int8_t)rintf(__fdiv_rn(to_f32(row[hoff + j]), s));
      if (h == 0 && lane == 0) (warp == 1 ? ks : vs)[(size_t)idx * B + b] = s;
    } else {
      for (int j = lane; j < hd; j += 32) cache[row_idx + j] = x[in_off + j];
    }
  };
  append();

  // lane groups: lpp lanes a position (a power of two; lanes past hd idle)
  int lpp = 32;
  if constexpr (kVector) {
    const int need = hd * (int)sizeof(C) / VB;
    lpp = 1;
    while (lpp < need) lpp *= 2;
  }
  const int ppw = 32 / lpp;  // positions a warp load
  const int grp = lane / lpp, lig = lane % lpp;

  // this lane's elements of q: in bf16 a product of q and a cache value
  // (both bf16, 8 significant bits each) is exact in float32, so only its
  // sum needs float64; float32 products are taken in float64, q widened once
  using QT = typename std::conditional<std::is_same<T, float>::value, double, float>::type;
  QT qv[NV * E];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int j = (v * lpp + lig) * E + e;
      qv[v * E + e] = j < hd ? (QT)to_f32(q[in_off + j]) : (QT)0;
    }
  double acc[NV * E];
#pragma unroll
  for (int e = 0; e < NV * E; ++e) acc[e] = 0.0;
  double m = kNegInf, l = 0.0;

  const int lo = start ? min(max(start[b], 0), idx) : 0;
  const int stride = kWarps * ppw;  // positions between a warp's consecutive loads
  for (int base = lo + warp * ppw; base < idx; base += stride * kGroups) {
    bool live[kGroups];
    size_t roff[kGroups];
    float ksc[kGroups], vsc[kGroups];
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int t = base + i * stride + grp;
      live[i] = t < idx;
      int src = b;
      if (kOrigin && live[i] && t >= gather_start) src = origin[(size_t)t * B + b];
      roff[i] = (size_t)t * trow + (size_t)src * D + hoff;
      ksc[i] = vsc[i] = 0.f;
      if constexpr (kInt8) {
        if (live[i]) {
          ksc[i] = to_f32(from_f32<T>(ks[(size_t)t * B + src]));
          vsc[i] = to_f32(from_f32<T>(vs[(size_t)t * B + src]));
        }
      }
    }
    // every K and V load of the pass in flight before any is used
    V kr[kGroups][NV], vr[kGroups][NV];
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int j = (v * lpp + lig) * E;
        const bool in = live[i] && j < hd;
        kr[i][v] = in ? *reinterpret_cast<const V*>(kc + roff[i] + j) : V{};
        vr[i][v] = in ? *reinterpret_cast<const V*>(vc + roff[i] + j) : V{};
      }
    double s[kGroups];
    double cmax = kNegInf;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      double d = 0.0;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float kx[E];
        cache_values<T, C, VB>(kr[i][v], ksc[i], kx);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if constexpr (std::is_same<QT, float>::value)
            d += (double)__fmul_rn(qv[v * E + e], kx[e]);
          else
            d = fma(qv[v * E + e], (double)kx[e], d);
        }
      }
      for (int o = lpp / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      s[i] = live[i] ? d * scale : kNegInf;
      cmax = fmax(cmax, s[i]);
    }
    // one running max for the whole warp, so its lane groups merge below
    // by plain sums, with no rescaling
    for (int o = lpp; o < 32; o <<= 1) cmax = fmax(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
    const double m_new = fmax(m, cmax);
    const double alpha = exp(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < NV * E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const double p = live[i] ? exp(s[i] - m_new) : 0.0;
      l += p;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float vx[E];
        cache_values<T, C, VB>(vr[i][v], vsc[i], vx);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[v * E + e] = fma(p, (double)vx[e], acc[v * E + e]);
      }
    }
    m = m_new;
  }

  // the warp's lane groups merged: they share m, so their l and acc add up
  // (every group ends with the warp's sums)
  for (int o = lpp; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int e = 0; e < NV * E; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (grp == 0) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = (v * lpp + lig) * E + e;
        if (j < hd) s_acc[warp][j] = acc[v * E + e];
      }
    if (lane == 0) {
      s_m[warp] = m;
      s_l[warp] = l;
    }
  }
  __syncthreads();

  // the warps merged and this step's own row folded in, from its inputs
  for (int j = threadIdx.x; j < hd; j += kThreads) {
    const double sn = s_new;
    double mm = sn;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmax(mm, s_m[w]);
    const double pn = exp(sn - mm);
    double sum_l = pn, sum_a = pn * (double)to_f32(vn[in_off + j]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const double a = exp(s_m[w] - mm);
      sum_l = fma(s_l[w], a, sum_l);
      sum_a = fma(s_acc[w][j], a, sum_a);
    }
    out[(size_t)b * D + hoff + j] = from_f32<T>((float)(sum_a / sum_l));
  }
}

template <typename T, typename C, bool kOrigin, int VB>
static void launch(const void* q, const void* kn, const void* vn, int in_stride, void* kc,
                   void* vc, void* out, int B, int D, int H, int idx, const int* origin,
                   int gather_start, const int* start, float* ks, float* vs, cudaStream_t s) {
  const double scale = 1.0 / sqrt((double)(D / H));
  decode_attention_kernel<T, C, kOrigin, VB><<<B * H, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn), static_cast<const T*>(vn), in_stride,
      static_cast<C*>(kc), static_cast<C*>(vc), static_cast<T*>(out), B, D, H, idx, scale, origin,
      gather_start, start, ks, vs);
}

// the vector walk when every head row of the caches starts on a boundary of
// its vector, else one element a lane
template <typename T, typename C, bool kOrigin>
static void dispatch_route(const void* q, const void* kn, const void* vn, int in_stride, void* kc,
                           void* vc, void* out, int B, int D, int H, int idx, const int* origin,
                           int gather_start, const int* start, float* ks, float* vs,
                           cudaStream_t s) {
  constexpr int VB = kVectorBytes<C>;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc);
  const bool aligned = (D / H) * sizeof(C) % VB == 0 && bases % VB == 0;
  if (aligned)
    launch<T, C, kOrigin, VB>(q, kn, vn, in_stride, kc, vc, out, B, D, H, idx, origin,
                              gather_start, start, ks, vs, s);
  else
    launch<T, C, kOrigin, (int)sizeof(C)>(q, kn, vn, in_stride, kc, vc, out, B, D, H, idx,
                                          origin, gather_start, start, ks, vs, s);
}

template <typename T, typename C>
static void dispatch(const void* q, const void* kn, const void* vn, int in_stride, void* kc,
                     void* vc, void* out, int B, int D, int H, int idx, const int* origin,
                     int gather_start, const int* start, float* ks, float* vs, cudaStream_t s) {
  if (origin)
    dispatch_route<T, C, true>(q, kn, vn, in_stride, kc, vc, out, B, D, H, idx, origin,
                               gather_start, nullptr, ks, vs, s);
  else
    dispatch_route<T, C, false>(q, kn, vn, in_stride, kc, vc, out, B, D, H, idx, nullptr, 0,
                                start, ks, vs, s);
}

template <typename T>
static void dispatch_cache(const void* q, const void* kn, const void* vn, int in_stride,
                           void* kc, void* vc, void* out, int B, int D, int H, int idx,
                           const int* origin, int gather_start, const int* start, float* ks,
                           float* vs, cudaStream_t s) {
  if (ks)
    dispatch<T, int8_t>(q, kn, vn, in_stride, kc, vc, out, B, D, H, idx, origin, gather_start,
                        start, ks, vs, s);
  else
    dispatch<T, T>(q, kn, vn, in_stride, kc, vc, out, B, D, H, idx, origin, gather_start, start,
                   nullptr, nullptr, s);
}

}  // namespace gic

// q/k_new/v_new: (B, D) rows with row stride in_stride (elements), unit
// column stride; k_cache/v_cache: (T, B, D) contiguous, row idx < T is
// written; out: (B, D).  All in the element type.  origin: (T, B) int32
// contiguous with entries in [0, B), or null; gather_start: the first
// position read through it.  start: (B,) int32 first live position of each
// row (<= idx), or null for 0; never together with origin.  k_scale /
// v_scale: null, or the (T, B) float32 per-row scales of int8 caches, whose
// row idx the call writes with the quantized new rows.  One launch; returns
// cudaGetLastError().
extern "C" int gic_decode_attention(int dtype, const void* q, const void* kn, const void* vn,
                                    int in_stride, void* kc, void* vc, void* out, int B, int D,
                                    int H, int idx, const void* origin, int gather_start,
                                    const void* start, void* k_scale, void* v_scale,
                                    void* stream) {
  using namespace gic;
  if (B <= 0 || H <= 0 || D % H != 0 || D / H > kMaxHd || idx < 0 || gather_start < 0 ||
      (origin && start) || (!k_scale != !v_scale))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(origin);
  const int* st = static_cast<const int*>(start);
  float* ks = static_cast<float*>(k_scale);
  float* vs = static_cast<float*>(v_scale);
  if (dtype == kBF16)
    dispatch_cache<__nv_bfloat16>(q, kn, vn, in_stride, kc, vc, out, B, D, H, idx, o,
                                  gather_start, st, ks, vs, s);
  else if (dtype == kF32)
    dispatch_cache<float>(q, kn, vn, in_stride, kc, vc, out, B, D, H, idx, o, gather_start, st,
                          ks, vs, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
