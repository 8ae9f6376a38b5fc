// Flash-attention forward: softmax(q k^T / sqrt(hd) + masks) v, with the
// (Tq, Tk) scores kept on chip.  The kernel and its launch; the dispatch and
// the C entry are in flash_attention.cu, the wide head dims' instantiations
// in flash_attention_hd{128,160,208}.cu and flash_attention_hd208_bf16.cu:
// each compiles in an nvcc process of its own, in parallel (a build at hd
// 208 unrolls 26 column tiles of the O accumulator; one file took 34 s).
//
// Replaces: gpt2_image_captioning_tpu/ops/attention.py::_flash_kernel (:40),
// reached through flash_attention (:156) and the dispatcher mha (:195).  It
// computes what that kernel computes: float32 scores of the rows, scaled by
// 1/sqrt(hd); causal masking with a static q_offset (query i sees keys
// <= q_offset + i); a (B, Tk) key mask; an online float32 softmax.  A row
// with no valid key takes the uniform softmax over the Tk keys, the mean of
// v, as the JAX package's attention_xla does (its masked scores are all the
// float32 minimum) and its Pallas kernel does wherever Tk fills a key block.
// The backward stays torch ops (ops/attention.py::FlashAttention), as the
// reference's stays XLA.
//
// Bound on the H100: bytes.  Reading q, k, v and writing the output once is
// 4 B H T hd elements (ViT-B/16 at b 128, T 197: 155 MB in bf16, 46 us at
// 3.35 TB/s); the products are 4 hd flops per (query, key) pair, 15 GFLOP
// there, 16 us on the tensor cores.  On an H100 this kernel takes 0.165 ms
// there (SDPA 0.088), of which the copies and the store alone take 0.077:
// at 2 blocks of 7 warps an SM (128 registers a thread) the copies and the
// MMAs do not overlap.  A TMA producer warp would free the copies'
// registers for a third block.
//
// Head dims: 64 (GPT-2 124M, the towers), 96 (config.yml's mapper: 768 / 8
// heads), 128, 160 and 208 (the mapper at GPT-2 medium, large and XL: 1024,
// 1280 and 1600 over 8 heads; XL's 200 is zero-padded to 208 by the
// wrapper, which passes 200 for the scale).  A thread's O accumulator is
// hd / 8 x 4 floats: 80 at 160 and 104 at 208, beside 32 scores (and, in
// float, 64 TF32 halves of P), so the wide float builds spill; their ring
// and query rows also outgrow shared memory at 8 warps, and `launch` then
// gives a block fewer warps.
//
// Design (FlashAttention-2's on mma.sync):
//   - a block owns `rows` query rows of one (batch row, head), 16 per warp,
//     up to 8 warps; ops/attention.py::flash_plan sizes it so that the
//     q-tiles of a head split Tq evenly (T 197: 2 blocks of 112 rows), so
//     K and V are read ceil(Tq / 128) times a head, and a block computes at
//     most 15 rows past Tq (a warp whose rows all lie past Tq skips the
//     MMAs);
//   - K, V and the key mask stream through a ring of STAGES 64-key tiles in
//     shared memory, filled with cp.async (16-byte copies, zero-filled past
//     Tk) STAGES - 1 tiles ahead, so a tile's copy overlaps the MMAs of the
//     tiles before it; one barrier a tile;
//   - each warp keeps its 16 rows' scores S, their running (max, sum) and
//     the O accumulator in registers; row statistics reduce over the four
//     lanes of a quad with __shfl_xor_sync.  Nothing of S, P or O touches
//     shared memory;
//   - bf16: mma.sync m16n8k16 with float accumulators; Q fragments come
//     from ldmatrix once, K's from ldmatrix, V's from ldmatrix.trans; P is
//     rounded to bf16 in registers, where the accumulator layout of S is the
//     A layout of P V (bf16 rounds p before P V, about one bf16 ulp against
//     the float32 twin; the TPU kernel keeps p in float32).  The softmax
//     costs two instructions a score, one FMA and ex2.approx.ftz, and
//     none for masks on a tile whose keys all lie inside Tk and the
//     warp's causal limit;
//   - float: the three-term TF32 split of common.cuh (mma_tf32x3), about
//     2^-21 relative error a product.  P V reads the keys of each 8-key
//     chunk permuted (A column t is key 2t, column t + 4 key 2t + 1), which
//     makes S's accumulator layout P's A layout without a shuffle; V is read
//     in the same order.  The tile's P V goes to a fresh accumulator that
//     is folded in as O * alpha + PV, in float32;
//   - a warp skips the 8- or 16-key chunks that lie past Tk or past its
//     last row's causal limit, and a warp whose rows all lie past Tq does no
//     MMA work;
//   - the shared pitches (hd + 8 bf16, hd + 4 floats) make ldmatrix's eight
//     row addresses and the TF32 fragment loads conflict-free.
// A row that saw no valid key (l = 0) reads the mean of v over [0, Tk) from
// device memory when it stores its output: no row of the captioner's paths
// is one, so the slow loop never runs there.
// q, k, v and the output are taken with their own strides (unit stride on
// hd), so the permuted views that split_heads gives are read in place and
// the output can be written straight into merge_heads' layout.  Ragged
// lengths need no padded copies: key rows >= Tk are zero-filled in shared
// memory and masked, query rows >= Tq are computed on zeros and never stored.
#pragma once

#include "common.cuh"

#include <math.h>

#include <algorithm>

namespace gic {
namespace flash {

constexpr int BKV = 64;       // keys per shared-memory tile
constexpr int MAX_WARPS = 8;  // 16 query rows each

struct Strides {
  long long b, h, t;  // elements between consecutive batch rows, heads, positions
};

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  const int* key_mask;  // (B, Tk), nonzero = attend; null = every key
  Strides qs, ks, vs, os;
  int H, Tq, Tk, causal, q_offset;
  int stages;        // K/V tiles the ring holds: min(STAGES, key tiles of Tk)
  float scale_log2;  // log2(e) / sqrt(hd): scores in base-2 units
};

// Dynamic shared memory of one block: K and V rings of `stages` tiles, the
// key-valid ring, then the block's query rows.  Every piece starts 16-byte
// aligned.  The ring holds at most STAGES tiles, and no more than Tk needs
// (a 25-key head holds one), so short heads leave room for more blocks.
template <typename T, int HD>
struct Layout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int LD = HD + (kF32 ? 4 : 8);  // pitch of every tile, elements
  static constexpr int STAGES = kF32 ? 2 : 3;
  static constexpr int TILE = BKV * LD;           // elements of one K or V tile
  static int stages(int Tk) {
    const int tiles = (Tk + BKV - 1) / BKV;
    return tiles < 1 ? 1 : (tiles < STAGES ? tiles : STAGES);
  }
  static size_t bytes(int rows, int stages) {
    return (2 * (size_t)stages * TILE + (size_t)rows * LD) * sizeof(T) +
           (size_t)stages * BKV * sizeof(int);
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// c += a b, m16n8k16 bf16 fragments, float accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x to about 2^-22 relative, denormal results flushed to 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Copy rows [t0, t0 + nrows) of one head into a shared tile of pitch LD with
// 16-byte cp.async; rows at or past tlim are zero-filled.
template <typename T, int HD>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, long long st, int t0, int nrows,
                                          int tlim) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int VPR = HD / VE;  // vectors per row
  constexpr int LD = Layout<T, HD>::LD;
  for (int i = threadIdx.x; i < nrows * VPR; i += blockDim.x) {
    const int r = i / VPR, c = (i % VPR) * VE;
    const int t = t0 + r;
    const bool ok = t < tlim;
    cp_async16(dst + r * LD + c, ok ? src + (long long)t * st + c : src, ok);
  }
}

// Column c of the mean of v over the Tk keys of one head: the output of a
// row with no valid key.
template <typename T>
__device__ float mean_v(const T* vp, long long st, int Tk, int c) {
  float s = 0.f;
  for (int t = 0; t < Tk; ++t) s += to_f32(vp[(long long)t * st + c]);
  return Tk > 0 ? s / (float)Tk : 0.f;
}

// One warp's 16 query rows: lane (g, t) holds rows g and g + 8 of every
// accumulator (the m16n8 C layout: columns 2t and 2t + 1 of each 8-column
// tile), their running max m (base 2) and its partial sums l.
template <typename T, int HD>
struct WarpRows {
  static constexpr int LD = Layout<T, HD>::LD;
  float o[HD / 8][4];
  float m[2], l[2];
  uint32_t qf[std::is_same<T, float>::value ? 1 : HD / 16][4];  // bf16: Q's A fragments

  __device__ void init() {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  // bf16: Q's fragments from shared memory, once.
  __device__ void load_q(const T* qw) {
    if constexpr (!std::is_same<T, float>::value) {
      const int lane = threadIdx.x % 32;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        ldsm_x4(qf[kk], qw + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 + (lane >> 4) * 8);
    }
  }

  // S = Q K^T for the tile's keys [0, nvalid) rounded up to the chunk.
  __device__ void scores(float (&s)[BKV / 8][4], const T* qw, const T* kst, int nvalid) const {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int kk = 0; kk < HD; kk += 8) {
        uint32_t ah[4], al[4];
        const float* q = qw + g * LD + kk + t;
        split_tf32(q[0], ah[0], al[0]);
        split_tf32(q[8 * LD], ah[1], al[1]);
        split_tf32(q[4], ah[2], al[2]);
        split_tf32(q[8 * LD + 4], ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < BKV / 8; ++n) {
          if (n * 8 >= nvalid) break;
          // B = K^T: element (d, j) sits at k[j][d]
          const float* kr = kst + (n * 8 + g) * LD + kk + t;
          uint32_t bh[2], bl[2];
          split_tf32(kr[0], bh[0], bl[0]);
          split_tf32(kr[4], bh[1], bl[1]);
          mma_tf32x3(s[n], ah, al, bh, bl);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
        for (int np = 0; np < BKV / 16; ++np) {
          if (np * 16 >= nvalid) break;
          // keys np*16 + 0..15 by hd kk*16 + 0..15: four 8 x 8 matrices, the
          // B fragments of two 8-key tiles
          uint32_t b[4];
          ldsm_x4(b, kst + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                         ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
        }
    }
  }

  // Masks, the online softmax, and O = O * alpha + P V for one key tile.
  __device__ void tile(const T* qw, const T* kst, const T* vst, const int* kval, int k0,
                       int nvalid, int row0, const Args<T>& a) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    float s[BKV / 8][4];
    scores(s, qw, kst, nvalid);

    // masks: a key must be inside Tk and unmasked (kval) and, causal, at or
    // before the row's last visible position.  float keeps scaled scores and
    // exp2f, as the twin's order of operations.  bf16 keeps raw scores and
    // forms p = 2^(s * scale - m) with one FMA and ex2.approx.ftz (p is
    // rounded to bf16 anyway); a tile whose 64 keys are all inside Tk, with
    // no key mask and (causal) all visible to the warp's first row, needs no
    // mask, and chunks past nvalid hold no visible key and get p = 0
    // without an exp.
    constexpr bool kF32 = std::is_same<T, float>::value;
    const int nchunk = kF32 ? BKV / 8 : (nvalid + 7) / 8;
    const bool all_ok = !kF32 && nvalid >= BKV && a.key_mask == nullptr &&
                        (!a.causal || k0 + BKV - 1 <= row0 + a.q_offset);
    float mx[2] = {-INFINITY, -INFINITY};
    if (all_ok) {
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    } else {
#pragma unroll
      for (int n = 0; n < BKV / 8; ++n) {
        if (n >= nchunk) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1), r = e >> 1;
          const bool ok = kval[c] != 0 &&
                          (!a.causal || k0 + c <= row0 + g + 8 * r + a.q_offset);
          s[n][e] = ok ? (kF32 ? s[n][e] * a.scale_log2 : s[n][e]) : -INFINITY;
          mx[r] = fmaxf(mx[r], s[n][e]);
        }
      }
    }
    float alpha[2], msub[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], kF32 ? mx[r] : mx[r] * a.scale_log2);
      // no valid key yet: keep the (empty) state as it is
      alpha[r] = m_new == -INFINITY ? 1.f : exp2f(m[r] - m_new);
      msub[r] = m_new == -INFINITY ? 0.f : m_new;
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p;
        if constexpr (kF32)
          p = s[n][e] == -INFINITY ? 0.f : exp2f(s[n][e] - m[r]);
        else  // a masked score is -inf: 2^-inf = 0
          p = n >= nchunk ? 0.f : fast_exp2(fmaf(s[n][e], a.scale_log2, -msub[r]));
        s[n][e] = p;
        l[r] += p;
      }

    if constexpr (kF32) {
      // P's A fragments, keys of chunk kc in the order 2t, 2t + 1 (columns
      // t, t + 4): a0 = P(g, 2t), a1 = P(g + 8, 2t), a2 = P(g, 2t + 1), ...
      uint32_t ph[BKV / 8][4], pl[BKV / 8][4];
#pragma unroll
      for (int kc = 0; kc < BKV / 8; ++kc) {
        split_tf32(s[kc][0], ph[kc][0], pl[kc][0]);
        split_tf32(s[kc][2], ph[kc][1], pl[kc][1]);
        split_tf32(s[kc][1], ph[kc][2], pl[kc][2]);
        split_tf32(s[kc][3], ph[kc][3], pl[kc][3]);
      }
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kc = 0; kc < BKV / 8; ++kc) {
          if (kc * 8 >= nvalid) break;
          // B = V rows kc*8 + 2t and kc*8 + 2t + 1, column n*8 + g
          const float* vr = vst + (kc * 8 + 2 * t) * LD + n * 8 + g;
          uint32_t bh[2], bl[2];
          split_tf32(vr[0], bh[0], bl[0]);
          split_tf32(vr[LD], bh[1], bl[1]);
          mma_tf32x3(pv, ph[kc], pl[kc], bh, bl);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], alpha[e >> 1], pv[e]);
      }
    } else {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc) {
        if (kc * 16 >= nvalid) break;
        const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                                pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                                pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                                pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int np = 0; np < HD / 16; ++np) {
          // keys kc*16 + 0..15 by hd np*16 + 0..15, transposed: the B
          // fragments of two 8-column tiles of O
          uint32_t b[4];
          ldsm_x4_trans(b, vst + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + np * 16 +
                               (lane >> 4) * 8);
          mma_bf16(o[2 * np], pa, b[0], b[1]);
          mma_bf16(o[2 * np + 1], pa, b[2], b[3]);
        }
      }
    }
  }

  // Normalise and store rows row0 + g and row0 + g + 8 (those below Tq).
  __device__ void store(T* op, const T* vp, int row0, const Args<T>& a) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= a.Tq) continue;
      T* dst = op + (long long)row * a.os.t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const int c = n * 8 + 2 * t;
        float y0, y1;
        if (l[r] == 0.f) {  // no valid key: the mean of v
          y0 = mean_v(vp, a.vs.t, a.Tk, c);
          y1 = mean_v(vp, a.vs.t, a.Tk, c + 1);
        } else {  // divided, one rounding, as the twin and the TPU kernel
          y0 = o[n][2 * r] / l[r];
          y1 = o[n][2 * r + 1] / l[r];
        }
        if constexpr (std::is_same<T, float>::value)
          *reinterpret_cast<float2*>(dst + c) = make_float2(y0, y1);
        else
          *reinterpret_cast<uint32_t*>(dst + c) = pack_bf16(y0, y1);
      }
    }
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(32 * MAX_WARPS) flash_attention_kernel(Args<T> a) {
  using L = Layout<T, HD>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int nst = a.stages;
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + nst * L::TILE;
  int* kvs = reinterpret_cast<int*>(vs + nst * L::TILE);
  T* qs = reinterpret_cast<T*>(kvs + nst * BKV);

  const int warp = threadIdx.x / 32;
  const int rows = blockDim.x / 32 * 16;
  const int q0 = blockIdx.x * rows, h = blockIdx.y, b = blockIdx.z;
  const T* qp = a.q + b * a.qs.b + h * a.qs.h;
  const T* kp = a.k + b * a.ks.b + h * a.ks.h;
  const T* vp = a.v + b * a.vs.b + h * a.vs.h;
  T* op = a.out + b * a.os.b + h * a.os.h;
  const int* mask = a.key_mask ? a.key_mask + (long long)b * a.Tk : nullptr;

  // keys the block's last row, and this warp's last row, can see
  int kend = a.Tk, wend = a.Tk;
  const int row0 = q0 + warp * 16;
  if (a.causal) {
    kend = min(kend, max(0, min(q0 + rows, a.Tq) + a.q_offset));
    wend = min(wend, max(0, min(row0 + 16, a.Tq) + a.q_offset));
  }
  const bool active = row0 < a.Tq;
  const int ntiles = (kend + BKV - 1) / BKV;

  // Tile j's K, V and key-valid rows go to stage j % nst.  Tiles up to
  // STAGES - 2 are issued before the loop and tile j + STAGES - 1 in
  // iteration j, into tile j - 1's stage; a ring shorter than STAGES holds
  // every tile of the head, all issued before the loop.
  auto issue = [&](int j) {
    const int st = j % nst, k0 = j * BKV;
    copy_rows<T, HD>(ks + st * L::TILE, kp, a.ks.t, k0, BKV, a.Tk);
    copy_rows<T, HD>(vs + st * L::TILE, vp, a.vs.t, k0, BKV, a.Tk);
    int* kv = kvs + st * BKV;
    for (int i = threadIdx.x; i < BKV; i += blockDim.x) {
      const int t = k0 + i;
      if (mask) cp_async4(kv + i, t < a.Tk ? mask + t : mask, t < a.Tk);
      else kv[i] = t < a.Tk;
    }
  };

  // Q joins tile 0's group; STAGES - 1 groups in flight before the loop
  copy_rows<T, HD>(qs, qp, a.qs.t, q0, rows, a.Tq);
#pragma unroll
  for (int j = 0; j < L::STAGES - 1; ++j) {
    if (j < ntiles) issue(j);
    cp_async_commit();
  }

  WarpRows<T, HD> w;
  w.init();
  const T* qw = qs + warp * 16 * L::LD;
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<L::STAGES - 2>();  // this thread's copies of tile j have landed
    __syncthreads();  // everyone's have, and every warp is done with tile j - 1
    if (j + L::STAGES - 1 < ntiles) issue(j + L::STAGES - 1);  // into tile j - 1's stage
    cp_async_commit();
    if (j == 0 && active) w.load_q(qw);
    const int k0 = j * BKV, st = j % nst;
    if (active && k0 < wend)
      w.tile(qw, ks + st * L::TILE, vs + st * L::TILE, kvs + st * BKV, k0, wend - k0, row0, a);
  }
  cp_async_wait<0>();
  if (active) w.store(op, vp, row0, a);
}

// The opt-in shared memory of a block on the current device (227 KB on an
// H100).
inline size_t smem_optin() {
  static const size_t bytes = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return (size_t)v;
  }();
  return bytes;
}

// The widest float builds (hd 160 and 208) cannot hold a full ring and 8
// warps' query rows: a block there takes fewer warps, and the grid more
// q-tiles, until its shared memory fits.  Each head dim's instantiations
// are compiled in one translation unit only (GIC_FLASH_INSTANTIATE), and
// the dispatch declares them (GIC_FLASH_EXTERN), so the one-time attribute
// flag below exists once per instantiation.
template <typename T, int HD>
int launch(Args<T> a, int B, int warps, cudaStream_t stream) {
  using L = Layout<T, HD>;
  if (warps < 1 || warps > MAX_WARPS) return (int)cudaErrorInvalidValue;
  a.stages = L::stages(a.Tk);
  const size_t limit = smem_optin();
  while (warps > 1 && L::bytes(16 * warps, a.stages) > limit) --warps;
  if (L::bytes(16 * warps, a.stages) > limit) return (int)cudaErrorInvalidValue;
  const int rows = 16 * warps;
  auto kernel = flash_attention_kernel<T, HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instantiation
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)std::min(L::bytes(16 * MAX_WARPS, L::STAGES), limit));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((a.Tq + rows - 1) / rows, a.H, B);
  kernel<<<grid, 32 * warps, L::bytes(rows, a.stages), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace flash
}  // namespace gic

// Explicit instantiation (in the head dim's own translation unit) and its
// declaration (where the dispatch calls it) of one element type's launch.
#define GIC_FLASH_LAUNCH(PREFIX, T, HD) \
  PREFIX template int gic::flash::launch<T, HD>(gic::flash::Args<T>, int, int, cudaStream_t);
#define GIC_FLASH_INSTANTIATE(T, HD) GIC_FLASH_LAUNCH(, T, HD)
#define GIC_FLASH_EXTERN(T, HD) GIC_FLASH_LAUNCH(extern, T, HD)
