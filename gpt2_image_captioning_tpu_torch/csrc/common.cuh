// Shared pieces of the port's CUDA kernels: element types, warp reductions,
// and the tiled row-block x weight-tile product that fused_linear.cu and
// the vocabulary kernels all run.
//
// Element type codes match ops/_build.py::DTYPE_CODE: 0 = float, 1 = bf16.
// Inputs are read in the element type, products accumulate in float32, and
// LayerNorm statistics are float32, as in the TPU kernel
// (gpt2_image_captioning_tpu/ops/decode_step.py::_step_kernel).  The W8A8
// mode (the step kernel's quant mode) multiplies int8 rows by int8 weights
// with int32 accumulators and dequantizes each tile as acc * sx * sw.
//
// The tile serves the step kernel's weight stream (fused_linear.cu, the four
// vocabulary kernels) and the prefill kernel's products (prefill.cu,
// gpt2_image_captioning_tpu/ops/prefill_step.py::_prefill_kernel).  Its
// bound on the H100: at a decode batch of 128 the weights' bytes (a float32
// GPT-2 layer: 28 MB, 8.5 us at 3.35 TB/s); the prefill's 1,920 rows are
// bound by operations (float32: three TF32 products at 495 TFLOP/s).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace gic {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round to nearest even, as jnp.astype(bfloat16) and torch's .to(bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Asynchronous 16- and 4-byte copies global -> shared (cp.async), zero-filled
// where ``valid`` is false (src is then not read), and their groups.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// float32 products on the tensor cores: the three-term TF32 split.
// mma.sync m16n8k8 .tf32 fragments, lane = 4 g + t (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// ---------------------------------------------------------------------------

// x = hi + lo with hi = tf32(x) rounded to nearest (ties away) and lo =
// tf32(x - hi): 11 + 11 significant bits, x to about 2^-22 relative.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in about float32 precision: the two small cross terms first.
__device__ __forceinline__ void mma_tf32x3(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

// The int8 row scale, as the TPU kernel's float32 math has it: max(max|v| *
// kInv127, kMinScale) with float32(1/127) and float32(1e-12).
constexpr float kInv127 = (float)(1.0 / 127.0);
constexpr float kMinScale = (float)1e-12;

// csrc/rowquant.cu: per-row symmetric int8 quantization of M rows of K (row
// m of x at x + m * ld, in T, or with LN the float32 rows LayerNorm'd and
// rounded to T first) into q (row m at q + m * ldq) and sx (M,) float32.
// One launch on stream s; T is float or __nv_bfloat16.
template <typename T, bool LN>
void launch_rowquant(cudaStream_t s, const void* x, int ld, const float* ln_s, const float* ln_b,
                     float eps, int M, int K, int8_t* q, int ldq, float* sx);

// ---------------------------------------------------------------------------
// Tiled product: one block computes a BM x BN tile of
//   Y = prologue(X) @ W^T,   X (M, K) row-major,  W (N, K) row-major,
// walking K in BK steps through shared memory.  W is stored output-major
// ((N, K): each output column's weights are contiguous in K), which is the
// natural layout of the tied embedding (V, D) and what pack_decode_weights
// gives the four GPT-2 projections.
//
// prologue: either a plain load of X in the element type, or the LayerNorm of
// each float32 row of the residual stream, cast to the element type, from
// per-row statistics (mean, rstd) that a pre-pass computed once.
//
// bf16 runs on the tensor cores through WMMA 16x16x16 fragments (float
// accumulators).  float runs on the tensor cores too, as a three-term TF32
// split (mma.sync m16n8k8 .tf32, split_tf32 and mma_tf32x3 below): each
// operand x is hi = tf32(x) plus lo = tf32(x - hi), 22 significant bits
// together, and a product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with float32
// accumulators; the dropped a_lo*b_lo term and the split's rounding leave
// about 2^-21 relative error a product, the order of a float32 summation
// difference.  Each 64-deep stage accumulates into a fresh register tile
// that is added to the running sum with a float32 add, so the tensor
// core's truncating accumulation reaches over 24 products at most.  The
// float stage has its own pitch (BK + 4 floats) so that the fragment
// loads, lane (g, t) at row g and column t, hit 32 distinct banks.  On an
// H100 a float32 GPT-2 layer at b 128 takes 0.19 ms against its 0.011 ms
// bound: its grids of 48-192 blocks keep one stage in flight each.
// int8 (W8A8: X quantized per row by rowquant.cu, W per output column by
// ops/quant.py::colquant) runs WMMA signed-char 16x16x16 fragments with
// int32 accumulators, exact at any K; the tile is dequantized on its way
// to sm.cs as (float)acc * sx[row] * sw[col] (decode_step.py:286, :562),
// so every epilogue reads float tiles whatever the operand type.
// ---------------------------------------------------------------------------

constexpr int BM = 64;       // rows of X (batch rows) per block
constexpr int BN = 32;       // output columns per block
constexpr int BK = 64;       // depth of one shared-memory stage
constexpr int THREADS = 128; // 4 warps
constexpr int LDS = BK + 8;  // shared pitch of the bf16 X/W stages (WMMA wants a multiple of 8)
constexpr int LDC = BN + 4;  // shared pitch of the float result tile

template <typename T>
struct __align__(32) TileSmem {
  __align__(32) T xs[BM][LDS];
  __align__(32) T ws[BN][LDS];
  __align__(32) float cs[BM][LDC];
  float mean[BM];
  float rstd[BM];
};

// float: the pitch BK + 4 (= 4 mod 32 banks) makes the TF32 fragment loads
// conflict-free (TileMma<float>) and keeps every row 16-byte aligned.
constexpr int LDSF = BK + 4;
template <>
struct __align__(32) TileSmem<float> {
  __align__(32) float xs[BM][LDSF];
  __align__(32) float ws[BN][LDSF];
  __align__(32) float cs[BM][LDC];
  float mean[BM];
  float rstd[BM];
};

// int8: each 16-deep k-slice of the stage is stored apart ([slice][row][16]),
// so every WMMA fragment starts on a 32-byte boundary (an int8 fragment
// 16 bytes into a padded row would not); sx/sw hold the tile's row and
// column scales.
constexpr int KS = BK / 16;  // k-slices of one stage
template <>
struct __align__(32) TileSmem<int8_t> {
  __align__(32) int8_t xs[KS][BM][16];
  __align__(32) int8_t ws[KS][BN][16];
  __align__(32) float cs[BM][LDC];
  float sx[BM];
  float sw[BN];
};

// Where a stage's 16-byte vector of row r, columns c.., is stored.
template <typename T>
__device__ __forceinline__ T* x_slot(TileSmem<T>& sm, int r, int c) { return &sm.xs[r][c]; }
template <typename T>
__device__ __forceinline__ T* w_slot(TileSmem<T>& sm, int r, int c) { return &sm.ws[r][c]; }
template <>
__device__ __forceinline__ int8_t* x_slot(TileSmem<int8_t>& sm, int r, int c) {
  return &sm.xs[c / 16][r][0];
}
template <>
__device__ __forceinline__ int8_t* w_slot(TileSmem<int8_t>& sm, int r, int c) {
  return &sm.ws[c / 16][r][0];
}

// LayerNorm statistics of one float32 row, two-pass (mean, then the mean of
// squared deviations), by one warp; every lane gets the result.  The sums
// run in float64 and are rounded once, mean = float(m) and rstd =
// float(1 / sqrt(v + eps)), so the float32 statistics do not depend on the
// order of the sums: the plain twins (ops/nn.py::layer_norm_rows) reach the
// same values in any order.  That matters in the int8 step, where a
// one-ulp difference in a normalised value can move it across a
// quantization step and the step's later layers carry that on.
__device__ __forceinline__ void row_mean_rstd(const float* row, int K, float eps, float& mean,
                                              float& rstd) {
  const int lane = threadIdx.x % 32;
  double s = 0.0;
  for (int k = lane; k < K; k += 32) s += row[k];
  const double m = warp_sum(s) / K;
  double v = 0.0;
  for (int k = lane; k < K; k += 32) {
    const double d = row[k] - m;
    v += d * d;
  }
  mean = (float)m;
  rstd = (float)(1.0 / sqrt(warp_sum(v) / K + (double)eps));
}

// The LN prologue's value of one element, rounded to the compute dtype where
// _step_kernel rounds it (decode_step.py:531, :553): ((x - mean) * rstd) *
// s + b in float32, each operation rounded on its own (no contraction into
// an FMA), as the twins' elementwise torch ops round.
template <typename T>
__device__ __forceinline__ T ln_value(float x, float mean, float rstd, float s, float b) {
  return from_f32<T>(__fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mean), rstd), s), b));
}

// GPT-2's tanh GELU (decode_step.py:76-78, prefill_step.py:80-82), in
// float64 and rounded once to float32, so the result does not depend on how
// the expression is contracted or on the float32 tanh's last bit: the twin
// (ops/decode_step.py::_gelu_new) computes it alike.
__device__ __forceinline__ float gelu_new(float x32) {
  const double c = 0.7978845608028654;  // sqrt(2 / pi)
  const double x = x32;
  return (float)(0.5 * x * (1.0 + tanh(c * (x + 0.044715 * x * x * x))));
}

// Copy the (mean, rstd) pairs of rows m0 .. m0+BM-1 into shared memory.
template <typename T>
__device__ void load_row_stats(TileSmem<T>& sm, const float* stats, int M, int m0) {
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const int m = m0 + r;
    sm.mean[r] = m < M ? stats[2 * (size_t)m] : 0.f;
    sm.rstd[r] = m < M ? stats[2 * (size_t)m + 1] : 0.f;
  }
}

// One 64-deep stage travels global -> registers -> shared.  Every load of a
// stage is a 16-byte vector and all of a thread's loads are issued before
// any of them is stored, so each thread keeps several loads in flight; the
// caller issues stage k+1's loads before stage k's MMAs (tile_product).
// Needs K to be a multiple of the vector width (8 bf16 / 4 float / 16 int8)
// and 16-byte-aligned rows, which the wrappers check.
template <typename T, bool LN>
struct StageRegs {
  using XT = typename std::conditional<LN, float, T>::type;  // element type of X in memory
  static constexpr int XE = 16 / sizeof(XT);                // X elements per vector
  static constexpr int WE = 16 / sizeof(T);                 // W elements per vector
  static constexpr int NX = BM * BK / XE / THREADS;
  static constexpr int NW = BN * BK / WE / THREADS;
  static_assert(NX * XE * THREADS == BM * BK && NW * WE * THREADS == BN * BK, "stage split");
  uint4 x[NX];
  uint4 w[NW];

  __device__ void load(const void* xp, const T* wp, int M, int K, int N, int m0, int n0, int k0) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int v = threadIdx.x + i * THREADS;
      const int r = v / (BK / XE), c = (v % (BK / XE)) * XE;
      const int m = m0 + r, k = k0 + c;
      x[i] = (m < M && k < K)
                 ? *reinterpret_cast<const uint4*>(static_cast<const XT*>(xp) + (size_t)m * K + k)
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int v = threadIdx.x + i * THREADS;
      const int r = v / (BK / WE), c = (v % (BK / WE)) * WE;
      const int n = n0 + r, k = k0 + c;
      w[i] = (n < N && k < K) ? *reinterpret_cast<const uint4*>(wp + (size_t)n * K + k)
                              : make_uint4(0, 0, 0, 0);
    }
  }

  // LN prologue applied here, on the way into shared memory
  __device__ void store(TileSmem<T>& sm, const float* ln_s, const float* ln_b, int K,
                        int k0) const {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int v = threadIdx.x + i * THREADS;
      const int r = v / (BK / XE), c = (v % (BK / XE)) * XE;
      if constexpr (LN) {
        const float* xv = reinterpret_cast<const float*>(&x[i]);
#pragma unroll
        for (int e = 0; e < XE; ++e) {
          const int k = k0 + c + e;
          // zero-filled columns past K stay zero (their products are padding)
          sm.xs[r][c + e] = k < K ? ln_value<T>(xv[e], sm.mean[r], sm.rstd[r], ln_s[k], ln_b[k])
                                  : from_f32<T>(0.f);
        }
      } else {
        *reinterpret_cast<uint4*>(x_slot(sm, r, c)) = x[i];
      }
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int v = threadIdx.x + i * THREADS;
      const int r = v / (BK / WE), c = (v % (BK / WE)) * WE;
      *reinterpret_cast<uint4*>(w_slot(sm, r, c)) = w[i];
    }
  }
};

template <typename T> struct TileMma;

// bf16: warp w owns rows 16w .. 16w+15 of the tile and all BN columns.
template <> struct TileMma<__nv_bfloat16> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[BN / 16];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) nvcuda::wmma::fill_fragment(acc[j], 0.f);
  }
  __device__ void step(TileSmem<__nv_bfloat16>& sm) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &sm.xs[warp * 16][kk], LDS);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        // B = W^T: element (k, n) sits at ws[n][k], i.e. column-major with pitch LDS
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, &sm.ws[j * 16][kk], LDS);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  __device__ void store(TileSmem<__nv_bfloat16>& sm) {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
      nvcuda::wmma::store_matrix_sync(&sm.cs[warp * 16][j * 16], acc[j], LDC,
                                      nvcuda::wmma::mem_row_major);
  }
};

// float: warp w owns rows 16w .. 16w+15 and all BN columns, as bf16 does, as
// BN / 8 TF32 m16n8k8 accumulators; each stage's products go to a fresh
// tile (part) that is added to acc once, in float32.
template <> struct TileMma<float> {
  float acc[BN / 8][4];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  __device__ void step(TileSmem<float>& sm) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    float part[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
    const float* x0 = &sm.xs[warp * 16 + g][t];
    const float* x1 = &sm.xs[warp * 16 + g + 8][t];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[4], al[4];
      split_tf32(x0[kk], ah[0], al[0]);
      split_tf32(x1[kk], ah[1], al[1]);
      split_tf32(x0[kk + 4], ah[2], al[2]);
      split_tf32(x1[kk + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        // B = W^T: element (k, n) sits at ws[n][k]
        const float* w = &sm.ws[j * 8 + g][kk + t];
        uint32_t bh[2], bl[2];
        split_tf32(w[0], bh[0], bl[0]);
        split_tf32(w[4], bh[1], bl[1]);
        mma_tf32x3(part[j], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
  __device__ void store(TileSmem<float>& sm) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(&sm.cs[warp * 16 + g][j * 8 + 2 * t]) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(&sm.cs[warp * 16 + g + 8][j * 8 + 2 * t]) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
};

// int8: warp w owns rows 16w .. 16w+15 and all BN columns, as bf16 does;
// its int32 tile goes to sm.cs as ints and is dequantized in place.
template <> struct TileMma<int8_t> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, int> acc[BN / 16];

  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) nvcuda::wmma::fill_fragment(acc[j], 0);
  }
  __device__ void step(TileSmem<int8_t>& sm) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a;
      wmma::load_matrix_sync(a, &sm.xs[s][warp * 16][0], 16);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        // B = W^T: element (k, n) sits at ws[s][n][k % 16], column-major with pitch 16
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> b;
        wmma::load_matrix_sync(b, &sm.ws[s][j * 16][0], 16);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  __device__ void store(TileSmem<int8_t>& sm) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
      nvcuda::wmma::store_matrix_sync(reinterpret_cast<int*>(&sm.cs[warp * 16][j * 16]), acc[j],
                                      LDC, nvcuda::wmma::mem_row_major);
    __syncwarp();
    for (int i = lane; i < 16 * BN; i += 32) {  // this warp's own rows
      const int r = warp * 16 + i / BN, c = i % BN;
      float& cell = sm.cs[r][c];
      cell = (float)__float_as_int(cell) * sm.sx[r] * sm.sw[c];
    }
  }
};

// Copy the row scales of rows m0.. and the column scales of columns n0..
// into shared memory (0 past M and N, whose products are padding anyway).
__device__ __forceinline__ void load_scales(TileSmem<int8_t>& sm, const float* sx,
                                            const float* sw, int M, int N, int m0, int n0) {
  for (int r = threadIdx.x; r < BM; r += THREADS) sm.sx[r] = m0 + r < M ? sx[m0 + r] : 0.f;
  for (int c = threadIdx.x; c < BN; c += THREADS) sm.sw[c] = n0 + c < N ? sw[n0 + c] : 0.f;
}

// Computes this block's tile (rows m0.., columns n0..) into sm.cs; rows >= M
// and columns >= N hold zeros.  Ends with a barrier, so sm.cs is readable.
// With LN, ``stats`` holds each row's (mean, rstd) and ln_s/ln_b the scale and
// bias; without, all three are unused.  For int8 operands (never with LN),
// ``sx`` (M,) and ``sw`` (N,) are the row and column dequantization scales.
template <typename T, bool LN>
__device__ void tile_product(TileSmem<T>& sm, const void* x, const float* stats,
                             const float* ln_s, const float* ln_b, const T* w, int M, int K, int N,
                             int m0, int n0, const float* sx = nullptr,
                             const float* sw = nullptr) {
  static_assert(!(LN && std::is_same<T, int8_t>::value), "int8 rows are quantized after LN");
  StageRegs<T, LN> regs;
  regs.load(x, w, M, K, N, m0, n0, 0);
  if constexpr (LN) load_row_stats(sm, stats, M, m0);
  // read only by mma.store, after the loop's barriers
  if constexpr (std::is_same<T, int8_t>::value) load_scales(sm, sx, sw, M, N, m0, n0);
  TileMma<T> mma;
  mma.zero();
  for (int k0 = 0; k0 < K; k0 += BK) {
    if (LN && k0 == 0) __syncthreads();  // the first store reads the row statistics
    regs.store(sm, ln_s, ln_b, K, k0);
    __syncthreads();
    if (k0 + BK < K) regs.load(x, w, M, K, N, m0, n0, k0 + BK);  // in flight during the MMAs
    mma.step(sm);
    __syncthreads();
  }
  mma.store(sm);
  __syncthreads();
}

}  // namespace gic
