// Shared pieces of the port's CUDA kernels: element types, warp reductions,
// the Hopper building blocks (TMA tensor maps and copies, mbarriers, wgmma
// descriptors and products, cluster barriers and distributed shared memory)
// that fused_linear.cu, patch_embed.cu and vocab_walk.cuh run on, the TF32
// split of float32 operands, and the LayerNorm pre-pass.
//
// Element type codes match ops/_build.py::DTYPE_CODE: 0 = float, 1 = bf16.
// Inputs are read in the element type, products accumulate in float32, and
// LayerNorm statistics are float32, as in the TPU kernel
// (gpt2_image_captioning_tpu/ops/decode_step.py::_step_kernel).  The W8A8
// mode (the step kernel's quant mode) multiplies int8 rows by int8 weights
// with int32 accumulators and dequantizes as acc * sx * sw.
//
// Which design runs where: the decode step's projections (fused_linear.cu)
// stream their operands by TMA into a ring and multiply on wgmma, split over
// K across a thread-block cluster, in bf16, int8 and float32 (wgmma TF32, the
// three-term split; its header gives the design and the bound); the four
// vocabulary kernels walk wte on vocab_walk.cuh in every operand type
// (float32 on wgmma TF32 too); the prefill's products (prefill.cu) run on
// fused_linear.cu's route in bf16 and float32; flash attention
// (flash_attention.cuh) loads its heads by TMA through 4-D maps and runs both
// products on wgmma, P V from registers; the patch embedding (patch_embed.cu)
// loads W by TMA and multiplies on wgmma, float32 on TF32.  Every product
// of the port's kernels runs on wgmma, and every asynchronous copy into
// shared memory is a TMA (bulk tensor) copy.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the CUDA driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <functional>
#include <mutex>
#include <type_traits>
#include <unordered_map>

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

// ---------------------------------------------------------------------------
// float32 products on the tensor cores: the three-term TF32 split, the
// operands of wgmma .tf32 (A and B as float32 words whose low 13 bits are 0)
// ---------------------------------------------------------------------------

// x = hi + lo with hi = tf32(x) rounded to nearest (ties away) and lo =
// tf32(x - hi): 11 + 11 significant bits, x to about 2^-22 relative.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// split_tf32 by integer operations, as the float32 converter warps split a
// landed box (fused_linear.cu, vocab_walk.cuh): half a TF32 ulp added to the
// magnitude bits and the low 13 dropped is cvt.rna.tf32.f32's rounding (to
// nearest, ties away from zero) of every finite x, without the conversion
// unit, whose quarter rate held the converters back.
__device__ __forceinline__ float tf32_rna_bits(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}
__device__ __forceinline__ void tf32_split_bits(float x, float& hi, float& lo) {
  hi = tf32_rna_bits(x);
  lo = tf32_rna_bits(x - hi);
}

// The int8 row scale, as the TPU kernel's float32 math has it: max(max|v| *
// kInv127, kMinScale) with float32(1/127) and float32(1e-12).
constexpr float kInv127 = (float)(1.0 / 127.0);
constexpr float kMinScale = (float)1e-12;

// rint(v / s) for 4 values, as int8 bytes packed into 4 (v[0] the lowest),
// equal to rowquant's first version's rintf(__fdiv_rn(v, s)) for |v| <=
// 127.5 s, from the product z = v * inv with inv = __frcp_rn(s): z lies
// within 2^-17 of v / s (inv is 2^-24 relative from 1 / s, |v / s| <= 128)
// and the correctly rounded quotient within 2^-18, so the two round to the
// same integer unless z lies within 2^-14 of a half-integer; there (about
// one value in 8,000) the IEEE division decides (quant_pack4_exact).  The
// rounding is one FMA, z + 1.5 * 2^23, whose float's low byte is rint(z)
// (half to even, |z| < 2^22), and a second FMA gives z - rint(z): float
// operations at the full rate, where F2I and I2F run at an eighth of it.
// The row quantizer (rowquant.cu) and the products that quantize their own
// rows (fused_linear.cu, where each column tile quantizes the rows again)
// round so, running many chunks' fast paths before any fix-up: a branch at
// each would keep the chunks' latencies from overlapping.
constexpr float kRoundMagic = 12582912.0f;  // 1.5 * 2^23
__device__ __forceinline__ uint32_t pack_low_bytes(float f0, float f1, float f2, float f3) {
  return __byte_perm(__byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x0040),
                     __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x0040), 0x5410);
}
// The exact path, out of line: the kernels that quantize run each of their
// code regions once or a few times a block, so their time follows the code's
// size (instruction fetch), and four inlined IEEE divisions at every call
// site would double it.
static __device__ __noinline__ uint32_t quant_pack4_exact(float v0, float v1, float v2,
                                                          float v3, float s) {
  return pack_low_bytes(__fadd_rn(__fdiv_rn(v0, s), kRoundMagic),
                        __fadd_rn(__fdiv_rn(v1, s), kRoundMagic),
                        __fadd_rn(__fdiv_rn(v2, s), kRoundMagic),
                        __fadd_rn(__fdiv_rn(v3, s), kRoundMagic));
}
// The fast path alone, without a branch (so a caller can run many chunks'
// fast paths before any fix-up): near is set where the division must decide.
__device__ __forceinline__ uint32_t quant_pack4_fast(const float (&v)[4], float inv,
                                                     bool& near) {
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j] = __fmaf_rn(v[j], inv, kRoundMagic);
    near |= fabsf(__fmaf_rn(v[j], inv, -__fsub_rn(f[j], kRoundMagic))) >= 0.5f - 0x1p-14f;
  }
  return pack_low_bytes(f[0], f[1], f[2], f[3]);
}

// The float32 values of a 16-byte chunk: 8 bf16 (a bf16 is a float32's high
// half) or 4 float32, from the registers themselves.
__device__ __forceinline__ void unpack16(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

// csrc/rowquant.cu: per-row symmetric int8 quantization of M rows of K (row
// m of x at x + m * ld, in T, or with LN the float32 rows LayerNorm'd and
// rounded to T first) into q (row m at q + m * ldq) and sx (M,) float32.
// One launch on stream s; T is float or __nv_bfloat16.
template <typename T, bool LN>
void launch_rowquant(cudaStream_t s, const void* x, int ld, const float* ln_s, const float* ln_b,
                     float eps, int M, int K, int8_t* q, int ldq, float* sx);

// Epilogues of the products (fused_linear.cu, prefill.cu): the cast to the
// compute dtype, gelu_new then the cast, the in-place float32 residual add.
constexpr int kEpiCast = 0;
constexpr int kEpiGelu = 1;
constexpr int kEpiResidual = 2;

// csrc/fused_linear.cu's bf16 route, without a prologue: out = epi(a @ w^T +
// bias) for (M, K) bf16 rows a and (N, K) bf16 weights w, on the TMA ring,
// wgmma and the cluster split (bn, splits, kslice: a linear_plan of the
// shape); out is (M, N) bf16, or the float32 residual stream for
// kEpiResidual.  One launch on stream s; returns its cudaError_t (0: none).
// The prefill's four products run on it.
int linear_wgmma_bf16(const void* a, const void* w, const float* bias, void* out, int epi, int M,
                      int N, int K, int bn, int splits, int kslice, cudaStream_t s);
// The same in float32 on wgmma TF32 (the three-term split): a (M, K) float32
// rows, or with a_split its TF32 pair, (2M, K): tf32(y) in rows 0 .. M - 1
// and tf32(y - tf32(y)) in rows M .. 2M - 1 (ln_rows_kernel with xl); w (N,
// K) float32; out (M, N) float32, or the residual stream for kEpiResidual.
int linear_wgmma_f32(const float* a, int a_split, const float* w, const float* bias, float* out,
                     int epi, int M, int N, int K, int bn, int splits, int kslice, cudaStream_t s);

// ---------------------------------------------------------------------------
// Hopper building blocks: TMA, mbarriers, wgmma, clusters
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
// makes the initialised barriers visible to the async proxy (TMA) and to the
// cluster; a __syncthreads (or cluster barrier) follows
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also announces ``bytes`` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// mbar_wait that turns a lost arrival into a fault rather than a hang: past
// about ten seconds of polling (2^34 SM clocks) the block traps, and the
// launch's stream reports an error.
__device__ __forceinline__ void wait_or_trap(uint64_t* bar, int parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  }
}

// A TMA tile copy global -> shared that signals ``bar`` with its bytes;
// coordinates innermost first.  Boxes that reach past the tensor are
// zero-filled (and still count their whole size).
// fetch a tensor map into the descriptor cache ahead of its first copy
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// cuTensorMapEncodeTiled, fetched from the CUDA driver once (no link to libcuda);
// null where the CUDA driver has none.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// The TMA map of a (rows, cols) row-major operand (cols = K), box (128 bytes
// of K, box_rows), 128-byte swizzled, zero-filled out of bounds; encoded
// once per (pointer, shape, box) and cached: a map is a function of these
// alone, and the step's weights, and the caching allocator's buffers, recur.
// fused_linear.cu and the vocabulary walk (vocab_walk.cuh) read their
// operands through these maps.  Returns 0 or a cudaError_t.
constexpr int kTmaBox = 128;  // bytes of K a box: one swizzled row

struct TmaMapKey {
  const void* ptr;
  int rows, cols, box_rows, el;
  bool operator==(const TmaMapKey& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols && box_rows == o.box_rows &&
           el == o.el;
  }
};
struct TmaMapKeyHash {
  size_t operator()(const TmaMapKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr);
    for (int v : {k.rows, k.cols, k.box_rows, k.el}) h = h * 1000003u ^ (size_t)v;
    return h;
  }
};

// el: the element's bytes, 1 (int8), 2 (bf16) or 4 (float32).
inline int tma_operand_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
                           int el) {
  static std::mutex mu;
  static std::unordered_map<TmaMapKey, CUtensorMap, TmaMapKeyHash> cache;
  if (el != 1 && el != 2 && el != 4) return (int)cudaErrorInvalidValue;
  const TmaMapKey key{ptr, rows, cols, box_rows, el};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return 0;
  }
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * el};  // bytes
  const cuuint32_t box[2] = {(cuuint32_t)(kTmaBox / el), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, el == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                : el == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            2, const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

// The TMA map of a (B, H, T, hd) operand read through its own strides
// (elements; unit stride on hd, the others 16-byte multiples): dims (hd, T,
// H, B), box (64 bytes of hd, box_rows, 1, 1), 64-byte swizzled, zero-filled
// past hd and T; encoded once per (pointer, shape, strides, box) and cached,
// as tma_operand_map's.  Flash attention reads q, k and v through these.
// Returns 0 or a cudaError_t.
struct TmaHeadKey {
  const void* ptr;
  long long dims[4], strides[3];
  int box_rows, el;
  bool operator==(const TmaHeadKey& o) const {
    for (int i = 0; i < 4; ++i)
      if (dims[i] != o.dims[i]) return false;
    for (int i = 0; i < 3; ++i)
      if (strides[i] != o.strides[i]) return false;
    return ptr == o.ptr && box_rows == o.box_rows && el == o.el;
  }
};
struct TmaHeadKeyHash {
  size_t operator()(const TmaHeadKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr);
    for (long long v : k.dims) h = h * 1000003u ^ (size_t)v;
    for (long long v : k.strides) h = h * 1000003u ^ (size_t)v;
    return (h * 1000003u ^ (size_t)k.box_rows) * 1000003u ^ (size_t)k.el;
  }
};

constexpr int kTmaHeadBox = 64;  // bytes of hd a box: one 64-byte swizzled row

inline int tma_head_map(CUtensorMap* map, const void* ptr, int el, int hd, int T, int H, int B,
                        long long st_t, long long st_h, long long st_b, int box_rows) {
  static std::mutex mu;
  static std::unordered_map<TmaHeadKey, CUtensorMap, TmaHeadKeyHash> cache;
  if (el != 2 && el != 4) return (int)cudaErrorInvalidValue;
  const TmaHeadKey key{ptr, {hd, T, H, B}, {st_t, st_h, st_b}, box_rows, el};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return 0;
  }
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(st_t * el), (cuuint64_t)(st_h * el),
                                 (cuuint64_t)(st_b * el)};  // bytes
  const cuuint32_t box[4] = {(cuuint32_t)(kTmaHeadBox / el), (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, el == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            4, const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

// A wgmma shared-memory descriptor: 128-byte swizzle, byte offsets lbo
// (between 64-element blocks along the contiguous dimension; unused where
// one k-step lies inside a 128-byte row) and sbo (between 8-row groups).
// The tile's base is 1024-byte aligned, so a k-step inside the swizzled row
// is the base plus its byte offset.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// The same for a 64-byte swizzled operand (TMA's CU_TENSOR_MAP_SWIZZLE_64B):
// 64-byte rows, an 8-row group 512 bytes, the tile's base 512-byte aligned.
// K-major: sbo is the 8-row groups' stride (512 where rows are packed) and a
// k-step inside the row is the base plus its byte offset.  N-major (the
// transpose bit): lbo steps between 32-element blocks of N (64 bytes of
// bf16), sbo between 8-row groups of K.
__device__ __forceinline__ uint64_t wgmma_desc64(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (2ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads above a wgmma wait
template <typename A, int R>
__device__ __forceinline__ void wgmma_fence_regs(A (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if constexpr (std::is_same<A, float>::value) asm volatile("" : "+f"(d[i])::"memory");
    else asm volatile("" : "+r"(d[i])::"memory");
  }
}

// d (64 x 256 float32, the warpgroup's fragments) += A (64 x 16 bf16, K-major
// in shared memory) x B (16 x 256 bf16, N-major in shared memory: trans-b 1).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x N) += A (64 x one k-step, K-major) x B (one k-step x N, K-major:
// W's own (N, K) rows), both 128-byte swizzled in shared memory, for N 32,
// 64 and 128: bf16 (mma, k16, float32 accumulators), int8 (mma, k32, int32
// accumulators, exact) and TF32 (tf32, k8, float32 accumulators; K-major is
// the only layout .tf32 takes; A and B as float32 words whose low 13 bits
// the caller has zeroed: split_tf32, tf32_split_bits).  A k-step is 32
// bytes of K in every type.  d has N / 2 registers a thread: d[4j + e] holds
// row 16 w + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2 of the
// warpgroup's 64 rows (w its warp in the warpgroup).
#define GIC_ACC8(C, d, i)                                                                  \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), C(d[i + 6]),    \
      C(d[i + 7])
#define GIC_ACC16(C, d) GIC_ACC8(C, d, 0), GIC_ACC8(C, d, 8)
#define GIC_ACC32(C, d) GIC_ACC16(C, d), GIC_ACC8(C, d, 16), GIC_ACC8(C, d, 24)
#define GIC_ACC64(C, d) \
  GIC_ACC32(C, d), GIC_ACC8(C, d, 32), GIC_ACC8(C, d, 40), GIC_ACC8(C, d, 48), GIC_ACC8(C, d, 56)
#define GIC_OPS16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define GIC_OPS32 \
  GIC_OPS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define GIC_OPS64                                                                            \
  GIC_OPS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
// the operands after R accumulators: A's descriptor, B's, and scale-d (1)
#define GIC_WGMMA_TAIL(A, B, P) \
  "}, %" #A ", %" #B ", p"
#define GIC_WGMMA(N, R, OPS, ACC, A, B, P)                                                      \
  template <>                                                                                   \
  struct Wgmma<N> {                                                                             \
    static __device__ __forceinline__ void mma(float (&d)[R], uint64_t da, uint64_t db) {      \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                              \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" OPS           \
                   GIC_WGMMA_TAIL(A, B, P) ", 1, 1, 0, 0;\n}\n"                                 \
                   : ACC("+f", d)                                                               \
                   : "l"(da), "l"(db), "r"(1));                                                 \
    }                                                                                           \
    static __device__ __forceinline__ void mma(int (&d)[R], uint64_t da, uint64_t db) {        \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                              \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 {" OPS                \
                   GIC_WGMMA_TAIL(A, B, P) ";\n}\n"                                              \
                   : ACC("+r", d)                                                               \
                   : "l"(da), "l"(db), "r"(1));                                                 \
    }                                                                                           \
    static __device__ __forceinline__ void tf32(float (&d)[R], uint64_t da, uint64_t db) {     \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                              \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" OPS              \
                   GIC_WGMMA_TAIL(A, B, P) ", 1, 1;\n}\n"                                       \
                   : ACC("+f", d)                                                               \
                   : "l"(da), "l"(db), "r"(1));                                                 \
    }                                                                                           \
  };
template <int N> struct Wgmma;
GIC_WGMMA(32, 16, GIC_OPS16, GIC_ACC16, 16, 17, 18)
GIC_WGMMA(64, 32, GIC_OPS32, GIC_ACC32, 32, 33, 34)
GIC_WGMMA(128, 64, GIC_OPS64, GIC_ACC64, 64, 65, 66)
#undef GIC_WGMMA
#undef GIC_WGMMA_TAIL

// d (64 x 32 float32) += A (64 x one k-step, from registers) x B (one k-step
// x 32 in shared memory), the register-A form: A is the warpgroup's
// fragments, four 32-bit registers a thread, which for warp w of the
// warpgroup and lane = 4 g + t hold rows 16 w + g (a0, a2) and 16 w + g + 8
// (a1, a3) — bf16 (k16): columns 2t, 2t + 1 in a0 / a1 and 2t + 8, 2t + 9 in
// a2 / a3, packed low first; TF32 (k8): column t in a0 / a1, t + 4 in a2 /
// a3.  That is the accumulator layout of d's columns 8j + 2t, 8j + 2t + 1
// for bf16, so a product's float accumulators are the next one's A after the
// rounding; for TF32 it is so with the k8 step's columns read in the order
// 0, 2, 4, 6, 1, 3, 5, 7.  bf16's B is N-major (the transpose bit: V's own
// (keys, hd) rows), TF32's K-major (the only layout .tf32 takes).
struct WgmmaRS32 {
  static __device__ __forceinline__ void bf16_nmajor(float (&d)[16], const uint32_t (&a)[4],
                                                     uint64_t db) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" GIC_OPS16
                 "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
                 : GIC_ACC16("+f", d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
  static __device__ __forceinline__ void tf32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" GIC_OPS16
                 "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
                 : GIC_ACC16("+f", d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
// The TF32 register-A form at N 128: d (64 x 128) += A (64 x k8, the
// warpgroup's fragments as WgmmaRS32's) x B (k8 x 128, K-major in shared
// memory).  The patch embedding's float32 route runs on it with W^T as A.
struct WgmmaRS128 {
  static __device__ __forceinline__ void tf32(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" GIC_OPS64
                 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                 : GIC_ACC64("+f", d)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma, TMA); a barrier then passes them on.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Thread-block clusters: this block's rank, the cluster-wide barrier in its
// two halves (every thread of every block of the cluster arrives, then
// waits; arrive releases and wait acquires, so shared writes before the
// arrival are visible to the cluster's reads after the wait), and reads
// of another block's shared memory (distributed shared memory) at the
// address ``addr`` has in this block.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();  // .aligned: the warp arrives together
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// the same, a thread at a time (its warp need not be converged)
__device__ __forceinline__ void cluster_arrive_thread() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_thread() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster(uint32_t addr, float*) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ int4 ld_cluster(uint32_t addr, int*) {
  int4 v;
  asm volatile("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Named barriers (0 is __syncthreads) over ``n`` threads, whole warps.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Hopper's register reallocation (sm_90a): every thread of the calling
// warpgroup lowers (dec) or raises (inc) its register count to N, a
// multiple of 8 in [24, 256]; inc waits until other warpgroups of the block
// have released enough.  The kernel needs a register count fixed at its
// launch (__launch_bounds__), which ptxas takes as the count on entry.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// The LayerNorm pre-pass and the epilogues' elementwise pieces
// ---------------------------------------------------------------------------

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

// Internal linkage: each .cu that includes this header gets its own copy of
// the pre-pass kernel, so no two translation units register one kernel.
namespace {

// The LayerNorm pre-pass: each float32 row normalised once, a block of four
// warps a row, into (M, K) rows of the compute dtype T (ln_value: the
// float64 statistics rounded once, then the elementwise float32 steps and
// the rounding to T) — the operand that fused_linear.cu's bf16 products,
// the prefill's products and the vocabulary walks read.  A row of whole
// 16-byte vectors up to 2,048 elements (every GPT-2 width) is read once
// into registers, all of a thread's loads in flight together, and
// normalised from there; four warps a row keep each thread's chain of
// dependent instructions (the float64 sums, the stores) short, which sets
// a launch's time at these sizes (one warp a row took 5.5 us at 128 rows
// of 768 on an H100).  Other rows are walked an element a lane by the
// block's first warp, once for each statistic and once to write.  With xl
// (float rows only), each value y is stored as its three-term TF32 pair:
// hi = tf32(y) in xf and lo = tf32(y - hi) in xl (split_tf32), the operands
// of the float32 projections (fused_linear.cu) and vocabulary walk.  Launch:
// launch_ln_rows.
constexpr int kLnThreads = 128;  // a row's threads: 4 warps
constexpr int kLnVectors = 4;    // float4 registers a thread: rows of <= 2,048 floats

// The sum of a 128-thread block's values, its 4 warps' sums added in warp
// order (a fixed order), to every thread; red: 4 doubles of shared memory.
__device__ __forceinline__ double block_sum(double v, double* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  const double total = ((red[0] + red[1]) + red[2]) + red[3];
  __syncthreads();  // red is written again by the next sum
  return total;
}

// Stores y at out[0], or with lo its TF32 pair at out[0] and lo[0].
__device__ __forceinline__ void ln_store(float* out, float* lo, float y) {
  if (lo) {
    uint32_t h, l;
    split_tf32(y, h, l);
    *out = __uint_as_float(h);
    *lo = __uint_as_float(l);
  } else {
    *out = y;
  }
}
__device__ __forceinline__ void ln_store(__nv_bfloat16* out, float*, __nv_bfloat16 y) { *out = y; }

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
ln_rows_kernel(const float* x, const float* ln_s, const float* ln_b, float eps, int M, int K,
               T* xf, float* xl) {
  const int m = blockIdx.x;
  if (m >= M) return;
  const float* row = x + (size_t)m * K;
  T* out = xf + (size_t)m * K;
  float* out_lo = xl ? xl + (size_t)m * K : nullptr;
  float mean, rstd;
  const bool vec = K % 4 == 0 && K <= 4 * kLnThreads * kLnVectors &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ln_s) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ln_b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xf) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(xl) % 16 == 0;
  if (!vec) {
    if (threadIdx.x >= 32) return;
    row_mean_rstd(row, K, eps, mean, rstd);
    for (int k = threadIdx.x; k < K; k += 32)
      ln_store(out + k, out_lo ? out_lo + k : nullptr,
               ln_value<T>(row[k], mean, rstd, ln_s[k], ln_b[k]));
    return;
  }
  __shared__ double red[kLnThreads / 32];
  const int nv = K / 4;  // the row's 16-byte vectors; thread t holds t, t + 128, ..
  float4 v[kLnVectors];
#pragma unroll
  for (int i = 0; i < kLnVectors; ++i) {
    const int j = threadIdx.x + kLnThreads * i;
    v[i] = j < nv ? reinterpret_cast<const float4*>(row)[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // the statistics of row_mean_rstd, in float64, rounded once
  double sum = 0.0;
#pragma unroll
  for (int i = 0; i < kLnVectors; ++i)
    sum += ((double)v[i].x + (double)v[i].y) + ((double)v[i].z + (double)v[i].w);
  const double mu = block_sum(sum, red) / K;
  double var = 0.0;
#pragma unroll
  for (int i = 0; i < kLnVectors; ++i) {
    if (threadIdx.x + kLnThreads * i < nv) {
      const double a = v[i].x - mu, b = v[i].y - mu, c = v[i].z - mu, d = v[i].w - mu;
      var += (a * a + b * b) + (c * c + d * d);
    }
  }
  mean = (float)mu;
  rstd = (float)(1.0 / sqrt(block_sum(var, red) / K + (double)eps));
#pragma unroll
  for (int i = 0; i < kLnVectors; ++i) {
    const int j = threadIdx.x + kLnThreads * i;
    if (j < nv) {
      const float4 s = reinterpret_cast<const float4*>(ln_s)[j];
      const float4 b = reinterpret_cast<const float4*>(ln_b)[j];
      const T y0 = ln_value<T>(v[i].x, mean, rstd, s.x, b.x);
      const T y1 = ln_value<T>(v[i].y, mean, rstd, s.y, b.y);
      const T y2 = ln_value<T>(v[i].z, mean, rstd, s.z, b.z);
      const T y3 = ln_value<T>(v[i].w, mean, rstd, s.w, b.w);
      if constexpr (std::is_same<T, float>::value) {
        if (out_lo) {
          float4 h, l;
          ln_store(&h.x, &l.x, y0);
          ln_store(&h.y, &l.y, y1);
          ln_store(&h.z, &l.z, y2);
          ln_store(&h.w, &l.w, y3);
          reinterpret_cast<float4*>(out)[j] = h;
          reinterpret_cast<float4*>(out_lo)[j] = l;
        } else {
          reinterpret_cast<float4*>(out)[j] = make_float4(y0, y1, y2, y3);
        }
      } else {
        __nv_bfloat162 lo, hi;
        lo.x = y0;
        lo.y = y1;
        hi.x = y2;
        hi.y = y3;
        reinterpret_cast<uint2*>(out)[j] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                                      *reinterpret_cast<const uint32_t*>(&hi));
      }
    }
  }
}

// One launch of ln_rows_kernel over M rows on stream s.
template <typename T>
void launch_ln_rows(cudaStream_t s, const float* x, const float* ln_s, const float* ln_b,
                    float eps, int M, int K, T* xf, float* xl) {
  ln_rows_kernel<T><<<M, kLnThreads, 0, s>>>(x, ln_s, ln_b, eps, M, K, xf, xl);
}

}  // namespace

}  // namespace gic
