// Shared pieces of the port's CUDA kernels: element types, warp reductions,
// the Hopper building blocks (TMA tensor maps and copies, mbarriers, wgmma
// descriptors and products, cluster barriers and distributed shared memory)
// that fused_linear.cu and patch_embed.cu run on, the LayerNorm pre-pass,
// and the tiled row-block x weight-tile product that the float32 route of
// fused_linear.cu, the vocabulary kernels and the prefill run.
//
// Element type codes match ops/_build.py::DTYPE_CODE: 0 = float, 1 = bf16.
// Inputs are read in the element type, products accumulate in float32, and
// LayerNorm statistics are float32, as in the TPU kernel
// (gpt2_image_captioning_tpu/ops/decode_step.py::_step_kernel).  The W8A8
// mode (the step kernel's quant mode) multiplies int8 rows by int8 weights
// with int32 accumulators and dequantizes as acc * sx * sw.
//
// Which design runs where: the decode step's bf16 and int8 projections
// (fused_linear.cu) stream their operands by TMA into a ring and multiply
// on wgmma, split over K across a thread-block cluster (its header gives the
// design and the bound).  The tile below serves the float32 projections,
// the four vocabulary kernels (every operand type) and the prefill kernel's
// products (prefill.cu, gpt2_image_captioning_tpu/ops/prefill_step.py::
// _prefill_kernel).  Its bound on the H100: at a decode batch of 128 the
// weights' bytes (a float32 GPT-2 layer: 28 MB, 8.5 us at 3.35 TB/s); the
// prefill's 1,920 rows are bound by operations (float32: three TF32
// products at 495 TFLOP/s).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the CUDA driver at run time
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

// A wgmma shared-memory descriptor: 128-byte swizzle, byte offsets lbo
// (between 64-element blocks along the contiguous dimension; unused where
// one k-step lies inside a 128-byte row) and sbo (between 8-row groups).
// The tile's base is 1024-byte aligned, so a k-step inside the swizzled row
// is the base plus its byte offset.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
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
// 64 and 128: bf16 (k16, float32 accumulators) and int8 (k32, int32
// accumulators, exact).  d has N / 2 registers a thread: d[4j + e] holds
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
  };
template <int N> struct Wgmma;
GIC_WGMMA(32, 16, GIC_OPS16, GIC_ACC16, 16, 17, 18)
GIC_WGMMA(64, 32, GIC_OPS32, GIC_ACC32, 32, 33, 34)
GIC_WGMMA(128, 64, GIC_OPS64, GIC_ACC64, 64, 65, 66)
#undef GIC_WGMMA
#undef GIC_WGMMA_TAIL

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

// Named barriers (0 is __syncthreads) over ``n`` threads, whole warps.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------------------------------
// Tiled product: one block computes a BM x BN tile of
//   Y = prologue(X) @ W^T,   X (M, K) row-major,  W (N, K) row-major,
// walking K in BK steps through shared memory.  W is stored output-major
// ((N, K): each output column's weights are contiguous in K), which is the
// natural layout of the tied embedding (V, D) and what pack_decode_weights
// gives the four GPT-2 projections.  Its users: the float32 route of
// fused_linear.cu, the four vocabulary kernels in every operand type, and
// the prefill's products.  (The decode step's bf16 and int8 projections
// run on fused_linear.cu's TMA ring, wgmma and cluster split instead: at B
// 128 this tile's 48-192 blocks, one stage in flight each, read every
// weight once a 64-row block and normalised every row once a column block,
// 19x the layer's bound in bf16.)
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
// bound: its grids of 48-192 blocks keep one stage in flight each, and
// each block re-reads its rows from L2.  The vocabulary walks at 1,571
// column blocks fill the card; their bound is wte's bytes.
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

// Internal linkage: each .cu that includes this header gets its own copy of
// the pre-pass kernel, so no two translation units register one kernel.
namespace {

// The LayerNorm pre-pass: each float32 row normalised once, one warp per
// row, into (M, K) rows of the compute dtype T (ln_value: the float64
// statistics rounded once, then the elementwise float32 steps and the
// rounding to T) — the operand that fused_linear.cu's bf16 products and the
// vocabulary walks read.  A row of whole 16-byte vectors up to 2,048
// elements (every GPT-2 width) is read once into registers, all of a lane's
// loads in flight together, and normalised from there; other rows are
// walked an element a lane, once for each statistic and once to write.
constexpr int kLnVectors = 16;  // float4 registers a lane: rows of <= 2,048 floats

template <typename T>
__global__ void ln_rows_kernel(const float* x, const float* ln_s, const float* ln_b, float eps,
                               int M, int K, T* xf) {
  const int m = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (m >= M) return;
  const float* row = x + (size_t)m * K;
  T* out = xf + (size_t)m * K;
  const int lane = threadIdx.x % 32;
  float mean, rstd;
  const bool vec = K % 4 == 0 && K <= 128 * kLnVectors &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ln_s) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ln_b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xf) % (4 * sizeof(T)) == 0;
  if (!vec) {
    row_mean_rstd(row, K, eps, mean, rstd);
    for (int k = lane; k < K; k += 32)
      out[k] = ln_value<T>(row[k], mean, rstd, ln_s[k], ln_b[k]);
    return;
  }
  const int nv = K / 4;  // the row's 16-byte vectors; lane l holds l, l + 32, ..
  float4 v[kLnVectors];
#pragma unroll
  for (int i = 0; i < kLnVectors; ++i)
    v[i] = lane + 32 * i < nv ? reinterpret_cast<const float4*>(row)[lane + 32 * i]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  // the statistics of row_mean_rstd, in float64, rounded once
  double sum = 0.0;
#pragma unroll
  for (int i = 0; i < kLnVectors; ++i)
    sum += ((double)v[i].x + (double)v[i].y) + ((double)v[i].z + (double)v[i].w);
  const double mu = warp_sum(sum) / K;
  double var = 0.0;
#pragma unroll
  for (int i = 0; i < kLnVectors; ++i) {
    if (lane + 32 * i < nv) {
      const double a = v[i].x - mu, b = v[i].y - mu, c = v[i].z - mu, d = v[i].w - mu;
      var += (a * a + b * b) + (c * c + d * d);
    }
  }
  mean = (float)mu;
  rstd = (float)(1.0 / sqrt(warp_sum(var) / K + (double)eps));
#pragma unroll
  for (int i = 0; i < kLnVectors; ++i) {
    const int j = lane + 32 * i;
    if (j < nv) {
      const float4 s = reinterpret_cast<const float4*>(ln_s)[j];
      const float4 b = reinterpret_cast<const float4*>(ln_b)[j];
      const T y0 = ln_value<T>(v[i].x, mean, rstd, s.x, b.x);
      const T y1 = ln_value<T>(v[i].y, mean, rstd, s.y, b.y);
      const T y2 = ln_value<T>(v[i].z, mean, rstd, s.z, b.z);
      const T y3 = ln_value<T>(v[i].w, mean, rstd, s.w, b.w);
      if constexpr (std::is_same<T, float>::value) {
        reinterpret_cast<float4*>(out)[j] = make_float4(y0, y1, y2, y3);
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

constexpr int kLnRowsPerBlock = 4;  // one warp per row

}  // namespace

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
