// Final LayerNorm + tied-embedding logits of the decode step, stored in
// float32: the sampled-decode tail's input.
//
// Replaces: the emit_logits mode of gpt2_image_captioning_tpu/ops/decode_step.py::
// _step_kernel (:617-640; the int8 tile :555-563): LN_f of the float32
// residual stream, then logits = LN_f(x) @ wte^T tile by tile, each tile
// written to a (B, V) float32 tensor (the TPU kernel streams (NT_v, B, VW)
// tiles and the wrapper slices them to (B, V); here the store is (B, V)
// directly).
//
// Bound on the H100, at the sampled path's B 128: the bytes in bf16 (wte
// 77.2 MB read, the logits 25.7 MB written: 31 us at 3.35 TB/s; the
// products 9.9 GFLOP, 10 us) and int8 (38.6 MB of wte, 19 us); in float32
// the three TF32 products of the split (29.6 GFLOP, 60 us at 495 TFLOP/s)
// above the bytes (154 + 25.7 MB, 54 us).
//
// Design: two launches, in every operand type.  Pass 0 normalises each row
// once (vocab_walk.cuh::vw_prepass; int8 rows and scales for an int8 wte,
// TF32 hi and lo parts for float32), pass 1 is the vocabulary walk
// (vocab_walk.cuh: a block per (row tile, range of 128-column wte tiles),
// TMA ring, wgmma; float32 on wgmma TF32 with the three-term split), whose
// selection is the store: as each tile's products finish, the threads that
// hold them write the tile's logits out.  V is odd (50,257), so a row of the
// (B, V) float32 output starts 4 bytes past an 8-byte boundary on every
// other row: a float2 store would be misaligned there, and the tensor's row
// pitch (4 V bytes) is no multiple of 16, which a TMA store needs.  Straight
// from the accumulators (a thread holds rows r and r + 8, columns c0 + 8 j +
// {0, 1}) the stores are 4-byte and each warp instruction scatters 128 bytes
// over 8 rows; so each warp stages a quarter of its 16 rows' tile (32
// columns) in a shared slot of its own past the ring (float2 writes, the
// pitch 40 floats keeping them free of bank conflicts), then stores each row's
// 32 columns with one instruction: 128 consecutive bytes, 4-byte aligned.
// That took the bf16 store at B 128 from 0.0772 to 0.0525 device ms (B 512:
// 0.2262 to 0.1299; NVIDIA H100 80GB HBM3, 700 W, one card, both in one
// process: scratch builds of csrc/ timed as scripts/vocab_walk_split.py
// does).  Columns >= V and rows >= M are not stored, so the output is exactly
// the contiguous (B, V) tensor that ops/decode_step.py::logits_plain returns.
#include "vocab_walk.cuh"

namespace gic {

// The store's staging: each consumer warp writes a quarter of its 16 rows'
// tile (32 columns) to its own shared slot, then stores a row's 32 columns
// with one warp instruction.  The pitch, 40 floats (8 mod 32 banks), lets a
// half-warp's float2 writes (4 rows x 4 lanes) hit 32 distinct banks.
constexpr int kStageCols = 32;
constexpr int kStagePitch = kStageCols + 8;
constexpr int kStageWarpFloats = 16 * kStagePitch;

// Per consumer thread: its warp's rows and staging slot.
template <typename E>
struct StoreSel {
  static constexpr int kSteps = 0;  // prepare() stores the whole tile
  static constexpr bool kInt8 = std::is_same<E, int8_t>::value;
  const float* sw;  // int8: wte's (V,) scales
  int M, V;
  int wrow0;        // the warp's first row (rows wrow0 .. wrow0 + 15)
  float rs[2];      // int8: the rows' scales
  float* logits;
  float* stage;     // the warp's staging slot

  __device__ __forceinline__ void init(const float* sx, const float* sw_, float* logits_, int M_,
                                       int V_, int row0) {
    sw = sw_;
    M = M_;
    V = V_;
    logits = logits_;
    wrow0 = row0 - (int)(threadIdx.x % 32) / 4;
    stage = reinterpret_cast<float*>(vw_after_ring<E>()) + (threadIdx.x / 32) * kStageWarpFloats;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      rs[h] = kInt8 && row < M ? sx[row] : 0.f;
    }
  }

  // A tile (vocab_walk): its logits, a quarter (j = 4 q .. 4 q + 3: columns
  // 32 q .. 32 q + 31) at a time through the warp's slot, then each of the
  // warp's rows below M as one 128-byte run of its columns below V.
  template <typename Acc>
  __device__ __forceinline__ void prepare(Acc (&d)[VW_ACC], float (&lg)[VW_ACC], int n0) {
    const float one[2] = {1.f, 1.f};
    float mx[2];
    const int lane = threadIdx.x % 32, t = lane % 4, r = lane / 4;
    vw_logits(d, n0 + 2 * t, V, sw, rs, one, lg, mx);
#pragma unroll
    for (int q = 0; q < VW_BN / kStageCols; ++q) {
#pragma unroll
      for (int jj = 0; jj < kStageCols / 8; ++jj) {
        const int j = 4 * q + jj;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(stage + (r + 8 * h) * kStagePitch + 8 * jj + 2 * t) =
              make_float2(lg[4 * j + 2 * h], lg[4 * j + 2 * h + 1]);
      }
      __syncwarp();
      const int n = n0 + kStageCols * q + lane;
#pragma unroll 4
      for (int rr = 0; rr < 16; ++rr) {
        const int row = wrow0 + rr;
        if (row < M && n < V) logits[(size_t)row * V + n] = stage[rr * kStagePitch + lane];
      }
      __syncwarp();
    }
  }

  __device__ __forceinline__ void step(float (&)[VW_ACC], int) {}
};

// Grid (row tiles, ranges): rows blockIdx.x * bm .., range blockIdx.y's
// tiles, stored into logits (M, V).
template <typename E>
__global__ void __launch_bounds__(vw_max_threads<E>(), 1)
store_walk_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap wmap, int M, int K, int V, float* logits,
                  const float* sx, const float* sw) {
  const int tiles = (V + VW_BN - 1) / VW_BN, ranges = gridDim.y, range = blockIdx.y;
  const int row0 = blockIdx.x * (vw_consumers<E>() / 2) + vw_row0();
  StoreSel<E> sel;
  sel.init(sx, sw, logits, M, V, row0);
  vocab_walk<E>(&amap, &wmap, M, K, tiles * range / ranges, tiles * (range + 1) / ranges, sel);
}

// The staging's bytes at 128 rows: 8 consumer warps' slots.
constexpr size_t kStageBytes = 8 * kStageWarpFloats * sizeof(float);

template <typename T, typename E>
static int launch_passes(cudaStream_t s, const float* x, const float* lns, const float* lnb,
                         float eps, const void* wte, const float* wte_scale, int M, int K, int V,
                         int ranges, void* xf, float* sx, float* logits) {
  vw_prepass<T, E>(s, x, lns, lnb, eps, M, K, xf, sx);
  const cudaError_t pre = cudaGetLastError();
  if (pre != cudaSuccess) return (int)pre;
  const auto kernel = store_walk_kernel<E>;
  static const cudaError_t attr = vw_set_smem<E>(kernel, kStageBytes);
  if (attr != cudaSuccess) return (int)attr;
  return vw_launch<E>(kernel, s, xf, wte, M, K, V, ranges, kStageBytes, M, K, V, logits, sx,
                      wte_scale);
}

}  // namespace gic

// x32: (M, K) float32 residual stream; wte: (V, K) element type, or int8
// when wte_scale ((V,) float32) is given; ranges: the walk's column ranges
// (ops/decode_step.py::vocab_plan, 1 .. ceil(V / 128)); xf: scratch for the
// normalised rows, (M, K) of the element type, int8 with an int8 wte (their
// scales then in sx, (M,) float32 scratch), (2, M, K) float32 for float32
// (their TF32 hi and lo parts); logits: (M, V) float32.  K must be a
// multiple of the 16-byte vector width.  Returns the first launch error.
extern "C" int gic_logits(int dtype, const void* x32, const void* ln_s, const void* ln_b,
                          float eps, const void* wte, const void* wte_scale, int M, int K, int V,
                          int ranges, void* xf, void* sx, void* logits, void* stream) {
  using namespace gic;
  if (M <= 0 || K <= 0 || V <= 0 || ranges < 1 || ranges > (V + VW_BN - 1) / VW_BN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(x32);
  const float* lns = static_cast<const float*>(ln_s);
  const float* lnb = static_cast<const float*>(ln_b);
  float* out = static_cast<float*>(logits);
  const float* ws = static_cast<const float*>(wte_scale);
  float* sq = static_cast<float*>(sx);
  int err = 0;
  if (!with_types(dtype, ws != nullptr, [&](auto t) {
        using Ty = decltype(t);
        err = launch_passes<typename Ty::T, typename Ty::E>(s, x, lns, lnb, eps, wte, ws, M, K, V,
                                                            ranges, xf, sq, out);
      }))
    return (int)cudaErrorInvalidValue;
  return err;
}

// The float32 walk kernel's registers and local (spill) bytes a thread into
// out[0], out[1] (vocab_walk.cuh::vw_attrs; variant 0, the only one).
// Returns 0 or a cudaError_t.
extern "C" int gic_logits_f32_attrs(int variant, int* out) {
  if (variant != 0) return (int)cudaErrorInvalidValue;
  return gic::vw_attrs(gic::store_walk_kernel<float>, out);
}

// The walk's ring for a block of bm rows and operands of el bytes (1, 2 or
// 4): its stages, and its dynamic shared memory in bytes with (store 1) or
// without the store's staging, the values that ops/decode_step.py::
// vocab_ring mirrors.
extern "C" int gic_vocab_stages(int bm, int el) { return gic::vw_stages(bm, el); }
extern "C" int gic_vocab_smem(int bm, int el, int store) {
  return (int)(gic::vw_smem(bm, el) + (store ? gic::kStageBytes : 0));
}
