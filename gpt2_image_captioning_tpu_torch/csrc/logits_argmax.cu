// Final LayerNorm + tied-embedding logits + greedy argmax of the decode step.
//
// Replaces: the greedy vocab walk of gpt2_image_captioning_tpu/ops/decode_step.py::
// _step_kernel (:552-568 and :805-821; the int8 tile :555-563): LN_f of the
// float32 residual stream, logits = LN_f(x) @ wte^T tile by tile, and a
// running (max, argmax) per row in which a larger logit wins and, on equal
// logits, the smaller token id wins (jnp.argmax / torch.argmax order).  The
// (B, V) logits never reach device memory.
//
// Bound on the H100, at the greedy path's B 128: wte's bytes in bf16 (50,257
// x 768 = 77.2 MB, 23 us at 3.35 TB/s) and int8 (38.6 MB, 12 us); in
// float32 the three TF32 products of the split (29.6 GFLOP, 60 us at 495
// TFLOP/s), above wte's 154 MB (46 us).
//
// Design: three launches, in every operand type.  Pass 0 normalises the
// float32 stream once, one warp a row (vocab_walk.cuh::vw_prepass: the
// compute dtype's rows; int8 rows and their scales for an int8 wte; for
// float32 the rows' TF32 hi and lo parts).  Pass 1 is the vocabulary walk
// (vocab_walk.cuh: a block per (row tile, range of 128-column wte tiles),
// TMA ring, wgmma; float32 on wgmma TF32 with the three-term split), whose
// selection is one compare a logit: as each tile's products finish, every
// thread folds its two rows' 32 columns of the tile into a running (value,
// index) in registers, columns in increasing order with a strict compare,
// so an equal logit keeps the smaller id.  At the end of its range the
// thread merges with its quad (the lanes that hold the rest of its rows'
// columns) under the (value, index) order (vocab.cuh::better), and one lane
// writes the row's partial for that block: (B, ranges) pairs, ranges =
// ops/decode_step.py::vocab_plan(B, V).ranges (33 at B 512, 132 at B 128).
// Pass 2 reduces each row's partials with one warp under the same order.
// The blocks run in no order, but every comparison is of (value, index)
// pairs, a total order on distinct ids, so the result does not depend on
// which block finished first.  Columns >= V are -inf and never win; rows
// >= M write nothing.
#include "vocab_walk.cuh"

namespace gic {

// Per thread, for each of its two rows: the best (value, index) so far.
template <typename E>
struct ArgmaxSel {
  static constexpr int kSteps = 0;  // prepare() folds the whole tile
  static constexpr bool kInt8 = std::is_same<E, int8_t>::value;
  const float* sw;  // int8: wte's (V,) scales
  int V;
  float rs[2];  // int8: the rows' scales
  float bv[2];
  int bi[2];

  __device__ __forceinline__ void init(const float* sx, const float* sw_, int M, int V_,
                                       int row0) {
    sw = sw_;
    V = V_;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      rs[h] = kInt8 && row < M ? sx[row] : 0.f;
      bv[h] = -CUDART_INF_F;
      bi[h] = INT_MAX;
    }
  }

  // A tile (vocab_walk): the thread's logits (-inf past V), taken in
  // increasing column order, so a strict compare keeps the first of equals.
  template <typename Acc>
  __device__ __forceinline__ void prepare(Acc (&d)[VW_ACC], float (&lg)[VW_ACC], int n0) {
    const float one[2] = {1.f, 1.f};
    float mx[2];
    const int c0 = n0 + 2 * (threadIdx.x % 4);
    vw_logits(d, c0, V, sw, rs, one, lg, mx);
#pragma unroll
    for (int j = 0; j < VW_ACC / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = lg[4 * j + 2 * h + e];
          if (v > bv[h]) {
            bv[h] = v;
            bi[h] = c0 + 8 * j + e;
          }
        }
      }
    }
  }

  __device__ __forceinline__ void step(float (&)[VW_ACC], int) {}

  // The quad's best pair; its first lane writes the (row, block) partial.
  __device__ __forceinline__ void finish(int M, int row0, int ranges, int range, float* part_val,
                                         int* part_idx) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float none = 0.f;
      quad_argmax(bv[h], bi[h], none);
      const int row = row0 + 8 * h;
      if (threadIdx.x % 4 == 0 && row < M) {
        part_val[(size_t)row * ranges + range] = bv[h];
        part_idx[(size_t)row * ranges + range] = bi[h];
      }
    }
  }
};

// Grid (row tiles, ranges): the partials of rows blockIdx.x * bm .. over
// range blockIdx.y's tiles.  part_*: (M, ranges).
template <typename E>
__global__ void __launch_bounds__(vw_max_threads<E>(), 1)
argmax_walk_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap wmap, int M, int K, int V,
                   float* part_val, int* part_idx, const float* sx, const float* sw) {
  const int tiles = (V + VW_BN - 1) / VW_BN, ranges = gridDim.y, range = blockIdx.y;
  const int row0 = blockIdx.x * (vw_consumers<E>() / 2) + vw_row0();
  ArgmaxSel<E> sel;
  sel.init(sx, sw, M, V, row0);
  vocab_walk<E>(&amap, &wmap, M, K, tiles * range / ranges, tiles * (range + 1) / ranges, sel);
  sel.finish(M, row0, ranges, range, part_val, part_idx);
}

__global__ void argmax_reduce_kernel(const float* part_val, const int* part_idx, int M, int nblk,
                                     int* tok) {
  const int m = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;
  float v = -CUDART_INF_F;
  int i = INT_MAX;
  for (int j = lane; j < nblk; j += 32) {
    const float pv = part_val[(size_t)m * nblk + j];
    const int pi = part_idx[(size_t)m * nblk + j];
    if (better(pv, pi, v, i)) {
      v = pv;
      i = pi;
    }
  }
  warp_argmax(v, i);
  if (lane == 0) tok[m] = i;
}

template <typename T, typename E>
static int launch_passes(cudaStream_t s, const float* x, const float* lns, const float* lnb,
                         float eps, const void* wte, const float* wte_scale, int M, int K, int V,
                         int ranges, void* xf, float* sx, float* pv, int* pi) {
  vw_prepass<T, E>(s, x, lns, lnb, eps, M, K, xf, sx);
  const cudaError_t pre = cudaGetLastError();
  if (pre != cudaSuccess) return (int)pre;
  const auto kernel = argmax_walk_kernel<E>;
  static const cudaError_t attr = vw_set_smem<E>(kernel);
  if (attr != cudaSuccess) return (int)attr;
  return vw_launch<E>(kernel, s, xf, wte, M, K, V, ranges, 0, M, K, V, pv, pi, sx, wte_scale);
}

}  // namespace gic

// x32: (M, K) float32 residual stream; wte: (V, K) element type, or int8
// when wte_scale ((V,) float32) is given; ranges: the walk's column ranges
// (ops/decode_step.py::vocab_partials, 1 .. ceil(V / 128)); xf: scratch for
// the normalised rows, (M, K) of the element type, int8 with an int8 wte
// (the row scales then in sx, (M,) float32 scratch), (2, M, K) float32 for
// float32 (their TF32 hi and lo parts); part_val/part_idx: (M, ranges)
// float32/int32 scratch; tok: (M,) int32.  K must be a multiple of the
// 16-byte vector width.  Returns the first launch error (cudaGetLastError()
// after the three launches).
extern "C" int gic_logits_argmax(int dtype, const void* x32, const void* ln_s, const void* ln_b,
                                 float eps, const void* wte, const void* wte_scale, int M, int K,
                                 int V, int ranges, void* xf, void* sx, void* part_val,
                                 void* part_idx, void* tok, void* stream) {
  using namespace gic;
  if (M <= 0 || K <= 0 || V <= 0 || ranges < 1 || ranges > (V + VW_BN - 1) / VW_BN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(x32);
  const float* lns = static_cast<const float*>(ln_s);
  const float* lnb = static_cast<const float*>(ln_b);
  float* pv = static_cast<float*>(part_val);
  int* pi = static_cast<int*>(part_idx);
  const float* ws = static_cast<const float*>(wte_scale);
  float* sq = static_cast<float*>(sx);
  int err = 0;
  if (!with_types(dtype, ws != nullptr, [&](auto t) {
        using Ty = decltype(t);
        err = launch_passes<typename Ty::T, typename Ty::E>(s, x, lns, lnb, eps, wte, ws, M, K, V,
                                                            ranges, xf, sq, pv, pi);
      }))
    return (int)cudaErrorInvalidValue;
  if (err) return err;
  const int rows_per_block = 4;  // one warp per row
  argmax_reduce_kernel<<<(M + rows_per_block - 1) / rows_per_block, 32 * rows_per_block, 0, s>>>(
      pv, pi, M, ranges, static_cast<int*>(tok));
  return (int)cudaGetLastError();
}

// The float32 walk kernel's registers and local (spill) bytes a thread into
// out[0], out[1] (vocab_walk.cuh::vw_attrs; variant 0, the only one).
// Returns 0 or a cudaError_t.
extern "C" int gic_logits_argmax_f32_attrs(int variant, int* out) {
  if (variant != 0) return (int)cudaErrorInvalidValue;
  return gic::vw_attrs(gic::argmax_walk_kernel<float>, out);
}
