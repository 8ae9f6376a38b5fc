// Final LayerNorm + tied-embedding logits + per-row top-k and logsumexp of
// the decode step: the beam-search tail's input, without storing the (B, V)
// logits.
//
// Replaces: the topk mode of gpt2_image_captioning_tpu/ops/decode_step.py::
// _step_kernel (:569-616): each row's k largest logits, descending, ties to
// the smaller token id, with distinct ids (ops/sampling.py::topk_small masks
// a taken entry with -inf), and the row's logsumexp by the online (max, sum)
// merge.  Columns >= V are masked.
//
// Bound on the H100: the operations.  At B = 512 (128 images x 4 beams) in
// bf16 the product is 2 x 512 x 768 x 50257 = 39.5 GFLOP, ~40 us at
// 989 TFLOP/s; the bytes (wte, 77.2 MB) take ~23 us.  With an int8 wte
// (W8A8): 39.5 G int8 operations, ~20 us at 1,979 TOPS, and 38.6 MB of wte.
// float32: the split's three TF32 products, 118.6 GFLOP, 240 us at 495
// TFLOP/s.
//
// Every operand type runs the vocabulary walk of vocab_walk.cuh (TMA ring,
// wgmma — float32 on wgmma TF32 with the three-term split —, a block per
// (row tile, column range)).  Pass 0 normalises each row once (for an int8
// wte it quantizes it, for float32 it writes its TF32 hi and lo parts:
// vocab.cuh, vw_prepass).  In the walk each
// thread keeps, for each of its two rows, the running (max, sum of exp(logit
// - max)) and a sorted top-k of the logits it holds, in registers (KS
// slots, 4, 8 or 16, the fewest that hold k).  A tile's logits first give
// each row's max (the sum is rescaled once a tile, and its terms use the
// fast exp, ~1e-6 relative: the logsumexp's tolerance is 1e-4); a logit
// enters the list only if it beats the best last slot of the quad's four
// lanes as the tile began (with fewer than k better logits in the quad it
// could be in the top-k; with k, it cannot), which few do once the lists
// fill.  At the end of its range the quad merges: the (max, sum) pairs,
// then k rounds of the quad's (value, index) argmax over the lanes' heads,
// the winner popping its head.  So the partials are one per (row, block),
// k entries and a (max, sum) pair: 33 a row at B 512, not the 1,571 of a
// 32-column tile of the first port.  The merge launch gives each row one
// warp: the lanes fold the (max, sum) pairs into the logsumexp in block
// order and keep sorted top-k lists of the partials, then k rounds of the
// warp argmax pick the row's top-k.  The global top-k lies in the union of
// the blocks' top-k, every comparison is the (value, index) order, and
// every sum runs in a fixed order, so the result does not depend on which
// block finished first and two runs give the same bits.  In float32 the
// selection holds more registers than the walk's 16-warp block leaves a
// thread; the walk trades them from its service warpgroups to its
// consumers (vocab_walk.cuh, "Registers of the float32 selections").
#include "vocab_walk.cuh"

namespace gic {

constexpr int kMaxK = 16;  // the merge keeps a lane's top-k in registers

__global__ void topk_merge_kernel(const float* part_val, const int* part_idx,
                                  const float* part_m, const float* part_s, int M, int nblk,
                                  int k, float* vals, int* ids, float* lse) {
  const int m = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;

  // logsumexp: the online (max, sum) merge of the tiles' partials
  const float* pm = part_m + (size_t)m * nblk;
  const float* ps = part_s + (size_t)m * nblk;
  float mx = -CUDART_INF_F;
  for (int j = lane; j < nblk; j += 32) mx = fmaxf(mx, pm[j]);
  mx = warp_max(mx);
  float s = 0.f;
  for (int j = lane; j < nblk; j += 32) s += ps[j] * expf(pm[j] - mx);
  s = warp_sum(s);
  if (lane == 0) lse[m] = mx + logf(s);

  // each lane's sorted top-k of the partials it reads, best first
  float lv[kMaxK];
  int li[kMaxK];
#pragma unroll
  for (int jj = 0; jj < kMaxK; ++jj) {
    lv[jj] = -CUDART_INF_F;
    li[jj] = INT_MAX;
  }
  const int nc = nblk * k;
  const float* pv = part_val + (size_t)m * nc;
  const int* pi = part_idx + (size_t)m * nc;
  for (int c = lane; c < nc; c += 32) {
    float v = pv[c];
    int i = pi[c];
#pragma unroll
    for (int jj = 0; jj < kMaxK; ++jj) {  // insertion: the displaced entry moves down
      if (jj < k && better(v, i, lv[jj], li[jj])) {
        const float tv = lv[jj];
        const int ti = li[jj];
        lv[jj] = v;
        li[jj] = i;
        v = tv;
        i = ti;
      }
    }
  }
  for (int j = 0; j < k; ++j) {
    float wv = lv[0];
    int wi = li[0];
    warp_argmax(wv, wi);
    if (lane == 0) {
      vals[(size_t)m * k + j] = wv;
      ids[(size_t)m * k + j] = wi;
    }
    if (li[0] == wi && wi != INT_MAX) {  // ids are distinct: one lane pops its head
#pragma unroll
      for (int jj = 0; jj + 1 < kMaxK; ++jj) {
        lv[jj] = lv[jj + 1];
        li[jj] = li[jj + 1];
      }
      lv[kMaxK - 1] = -CUDART_INF_F;
      li[kMaxK - 1] = INT_MAX;
    }
  }
}

// Per thread, for each of its two rows: the running (max, sum) and a sorted
// top-KS of its logits, best first.
template <typename E, int KS>
struct TopkSel {
  static constexpr int kSteps = VW_STEPS;  // four logits a step (vocab_walk)
  static constexpr bool kInt8 = std::is_same<E, int8_t>::value;
  const float* sw;  // int8: wte's (V,) scales
  int V;
  float rs[2];      // int8: the rows' scales
  float m[2], s[2];
  float lv[2][KS];
  int li[2][KS];
  int c0;                       // the tile's first column of the thread
  float tv[2];                  // the quad's best last slot as the tile began
  int ti[2];
  bool seen[2];

  __device__ __forceinline__ void init(const float* sx, const float* sw_, int M, int V_,
                                       int row0) {
    sw = sw_;
    V = V_;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      rs[h] = kInt8 && row < M ? sx[row] : 0.f;
      m[h] = -CUDART_INF_F;
      s[h] = 0.f;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        lv[h][j] = -CUDART_INF_F;
        li[h][j] = INT_MAX;
      }
    }
  }

  // Inserts (v, n) into row h's sorted list, the displaced entry moving down.
  __device__ __forceinline__ void insert(int h, float v, int n) {
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      if (better(v, n, lv[h][j], li[h][j])) {
        const float tv = lv[h][j];
        const int ti = li[h][j];
        lv[h][j] = v;
        li[h][j] = n;
        v = tv;
        n = ti;
      }
    }
  }

  // A tile (vocab_walk): its logits and row maxima, the rescaled (max,
  // sum), and the best last slot of the quad's lanes as the tile begins: a
  // logit that loses to that slot has k better ones in the quad's lists and
  // is in no top-k, so once the lists fill a step inserts nothing.
  template <typename Acc>
  __device__ __forceinline__ void prepare(Acc (&d)[VW_ACC], float (&lg)[VW_ACC], int n0) {
    const float one[2] = {1.f, 1.f};
    float mx[2];
    c0 = n0 + 2 * (threadIdx.x % 4);
    vw_logits(d, c0, V, sw, rs, one, lg, mx);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float none = 0.f;
      tv[h] = lv[h][KS - 1];
      ti[h] = li[h][KS - 1];
      quad_argmax(tv[h], ti[h], none);
      lse_rescale(m[h], s[h], mx[h]);
      seen[h] = m[h] != -CUDART_INF_F;  // a column of the row below V so far
    }
  }

  // Step j of a tile: the sums of exp and the insertions of four logits.
  __device__ __forceinline__ void step(float (&lg)[VW_ACC], int j) {
    const int n = c0 + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = lg[2 * h + e];
        s[h] += seen[h] ? __expf(v - m[h]) : 0.f;  // 0 past V
        if (n + e < V && better(v, n + e, tv[h], ti[h])) insert(h, v, n + e);
      }
    }
    vw_shift(lg);
  }

  // The quad's merge; its first lane writes the (row, block) partials.
  __device__ __forceinline__ void finish(int M, int row0, int k, size_t ranges, int range,
                                         float* part_val, int* part_idx, float* part_m,
                                         float* part_s) {
    const bool lead = threadIdx.x % 4 == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const bool write = lead && row < M;
      const size_t slot = (size_t)row * ranges + range;
      quad_lse(m[h], s[h]);
      if (write) {
        part_m[slot] = m[h];
        part_s[slot] = s[h];
      }
      for (int j = 0; j < k; ++j) {
        float bv = lv[h][0], none = 0.f;
        int bi = li[h][0];
        quad_argmax(bv, bi, none);
        if (write) {
          part_val[slot * k + j] = bv;
          part_idx[slot * k + j] = bi;
        }
        if (li[h][0] == bi && bi != INT_MAX) {  // ids are distinct: one lane pops its head
#pragma unroll
          for (int jj = 0; jj + 1 < KS; ++jj) {
            lv[h][jj] = lv[h][jj + 1];
            li[h][jj] = li[h][jj + 1];
          }
          lv[h][KS - 1] = -CUDART_INF_F;
          li[h][KS - 1] = INT_MAX;
        }
      }
    }
  }
};

// Grid (row tiles, ranges): the partials of rows blockIdx.x * bm .. over
// range blockIdx.y's tiles.  part_*: (M, ranges, k) and (M, ranges).
template <typename E, int KS>
__global__ void __launch_bounds__(vw_max_threads<E>(), 1)
topk_walk_kernel(const __grid_constant__ CUtensorMap amap,
                 const __grid_constant__ CUtensorMap wmap, int M, int K, int V, int k,
                 float* part_val, int* part_idx, float* part_m, float* part_s, const float* sx,
                 const float* sw) {
  const int tiles = (V + VW_BN - 1) / VW_BN, ranges = gridDim.y, range = blockIdx.y;
  const int row0 = blockIdx.x * (vw_consumers<E>() / 2) + vw_row0();
  TopkSel<E, KS> sel;
  sel.init(sx, sw, M, V, row0);
  vocab_walk<E>(&amap, &wmap, M, K, tiles * range / ranges, tiles * (range + 1) / ranges, sel);
  sel.finish(M, row0, k, ranges, range, part_val, part_idx, part_m, part_s);
}

template <typename E, int KS>
static int launch_topk_walk(cudaStream_t s, const void* xf, const void* wte, int M, int K, int V,
                            int k, int ranges, float* pv, int* pi, float* pm, float* ps,
                            const float* sx, const float* sw) {
  const auto kernel = topk_walk_kernel<E, KS>;
  static const cudaError_t attr = vw_set_smem_heavy<E>(kernel);
  if (attr != cudaSuccess) return (int)attr;
  return vw_launch<E>(kernel, s, xf, wte, M, K, V, ranges, 0, M, K, V, k, pv, pi, pm, ps, sx, sw);
}

// Pass 0 (vw_prepass) and pass 1 (the walk), ranges partials a row.
// Returns 0 or a cudaError_t.
template <typename T, typename E>
static int launch_walk(cudaStream_t s, const float* x, const float* lns, const float* lnb,
                       float eps, const void* wte, const float* wte_scale, int M, int K, int V,
                       int k, int ranges, void* xf, float* sx, float* pv, int* pi, float* pm,
                       float* ps) {
  vw_prepass<T, E>(s, x, lns, lnb, eps, M, K, xf, sx);
  const cudaError_t pre = cudaGetLastError();
  if (pre != cudaSuccess) return (int)pre;
  if (k <= 4)
    return launch_topk_walk<E, 4>(s, xf, wte, M, K, V, k, ranges, pv, pi, pm, ps, sx, wte_scale);
  if (k <= 8)
    return launch_topk_walk<E, 8>(s, xf, wte, M, K, V, k, ranges, pv, pi, pm, ps, sx, wte_scale);
  return launch_topk_walk<E, 16>(s, xf, wte, M, K, V, k, ranges, pv, pi, pm, ps, sx, wte_scale);
}

// The float32 walk kernels' registers and local bytes a thread (vw_attrs),
// for k's three list sizes in turn: variant 0, 1, 2 for 4, 8, 16 slots.
static int topk_f32_attrs(int variant, int* out) {
  if (variant == 0) return vw_attrs(topk_walk_kernel<float, 4>, out);
  if (variant == 1) return vw_attrs(topk_walk_kernel<float, 8>, out);
  if (variant == 2) return vw_attrs(topk_walk_kernel<float, 16>, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace gic

// x32: (M, K) float32 residual stream; wte: (V, K) element type, or int8
// when wte_scale ((V,) float32) is given; xf: (M, K) element-type scratch
// (int8 rows with an int8 wte, their scales in sx, (M,) float32 scratch;
// (2, M, K) float32 for float32, the rows' TF32 hi and lo parts); nblk:
// the walk's ranges, the partials a row (ops/decode_step.py::
// vocab_partials, 1 .. ceil(V / 128)); part_val/part_idx: (M, nblk, k)
// and part_m/part_s: (M, nblk)
// float32/int32 scratch; vals (M, k) float32, ids (M, k) int32, lse (M,)
// float32.  1 <= k <= min(16, V); K a multiple of the 16-byte vector width.
// Returns the first launch error (cudaGetLastError() after the three
// launches).
extern "C" int gic_logits_topk(int dtype, const void* x32, const void* ln_s, const void* ln_b,
                               float eps, const void* wte, const void* wte_scale, int M, int K,
                               int V, int k, int nblk, void* xf, void* sx, void* part_val,
                               void* part_idx, void* part_m, void* part_s, void* vals, void* ids,
                               void* lse, void* stream) {
  using namespace gic;
  if (M <= 0 || K <= 0 || V <= 0 || k < 1 || k > kMaxK || k > V || nblk < 1 ||
      nblk > (V + VW_BN - 1) / VW_BN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(x32);
  const float* lns = static_cast<const float*>(ln_s);
  const float* lnb = static_cast<const float*>(ln_b);
  float* pv = static_cast<float*>(part_val);
  int* pi = static_cast<int*>(part_idx);
  float* pm = static_cast<float*>(part_m);
  float* ps = static_cast<float*>(part_s);
  const float* ws = static_cast<const float*>(wte_scale);
  float* sq = static_cast<float*>(sx);
  int err = 0;
  if (!with_types(dtype, ws != nullptr, [&](auto t) {
        using Ty = decltype(t);
        err = launch_walk<typename Ty::T, typename Ty::E>(s, x, lns, lnb, eps, wte, ws, M, K, V,
                                                          k, nblk, xf, sq, pv, pi, pm, ps);
      }))
    return (int)cudaErrorInvalidValue;
  if (err) return err;
  const int rows_per_block = 4;  // one warp per row
  topk_merge_kernel<<<(M + rows_per_block - 1) / rows_per_block, 32 * rows_per_block, 0, s>>>(
      pv, pi, pm, ps, M, nblk, k, static_cast<float*>(vals), static_cast<int*>(ids),
      static_cast<float*>(lse));
  return (int)cudaGetLastError();
}

// The float32 walk kernel's registers and local (spill) bytes a thread for
// k's list size ``variant`` (0, 1, 2: 4, 8, 16 slots) into out[0], out[1].
// Returns 0 or a cudaError_t (cudaErrorInvalidValue past the variants).
extern "C" int gic_logits_topk_f32_attrs(int variant, int* out) {
  return gic::topk_f32_attrs(variant, out);
}
