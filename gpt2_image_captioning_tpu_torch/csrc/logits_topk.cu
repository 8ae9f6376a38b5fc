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
// 989 TFLOP/s; the bytes (wte, 77.2 MB) take ~23 us.
//
// Design: three launches.  Pass 0 normalises each row once (vocab.cuh).
// Pass 1 is the common.cuh tile over wte; for each row of its 64 x 32 tile
// one warp (a lane per column) reduces the 32 logits to a partial (max,
// sum of exp(logit - max)) and a partial top-k: k rounds of the warp's
// (value, index) argmax, the winning lane dropping out as (-inf, INT_MAX),
// so a tile with fewer than k columns left pads with entries that lose to
// every real one.  The partials go to (B, ceil(V/32), k) and (B, ceil(V/32))
// scratch (1/8 of the logits' bytes at k = 4).  Pass 2 gives each row one
// warp: the lanes fold the partial (max, sum) pairs into the logsumexp, and
// each lane keeps a sorted top-k of the partials it reads (in registers,
// k <= 16), then k rounds of the warp argmax over the lanes' heads pick the
// row's top-k, the winning lane popping its head.  The global top-k lies in
// the union of the tiles' top-k, and every comparison is the (value, index)
// order, so the result does not depend on which block finished first.  With
// an int8 wte (W8A8) pass 0 quantizes the rows too and pass 1 runs the int8
// tile: 39.5 G int8 operations, ~20 us at 1,979 TOPS, and 38.6 MB of wte.
#include "vocab.cuh"

namespace gic {

constexpr int kMaxK = 16;  // the merge keeps a lane's top-k in registers

template <typename T>
__global__ void __launch_bounds__(THREADS)
topk_tile_kernel(const T* xf, const T* wte, int M, int K, int V, int k, float* part_val,
                 int* part_idx, float* part_m, float* part_s, const float* sx, const float* sw) {
  __shared__ TileSmem<T> sm;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nblk = gridDim.x;
  tile_product<T, false>(sm, xf, nullptr, nullptr, nullptr, wte, M, K, V, m0, n0, sx, sw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = n0 + lane;
  const bool valid = n < V;  // every tile holds column n0 < V
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int m = m0 + r;
    if (m >= M) break;  // warp-uniform; rows only grow
    const float v = valid ? sm.cs[r][lane] : -CUDART_INF_F;
    const size_t slot = (size_t)m * nblk + blockIdx.x;
    const float mx = warp_max(v);
    const float s = warp_sum(valid ? expf(v - mx) : 0.f);
    if (lane == 0) {
      part_m[slot] = mx;
      part_s[slot] = s;
    }
    float cv = valid ? v : -CUDART_INF_F;
    int ci = valid ? n : INT_MAX;
    for (int j = 0; j < k; ++j) {
      float bv = cv;
      int bi = ci;
      warp_argmax(bv, bi);
      if (lane == 0) {
        part_val[slot * k + j] = bv;
        part_idx[slot * k + j] = bi;
      }
      if (ci == bi) {  // taken: out of the later rounds
        cv = -CUDART_INF_F;
        ci = INT_MAX;
      }
    }
  }
}

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

template <typename T, typename E>
static void launch_tiles(cudaStream_t s, const float* x, const float* lns, const float* lnb,
                         float eps, const void* wte, const float* wte_scale, int M, int K, int V,
                         int k, void* xf, float* sx, float* pv, int* pi, float* pm, float* ps) {
  launch_prepass<T, E>(s, x, lns, lnb, eps, M, K, xf, sx);
  const dim3 grid((V + BN - 1) / BN, (M + BM - 1) / BM);
  topk_tile_kernel<E><<<grid, THREADS, 0, s>>>(static_cast<const E*>(xf),
                                               static_cast<const E*>(wte), M, K, V, k, pv, pi,
                                               pm, ps, sx, wte_scale);
}

}  // namespace gic

// x32: (M, K) float32 residual stream; wte: (V, K) element type, or int8
// when wte_scale ((V,) float32) is given; xf: (M, K) element-type scratch
// (int8 rows with an int8 wte, their scales in sx, (M,) float32 scratch);
// part_val/part_idx: (M, ceil(V/32), k) and
// part_m/part_s: (M, ceil(V/32)) float32/int32 scratch; vals (M, k) float32,
// ids (M, k) int32, lse (M,) float32.  1 <= k <= min(16, V); K a multiple of
// the 16-byte vector width.  Returns cudaGetLastError() after the three
// launches.
extern "C" int gic_logits_topk(int dtype, const void* x32, const void* ln_s, const void* ln_b,
                               float eps, const void* wte, const void* wte_scale, int M, int K,
                               int V, int k, void* xf, void* sx, void* part_val, void* part_idx, void* part_m, void* part_s,
                               void* vals, void* ids, void* lse, void* stream) {
  using namespace gic;
  if (M <= 0 || K <= 0 || V <= 0 || k < 1 || k > kMaxK || k > V)
    return (int)cudaErrorInvalidValue;
  const int nblk = (V + BN - 1) / BN;
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
  if (!with_types(dtype, ws != nullptr, [&](auto t) {
        using Ty = decltype(t);
        launch_tiles<typename Ty::T, typename Ty::E>(s, x, lns, lnb, eps, wte, ws, M, K, V, k, xf,
                                                     sq, pv, pi, pm, ps);
      }))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows_per_block = 4;  // one warp per row
  topk_merge_kernel<<<(M + rows_per_block - 1) / rows_per_block, 32 * rows_per_block, 0, s>>>(
      pv, pi, pm, ps, M, nblk, k, static_cast<float*>(vals), static_cast<int*>(ids),
      static_cast<float*>(lse));
  return (int)cudaGetLastError();
}
