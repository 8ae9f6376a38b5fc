// Final LayerNorm + tied-embedding logits + an in-kernel temperature / top-p
// draw by speculative accept: the sampled decode step's tail without storing
// the (B, V) logits.
//
// Replaces: the sample mode of gpt2_image_captioning_tpu/ops/decode_step.py::
// _step_kernel (:641-804; wrapper fused_decode_step :971-1454).  Per row, of
// the logits scaled by 1/temp (temp 0 rows: unscaled):
// - the running argmax (ties to the lowest id), which temp-0 rows take, in
//   round 0;
// - the logsumexp, by the online (max, sum) merge;
// - k Gumbel-max candidates over the full scaled softmax: the column of each
//   one's perturbed maximum (ties to the lowest id) and its unperturbed
//   scaled logit;
// - verification rounds r = 1..R: candidate c is accepted iff the mass of the
//   tokens whose scaled logit is strictly above its own is <= top_p, the
//   first accepted candidate in candidate order wins and the row reports r;
//   each round also draws k fresh candidates, which the next round tests.
//   A row still unresolved after R rounds takes round R's first fresh
//   candidate and reports R + 1.
// Noise: the TPU's hardware PRNG becomes Philox4x32-10 (Random123), written
// out below, keyed by the wrapper's 64-bit seed, its counter (row, column,
// round, 0); candidate c takes word c of the four (so k <= 4, and one Philox
// call serves all of a (row, column)'s candidates in a round).  The 32-bit
// word becomes a Gumbel draw as the TPU kernel does it (:671-678):
// u = (bits & 0x7FFFFF) * 2^-23 + 2^-24, g = -log(-log(u)).  The plain twin
// (ops/sampling.py::sample_step_plain) computes the same words in torch
// integer ops, so the two agree token for token.
//
// Bound on the H100, B = 512 rows in bf16: the operations.  The work needs
// one product, 2 x 512 x 768 x 50257 = 39.5 GFLOP (40 us at 989 TFLOP/s;
// wte's 77.2 MB take 23 us), and one set of draws per (row, column): a
// Philox call (10 rounds of two 32-bit multiplies) and 2k logs, 25.7 M calls
// and 77 M Gumbel draws at k = 3, ~3.4 G vector operations with the logits'
// statistics and the candidates' checks (~51 us at 67 TFLOP/s).  Fresh draws
// are needed only for rows a round leaves unresolved.  A row needs round
// r + 1 with probability <= (1 - top_p)^k (each candidate is an independent
// draw from the full softmax, inside the nucleus with probability >= top_p),
// 1e-3 at top_p 0.9, k 3: round 2 and on are rare, and their launches exit
// at once on a device-side count of unresolved rows that the host never
// reads.  This design keeps no logits, so round 1 walks wte again for the
// masses (a second 39.5 GFLOP product and set of draws): a cost of the
// design, which storing the logits (2 x 103 MB, ~60 us) would trade for.
//
// Design, in the shape of logits_topk.cu: pass 0 normalises each row once
// (vocab.cuh).  Then one launch per pass over wte — the initial walk, then
// each verification round.  A block owns 64 rows x kTilesPerBlock 32-column
// tiles of common.cuh (256 columns); per tile one warp per row (a lane per
// column) reduces the tile and folds it into the row's running partials in
// shared memory (only that warp touches them).  The block writes its
// partials, and the last block of its row block to arrive (a ticket counter;
// __threadfence before the ticket) merges all column blocks' partials of
// its 64 rows in a fixed order and resolves them, so a round is one launch
// whose result does not depend on which block finished first.  Every
// comparison is the (value, index) order of vocab.cuh.  With an int8 wte
// (W8A8) pass 0 quantizes the rows too and every walk runs the int8 tile.
#include "vocab.cuh"

#include <cstdint>

namespace gic {

constexpr int kMaxCand = 4;         // candidates per row: the four words of one Philox call
constexpr int kTilesPerBlock = 8;   // 32-column tiles per block (256 columns)

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 key) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      key.x += 0x9E3779B9u;
      key.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ key.x, lo1, hi0 ^ c.w ^ key.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float gumbel(uint32_t bits) {
  const float u = (float)(bits & 0x7FFFFFu) * 1.1920928955078125e-07f + 5.9604644775390625e-08f;
  return -logf(-logf(u));
}

__device__ __forceinline__ uint32_t word(const uint4& w, int c) {
  return c == 0 ? w.x : c == 1 ? w.y : c == 2 ? w.z : w.w;
}

// The best (value, index) pair of the warp with a payload that travels with it.
__device__ __forceinline__ void warp_argmax_with(float& v, int& i, float& p) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    const float op = __shfl_xor_sync(0xffffffffu, p, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
      p = op;
    }
  }
}

struct SampleArgs {
  const float* temp;  // (M,) per-row temperature, <= 0 is greedy
  const float* topp;  // (M,) per-row nucleus mass
  uint2 key;          // Philox key: the wrapper's seed
  int M, K, V, k, rounds, ncb;
  // partials, one per (row, column block): running max and sum of exp of the
  // scaled logits, their argmax, k candidates (perturbed value, column,
  // scaled logit) and, in a round, the k masses
  float *p_m, *p_s, *p_av, *p_cv, *p_cl, *p_mass;
  int *p_ai, *p_cc;
  // per-row state across the passes
  int* tok;     // (M,) the chosen token
  int* rnd;     // (M,) the round that resolved it
  float* lse;   // (M,) logsumexp of the scaled logits
  int* unres;   // (M,) 1 while the row is unresolved
  int* cc;      // (M, k) the candidates the next round tests
  float* cl;    // (M, k) their scaled logits
  int* count;   // [0] unresolved rows; [1 + row block] arrival tickets
  // W8A8 only: the rows' (M,) and wte's (V,) dequantization scales
  const float* sx;
  const float* sw;
};

struct RowPartial {
  float m, s, av;
  int ai;
  float cv[kMaxCand], cl[kMaxCand], mass[kMaxCand];
  int cc[kMaxCand];
};

__device__ __forceinline__ float scale_of(float temp) { return temp > 0.f ? 1.f / temp : 1.f; }

// One pass over wte: kRound false is the initial walk, true verification
// round ``round`` (1-based).
template <typename T, bool kRound>
__global__ void __launch_bounds__(THREADS)
sample_tile_kernel(const T* xf, const T* wte, SampleArgs a, int round) {
  __shared__ TileSmem<T> sm;
  __shared__ RowPartial part[BM];
  __shared__ int s_flag;
  const int cb = blockIdx.x, rb = blockIdx.y, m0 = rb * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k = a.k;

  if (kRound) {
    // nothing to do once every row resolved; else only row blocks with an
    // unresolved row re-stream wte (the flags change only in this row
    // block's merge, after all of its blocks have arrived)
    if (__ldcg(a.count) == 0) return;
    if (threadIdx.x == 0) s_flag = 0;
    __syncthreads();
    if (threadIdx.x < BM && m0 + threadIdx.x < a.M && __ldcg(a.unres + m0 + threadIdx.x))
      s_flag = 1;
    __syncthreads();
    if (!s_flag) return;
  }
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    RowPartial& p = part[r];
    p.m = -CUDART_INF_F;
    p.s = 0.f;
    p.av = -CUDART_INF_F;
    p.ai = INT_MAX;
    for (int c = 0; c < kMaxCand; ++c) {
      p.cv[c] = -CUDART_INF_F;
      p.cc[c] = INT_MAX;
      p.cl[c] = -CUDART_INF_F;
      p.mass[c] = 0.f;
    }
  }
  // the first tile_product's barriers order these stores before any use

  const int ntiles = (a.V + BN - 1) / BN;
  const int t_end = min(ntiles, (cb + 1) * kTilesPerBlock);
  for (int t = cb * kTilesPerBlock; t < t_end; ++t) {
    const int n0 = t * BN;
    tile_product<T, false>(sm, xf, nullptr, nullptr, nullptr, wte, a.M, a.K, a.V, m0, n0, a.sx,
                           a.sw);
    const int n = n0 + lane;
    const bool valid = n < a.V;  // every tile holds column n0 < V
    for (int r = warp; r < BM; r += THREADS / 32) {
      const int m = m0 + r;
      if (m >= a.M) break;  // warp-uniform; rows only grow
      if (kRound && !a.unres[m]) continue;
      RowPartial& p = part[r];
      const float lq = valid ? sm.cs[r][lane] * scale_of(a.temp[m]) : -CUDART_INF_F;
      if (!kRound) {
        const float mx = warp_max(lq);
        const float s = warp_sum(valid ? expf(lq - mx) : 0.f);
        float bv = lq;
        int bi = valid ? n : INT_MAX;
        warp_argmax(bv, bi);
        if (lane == 0) {
          const float m_new = fmaxf(p.m, mx);
          p.s = p.s * expf(p.m - m_new) + s * expf(mx - m_new);
          p.m = m_new;
          if (better(bv, bi, p.av, p.ai)) {
            p.av = bv;
            p.ai = bi;
          }
        }
      } else {
        const float lse = a.lse[m];
        const float e = valid ? expf(lq - lse) : 0.f;
        for (int c = 0; c < k; ++c) {
          const float above = warp_sum(lq > a.cl[(size_t)m * k + c] ? e : 0.f);
          if (lane == 0) p.mass[c] += above;
        }
      }
      const uint4 w = philox4x32_10(make_uint4((uint32_t)m, (uint32_t)n, (uint32_t)round, 0u),
                                    a.key);
      for (int c = 0; c < k; ++c) {
        float pv = valid ? lq + gumbel(word(w, c)) : -CUDART_INF_F;
        int ci = valid ? n : INT_MAX;
        float pl = lq;
        warp_argmax_with(pv, ci, pl);
        if (lane == 0 && better(pv, ci, p.cv[c], p.cc[c])) {
          p.cv[c] = pv;
          p.cc[c] = ci;
          p.cl[c] = pl;
        }
      }
    }
  }

  // this block's partials (written by each row's warp, read here by thread r)
  __syncthreads();
  const int ncb = a.ncb;
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const int m = m0 + r;
    if (m >= a.M || (kRound && !a.unres[m])) continue;
    const RowPartial& p = part[r];
    const size_t slot = (size_t)m * ncb + cb;
    if (!kRound) {
      a.p_m[slot] = p.m;
      a.p_s[slot] = p.s;
      a.p_av[slot] = p.av;
      a.p_ai[slot] = p.ai;
    }
    for (int c = 0; c < k; ++c) {
      a.p_cv[slot * k + c] = p.cv[c];
      a.p_cc[slot * k + c] = p.cc[c];
      a.p_cl[slot * k + c] = p.cl[c];
      if (kRound) a.p_mass[slot * k + c] = p.mass[c];
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_flag = atomicAdd(a.count + 1 + rb, 1) == ncb - 1;
  __syncthreads();
  if (!s_flag) return;
  __threadfence();

  // the last block of this row block: merge every column block's partials
  // of its rows, in column order, and resolve them
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int m = m0 + r;
    if (m >= a.M) break;
    if (kRound && !a.unres[m]) continue;
    const size_t row = (size_t)m * ncb;
    float cv[kMaxCand], cl[kMaxCand];
    int cc[kMaxCand];
    for (int c = 0; c < k; ++c) {
      cv[c] = -CUDART_INF_F;
      cc[c] = INT_MAX;
      cl[c] = -CUDART_INF_F;
      for (int j = lane; j < ncb; j += 32) {
        const float v = __ldcg(a.p_cv + (row + j) * k + c);
        const int i = __ldcg(a.p_cc + (row + j) * k + c);
        if (better(v, i, cv[c], cc[c])) {
          cv[c] = v;
          cc[c] = i;
          cl[c] = __ldcg(a.p_cl + (row + j) * k + c);
        }
      }
      warp_argmax_with(cv[c], cc[c], cl[c]);
    }
    if (!kRound) {
      float mx = -CUDART_INF_F;
      for (int j = lane; j < ncb; j += 32) mx = fmaxf(mx, __ldcg(a.p_m + row + j));
      mx = warp_max(mx);
      float s = 0.f, av = -CUDART_INF_F;
      int ai = INT_MAX;
      for (int j = lane; j < ncb; j += 32) {
        s += __ldcg(a.p_s + row + j) * expf(__ldcg(a.p_m + row + j) - mx);
        const float v = __ldcg(a.p_av + row + j);
        const int i = __ldcg(a.p_ai + row + j);
        if (better(v, i, av, ai)) {
          av = v;
          ai = i;
        }
      }
      s = warp_sum(s);
      warp_argmax(av, ai);
      if (lane == 0) {
        a.lse[m] = mx + logf(s);
        int tok = ai, rnd = 0, unres = a.temp[m] > 0.f;
        if (unres && a.rounds == 0) {  // no round to test in: the forced fallback
          tok = cc[0];
          rnd = 1;
          unres = 0;
        }
        a.tok[m] = tok;
        a.rnd[m] = rnd;
        a.unres[m] = unres;
        for (int c = 0; c < k; ++c) {
          a.cc[(size_t)m * k + c] = cc[c];
          a.cl[(size_t)m * k + c] = cl[c];
        }
        if (unres) atomicAdd(a.count, 1);
      }
    } else {
      float mass[kMaxCand];
      for (int c = 0; c < k; ++c) {
        float s = 0.f;
        for (int j = lane; j < ncb; j += 32) s += __ldcg(a.p_mass + (row + j) * k + c);
        mass[c] = warp_sum(s);
      }
      if (lane == 0) {
        bool done = false;
        for (int c = 0; c < k && !done; ++c) {
          if (mass[c] <= a.topp[m]) {
            a.tok[m] = a.cc[(size_t)m * k + c];
            a.rnd[m] = round;
            done = true;
          }
        }
        if (!done && round == a.rounds) {  // out of rounds: round R's first fresh candidate
          a.tok[m] = cc[0];
          a.rnd[m] = round + 1;
          done = true;
        }
        for (int c = 0; c < k; ++c) {
          a.cc[(size_t)m * k + c] = cc[c];
          a.cl[(size_t)m * k + c] = cl[c];
        }
        if (done) {
          a.unres[m] = 0;
          atomicSub(a.count, 1);
        }
      }
    }
  }
  if (threadIdx.x == 0) a.count[1 + rb] = 0;  // the next pass's tickets
}

template <typename T, typename E>
static void launch_all(cudaStream_t s, const float* x, const float* lns, const float* lnb,
                       float eps, const void* wte, void* xf, const SampleArgs& a) {
  launch_prepass<T, E>(s, x, lns, lnb, eps, a.M, a.K, xf, const_cast<float*>(a.sx));
  const dim3 grid(a.ncb, (a.M + BM - 1) / BM);
  const E* xt = static_cast<const E*>(xf);
  const E* wt = static_cast<const E*>(wte);
  sample_tile_kernel<E, false><<<grid, THREADS, 0, s>>>(xt, wt, a, 0);
  for (int r = 1; r <= a.rounds; ++r) sample_tile_kernel<E, true><<<grid, THREADS, 0, s>>>(xt, wt, a, r);
}

}  // namespace gic

// x32: (M, K) float32 residual stream; ln_s/ln_b (K,) float32; wte: (V, K)
// element type, or int8 when wte_scale ((V,) float32) is given, the rows'
// scales then in sx, (M,) float32 scratch; temp/topp (M,) float32;
// key0/key1 the Philox key; 1 <= k <= 4 candidates, rounds >= 0.  Scratch: xf (M, K) element type; part_f float32
// of M * ncb * (3 + 3k) and part_i int32 of M * ncb * (1 + k), ncb =
// ceil(ceil(V / 32) / 8); state_i int32 of M * (1 + k); state_f float32 of
// M * k; counters int32 of 1 + ceil(M / 64), ZEROED.  Outputs tok, rnd (M,)
// int32 and lse (M,) float32.  Launches 2 + rounds kernels; returns
// cudaGetLastError().
extern "C" int gic_logits_sample(int dtype, const void* x32, const void* ln_s, const void* ln_b,
                                 float eps, const void* wte, const void* wte_scale, int M, int K,
                                 int V, const void* temp, const void* topp, unsigned int key0,
                                 unsigned int key1, int k, int rounds, void* xf, void* sx,
                                 void* part_f,
                                 void* part_i, void* state_i, void* state_f, void* counters,
                                 void* tok, void* rnd, void* lse, void* stream) {
  using namespace gic;
  if (M <= 0 || K <= 0 || V <= 0 || k < 1 || k > kMaxCand || rounds < 0)
    return (int)cudaErrorInvalidValue;
  SampleArgs a;
  a.temp = static_cast<const float*>(temp);
  a.topp = static_cast<const float*>(topp);
  a.key = make_uint2(key0, key1);
  a.M = M;
  a.K = K;
  a.V = V;
  a.k = k;
  a.rounds = rounds;
  a.ncb = ((V + BN - 1) / BN + kTilesPerBlock - 1) / kTilesPerBlock;
  const size_t np = (size_t)M * a.ncb;
  float* pf = static_cast<float*>(part_f);
  a.p_m = pf;
  a.p_s = pf + np;
  a.p_av = pf + 2 * np;
  a.p_cv = pf + 3 * np;
  a.p_cl = pf + (3 + k) * np;
  a.p_mass = pf + (3 + 2 * k) * np;
  int* pi = static_cast<int*>(part_i);
  a.p_ai = pi;
  a.p_cc = pi + np;
  int* si = static_cast<int*>(state_i);
  a.unres = si;
  a.cc = si + M;
  a.cl = static_cast<float*>(state_f);
  a.tok = static_cast<int*>(tok);
  a.rnd = static_cast<int*>(rnd);
  a.lse = static_cast<float*>(lse);
  a.count = static_cast<int*>(counters);
  a.sx = static_cast<const float*>(sx);
  a.sw = static_cast<const float*>(wte_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(x32);
  const float* lns = static_cast<const float*>(ln_s);
  const float* lnb = static_cast<const float*>(ln_b);
  if (!with_types(dtype, a.sw != nullptr, [&](auto t) {
        using Ty = decltype(t);
        launch_all<typename Ty::T, typename Ty::E>(s, x, lns, lnb, eps, wte, xf, a);
      }))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
