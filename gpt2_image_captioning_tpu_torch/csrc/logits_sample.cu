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
// 1e-3 at top_p 0.9, k 3: round 2 and on are rare, and their blocks exit
// at once where their row tile's flags name no unresolved row; the host
// never reads them.  The kernel keeps no logits, so round 1 walks wte
// again for the masses (a second 39.5 GFLOP product): a cost of the
// design, which storing the logits (2 x 103 MB, ~60 us) would trade for.
// float32: the split's three TF32 products, 118.6 GFLOP a walk, 240 us at
// 495 TFLOP/s.
//
// Pass 0 normalises each row once (vocab.cuh, vw_prepass: for an int8 wte
// it quantizes the rows too, for float32 it writes their TF32 hi and lo
// parts).  Each later launch is one pass of the vocabulary walk of
// vocab_walk.cuh (TMA ring, wgmma — float32 on wgmma TF32 with the
// three-term split —, a block per (row tile, column range)) whose blocks
// write one partial per (row, block); the last block of a row tile to
// arrive (a ticket counter; __threadfence before the ticket) merges its
// rows' partials in block order and resolves them, so a pass's result does
// not depend on which block finished first and two runs give the same
// bits.  Every comparison is the (value, index) order of vocab.cuh.  The
// tickets are reset by the pass's last block, so the counters a call
// leaves are the zeros the next call needs.
//
// In the walk each thread folds its two rows' logits, in registers, into
// per-row state: the (max, sum) (rescaled once a tile), the argmax, and for each candidate the best perturbed value,
// its column and its scaled logit, from one Philox call per (row, column)
// (PhiloxRows: what depends on the row and the round alone computed once)
// and k Gumbel draws from its words; temperature-0 rows draw nothing.  A
// draw's two logs are computed only where it could beat its candidate (an
// exact test from the candidate's value, the row's max and the word's
// bits; see step()), and the common path is branch free, so the four
// Philox chains of a step overlap.  The quad merges once a range, and the
// ticket's merge takes a quad of lanes a row.  A round is two launches: the
// verification of the candidates drawn before it (masses only), then round
// r's fresh draws for the rows it left unresolved, which only those rows'
// row tiles walk (the same counters, candidates and tokens as drawing in
// the verification pass, where every unresolved row would draw though
// ~1e-3 of them need it); after round 1's verification these passes spread
// each row tile over as many blocks as a full pass has (rare_ranges).
// 2 + 2 R launches.  In float32 the selection holds more registers than
// the walk's 16-warp block leaves a thread; the walk trades them from its
// service warpgroups to its consumers (vocab_walk.cuh, "Registers of the
// float32 selections"), which alone run a pass's epilogue.
#include "vocab_walk.cuh"

#include <cstdint>

namespace gic {

constexpr int kMaxCand = 4;      // candidates per row: the four words of one Philox call
constexpr int kBarEpilogue = 2;  // named barrier of a pass's consumer threads after the walk

__device__ __forceinline__ float gumbel(uint32_t bits) {
  const float u = (float)(bits & 0x7FFFFFu) * 1.1920928955078125e-07f + 5.9604644775390625e-08f;
  return -logf(-logf(u));
}

// Philox4x32-10 (Random123) of the counters (row, n, round, 0) of one (row,
// round) as n varies: what depends on the row and the round alone is
// computed once (init): the first round's two products, the second round's
// product of word z, and the round keys.  An element then
// costs one product in round 2 and two in each of rounds 3-10.
struct PhiloxRows {
  static constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  uint32_t a;                  // round 2's x is a ^ n
  uint32_t c[2], d[2], e[2];   // per row: round 2's x, y and z's mask
  uint2 rk[8];                 // the keys of rounds 3 .. 10

  __device__ __forceinline__ void init(const int (&rows)[2], uint32_t round, uint2 key) {
    const uint2 k1 = make_uint2(key.x + 0x9E3779B9u, key.y + 0xBB67AE85u);
    uint2 k = k1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      k = make_uint2(k.x + 0x9E3779B9u, k.y + 0xBB67AE85u);
      rk[i] = k;
    }
    const uint32_t lo1 = kM1 * round;  // round 1: (row, n, round, 0) -> (a ^ n, lo1, b, lo0)
    a = __umulhi(kM1, round) ^ key.x;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t row = (uint32_t)rows[h];
      const uint32_t b = __umulhi(kM0, row) ^ key.y, lo0 = kM0 * row;
      c[h] = __umulhi(kM1, b) ^ lo1 ^ k1.x;
      d[h] = kM1 * b;
      e[h] = lo0 ^ k1.y;
    }
  }

  __device__ __forceinline__ uint4 operator()(int h, uint32_t n) const {
    const uint32_t x = a ^ n;
    uint4 w = make_uint4(c[h], d[h], __umulhi(kM0, x) ^ e[h], kM0 * x);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t hi0 = __umulhi(kM0, w.x), lo0 = kM0 * w.x;
      const uint32_t hi1 = __umulhi(kM1, w.z), lo1 = kM1 * w.z;
      w = make_uint4(hi1 ^ w.y ^ rk[i].x, lo1, hi0 ^ w.w ^ rk[i].y, lo0);
    }
    return w;
  }
};

__device__ __forceinline__ uint32_t word(const uint4& w, int c) {
  return c == 0 ? w.x : c == 1 ? w.y : c == 2 ? w.z : w.w;
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
  int* count;   // (row tiles,) arrival tickets
  // W8A8 only: the rows' (M,) and wte's (V,) dequantization scales
  const float* sx;
  const float* sw;
};

__device__ __forceinline__ float scale_of(float temp) { return temp > 0.f ? 1.f / temp : 1.f; }

// The walk's passes: the initial walk (statistics, argmax, round-0 draws),
// and for each round r the verification of the candidates drawn before it
// and, for the rows it leaves unresolved, round r's fresh draws.
constexpr int kInit = 0;
constexpr int kVerify = 1;
constexpr int kDraw = 2;
constexpr float kSkipMargin = 1.001f;  // the init pass's skip test, below

// Per thread, for each of its two rows, the state of one pass.
template <typename E, int Mode>
struct SampleSel {
  static constexpr int kSteps = VW_STEPS;  // four logits a step (vocab_walk)
  static constexpr bool kInt8 = std::is_same<E, int8_t>::value;
  const float* sw;  // int8: wte's (V,) scales
  int V, k;
  int row[2];
  bool live[2];     // the row takes part in this pass
  bool draws[2];    // ... and draws candidates in it
  float rs[2];      // int8: the rows' scales
  float inv_t[2];   // 1 / temperature (1 for temperature-0 rows)
  float m[2], s[2], av[2];  // kInit: running max, sum of exp, argmax value; kDraw m: lse
  int ai[2];
  float cv[2][kMaxCand], cl[2][kMaxCand];  // kInit, kDraw: the candidates
  int cc[2][kMaxCand];
  float em[2][kMaxCand];     // exp(m - cv), the skip test's scale
  bool seen[2];              // a column of the row below V so far (kDraw: always)
  int c0;                    // the tile's first column of the thread
  float lse[2], thr[2][kMaxCand], mass[2][kMaxCand];  // kVerify
  PhiloxRows philox;

  __device__ __forceinline__ void init(const SampleArgs& a, int row0, int round_) {
    sw = a.sw;
    V = a.V;
    k = a.k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      const bool in = r < a.M;
      row[h] = r;
      live[h] = in && (Mode == kInit || a.unres[r]);
      const float temp = in ? a.temp[r] : 0.f;
      draws[h] = live[h] && (Mode == kDraw || (Mode == kInit && temp > 0.f));
      rs[h] = kInt8 && in ? a.sx[r] : 0.f;
      inv_t[h] = scale_of(temp);
      m[h] = -CUDART_INF_F;
      s[h] = 0.f;
      av[h] = -CUDART_INF_F;
      ai[h] = INT_MAX;
      lse[h] = Mode != kInit && live[h] ? a.lse[r] : 0.f;
      if (Mode == kDraw) m[h] = lse[h];  // the skip test's reference: >= every logit
#pragma unroll
      for (int c = 0; c < kMaxCand; ++c) {
        cv[h][c] = -CUDART_INF_F;
        cc[h][c] = INT_MAX;
        cl[h][c] = -CUDART_INF_F;
        mass[h][c] = 0.f;
        em[h][c] = CUDART_INF_F;
        thr[h][c] = Mode == kVerify && live[h] && c < k ? a.cl[(size_t)r * k + c] : 0.f;
      }
    }
    if (Mode != kVerify) philox.init(row, (uint32_t)round_, a.key);
#pragma unroll
    for (int h = 0; h < 2; ++h) seen[h] = Mode == kDraw;
  }

  // Candidate c's draw at the logit lq of column n, from the word w: exact
  // (the twin's arithmetic); the best one stays.
  __device__ __forceinline__ void draw(int h, int c, float lq, int n, uint32_t w) {
    const float pv = lq + gumbel(w);
    if (better(pv, n, cv[h][c], cc[h][c])) {
      cv[h][c] = pv;
      cc[h][c] = n;
      cl[h][c] = lq;
      em[h][c] = expf(m[h] - pv);
    }
  }

  // A tile (vocab_walk): its scaled logits and row maxima; kInit the
  // rescaled (max, sum) and each candidate's skip scale.
  template <typename Acc>
  __device__ __forceinline__ void prepare(Acc (&d)[VW_ACC], float (&lg)[VW_ACC], int n0) {
    float mx[2];
    c0 = n0 + 2 * (threadIdx.x % 4);
    vw_logits(d, c0, V, sw, rs, inv_t, lg, mx);
    if (Mode != kInit) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (live[h] && mx[h] > m[h]) {
        lse_rescale(m[h], s[h], mx[h]);
#pragma unroll
        for (int c = 0; c < kMaxCand; ++c) em[h][c] = expf(m[h] - cv[h][c]);
      }
      seen[h] = m[h] != -CUDART_INF_F;  // a column of the row below V so far
    }
  }

  // Step j of a tile, four logits: kVerify the masses above each candidate;
  // else their Philox words (unconditional, so the four chains overlap),
  // kInit's exp, sum, argmax and skip tests (branch free, a mask of the
  // draws that need computing), and the draws the mask names.
  __device__ __forceinline__ void step(float (&lg)[VW_ACC], int j) {
    const int n = c0 + 8 * j;
    if (Mode != kInit && !live[0] && !live[1]) {  // a later pass: few rows are live
      vw_shift(lg);
      return;
    }
    if (Mode == kVerify) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const float e = live[h] ? expf(lg[i] - lse[h]) : 0.f;  // 0 past V
#pragma unroll
        for (int c = 0; c < kMaxCand; ++c)
          if (c < k && lg[i] > thr[h][c]) mass[h][c] += e;
      }
      vw_shift(lg);
      return;
    }
    uint4 w[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) w[h][e] = philox(h, (uint32_t)(n + e));
    uint32_t need = 0;  // bit 4 (2 h + e) + c: candidate c's draw at element (h, e)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lq = lg[2 * h + e];
        const bool in = live[h] && n + e < V;
        // exp(lq - m): kInit's sum term, and both passes' skip test
        const float el = in && seen[h] ? expf(lq - m[h]) : 0.f;
        if (Mode == kInit) {
          s[h] += el;
          const bool b = in && better(lq, n + e, av[h], ai[h]);
          av[h] = b ? lq : av[h];
          ai[h] = b ? n + e : ai[h];
        }
#pragma unroll
        for (int c = 0; c < kMaxCand; ++c) {
          // The draw lq + g(u) can beat cv only if -log u < exp(lq - cv) =
          // el * em (m the row's max, kDraw its logsumexp: any reference
          // value serves), and -log u >= 1 - u (u = bits 2^-23 +
          // 2^-24, bits the word's low 23; 1 - u = (2 - (1 + bits 2^-23)) -
          // 2^-24, each step exact): a draw whose 1 - u clears that bound by
          // kSkipMargin loses (its Gumbel value lies >= 1e-3 below cv - lq,
          // far beyond the float error of computing it), so only the others
          // are computed, as the twin computes them; the candidates are
          // unchanged.  el must be a normal float (else its error is
          // unbounded); em = inf (no candidate yet) never skips.
          const float one_minus_u =
              (2.f - __uint_as_float(0x3F800000u | (word(w[h][e], c) & 0x7FFFFFu))) -
              5.9604644775390625e-08f;
          const bool skip = el >= 1.17549435e-38f && one_minus_u >= el * em[h][c] * kSkipMargin;
          need |= (uint32_t)(draws[h] && in && c < k && !skip) << (4 * (2 * h + e) + c);
        }
      }
    }
    if (need) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int c = 0; c < kMaxCand; ++c)
            if (need >> (4 * (2 * h + e) + c) & 1u)
              draw(h, c, lg[2 * h + e], n + e, word(w[h][e], c));
    }
    vw_shift(lg);
  }

  // The quad's merge; its first lane writes the (row, block) partials.
  __device__ __forceinline__ void finish(const SampleArgs& a, int range) {
    const bool lead = threadIdx.x % 4 == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool write = lead && live[h];
      const size_t slot = (size_t)row[h] * a.ncb + range;
      if (Mode == kInit) {
        float none = 0.f;
        quad_lse(m[h], s[h]);
        quad_argmax(av[h], ai[h], none);
        if (write) {
          a.p_m[slot] = m[h];
          a.p_s[slot] = s[h];
          a.p_av[slot] = av[h];
          a.p_ai[slot] = ai[h];
        }
      }
#pragma unroll
      for (int c = 0; c < kMaxCand; ++c) {
        if (c >= k) break;  // uniform: every lane runs the same shuffles
        if (Mode == kVerify) {
          float v = mass[h][c];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          if (write) a.p_mass[slot * k + c] = v;
        } else {
          quad_argmax(cv[h][c], cc[h][c], cl[h][c]);
          if (write) {
            a.p_cv[slot * k + c] = cv[h][c];
            a.p_cc[slot * k + c] = cc[h][c];
            a.p_cl[slot * k + c] = cl[h][c];
          }
        }
      }
    }
  }
};

// The fixed-order merge of row m's partials, a quad of lanes a row (lane t
// of the quad reads partials t, t + 4, .., so a lane's loads are few and
// all in flight), and the row's resolution: kInit the logsumexp, the
// argmax (temperature-0 rows) and the round-0 candidates; kVerify the first
// candidate whose mass above is <= top_p; kDraw round r's fresh
// candidates, and the fallback after the last round.  Every lane of the
// warp calls it (the quads' shuffles); ``valid`` rows load and store.
template <int Mode>
__device__ void sample_merge_row(const SampleArgs& a, int m, bool valid, int round) {
  const int t = threadIdx.x % 4, k = a.k, ncb = valid ? a.ncb : 0;
  const size_t row = (size_t)m * a.ncb;
  if (Mode == kVerify) {
    float mass[kMaxCand] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int j = t; j < ncb; j += 4)
#pragma unroll
      for (int c = 0; c < kMaxCand; ++c)
        if (c < k) mass[c] += __ldcg(a.p_mass + (row + j) * k + c);
#pragma unroll
    for (int c = 0; c < kMaxCand; ++c) {
      mass[c] += __shfl_xor_sync(0xffffffffu, mass[c], 1);
      mass[c] += __shfl_xor_sync(0xffffffffu, mass[c], 2);
    }
    if (valid && t == 0) {
      bool done = false;  // the first accepted candidate wins
#pragma unroll
      for (int c = 0; c < kMaxCand; ++c) {  // unrolled: mass stays in registers
        if (!done && c < k && mass[c] <= a.topp[m]) {
          a.tok[m] = a.cc[(size_t)m * k + c];
          a.rnd[m] = round;
          a.unres[m] = 0;
          done = true;
        }
      }
    }
    return;
  }
  float cv[kMaxCand], cl[kMaxCand];
  int cc[kMaxCand];
#pragma unroll
  for (int c = 0; c < kMaxCand; ++c) {
    cv[c] = -CUDART_INF_F;
    cc[c] = INT_MAX;
    cl[c] = -CUDART_INF_F;
  }
  float mx = -CUDART_INF_F, s = 0.f, av = -CUDART_INF_F;
  int ai = INT_MAX;
  // branch free, so the loads of several partials are in flight together
#pragma unroll 4
  for (int j = t; j < ncb; j += 4) {
#pragma unroll
    for (int c = 0; c < kMaxCand; ++c) {
      if (c >= k) break;
      const float v = __ldcg(a.p_cv + (row + j) * k + c);
      const int i = __ldcg(a.p_cc + (row + j) * k + c);
      const float l = __ldcg(a.p_cl + (row + j) * k + c);
      const bool b = better(v, i, cv[c], cc[c]);
      cv[c] = b ? v : cv[c];
      cc[c] = b ? i : cc[c];
      cl[c] = b ? l : cl[c];
    }
    if (Mode == kInit) {
      lse_merge(mx, s, __ldcg(a.p_m + row + j), __ldcg(a.p_s + row + j));
      const float v = __ldcg(a.p_av + row + j);
      const int i = __ldcg(a.p_ai + row + j);
      const bool b = better(v, i, av, ai);
      av = b ? v : av;
      ai = b ? i : ai;
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxCand; ++c)
    if (c < k) quad_argmax(cv[c], cc[c], cl[c]);
  int tok = 0, rnd = 0, unres = 1;
  if (Mode == kInit) {
    float none = 0.f;
    quad_lse(mx, s);
    quad_argmax(av, ai, none);
    if (valid && t == 0) a.lse[m] = mx + logf(s);
    tok = ai;
    unres = valid && a.temp[m] > 0.f;
  }
  if (!valid || t != 0) return;
  if (unres && round == a.rounds) {  // no round left: this round's first fresh candidate
    tok = cc[0];
    rnd = round + 1;
    unres = 0;
  }
#pragma unroll
  for (int c = 0; c < kMaxCand; ++c) {  // unrolled: cc and cl stay in registers
    if (c < k) {
      a.cc[(size_t)m * k + c] = cc[c];
      a.cl[(size_t)m * k + c] = cl[c];
    }
  }
  if (Mode == kInit || !unres) {
    a.tok[m] = tok;
    a.rnd[m] = rnd;
    a.unres[m] = unres;
  }
}

// One pass over the walk: grid (row tiles, ranges = a.ncb).  The last block
// of a row tile to arrive (its ticket, count[row tile]) merges its rows.
// After the walk only the consumer threads go on (vocab_walk), synchronised
// by a named barrier.
template <typename E, int Mode>
__global__ void __launch_bounds__(vw_max_threads<E>(), 1)
sample_walk_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap wmap, SampleArgs a, int round) {
  __shared__ int s_flag;
  const int ncons = vw_consumers<E>(), bm = ncons / 2, rb = blockIdx.x, m0 = rb * bm;
  const int range = blockIdx.y;
  if (Mode != kInit) {
    // only row tiles with an unresolved row walk (the flags change only in
    // this row tile's merge, after all of its blocks have arrived, so every
    // block of the tile reads the same flags)
    if (threadIdx.x == 0) s_flag = 0;
    __syncthreads();
    if (threadIdx.x < bm && m0 + threadIdx.x < a.M && __ldcg(a.unres + m0 + threadIdx.x))
      s_flag = 1;
    __syncthreads();
    if (!s_flag) return;
  }
  const int tiles = (a.V + VW_BN - 1) / VW_BN;
  const int row0 = m0 + vw_row0();
  SampleSel<E, Mode> sel;
  sel.init(a, row0, round);
  vocab_walk<E>(&amap, &wmap, a.M, a.K, tiles * range / a.ncb, tiles * (range + 1) / a.ncb, sel);
  sel.finish(a, range);

  __threadfence();
  bar_sync(kBarEpilogue, ncons);
  if (threadIdx.x == 0) s_flag = atomicAdd(a.count + rb, 1) == a.ncb - 1;
  bar_sync(kBarEpilogue, ncons);
  if (!s_flag) return;
  __threadfence();
  const int end = min(a.M, m0 + bm);
  for (int base = m0; base < end; base += ncons / 4) {  // every consumer thread, every pass
    const int m = base + (int)threadIdx.x / 4;
    const bool valid = m < end && (Mode == kInit || __ldcg(a.unres + m));
    sample_merge_row<Mode>(a, m, valid, round);
  }
  if (threadIdx.x == 0) a.count[rb] = 0;  // the next pass's tickets
}

template <typename E, int Mode>
static int launch_sample_walk(cudaStream_t s, const void* xf, const void* wte, const SampleArgs& a,
                              int round) {
  const auto kernel = sample_walk_kernel<E, Mode>;
  static const cudaError_t attr = vw_set_smem_heavy<E>(kernel);
  if (attr != cudaSuccess) return (int)attr;
  return vw_launch<E>(kernel, s, xf, wte, a.M, a.K, a.V, a.ncb, 0, a, round);
}

// The ranges of a rare pass: the blocks of a full pass (row tiles x ranges),
// at most one a tile (ops/decode_step.py::VocabPlan.rare_ranges).
static int rare_ranges(int M, int V, int ranges) {
  const int row_tiles = (M + vw_rows(M) - 1) / vw_rows(M), tiles = (V + VW_BN - 1) / VW_BN;
  return tiles < row_tiles * ranges ? tiles : row_tiles * ranges;
}

// Every pass of a call: pass 0 (vw_prepass), then the walk's.  Returns 0 or
// the first launch error.
template <typename T, typename E>
static int launch_all(cudaStream_t s, const float* x, const float* lns, const float* lnb,
                      float eps, const void* wte, void* xf, const SampleArgs& a) {
  vw_prepass<T, E>(s, x, lns, lnb, eps, a.M, a.K, xf, const_cast<float*>(a.sx));
  // the passes after round 1's verification walk for the few rows it
  // leaves unresolved, so their row tiles' work spreads over as many
  // blocks as a full pass has
  SampleArgs rare = a;
  rare.ncb = rare_ranges(a.M, a.V, a.ncb);
  int err = (int)cudaGetLastError();
  if (!err) err = launch_sample_walk<E, kInit>(s, xf, wte, a, 0);
  for (int r = 1; r <= a.rounds && !err; ++r) {
    err = launch_sample_walk<E, kVerify>(s, xf, wte, r == 1 ? a : rare, r);
    if (!err) err = launch_sample_walk<E, kDraw>(s, xf, wte, rare, r);
  }
  return err;
}

// The float32 walk kernels' registers and local bytes a thread (vw_attrs):
// variant 0, 1, 2 for the initial walk, a verification, a draw.
static int sample_f32_attrs(int variant, int* out) {
  if (variant == kInit) return vw_attrs(sample_walk_kernel<float, kInit>, out);
  if (variant == kVerify) return vw_attrs(sample_walk_kernel<float, kVerify>, out);
  if (variant == kDraw) return vw_attrs(sample_walk_kernel<float, kDraw>, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace gic

// x32: (M, K) float32 residual stream; ln_s/ln_b (K,) float32; wte: (V, K)
// element type, or int8 when wte_scale ((V,) float32) is given, the rows'
// scales then in sx, (M,) float32 scratch; temp/topp (M,) float32;
// key0/key1 the Philox key; 1 <= k <= 4 candidates, rounds >= 0.  ncb: the
// blocks of a row, the walk's ranges, 1 .. ceil(V / 128)
// (ops/decode_step.py::vocab_plan).  Scratch: xf (M, K) element type
// ((2, M, K) float32 for float32: the rows' TF32 hi and lo parts); with P
// the partials a row (ops/decode_step.py::vocab_partials: the rare
// passes' ranges), part_f float32 of M * P * (3 + 3k) and part_i int32 of
// M * P * (1 + k); state_i int32 of M * (1 + k); state_f float32 of M * k;
// counters int32 of ceil(M / 64), zero on entry and left zero by a call
// that completes (each pass's last block resets its ticket).  Outputs
// tok, rnd (M,) int32 and lse (M,) float32.  Launches 2 + 2 rounds
// kernels; returns the first launch error.
extern "C" int gic_logits_sample(int dtype, const void* x32, const void* ln_s, const void* ln_b,
                                 float eps, const void* wte, const void* wte_scale, int M, int K,
                                 int V, const void* temp, const void* topp, unsigned int key0,
                                 unsigned int key1, int k, int rounds, int ncb, void* xf,
                                 void* sx, void* part_f, void* part_i, void* state_i,
                                 void* state_f, void* counters, void* tok, void* rnd, void* lse,
                                 void* stream) {
  using namespace gic;
  if (M <= 0 || K <= 0 || V <= 0 || k < 1 || k > kMaxCand || rounds < 0 || ncb < 1 ||
      ncb > (V + VW_BN - 1) / VW_BN)
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
  a.ncb = ncb;
  const size_t np = (size_t)M * rare_ranges(M, V, ncb);  // the most slots a pass writes
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
  int err = 0;
  if (!with_types(dtype, a.sw != nullptr, [&](auto t) {
        using Ty = decltype(t);
        err = launch_all<typename Ty::T, typename Ty::E>(s, x, lns, lnb, eps, wte, xf, a);
      }))
    return (int)cudaErrorInvalidValue;
  return err;
}

// The float32 walk kernel's registers and local (spill) bytes a thread for
// the pass ``variant`` (0 the initial walk, 1 a verification, 2 a draw)
// into out[0], out[1].  Returns 0 or a cudaError_t (cudaErrorInvalidValue
// past the variants).
extern "C" int gic_logits_sample_f32_attrs(int variant, int* out) {
  return gic::sample_f32_attrs(variant, out);
}
