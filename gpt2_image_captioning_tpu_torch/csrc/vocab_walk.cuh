// The vocabulary walk of the four vocabulary kernels: LN_f(x) @ wte^T over
// the (V, D) tied embedding on Hopper's TMA and wgmma, each tile's logits
// handed, still in the accumulator registers, to a selection that the kernel
// supplies: a running (max, first argmax) (logits_argmax.cu), a store
// (logits.cu), a partial top-k and logsumexp (logits_topk.cu) or the
// sampler's draws (logits_sample.cu).
//
// Replaces the vocabulary walk of gpt2_image_captioning_tpu/ops/
// decode_step.py::_step_kernel (:112; greedy :552-568 and :805-821, topk
// :569-616, emit_logits :617-640, sample :641, the int8 tile :555-563),
// whose first port was a 64 x 32 product tile (one stage in flight, four
// warps, a warp a row per 32-column tile) walking the whole of wte once per
// 64 rows.  All four run on this walk in every operand type
// (bf16, int8, float32).
//
// Bound on the H100, at the greedy path's B 128: wte's bytes in bf16 (77.2
// MB, 23 us at 3.35 TB/s) and int8 (38.6 MB, 12 us; the products 5 us at
// 1,979 TOPS); in float32 the products: three TF32 products (below) of 2 x
// 128 x 768 x 50,257, 29.6 GFLOP, 60 us at 495 TFLOP/s, above wte's 154 MB
// (46 us).  At B 512 the bf16 products (39.5 GFLOP, 40 us at 989 TFLOP/s)
// pass the bytes; the sampler's draws add vector work (its header).
//
// Design.
// - The grid is (row tiles, column ranges).  A row tile is 128 rows (two
//   consumer warpgroups of 64) or, for M <= 64, 64 rows (one); the V columns
//   are VW_BN-wide tiles, and each block owns one contiguous range of them,
//   the ranges balanced to one tile (ops/decode_step.py::vocab_plan picks
//   how many: a block an SM).  Blocks of one range are launched next to
//   each other (x, the row tile, varies fastest) and walk the same wte
//   tiles at the same time, so each wte byte leaves device memory about
//   once a call and the other row tiles read it from L2.
// - One producer warp keeps 128-byte-deep boxes of the rows and of wte in
//   flight by TMA (128-byte swizzled; boxes past M, V and K zero-filled)
//   in a ring of stages, running into the next tile's boxes while the
//   consumers select from the last one.
// - The product is direct: the rows are wgmma's A (64 a warpgroup, K-major)
//   and wte's own (V, K) rows its K-major B, bf16 m64n128k16 with float32
//   accumulators or int8 m64n128k32 with int32 ones, dequantized as acc *
//   sx * sw.  Direct, and not swapped, because the selection reduces along
//   the vocabulary: each thread then holds two rows x 32 of the tile's 128
//   columns (a quad of lanes the whole tile's columns for its two rows), so
//   it folds a tile into per-row running state in registers and merges
//   with its quad once a range.  The swapped product (wte as A) would give
//   a thread two columns of 64 rows and a shuffle merge every tile.
// - float32 runs the same walk on wgmma m64n128k8 .tf32 (K-major on both
//   sides, which is the direct product's layout; a 128-byte box is 32
//   floats, four k8 steps of 32 bytes, so the descriptors step as bf16's
//   k16 do) as the three-term split (common.cuh::split_tf32): x = xh + xl with
//   xh = tf32(x) (cvt.rna) and xl = tf32(x - xh), w alike, and d += xl wh +
//   xh wl + xh wh into the same float32 accumulators, the small terms
//   first.  Both sides are rounded explicitly; nothing relies on the tensor
//   core dropping a raw float's low bits.  The rows are split once, by the
//   pre-pass (common.cuh::ln_rows_kernel with xl): the (2M, K) operand holds
//   the xh rows, then the xl rows, streamed as two boxes a stage.  wte is
//   split in shared memory as each box lands, by seven converter warps
//   beside the producer (512 threads a block at 128 rows, 16 warps, so a
//   128-register cap a thread; common.cuh::tf32_rna_bits):
//   hi in place, lo into a second slot of the stage, then fence.proxy.async
//   and an mbarrier (ready) that the consumers wait on beside the TMA's.  A
//   stage is (2 bm + 2 VW_BN) x 128 bytes, 64 KB at bm 128: three stages.
//   What bounds it is shared memory: a stage moves 48 KB in by TMA, 48 KB
//   through the converters and 144 KB into the tensor cores (three products
//   a k8 step read A and B again each), against the 1,536 clocks of its
//   products; splitting the rows there too, for half the L2 traffic, ran
//   1.5x slower (PERF.md §6).  Error: the split leaves each product within
//   3 x 2^-22 of |x w| (the dropped xl wl and the two roundings, each <=
//   2^-22 |x w|), so a logit within 2^-20 sum_k |x_k w_k| of the exact sum
//   before the float32 accumulation, which adds at most one float32
//   rounding (2^-23 relative, truncating or not) of the running sum a
//   product instruction: 3 a k8 step, 288 at D 768
//   (tests/test_torch_tf32_split.py emulates both and holds them to these
//   bounds).
// - The selection runs from registers, by the thread that holds the
//   accumulators: when a tile's products are done, the kernel's selection
//   object turns them into the thread's logits (prepare(): dequantized,
//   scaled, each row's max, one branch-free pass) and, where the selection
//   is heavy (the top-k, the sampler: Sel::kSteps = VW_STEPS), takes them
//   four at a time (step(), a rolled loop: the logits shift down by four a
//   step, register moves, so they stay in registers and the code stays
//   small); the argmax and the store do a tile's work in prepare() (kSteps
//   0).  The two consumer warpgroups run half a ring out of phase, so one's
//   selection overlaps the other's products.  (Holding the next tile's
//   accumulators beside a tile's logits, to overlap within a warpgroup,
//   needs ~190 registers a thread against the 168 that a block of 9 warps
//   allows, and measured slower, spilling.)  At the end of its range
//   a thread merges with its quad once and writes one partial per (row,
//   block) (finish()); a fixed-order merge follows.
// - Registers of the float32 selections.  A heavy selection's thread holds
//   a tile's 64 logits beside its running state (the top-k's lists, the
//   sampler's candidates and Philox keys): 162-168 registers, past the
//   128 that the float32 block's 16 warps leave a thread.  So for them
//   (Sel::kSteps > 0) the block trades registers between its warpgroups
//   once the barriers are set (Hopper's setmaxnreg): the service warpgroups
//   (the producer and the converters, warps 8-15 at 128 rows, 4-11 at 64)
//   drop to VW_SERVICE_REGS, which their loops fit, and the consumer
//   warpgroups rise to VW_CONSUMER_REGS; 2 x 128 x (56 + 200) is the SM's
//   65,536.  The argmax and the store fit 128 and keep it.
#pragma once

#include "vocab.cuh"

namespace gic {

constexpr int VW_BN = 128;                  // vocabulary columns a tile (wgmma n128)
constexpr int VW_ACC = VW_BN / 2;           // accumulators a thread
constexpr int VW_STEPS = VW_ACC / 4;        // selection steps a tile: four logits a thread each
constexpr int VW_MAX_STAGES = 8;
constexpr int VW_RING_BUDGET = 192 * 1024;  // the ring: one block an SM
constexpr int VW_BAR_PHASE = 1;             // named barrier: warpgroup 1 starts behind 0
constexpr int VW_CONVERTERS = 224;          // float32: the converter warps' threads
// float32 heavy selections: registers a thread after the reallocation
// (design note above); the launch's 128 a thread must be what ptxas gives.
constexpr int VW_SERVICE_REGS = 56;
constexpr int VW_CONSUMER_REGS = 200;
constexpr int VW_ENTRY_REGS = 65536 / (2 * 128 + 32 + VW_CONVERTERS);
static_assert(2 * 128 * (VW_SERVICE_REGS + VW_CONSUMER_REGS) <= 65536, "the SM's registers");
static_assert(VW_SERVICE_REGS <= VW_ENTRY_REGS && VW_ENTRY_REGS <= VW_CONSUMER_REGS, "a trade");

// The threads beside the consumer warpgroups: the producer warp, and for a
// float32 operand (E = float) the seven converter warps with it.  (The
// split of a stage's wte box is the float32 walk's bottleneck after the
// shared memory's bandwidth: three warps held the walk at B 128 to 0.126
// device ms, seven to 0.108 (PERF.md §6); a block of 16 warps leaves the
// consumers 128 registers, which the argmax and the store fit.)
template <typename E>
__host__ __device__ constexpr int vw_service() {
  return std::is_same<E, float>::value ? 32 + VW_CONVERTERS : 32;
}
template <typename E>
__host__ __device__ constexpr int vw_max_threads() {
  return 2 * 128 + vw_service<E>();
}

// A ring stage of a block of bm rows, for operands of el bytes: the rows' box
// and wte's, each twice for float32 (the TF32 hi and lo).
__host__ __device__ inline int vw_stage_bytes(int bm, int el) {
  return (bm + VW_BN) * kTmaBox * (el == 4 ? 2 : 1);
}
// Ring stages of a block: as many as fit the budget.  ops/decode_step.py::
// vocab_ring mirrors this and vw_smem (chip_smoke.py compares the two).
__host__ __device__ inline int vw_stages(int bm, int el) {
  const int fit = VW_RING_BUDGET / vw_stage_bytes(bm, el);
  return fit < VW_MAX_STAGES ? fit : VW_MAX_STAGES;
}
__host__ __device__ inline size_t vw_smem(int bm, int el) {
  return 1024 + (size_t)vw_stages(bm, el) * vw_stage_bytes(bm, el);
}

// Rows a block of the walk: two consumer warpgroups, one where M <= 64.
__host__ __device__ inline int vw_rows(int M) { return M <= 64 ? 64 : 128; }

// Where a thread's accumulators lie (common.cuh::Wgmma): d[4 j + 2 h + e] is
// row rows0 + 8 h, column 8 j + 2 (lane % 4) + e of the tile, rows0 =
// 64 g + 16 (warp in its warpgroup) + lane / 4.
__device__ __forceinline__ int vw_row0() {
  return 64 * (threadIdx.x / 128) + 16 * ((threadIdx.x % 128) / 32) + (threadIdx.x % 32) / 4;
}

// The consumer threads of a walk kernel's block (the service threads follow).
template <typename E>
__device__ __forceinline__ int vw_consumers() {
  return (int)blockDim.x - vw_service<E>();
}

// The block's dynamic shared memory past the ring: a selection's own space
// (the launch's ``extra`` bytes, vw_launch).
template <typename E>
__device__ __forceinline__ unsigned char* vw_after_ring() {
  extern __shared__ unsigned char smem_raw[];
  const int bm = vw_consumers<E>() / 2;
  return reinterpret_cast<unsigned char*>(
             (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023)) +
         (size_t)vw_stages(bm, (int)sizeof(E)) * vw_stage_bytes(bm, (int)sizeof(E));
}

// The walk of one block: row tile blockIdx.x (rows m0 .. m0 + bm - 1), its
// range's tiles [t0, t1) of wte.  amap: the (M, K) operand rows, or for
// float32 the (2M, K) rows of their TF32 hi (rows 0 .. M - 1) and lo parts,
// box (128 bytes, bm rows); wmap: wte (V, K), box (128 bytes, VW_BN rows).
// Every consumer thread calls sel.prepare(d, lg, n0) once a tile (n0 its
// first column), which turns its accumulators into the logits lg, and then
// sel.step(lg, j) for j = 0 .. Sel::kSteps - 1 in a rolled loop, each taking
// lg[0 .. 3] (columns 8 j + {0, 1} past the thread's first, rows h = 0, 1:
// lg[2 h + e]) and shifting lg down by four (vw_shift).  Starts with a
// __syncthreads (the barriers' initialisation).  The service threads end
// (exit) once they have issued (the producer) or split (the converters)
// every box, so only the consumer threads return: what follows the walk is
// theirs alone, and a barrier there counts vw_consumers threads.  (A
// float32 heavy selection's two roles then run on different register
// counts, and no code may be shared by both.)
template <typename E, typename Sel>
__device__ __forceinline__ void vocab_walk(const CUtensorMap* amap, const CUtensorMap* wmap, int M,
                                           int K, int t0, int t1, Sel& sel) {
  constexpr bool kInt8 = std::is_same<E, int8_t>::value;
  constexpr bool kF32 = std::is_same<E, float>::value;
  constexpr int kParts = kF32 ? 2 : 1;  // boxes an operand: TF32 hi and lo, or the operand
  constexpr bool kRealloc = kF32 && Sel::kSteps > 0;  // registers traded (design note above)
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int BK = kTmaBox / (int)sizeof(E);  // K elements a box
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[VW_MAX_STAGES], empty[VW_MAX_STAGES], ready[VW_MAX_STAGES];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int ncons = vw_consumers<E>();
  const int bm = ncons / 2;  // 64 rows a consumer warpgroup
  const int stages = vw_stages(bm, (int)sizeof(E));
  const int stage_bytes = vw_stage_bytes(bm, (int)sizeof(E));
  const int w_off = kParts * bm * kTmaBox;  // wte's box in a stage, after the rows' boxes
  const int m0 = blockIdx.x * bm;
  const int nbox = (K + BK - 1) / BK;

  if (threadIdx.x == (unsigned)ncons) {
    tma_prefetch(amap);
    tma_prefetch(wmap);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], ncons);
      if (kF32) mbar_init(&ready[s], VW_CONVERTERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= ncons) {
    if constexpr (kRealloc) setmaxnreg_dec<VW_SERVICE_REGS>();
    const int st = threadIdx.x - ncons;  // the service thread
    if (st == 0) {
      // ---- producer: one lane streams every box of the range ----
      int it = 0;
      for (int t = t0; t < t1; ++t) {
        for (int b = 0; b < nbox; ++b, ++it) {
          const int s = it % stages;
          if (it >= stages) mbar_wait(&empty[s], (it / stages - 1) & 1);  // box it - stages freed
          unsigned char* a = ring + s * stage_bytes;
          mbar_expect_tx(&full[s], (kParts * bm + VW_BN) * kTmaBox);
          tma_load_2d(a, amap, &full[s], b * BK, m0);
          if (kF32) tma_load_2d(a + bm * kTmaBox, amap, &full[s], b * BK, M + m0);  // the lo rows
          tma_load_2d(a + w_off, wmap, &full[s], b * BK, t * VW_BN);
        }
      }
    } else if (kF32 && st >= 32) {
      // ---- float32 converters: each landed wte box split into TF32 hi (in
      // place) and lo (the stage's last slot), for the consumers' wgmma ----
      int it = 0;
      for (int t = t0; t < t1; ++t) {
        for (int b = 0; b < nbox; ++b, ++it) {
          const int s = it % stages;
          mbar_wait(&full[s], (it / stages) & 1);
          float4* hi = reinterpret_cast<float4*>(ring + s * stage_bytes + w_off);
          float4* lo = hi + VW_BN * kTmaBox / 16;
          constexpr int N = VW_BN * kTmaBox / 16, U = 4;  // U loads in flight a thread
          for (int i0 = st - 32; i0 < N; i0 += U * VW_CONVERTERS) {
            float4 w[U];
#pragma unroll
            for (int u = 0; u < U; ++u)
              if (i0 + u * VW_CONVERTERS < N) w[u] = hi[i0 + u * VW_CONVERTERS];
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int i = i0 + u * VW_CONVERTERS;
              if (i >= N) break;
              float4 h, l;
              tf32_split_bits(w[u].x, h.x, l.x);
              tf32_split_bits(w[u].y, h.y, l.y);
              tf32_split_bits(w[u].z, h.z, l.z);
              tf32_split_bits(w[u].w, h.w, l.w);
              hi[i] = h;
              lo[i] = l;
            }
          }
          fence_proxy_async();  // the splits, before the consumers' wgmma reads them
          mbar_arrive(&ready[s]);
        }
      }
    }
    asm volatile("exit;\n");
    __builtin_unreachable();
  }
  // ---- consumer warpgroup g: rows 64 g .. 64 g + 63 of the row tile ----
  if constexpr (kRealloc) setmaxnreg_inc<VW_CONSUMER_REGS>();
  // Warpgroup 1 starts half a ring behind warpgroup 0 (a named barrier that
  // 0 passes after its first boxes), so the two stay out of phase and one's
  // selection runs while the other's products hold the tensor cores.  (The
  // first ``stages`` boxes need no slot freed, so 0 gets there alone.)
  const int g = threadIdx.x / 128;
  const int lag = (nbox < stages ? nbox : stages) / 2;
  if (g == 1) bar_sync(VW_BAR_PHASE, ncons);
  Acc d[VW_ACC];
  float lg[VW_ACC];
  int it = 0;
  for (int t = t0; t < t1; ++t) {
#pragma unroll
    for (int i = 0; i < VW_ACC; ++i) d[i] = 0;
    for (int b = 0; b < nbox; ++b, ++it) {
      const int s = it % stages;
      mbar_wait(&full[s], (it / stages) & 1);
      if (kF32) mbar_wait(&ready[s], (it / stages) & 1);
      const uint32_t a0 = smem_u32(ring + s * stage_bytes) + g * 64 * kTmaBox;
      const uint32_t w0 = smem_u32(ring + s * stage_bytes) + w_off;
      wgmma_fence();
      if constexpr (kF32) {
        const uint32_t al = a0 + bm * kTmaBox, wl = w0 + VW_BN * kTmaBox;
#pragma unroll
        for (int kk = 0; kk < kTmaBox / 32; ++kk) {  // k8 a step: 32 bytes of K
          const uint64_t ah = wgmma_desc(a0 + 32 * kk, 16, 1024);
          const uint64_t wh = wgmma_desc(w0 + 32 * kk, 16, 1024);
          Wgmma<VW_BN>::tf32(d, wgmma_desc(al + 32 * kk, 16, 1024), wh);
          Wgmma<VW_BN>::tf32(d, ah, wgmma_desc(wl + 32 * kk, 16, 1024));
          Wgmma<VW_BN>::tf32(d, ah, wh);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kTmaBox / 32; ++kk)  // 32 bytes of K a step: k16 bf16, k32 int8
          Wgmma<VW_BN>::mma(d, wgmma_desc(a0 + 32 * kk, 16, 1024),
                            wgmma_desc(w0 + 32 * kk, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();  // box it - 1's products are done: release its slot
      wgmma_fence_regs(d);
      if (b > 0) mbar_arrive(&empty[(it - 1) % stages]);
      if (g == 0 && ncons > 128 && it == lag) bar_arrive(VW_BAR_PHASE, ncons);
    }
    wgmma_wait<0>();
    wgmma_fence_regs(d);
    mbar_arrive(&empty[(it - 1) % stages]);  // the tile's last box
    sel.prepare(d, lg, t * VW_BN);
#pragma unroll 1
    for (int j = 0; j < Sel::kSteps; ++j) sel.step(lg, j);
  }
  if (g == 0 && ncons > 128 && it <= lag) bar_arrive(VW_BAR_PHASE, ncons);  // a range shorter than the lag
}

// The logit of an accumulator: bf16 as is; int8 dequantized as
// float(acc) * sx[row] * sw[column] (decode_step.py:286, ops/quant.py::
// int8_matmul's order).
__device__ __forceinline__ float vw_logit(float acc, float, float) { return acc; }
__device__ __forceinline__ float vw_logit(int acc, float rs, float cs) {
  return (float)acc * rs * cs;
}

// The thread's logits of one tile, from its accumulators: lg[4 j + 2 h + e]
// is column c0 + 8 j + e (c0 = the tile's first column + 2 (lane % 4)) of
// row h, dequantized (int8) and scaled by scale[h]; -inf at columns >= V.
// mx[h]: row h's largest, so that the steps after it need no running max.
template <typename Acc>
__device__ __forceinline__ void vw_logits(const Acc (&d)[VW_ACC], int c0, int V, const float* sw,
                                          const float (&rs)[2], const float (&scale)[2],
                                          float (&lg)[VW_ACC], float (&mx)[2]) {
  constexpr bool kInt8 = std::is_same<Acc, int>::value;
  mx[0] = mx[1] = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < VW_ACC / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = c0 + 8 * j + e;
      const bool valid = n < V;
      const float cs = kInt8 && valid ? __ldg(sw + n) : 1.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = valid ? vw_logit(d[4 * j + 2 * h + e], rs[h], cs) * scale[h] : -CUDART_INF_F;
        lg[4 * j + 2 * h + e] = v;
        mx[h] = fmaxf(mx[h], v);
      }
    }
  }
}

// The end of a selection step: lg shifts down by four, register moves (the
// steps run in a rolled loop, so lg is never indexed by a variable and
// stays in registers).
__device__ __forceinline__ void vw_shift(float (&lg)[VW_ACC]) {
#pragma unroll
  for (int i = 0; i + 4 < VW_ACC; ++i) lg[i] = lg[i + 4];
}

// A row's running (max, sum of exp(x - max)) moved to a tile whose largest
// is mx: the sum rescaled once (s = 0 while m = -inf).
__device__ __forceinline__ void lse_rescale(float& m, float& s, float mx) {
  if (mx > m) {
    s *= expf(m - mx);
    m = mx;
  }
}

// Merge of two (max, sum) pairs; a side that saw no element is (-inf, 0).
__device__ __forceinline__ void lse_merge(float& m, float& s, float mo, float so) {
  const float mn = fmaxf(m, mo);
  s = (m == -CUDART_INF_F ? 0.f : s * expf(m - mn)) +
      (mo == -CUDART_INF_F ? 0.f : so * expf(mo - mn));
  m = mn;
}

// The (max, sum) pair of the thread's quad (xor 1, 2: the lanes that hold
// one row's columns), in every lane of the quad.
__device__ __forceinline__ void quad_lse(float& m, float& s) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float so = __shfl_xor_sync(0xffffffffu, s, o);
    lse_merge(m, s, mo, so);
  }
}

// The quad's best (value, index) pair, with a payload, in every lane of it.
__device__ __forceinline__ void quad_argmax(float& v, int& i, float& p) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
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

// A walk kernel's dynamic shared memory limit, set once per kernel by its
// launcher (a static there); extra: the selection's bytes past the ring at
// 128 rows (vw_launch), which bound its bytes at 64.
template <typename E, typename Kernel>
cudaError_t vw_set_smem(Kernel kernel, size_t extra = 0) {
  constexpr int el = (int)sizeof(E);
  const size_t most = vw_smem(64, el) > vw_smem(128, el) ? vw_smem(64, el) : vw_smem(128, el);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)(most + extra));
}

// Registers and local (spill) bytes a thread of a walk kernel, as
// cudaFuncGetAttributes reports them: out[0] numRegs (a float32 heavy
// selection's count on entry, before the trade), out[1] localSizeBytes.
// Returns 0 or a cudaError_t.
template <typename Kernel>
int vw_attrs(Kernel kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return 0;
}

// vw_set_smem for a heavy selection's kernel (Sel::kSteps > 0).  A float32
// one must have VW_ENTRY_REGS registers a thread on entry: with fewer, the
// consumers' setmaxnreg.inc would wait for registers that the service
// warpgroups never free, so it is refused (cudaErrorInvalidConfiguration).
template <typename E, typename Kernel>
cudaError_t vw_set_smem_heavy(Kernel kernel) {
  if (std::is_same<E, float>::value) {
    int r[2];
    const int err = vw_attrs(kernel, r);
    if (err) return (cudaError_t)err;
    if (r[0] != VW_ENTRY_REGS) return cudaErrorInvalidConfiguration;
  }
  return vw_set_smem<E>(kernel);
}

// Internal linkage, as launch_prepass (vocab.cuh).
namespace {

// Pass 0 of a walk: launch_prepass (vocab.cuh), a float32 route's rows
// written as their TF32 pairs, hi then lo: xf then holds 2 M K floats.
template <typename T, typename E>
void vw_prepass(cudaStream_t s, const float* x, const float* lns, const float* lnb, float eps,
                int M, int K, void* xf, float* sx) {
  float* xl = std::is_same<E, float>::value ? static_cast<float*>(xf) + (size_t)M * K : nullptr;
  launch_prepass<T, E>(s, x, lns, lnb, eps, M, K, xf, sx, xl);
}

}  // namespace

// Launches a walk kernel, whose first two parameters are the maps, over the
// grid (row tiles, ranges).  xf: the (M, K) operand rows (E; float32: the
// (2M, K) TF32 pairs of vw_prepass); wte: (V, K) E; extra: dynamic shared
// bytes past the ring (vw_after_ring).  Returns 0 or a cudaError_t.
template <typename E, typename Kernel, typename... Args>
int vw_launch(Kernel kernel, cudaStream_t s, const void* xf, const void* wte, int M, int K, int V,
              int ranges, size_t extra, Args... args) {
  constexpr int el = (int)sizeof(E);
  const int bm = vw_rows(M);
  CUtensorMap amap, wmap;
  int err = tma_operand_map(&amap, xf, std::is_same<E, float>::value ? 2 * M : M, K, bm, el);
  if (!err) err = tma_operand_map(&wmap, wte, V, K, VW_BN, el);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((M + bm - 1) / bm), (unsigned)ranges, 1);
  cfg.blockDim = dim3((unsigned)(2 * bm + vw_service<E>()), 1, 1);
  cfg.dynamicSmemBytes = vw_smem(bm, el) + extra;
  cfg.stream = s;
  return (int)cudaLaunchKernelEx(&cfg, kernel, amap, wmap, args...);
}

}  // namespace gic
