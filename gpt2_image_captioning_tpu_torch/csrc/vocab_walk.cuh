// The vocabulary walk of the two selection kernels (logits_topk.cu and
// logits_sample.cu) in bf16 and int8: LN_f(x) @ wte^T over the (V, D) tied
// embedding on Hopper's TMA and wgmma, each tile's logits handed, still in
// the accumulator registers, to a selection that the kernel supplies.
//
// Replaces, for those two kernels' bf16 and int8 routes, the 64 x 32 WMMA
// tile of common.cuh (one stage in flight, four warps, a warp a row per
// 32-column tile).  The float32 routes keep that tile (its three-term TF32
// split).
//
// Bound on the H100: at B 512 the product's operations (39.5 GFLOP in
// bf16, 40 us at 989 TFLOP/s; int8 20 us at 1,979 TOPS); wte's bytes (77.2
// MB bf16, 38.6 MB int8) take 23 / 12 us; the sampler's draws add vector
// work (its header).
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
// - The selection runs from registers, by the thread that holds the
//   accumulators: when a tile's products are done, the kernel's selection
//   object turns them into the thread's logits (prepare(): dequantized,
//   scaled, each row's max, one branch-free pass) and takes them four at a
//   time (step(), a rolled loop: the logits shift down by four a step,
//   register moves, so they stay in registers and the code stays small).
//   The two consumer warpgroups run half a ring out of phase, so one's
//   selection overlaps the other's products.  (Holding the next tile's
//   accumulators beside a tile's logits, to overlap within a warpgroup,
//   needs ~190 registers a thread against the 168 that a 288-thread block
//   allows, and measured slower, spilling.)  At the end of its range a
//   thread merges with its quad once and writes one partial per (row,
//   block) (finish()); a fixed-order merge follows.
#pragma once

#include "vocab.cuh"

namespace gic {

constexpr int VW_BN = 128;                  // vocabulary columns a tile (wgmma n128)
constexpr int VW_ACC = VW_BN / 2;           // accumulators a thread
constexpr int VW_STEPS = VW_ACC / 4;        // selection steps a tile: four logits a thread each
constexpr int VW_MAX_STAGES = 8;
constexpr int VW_RING_BUDGET = 192 * 1024;  // the ring: one block an SM
constexpr int VW_MAX_THREADS = 2 * 128 + 32;  // two consumer warpgroups and the producer warp
constexpr int VW_BAR_PHASE = 1;             // named barrier: warpgroup 1 starts behind 0

// Ring stages of a block: as many (rows + wte) boxes as fit the budget.
// ops/decode_step.py::vocab_plan mirrors the grid, not this.
__host__ __device__ inline int vw_stages(int bm) {
  const int fit = VW_RING_BUDGET / ((bm + VW_BN) * kTmaBox);
  return fit < VW_MAX_STAGES ? fit : VW_MAX_STAGES;
}
__host__ __device__ inline size_t vw_smem(int bm) { return 1024 + (size_t)vw_stages(bm) * (bm + VW_BN) * kTmaBox; }

// Rows a block of the walk: two consumer warpgroups, one where M <= 64.
__host__ __device__ inline int vw_rows(int M) { return M <= 64 ? 64 : 128; }

// Where a thread's accumulators lie (common.cuh::Wgmma): d[4 j + 2 h + e] is
// row rows0 + 8 h, column 8 j + 2 (lane % 4) + e of the tile, rows0 =
// 64 g + 16 (warp in its warpgroup) + lane / 4.
__device__ __forceinline__ int vw_row0() {
  return 64 * (threadIdx.x / 128) + 16 * ((threadIdx.x % 128) / 32) + (threadIdx.x % 32) / 4;
}

// The walk of one block: row tile blockIdx.x (rows m0 .. m0 + bm - 1), its
// range's tiles [t0, t1) of wte.  amap: the (M, K) operand rows, box (128
// bytes, bm rows); wmap: wte (V, K), box (128 bytes, VW_BN rows).  Every
// consumer thread calls sel.prepare(d, lg, n0) once a tile (n0 its first
// column), which turns its accumulators into the logits lg, and then
// sel.step(lg, j) for j = 0 .. VW_STEPS - 1 in a rolled loop, each taking
// lg[0 .. 3] (columns 8 j + {0, 1} past the thread's first, rows h = 0, 1:
// lg[2 h + e]) and shifting lg down by four (vw_shift).  The producer warp
// returns once it has issued every box.  Starts with a __syncthreads (the barriers'
// initialisation); the caller's next block-wide barrier waits for all
// threads.
template <typename E, typename Sel>
__device__ __forceinline__ void vocab_walk(const CUtensorMap* amap, const CUtensorMap* wmap,
                                           int K, int t0, int t1, Sel& sel) {
  constexpr bool kInt8 = std::is_same<E, int8_t>::value;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int BK = kTmaBox / (int)sizeof(E);  // K elements a box
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[VW_MAX_STAGES], empty[VW_MAX_STAGES];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int ncons = blockDim.x - 32;  // consumer threads
  const int bm = ncons / 2;           // 64 rows a consumer warpgroup
  const int stages = vw_stages(bm);
  const int stage_bytes = (bm + VW_BN) * kTmaBox;
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
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= ncons) {
    // ---- producer warp: one lane streams every box of the range ----
    if (threadIdx.x == ncons) {
      int it = 0;
      for (int t = t0; t < t1; ++t) {
        for (int b = 0; b < nbox; ++b, ++it) {
          const int s = it % stages;
          if (it >= stages) mbar_wait(&empty[s], (it / stages - 1) & 1);  // box it - stages freed
          unsigned char* a = ring + s * stage_bytes;
          mbar_expect_tx(&full[s], stage_bytes);
          tma_load_2d(a, amap, &full[s], b * BK, m0);
          tma_load_2d(a + bm * kTmaBox, wmap, &full[s], b * BK, t * VW_BN);
        }
      }
    }
    __syncwarp();
    return;
  }
  // ---- consumer warpgroup g: rows 64 g .. 64 g + 63 of the row tile ----
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
      const uint32_t a0 = smem_u32(ring + s * stage_bytes) + g * 64 * kTmaBox;
      const uint32_t w0 = smem_u32(ring + s * stage_bytes) + bm * kTmaBox;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTmaBox / 32; ++kk)  // 32 bytes of K a step: k16 bf16, k32 int8
        Wgmma<VW_BN>::mma(d, wgmma_desc(a0 + 32 * kk, 16, 1024),
                          wgmma_desc(w0 + 32 * kk, 16, 1024));
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
    for (int j = 0; j < VW_STEPS; ++j) sel.step(lg, j);
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
// launcher (a static there).
template <typename Kernel>
cudaError_t vw_set_smem(Kernel kernel) {
  const size_t most = vw_smem(64) > vw_smem(128) ? vw_smem(64) : vw_smem(128);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
}

// Launches a walk kernel, whose first two parameters are the maps, over the
// grid (row tiles, ranges).  xf: the (M, K) operand rows (E); wte: (V, K)
// E.  Returns 0 or a cudaError_t.
template <typename E, typename Kernel, typename... Args>
int vw_launch(Kernel kernel, cudaStream_t s, const void* xf, const void* wte, int M, int K, int V,
              int ranges, Args... args) {
  constexpr bool kInt8 = std::is_same<E, int8_t>::value;
  const int bm = vw_rows(M);
  CUtensorMap amap, wmap;
  int err = tma_operand_map(&amap, xf, M, K, bm, kInt8);
  if (!err) err = tma_operand_map(&wmap, wte, V, K, VW_BN, kInt8);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((M + bm - 1) / bm), (unsigned)ranges, 1);
  cfg.blockDim = dim3((unsigned)(2 * bm + 32), 1, 1);
  cfg.dynamicSmemBytes = vw_smem(bm);
  cfg.stream = s;
  return (int)cudaLaunchKernelEx(&cfg, kernel, amap, wmap, args...);
}

}  // namespace gic
