// Flash-attention forward: softmax(q k^T / sqrt(hd) + masks) v, with the
// (Tq, Tk) scores kept on chip.  The kernel and its launch; the dispatch and
// the C entry are in flash_attention.cu, the wide head dims' instantiations
// in flash_attention_hd{128,160,208}.cu and flash_attention_hd208_bf16.cu:
// each compiles in an nvcc process of its own, in parallel.
//
// Replaces: gpt2_image_captioning_tpu/ops/attention.py::_flash_kernel (:40),
// reached through flash_attention (:156) and the dispatcher mha (:195).  It
// computes what that kernel computes: float32 scores of the rows, scaled by
// 1/sqrt(hd); causal masking with a static q_offset (query i sees keys
// <= q_offset + i); a (B, Tk) key mask; an online float32 softmax.  A row
// with no valid key takes the uniform softmax over the Tk keys, the mean of
// v, as the JAX package's attention_xla does (its masked scores are all the
// float32 minimum) and its Pallas kernel does wherever Tk fills a key block.
// The backward stays torch ops (ops/attention.py::FlashAttention), as the
// reference's stays XLA.
//
// Bound on the H100: bytes at the paths' short heads.  Reading q, k, v and
// writing the output once is 4 B H T hd elements (ViT-B/16 at b 128, T 197:
// 155 MB in bf16, 46 us at 3.35 TB/s); the products are 4 hd flops per
// (query, key) pair, 15 GFLOP there, 16 us at bf16's 989 TFLOP/s; float32
// runs each product as three TF32 products (165 TFLOP/s for the pair), 93
// us there, which then bounds it.  What holds it back on the card is none of
// these: a consumer warpgroup walks its tiles one after another (S, the
// softmax, P V, each waited for), and each item's pass runs a long
// straight-line path once (clock stamps in an instrumented copy put most
// of a short item in the softmax and the store: PERF.md §6), so throughput
// comes from the warpgroups an SM holds at once.
//
// Design for Hopper (FlashAttention-3's roles, one consumer warpgroup a
// block):
//   - work items are (batch row, head, 64 query rows); a block walks items
//     blockIdx.x, + gridDim.x, .. (a grid of the SMs times the blocks an SM
//     holds: 3 at bf16 hd 64, 2 at the other bf16 head dims, 1 in float32),
//     so a short head (the mapper's 25 rows, the prefill's 15) is one item
//     whose loads overlap the previous item's products;
//   - one producer thread loads by TMA, through one 4-D map (hd, T, H, B) an
//     operand with the view's own strides (common.cuh::tma_head_map, cached):
//     an item's 64 Q rows into one of QBUF buffers, then its K and V in tiles
//     of BKV keys into a ring of STAGES stages (sized to what the blocks an
//     SM leave: Cfg), mbarriers full and empty (qfull / qempty for Q).
//     Boxes are 64 bytes of hd by the tile's rows, 64-byte swizzled,
//     chunk-major in shared memory; TMA zero-fills rows past Tq and Tk and
//     columns past hd (bf16 hd 208 is read as 224);
//   - one consumer warpgroup (128 threads) owns the item's 64 rows: S = Q
//     K^T by wgmma with both operands in shared memory, K-major (bf16
//     m64n64k16; float32 the three-term TF32 split, m64nBKVk8 x 3), S and O
//     in registers (the accumulator layout: a thread holds rows g, g + 8 of
//     its warp's 16); the key mask and Tk for the thread's 16 keys of a tile
//     are loaded into a bit mask before S is waited for; masks and the online
//     softmax on S in registers; P V by wgmma with P as the register A
//     operand, in 32-column slices of O (common.cuh::WgmmaRS32), skipping the
//     k-steps past the item's keys.  bf16: P rounded to bf16 in registers is
//     the A layout as it stands; V is read N-major through the transpose
//     bit.  float32: .tf32 takes only K-major operands, so P V reads V^T; P's
//     accumulators are A's registers when the keys of each 8-key step are
//     taken in the order 0, 2, 4, 6, 1, 3, 5, 7 (A column t is key 2t,
//     column t + 4 key 2t + 1), and V^T holds its keys in that order.  Each
//     tile's P V goes to a fresh accumulator folded in as O * alpha + PV, in
//     float32 (a long chain of TF32 products into one accumulator drifts one
//     way on the card).  Rows are divided by their sum once (a reciprocal a
//     row) and stored straight from the accumulators;
//   - float32 also has a converter warpgroup: it splits each landed Q and K
//     into TF32 hi (in place) and lo (a slot beside it), and turns V, which
//     TMA lands in K's lo slot, into V^T hi and lo (its keys permuted)
//     before splitting K there; a ready mbarrier tells the consumers;
//   - registers (setmaxnreg): the second warpgroup (bf16: the producer's,
//     whose other three warps only trade; float32: the converters) gives up
//     registers and the consumers take them.  A warp's registers belong to
//     one of the SM's four sub-partitions (warp index mod 4), so consumer
//     warp w takes exactly what warp w of the second warpgroup releases;
//     a release elsewhere would leave the .inc waiting forever.  The launch
//     refuses a build whose entry count would not cover the trade;
//   - the softmax costs two instructions a score in bf16 (one FMA and
//     ex2.approx.ftz, p rounded to bf16 anyway, about one bf16 ulp against
//     the float32 twin; the TPU kernel keeps p in float32) and none for masks
//     on a tile whose keys all lie inside Tk and the warp's causal limit;
//     float32 keeps scaled scores and exp2f, as the twin's order of
//     operations;
//   - an mbarrier wait that polls past about ten seconds traps, so a lost
//     arrival surfaces as a launch error and not as a hang.
// A row that saw no valid key (l = 0) reads the mean of v over [0, Tk) from
// device memory when it stores its output: no row of the captioner's paths
// is one, so the slow loop never runs there.  q, k, v and the output are
// taken with their own strides (unit stride on hd), so the permuted views
// that split_heads gives are read in place and the output is written
// straight into merge_heads' layout.
#pragma once

#include "common.cuh"

#include <math.h>

#include <algorithm>

namespace gic {
namespace flash {

constexpr int BM = 64;           // query rows of an item: the consumer warpgroup's wgmma M
constexpr int ROW = kTmaHeadBox;  // bytes of a swizzled row: 32 bf16 or 16 floats
constexpr int PV_N = 32;          // output columns of one P V product
constexpr int CONS = 128;         // consumer threads
constexpr int BAR_CONVERTERS = 1;  // named barrier of the float32 converter warpgroup

struct Strides {
  long long b, h, t;  // elements between consecutive batch rows, heads, positions
};

template <typename T>
struct Args {
  T* out;
  const T* v;           // for the mean of v of a row with no valid key
  const int* key_mask;  // (B, Tk), nonzero = attend; null = every key
  Strides vs, os;
  int H, Tq, Tk, hd, causal, q_offset;
  int q_tiles, items;  // 64-row tiles of Tq; items = B H q_tiles
  float scale_log2;    // log2(e) / sqrt(scale_hd): scores in base-2 units
};

// The layout of one (element type, head dim): the key tile BKV, the Q
// buffers and ring stages, the block's threads and the registers the trade
// assumes.  Shared memory, each slab 1024-byte aligned (sizes are multiples
// of 1024): QBUF Q buffers (float32: hi, then lo), then STAGES stages of K
// and V (float32: K hi, K lo — where V lands first —, V^T hi, V^T lo).  A
// slab holds its rows chunk-major: chunk c (64 bytes of hd) of row r at c x
// rows x 64 + r x 64.  V^T (float32) is key-chunk-major: 16 keys of row n
// (an output column, HDV rows) at kc x HDV x 64 + n x 64.
// ops/attention.py::flash_layout mirrors this table.
template <typename T, int HD>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int EL = (int)sizeof(T);
  static constexpr int CH = ROW / EL;                        // elements of a chunk
  static constexpr int NCH = (HD + CH - 1) / CH;              // chunks of a row
  static constexpr int HDV = (HD + PV_N - 1) / PV_N * PV_N;   // output columns the products cover
  static constexpr int NPV = HDV / PV_N;                      // P V slices
  static constexpr int BKV = kF32 && HD > 64 ? 32 : 64;  // keys a tile
  // a ring as deep as the blocks an SM leave room for (the loads of the next
  // tiles and items travel while this one computes; past two stages depth
  // measured no faster), and three blocks an SM at bf16 hd 64, which
  // measured faster than two (PERF.md §6)
  static constexpr int QBUF = kF32 ? (HD <= 128 ? 2 : 1) : (HD <= 160 ? 2 : 1);
  static constexpr int STAGES = kF32 ? (HD <= 96 ? 2 : 1) : (HD <= 96 ? 3 : HD == 128 ? 2 : 1);
  // threads: the consumer warpgroup, then a warpgroup that gives its
  // registers up (float32: the converters; bf16: the producer's, whose
  // first lane loads and whose other warps only trade), then float32's
  // producer warp
  static constexpr int THREADS = kF32 ? 2 * 128 + 32 : 2 * 128;
  static constexpr int MIN_BLOCKS = kF32 ? 1 : (HD == 64 ? 3 : 2);
  static constexpr int Q_SLAB = BM * NCH * ROW;
  static constexpr int KV_SLAB = BKV * NCH * ROW;
  static constexpr int VT_SLAB = kF32 ? HDV * BKV * 4 : 0;
  static constexpr int Q_BYTES = Q_SLAB * (kF32 ? 2 : 1);
  static constexpr int STAGE_BYTES = 2 * KV_SLAB + 2 * VT_SLAB;
  static constexpr int SMEM = 1024 + QBUF * Q_BYTES + STAGES * STAGE_BYTES;  // 1024: alignment
  // registers a thread: on entry, what ptxas gives a kernel that trades
  // (each of the SM's four sub-partitions holds 16,384 registers and its
  // share of the MIN_BLOCKS blocks' warps: 128 at 16 warps an SM, 168 at 9),
  // then after the trade: warp w of the second warpgroup shares a
  // sub-partition with consumer warp w (warps go to sub-partitions by their
  // index mod 4) and releases what that consumer warp takes
  static constexpr int ENTRY_REGS = (16384 / 32 / ((THREADS / 32 * MIN_BLOCKS + 3) / 4)) & ~7;
  static constexpr int RELEASE_REGS = kF32 ? 96 : 40;  // the second warpgroup's, after .dec
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 2 * ENTRY_REGS - RELEASE_REGS > 240 ? 240
                                                                         : 2 * ENTRY_REGS - RELEASE_REGS;
  static_assert(SMEM <= 232448, "a block's shared memory");
  static_assert(CONSUMER_REGS - ENTRY_REGS <= ENTRY_REGS - RELEASE_REGS && CONSUMER_REGS % 8 == 0,
                "a consumer warp's registers come from its sub-partition's releasing warp");
};

// 2^x to about 2^-22 relative, denormal results flushed to 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two neighbouring output elements (an even column), one 4- or 8-byte store.
__device__ __forceinline__ void store2(float* p, float y0, float y1) {
  *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float y0, float y1) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(y0, y1);
}

// Byte offset of byte b of row r in a 64-byte swizzled slab (TMA's 64-byte
// swizzle: the row's 16-byte units XORed with bits 1-2 of the row).
__device__ __forceinline__ int swz64(int r, int b) {
  return r * ROW + ((((b >> 4) ^ (r >> 1)) & 3) << 4) + (b & 15);
}

// An item's place and its key tiles: the keys its last row may see.
struct Item {
  int b, h, q0, kend, ntiles;
};
template <typename T, int BKV>
__device__ __forceinline__ Item item_at(const Args<T>& a, int item) {
  Item it;
  const int qt = item % a.q_tiles, bh = item / a.q_tiles;
  it.h = bh % a.H;
  it.b = bh / a.H;
  it.q0 = qt * BM;
  int kend = a.Tk;
  if (a.causal) kend = min(kend, max(0, min(it.q0 + BM, a.Tq) + a.q_offset));
  it.kend = kend;
  it.ntiles = (kend + BKV - 1) / BKV;
  return it;
}

// float32 converters: n16 16-byte units of a slab split into TF32 hi (in
// place) and lo (the same offsets of lo), by converter thread ct.
__device__ __forceinline__ void split_units(unsigned char* slab, unsigned char* lo, int n16,
                                            int ct) {
  float4* h = reinterpret_cast<float4*>(slab);
  float4* l = reinterpret_cast<float4*>(lo);
  for (int i = ct; i < n16; i += 128) {
    const float4 x = h[i];
    float4 xh, xl;
    tf32_split_bits(x.x, xh.x, xl.x);
    tf32_split_bits(x.y, xh.y, xl.y);
    tf32_split_bits(x.z, xh.z, xl.z);
    tf32_split_bits(x.w, xh.w, xl.w);
    h[i] = xh;
    l[i] = xl;
  }
}

// float32 converters: V (BKV keys x HD, chunk-major in vraw) into V^T hi
// and lo (HDV rows of BKV keys, key-chunk-major), the keys of each 8-key
// step in the order 0, 2, 4, 6, 1, 3, 5, 7: key j of a 16-key chunk at
// position 8 (j / 8) + (j % 8) / 2 + 4 (j % 2).  A thread reads 16 bytes
// (four columns of one key) and writes them to four rows.
template <int HD, int HDV, int BKV>
__device__ __forceinline__ void transpose_v(const unsigned char* vraw, unsigned char* vth,
                                            unsigned char* vtl, int ct) {
  constexpr int NCH = HD / 16;
  for (int i = ct; i < BKV * HD / 4; i += 128) {
    const int key = i % BKV, n4 = i / BKV;  // lanes walk keys: 16-byte reads of 32 rows
    const float4 x = *reinterpret_cast<const float4*>(
        vraw + (n4 / 4) * BKV * ROW + swz64(key, (n4 % 4) * 16));
    const int j = key % 16, p = 8 * (j / 8) + (j % 8) / 2 + 4 * (j % 2);
    const int kc = key / 16;
    const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * n4 + e;
      const int off = kc * HDV * ROW + swz64(n, 4 * p);
      float hi, lo;
      tf32_split_bits(xs[e], hi, lo);
      *reinterpret_cast<float*>(vth + off) = hi;
      *reinterpret_cast<float*>(vtl + off) = lo;
    }
  }
  static_assert(NCH * 16 == HD, "float32 head dims are whole 16-float chunks");
}

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T, HD>::THREADS, Cfg<T, HD>::MIN_BLOCKS)
flash_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, Args<T> a) {
  using C = Cfg<T, HD>;
  constexpr bool kF32 = C::kF32;
  constexpr int BKV = C::BKV;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t qfull[C::QBUF], qempty[C::QBUF], qready[C::QBUF];
  __shared__ uint64_t full[C::STAGES], empty[C::STAGES], ready[C::STAGES];
  unsigned char* qbuf = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ring = qbuf + C::QBUF * C::Q_BYTES;
  const int tid = threadIdx.x;
  const int producer = kF32 ? 2 * 128 : CONS;  // the thread that loads

  if (tid == producer) {
    tma_prefetch(&qmap);
    tma_prefetch(&kmap);
    tma_prefetch(&vmap);
  }
  if (tid == 0) {
    for (int q = 0; q < C::QBUF; ++q) {
      mbar_init(&qfull[q], 1);
      mbar_init(&qempty[q], CONS);
      if (kF32) mbar_init(&qready[q], 128);
    }
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONS);
      if (kF32) mbar_init(&ready[s], 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= producer || (!kF32 && tid >= CONS)) {
    // ---- producer: one lane keeps the block's Q rows and K/V tiles in flight ----
    if constexpr (kF32) setmaxnreg_dec<C::PRODUCER_REGS>();
    else setmaxnreg_dec<C::RELEASE_REGS>();
    if (tid == producer) {
      int n = 0, i = 0;
      for (int item = blockIdx.x; item < a.items; item += gridDim.x, ++i) {
        const Item it = item_at<T, BKV>(a, item);
        const int qb = i % C::QBUF;
        if (i >= C::QBUF) wait_or_trap(&qempty[qb], (i / C::QBUF - 1) & 1);
        unsigned char* qd = qbuf + qb * C::Q_BYTES;
        mbar_expect_tx(&qfull[qb], C::Q_SLAB);
#pragma unroll 1
        for (int c = 0; c < C::NCH; ++c)
          tma_load_4d(qd + c * BM * ROW, &qmap, &qfull[qb], c * C::CH, it.q0, it.h, it.b);
        for (int j = 0; j < it.ntiles; ++j, ++n) {
          const int s = n % C::STAGES;
          if (n >= C::STAGES) wait_or_trap(&empty[s], (n / C::STAGES - 1) & 1);
          unsigned char* st = ring + s * C::STAGE_BYTES;
          mbar_expect_tx(&full[s], 2 * C::KV_SLAB);
#pragma unroll 1
          for (int c = 0; c < C::NCH; ++c) {
            tma_load_4d(st + c * BKV * ROW, &kmap, &full[s], c * C::CH, j * BKV, it.h, it.b);
            tma_load_4d(st + C::KV_SLAB + c * BKV * ROW, &vmap, &full[s], c * C::CH, j * BKV,
                        it.h, it.b);
          }
        }
      }
    }
  } else if (tid >= CONS) {
    // ---- float32 converters: Q and K into TF32 hi / lo, V into V^T hi / lo ----
    if constexpr (kF32) {
      setmaxnreg_dec<C::RELEASE_REGS>();
      const int ct = tid - CONS;
      if constexpr (C::HDV > HD) {  // V^T rows past hd: zeros the products read and drop
        for (int s = 0; s < C::STAGES; ++s)
          for (int i = ct; i < (C::HDV - HD) * BKV / 4; i += 128) {
            const int kc = i / ((C::HDV - HD) * 4), r = HD + (i / 4) % (C::HDV - HD);
            unsigned char* vth = ring + s * C::STAGE_BYTES + 2 * C::KV_SLAB;
            const int off = kc * C::HDV * ROW + r * ROW + (i % 4) * 16;
            *reinterpret_cast<float4*>(vth + off) = make_float4(0.f, 0.f, 0.f, 0.f);
            *reinterpret_cast<float4*>(vth + C::VT_SLAB + off) = make_float4(0.f, 0.f, 0.f, 0.f);
          }
      }
      int n = 0, i = 0;
      for (int item = blockIdx.x; item < a.items; item += gridDim.x, ++i) {
        const Item it = item_at<T, BKV>(a, item);
        const int qb = i % C::QBUF;
        unsigned char* qd = qbuf + qb * C::Q_BYTES;
        wait_or_trap(&qfull[qb], (i / C::QBUF) & 1);
        split_units(qd, qd + C::Q_SLAB, C::Q_SLAB / 16, ct);
        fence_proxy_async();  // the splits, before the consumers' wgmma reads them
        mbar_arrive(&qready[qb]);
        for (int j = 0; j < it.ntiles; ++j, ++n) {
          const int s = n % C::STAGES;
          unsigned char* st = ring + s * C::STAGE_BYTES;
          wait_or_trap(&full[s], (n / C::STAGES) & 1);
          transpose_v<HD, C::HDV, BKV>(st + C::KV_SLAB, st + 2 * C::KV_SLAB,
                                       st + 2 * C::KV_SLAB + C::VT_SLAB, ct);
          bar_sync(BAR_CONVERTERS, 128);  // V is read out of K's lo slot: K lo may take it
          split_units(st, st + C::KV_SLAB, C::KV_SLAB / 16, ct);
          fence_proxy_async();
          mbar_arrive(&ready[s]);
        }
      }
    }
  } else {
    // ---- consumer warpgroup: the item's 64 query rows ----
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    int n = 0, i = 0;
    for (int item = blockIdx.x; item < a.items; item += gridDim.x, ++i) {
      const Item it = item_at<T, BKV>(a, item);
      const int qb = i % C::QBUF;
      wait_or_trap(kF32 ? &qready[qb] : &qfull[qb], (i / C::QBUF) & 1);
      const uint32_t qa = smem_u32(qbuf + qb * C::Q_BYTES);
      const int* mask = a.key_mask ? a.key_mask + (long long)it.b * a.Tk : nullptr;
      const int row0 = it.q0 + 16 * warp;  // this warp's first row
      const int wend = a.causal ? min(a.Tk, max(0, min(row0 + 16, a.Tq) + a.q_offset)) : a.Tk;

      float o[C::NPV][16];
#pragma unroll
      for (int c = 0; c < C::NPV; ++c)
#pragma unroll
        for (int e = 0; e < 16; ++e) o[c][e] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

      float sc[BKV / 2];
      for (int j = 0; j < it.ntiles; ++j, ++n) {
        const int s = n % C::STAGES;
        const uint32_t ka = smem_u32(ring + s * C::STAGE_BYTES);
        const int k0 = j * BKV;
        // this thread's keys of the tile (8 nb + 2 t + e) inside Tk and the
        // key mask, loaded before the products so that their latency hides
        // behind them (unconditional loads: a load behind a branch would wait
        // in the softmax, score by score)
        uint32_t key_ok = 0;  // bit 2 nb + e
#pragma unroll
        for (int nb = 0; nb < BKV / 8; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + nb * 8 + 2 * t + e;
            const int mk = mask ? __ldg(mask + min(key, a.Tk - 1)) : 1;
            key_ok |= (uint32_t)(key < a.Tk && mk != 0) << (2 * nb + e);
          }
        // S = Q K^T, both operands K-major; a k-step is 32 bytes of a
        // 64-byte row (the chunk, then the half row)
        wait_or_trap(&full[s], (n / C::STAGES) & 1);
        if (kF32) wait_or_trap(&ready[s], (n / C::STAGES) & 1);
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) sc[e] = 0.f;
        wgmma_fence_regs(sc);  // the zeros written before the fence, not moved past it
        wgmma_fence();
        if constexpr (kF32) {
#pragma unroll
          for (int kk = 0; kk < HD / 8; ++kk) {
            const uint32_t qo = (kk / 2) * BM * ROW + (kk % 2) * 32;
            const uint32_t ko = (kk / 2) * BKV * ROW + (kk % 2) * 32;
            const uint64_t qh = wgmma_desc64(qa + qo, 16, 512);
            const uint64_t kh = wgmma_desc64(ka + ko, 16, 512);
            const uint64_t ql = wgmma_desc64(qa + C::Q_SLAB + qo, 16, 512);
            const uint64_t kl = wgmma_desc64(ka + C::KV_SLAB + ko, 16, 512);
            Wgmma<BKV>::tf32(sc, ql, kh);
            Wgmma<BKV>::tf32(sc, qh, kl);
            Wgmma<BKV>::tf32(sc, qh, kh);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
            Wgmma<BKV>::mma(sc, wgmma_desc64(qa + (kk / 2) * BM * ROW + (kk % 2) * 32, 16, 512),
                            wgmma_desc64(ka + (kk / 2) * BKV * ROW + (kk % 2) * 32, 16, 512));
        }
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_fence_regs(sc);
        if (j == it.ntiles - 1) mbar_arrive(&qempty[qb]);  // Q's last read

        // masks: a key must be inside Tk and unmasked and, causal, at or
        // before the row's last visible position.  A tile whose keys all lie
        // inside Tk, with no key mask and (causal) all visible to the warp's
        // first row, needs no mask (bf16), and 8-key chunks past the warp's
        // visible keys get p = 0 without an exp.
        const int nvalid = wend - k0;
        const int nchunk = kF32 ? BKV / 8 : (nvalid + 7) / 8;
        const bool all_ok = !kF32 && nvalid >= BKV && mask == nullptr &&
                            (!a.causal || k0 + BKV - 1 <= row0 + a.q_offset);
        float mx[2] = {-INFINITY, -INFINITY};
        if (all_ok) {
#pragma unroll
          for (int e = 0; e < BKV / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
        } else {
#pragma unroll
          for (int nb = 0; nb < BKV / 8; ++nb) {
            if (nb >= nchunk) break;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + nb * 8 + 2 * t + (e & 1), r = e >> 1;
              const bool ok = (key_ok >> (2 * nb + (e & 1)) & 1) &&
                              (!a.causal || key <= row0 + g + 8 * r + a.q_offset);
              float& x = sc[4 * nb + e];
              x = ok ? (kF32 ? x * a.scale_log2 : x) : -INFINITY;
              mx[r] = fmaxf(mx[r], x);
            }
          }
        }
        float alpha[2], msub[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], kF32 ? mx[r] : mx[r] * a.scale_log2);
          // no valid key yet: keep the (empty) state as it is
          alpha[r] = m_new == -INFINITY ? 1.f : kF32 ? exp2f(m[r] - m_new) : fast_exp2(m[r] - m_new);
          msub[r] = m_new == -INFINITY ? 0.f : m_new;
          m[r] = m_new;
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) {
          const int r = (e >> 1) & 1;
          float p;
          if constexpr (kF32)
            p = sc[e] == -INFINITY ? 0.f : exp2f(sc[e] - m[r]);
          else  // a masked score is -inf: 2^-inf = 0
            p = e / 4 >= nchunk ? 0.f : fast_exp2(fmaf(sc[e], a.scale_log2, -msub[r]));
          sc[e] = p;
          l[r] += p;
        }

        // O = O * alpha + P V, skipping the k-steps past the item's keys
        // (their p is 0): gvalid is the same for the whole warpgroup, as
        // wgmma needs
        const uint32_t va = ka + C::KV_SLAB;
        const int gvalid = it.kend - k0;
        if constexpr (kF32) {
          // P's A fragments, a k8 step's keys in the order 2t, 2t + 1
          // (columns t, t + 4): a0 = P(g, 2t), a1 = P(g + 8, 2t), a2 = P(g, 2t + 1), ..
          uint32_t ph[BKV / 8][4], pl[BKV / 8][4];
#pragma unroll
          for (int k8 = 0; k8 < BKV / 8; ++k8) {
            split_tf32(sc[4 * k8 + 0], ph[k8][0], pl[k8][0]);
            split_tf32(sc[4 * k8 + 2], ph[k8][1], pl[k8][1]);
            split_tf32(sc[4 * k8 + 1], ph[k8][2], pl[k8][2]);
            split_tf32(sc[4 * k8 + 3], ph[k8][3], pl[k8][3]);
          }
          const uint32_t vth = va + C::KV_SLAB, vtl = vth + C::VT_SLAB;
#pragma unroll
          for (int c = 0; c < C::NPV; ++c) {
            float pv[16];
#pragma unroll
            for (int e = 0; e < 16; ++e) pv[e] = 0.f;
            wgmma_fence_regs(pv);
#pragma unroll
            for (int k8 = 0; k8 < BKV / 8; ++k8) {
              wgmma_fence_regs(ph[k8]);
              wgmma_fence_regs(pl[k8]);
            }
            wgmma_fence();
#pragma unroll
            for (int k8 = 0; k8 < BKV / 8; ++k8) {
              if (k8 * 8 >= gvalid) break;  // keys past the item's: p = 0
              const uint32_t off = (k8 / 2) * C::HDV * ROW + c * PV_N * ROW + (k8 % 2) * 32;
              const uint64_t vh = wgmma_desc64(vth + off, 16, 512);
              const uint64_t vl = wgmma_desc64(vtl + off, 16, 512);
              WgmmaRS32::tf32(pv, pl[k8], vh);
              WgmmaRS32::tf32(pv, ph[k8], vl);
              WgmmaRS32::tf32(pv, ph[k8], vh);
            }
            wgmma_commit();
            wgmma_wait<0>();
            wgmma_fence_regs(pv);
#pragma unroll
            for (int e = 0; e < 16; ++e) o[c][e] = fmaf(o[c][e], alpha[(e >> 1) & 1], pv[e]);
          }
        } else {
#pragma unroll
          for (int c = 0; c < C::NPV; ++c)
#pragma unroll
            for (int e = 0; e < 16; ++e) o[c][e] *= alpha[(e >> 1) & 1];
          uint32_t pa[BKV / 16][4];
#pragma unroll
          for (int kc = 0; kc < BKV / 16; ++kc)
#pragma unroll
            for (int r = 0; r < 4; ++r) pa[kc][r] = pack_bf16(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
          // P and the scaled O are final before the fence: the compiler may not
          // move their writes past it, which would serialize the products
#pragma unroll
          for (int kc = 0; kc < BKV / 16; ++kc) wgmma_fence_regs(pa[kc]);
#pragma unroll
          for (int c = 0; c < C::NPV; ++c) wgmma_fence_regs(o[c]);
          wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < BKV / 16; ++kc) {
            if (kc * 16 >= gvalid) break;  // keys past the item's: p = 0
#pragma unroll
            for (int c = 0; c < C::NPV; ++c)
              WgmmaRS32::bf16_nmajor(o[c], pa[kc],
                                     wgmma_desc64(va + c * BKV * ROW + kc * 16 * ROW, BKV * ROW, 512));
          }
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int c = 0; c < C::NPV; ++c) wgmma_fence_regs(o[c]);
        }
        mbar_arrive(&empty[s]);
      }
      if (it.ntiles == 0) mbar_arrive(&qempty[qb]);

      // normalise and store rows row0 + g and row0 + g + 8 (those below Tq)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      T* op = a.out + it.b * a.os.b + it.h * a.os.h;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        if (row >= a.Tq) continue;
        T* dst = op + (long long)row * a.os.t;
        if (l[r] == 0.f) {  // no valid key: the mean of v over the Tk keys (0 if none)
          const T* vp = a.v + it.b * a.vs.b + it.h * a.vs.h;
          for (int col = 2 * t; col < a.hd; col += 8) {
            float y0 = 0.f, y1 = 0.f;
            for (int key = 0; key < a.Tk; ++key) {
              y0 += to_f32(vp[(long long)key * a.vs.t + col]);
              y1 += to_f32(vp[(long long)key * a.vs.t + col + 1]);
            }
            store2(dst + col, a.Tk > 0 ? y0 / (float)a.Tk : 0.f, a.Tk > 0 ? y1 / (float)a.Tk : 0.f);
          }
          continue;
        }
        const float inv = 1.f / l[r];  // one division a row; a product an element
#pragma unroll
        for (int c = 0; c < C::NPV; ++c)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int col = c * PV_N + jj * 8 + 2 * t;
            if (col < a.hd) store2(dst + col, o[c][4 * jj + 2 * r] * inv, o[c][4 * jj + 2 * r + 1] * inv);
          }
      }
    }
  }
}

// The SMs of the current device.
inline int device_sms() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

// Once per instantiation: the shared-memory attribute, the registers on entry
// (the trade assumes ENTRY_REGS; with so few that the producer's release
// would not cover the consumers' .inc, which would then wait forever, the
// launch is refused with cudaErrorInvalidConfiguration), and the blocks an
// SM holds; returns that count, or minus a cudaError_t.
template <typename T, int HD>
int blocks_per_sm() {
  using C = Cfg<T, HD>;
  static const int result = [] {
    auto kernel = flash_attention_kernel<T, HD>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return -(int)err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return -(int)err;
    if (fa.numRegs < C::RELEASE_REGS || fa.numRegs < C::PRODUCER_REGS ||
        C::CONSUMER_REGS - fa.numRegs > fa.numRegs - C::RELEASE_REGS)
      return -(int)cudaErrorInvalidConfiguration;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, C::THREADS, C::SMEM);
    if (err != cudaSuccess) return -(int)err;
    return n > 0 ? n : -(int)cudaErrorInvalidConfiguration;
  }();
  return result;
}

// q, k, v: (B, H, T, HD-wide rows) with strides st (12 elements: (b, h, t)
// of q, k, v, out).  Each head dim's instantiations are compiled in one
// translation unit only (GIC_FLASH_INSTANTIATE), and the dispatch declares
// them (GIC_FLASH_EXTERN), so the one-time state above exists once per
// instantiation.
template <typename T, int HD>
int launch(const void* q, const void* k, Args<T> a, int B, const long long* st,
           cudaStream_t stream) {
  using C = Cfg<T, HD>;
  const int per_sm = blocks_per_sm<T, HD>();
  if (per_sm < 0) return -per_sm;
  CUtensorMap qm, km, vm;
  const int tk = a.Tk > 0 ? a.Tk : 1;  // a map needs a row; no tile is loaded when Tk is 0
  int err = tma_head_map(&qm, q, C::EL, HD, a.Tq, a.H, B, st[2], st[1], st[0], BM);
  if (!err) err = tma_head_map(&km, k, C::EL, HD, tk, a.H, B, st[5], st[4], st[3], C::BKV);
  if (!err) err = tma_head_map(&vm, a.v, C::EL, HD, tk, a.H, B, st[8], st[7], st[6], C::BKV);
  if (err) return err;
  const int grid = std::min(a.items, device_sms() * per_sm);
  flash_attention_kernel<T, HD><<<grid, C::THREADS, C::SMEM, stream>>>(qm, km, vm, a);
  return (int)cudaGetLastError();
}

// The layout and the build of one instantiation, for the C entry
// gic_flash_layout: out[0..7] = shared bytes, BKV, STAGES, QBUF, threads,
// blocks an SM, numRegs, local (spill) bytes a thread.  Returns 0 or a
// cudaError_t.
template <typename T, int HD>
int layout(int* out) {
  using C = Cfg<T, HD>;
  out[0] = C::SMEM;
  out[1] = C::BKV;
  out[2] = C::STAGES;
  out[3] = C::QBUF;
  out[4] = C::THREADS;
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, flash_attention_kernel<T, HD>);
  if (err != cudaSuccess) return (int)err;
  out[5] = blocks_per_sm<T, HD>();
  out[6] = fa.numRegs;
  out[7] = (int)fa.localSizeBytes;
  return 0;
}

}  // namespace flash
}  // namespace gic

// Explicit instantiation (in the head dim's own translation unit) and its
// declaration (where the dispatch calls it) of one element type's launch and
// layout.
#define GIC_FLASH_LAUNCH(PREFIX, T, HD)                                                       \
  PREFIX template int gic::flash::launch<T, HD>(const void*, const void*, gic::flash::Args<T>, \
                                                int, const long long*, cudaStream_t);         \
  PREFIX template int gic::flash::layout<T, HD>(int*);
#define GIC_FLASH_INSTANTIATE(T, HD) GIC_FLASH_LAUNCH(, T, HD)
#define GIC_FLASH_EXTERN(T, HD) GIC_FLASH_LAUNCH(extern, T, HD)
