// Fused linear layer of the decode step:
//   y = epilogue(prologue(x) @ W + b)
//
// Replaces: the weight stream of gpt2_image_captioning_tpu/ops/decode_step.py::
// _step_kernel — stream_matmul (:242-290), rowquant (:234-240), _ln (:70) and
// _gelu_new (:76) as the step applies them (:529-550).  One call serves each
// of the four projections of a GPT-2 layer, in every mode of the step:
//   QKV       768 -> 2304  prologue LN1, epilogue cast to the compute dtype
//   attn proj 768 ->  768  no prologue,  epilogue residual add (float32 stream)
//   MLP fc    768 -> 3072  prologue LN2, epilogue gelu_new then cast
//   MLP proj 3072 ->  768  no prologue,  epilogue residual add
//
// Bound on the H100: the weights' bytes.  At batch 128 a call does 2 * 128 =
// 256 flops a weight element, 128 a byte in bf16 (256 in int8), below the
// card's ridge (~295 flops a byte in bf16, ~590 in int8), so the weights'
// one trip from device memory sets the floor: 14.2 MB a bf16 layer, 4.2 us
// at 3.35 TB/s; half that in int8.  At 512 rows (beam-4, continuous serving)
// a call does 1,024 flops a bf16 weight element and sits near the ridge.
//
// Routes.  bf16, int8 (W8A8) and float32 weights all run the design below;
// float32 on wgmma TF32, as its own paragraph says.
//
// Design for Hopper.  The LayerNorm roles' prologue runs once a call as its
// own launch: it normalises their rows into (M, K) bf16
// (common.cuh::ln_rows_kernel), in float32 into their TF32 pair, or in the
// int8 route normalises, casts and quantizes them into (M, K) int8 and (M,)
// scales (rowquant.cu).  The int8
// roles without a LayerNorm (the attention output -> proj, gelu(h) ->
// cproj) have no prologue launch: their product quantizes its rows itself
// (the folded quantization, below).  The product kernel reads both operands
// by TMA: a block owns a column tile of BN (32, 64 or 128) outputs, all of the
// call's rows up to 128 (two consumer warpgroups of 64 rows on wgmma, one
// where M <= 64; more rows take more row tiles), and one K-slice.  One
// producer warp keeps the slice's 128-byte-deep boxes of rows and weights
// in flight, 128-byte swizzled, in a ring of up to 8 stages (as many as the
// slice has, within 110 KB, so two blocks share an SM: 3 stages at BN 128,
// 5 at BN 32; within 220 KB, one block an SM, for a folded product whose
// grid has no more blocks than SMs) whose mbarriers the consumers wait on
// and release.  W is (N,
// K) row-major, the K-major B operand wgmma reads in both types: bf16
// m64nBNk16 with float32 accumulators, int8 m64nBNk32 with int32
// accumulators.  The K-slices of a column tile form a thread-block cluster
// (<= 8, the portable size): each block leaves its partial tile in shared
// memory, and after a cluster barrier each block reduces its own share of
// the tile's rows and columns, reading the partials of blocks 0, 1, ..,
// splits - 1 in that order through distributed shared memory, so two runs
// give the same bits (int8 partials are exact: the unsplit result).  It then
// dequantizes (int8: float(acc) * sx[row] * sw[col], decode_step.py:286),
// adds the bias in float32 and applies the epilogue: the cast to the
// compute dtype, gelu_new in float64 rounded once (common.cuh::gelu_new),
// or the in-place float32 residual add.  Rows past M and columns past N are
// masked; TMA zero-fills the boxes past M, N and K.
//
// The folded quantization (int8 weights, rows in bf16 or float32).  A ring
// stage carries a stage's 128 int8 K-elements of rows as 2 bf16 (4 float32)
// boxes beside the weights' box.  Before the products each block takes the
// max |v| of each of its rows over its K-slice — from the ring where the
// whole slice fits it, else from global memory — and the blocks of the
// cluster, whose slices cover K, exchange their maxima through distributed
// shared memory, so every block holds each row's scale s = max(max |v| *
// float32(1/127), 1e-12), exactly rowquant.cu's.  Each consumer warpgroup
// then turns its 64 rows of each landed stage into int8 in place (into the
// last row box's bytes, as a TMA int8 box lays them: 128-byte rows, 16-byte
// chunks swizzled by the row), rint(v / s) by common.cuh::quant_pack4_fast, and
// runs wgmma s8 on them; the epilogue dequantizes with the same s.  The
// cost: every column tile quantizes its rows again, and the ring carries
// twice (four times) the rows' bytes.  ops/quant.py::rowquant_plain and
// int8_matmul are its twins, to the bit.  On an H100 the conversion's
// arithmetic sets a folded product's time: at B 128 attn_proj takes 10 us
// and mlp_proj 16 (the quantizer's launch and the bare product took 8 and
// 15), at 512 rows 16 and 30 (10 and 18), where four row tiles times six
// column tiles each convert their rows.
//
// float32 (the facade's default precision).  The same kernel on wgmma
// m64nBNk8 .tf32, as the three-term split of the vocabulary walk
// (vocab_walk.cuh): x = xh + xl with xh = tf32(x) and xl = tf32(x - xh), W
// alike, and each k8 step issues xl wh, xh wl, xh wh into the same float32
// accumulators, the small terms first; a 128-byte box is 32 floats, four k8
// steps of 32 bytes, so the descriptors step as bf16's k16 do.  Both sides
// are rounded explicitly (cvt.rna in the pre-pass, common.cuh::
// tf32_rna_bits in the converters); nothing relies on the tensor core
// dropping a raw float's low bits.  The LayerNorm roles' rows come split
// from the pre-pass (ln_rows_kernel with xl: a (2M, K) operand, the hi rows
// then the lo rows, two row boxes a stage by TMA).  The attention output
// and gelu(h) arrive unsplit, and W always does: eight converter warps
// beside the producer split each landed box in shared memory, hi in place
// and lo into a second slot of the stage (W's always, the rows' where they
// came unsplit), then fence.proxy.async and a ready mbarrier that the
// consumers wait on beside the TMA's.  A stage is (2 rows + 2 BN) x 128
// bytes, 64 KB at 128 rows and BN 128, so a block takes an SM (544
// threads, a 120-register cap) and a ring of up to 220 KB: 3 stages at BN
// 128, 5 at BN 32.  Error: as the walk's, an output lies within 2^-20
// sum_k |x_k w_k| of the exact sum before the float32 accumulation, which
// adds at most one float32 rounding of the running sum a product
// instruction (3 a k8 step) and one a K-slice where the cluster adds the
// partials (tests/test_torch_tf32_split.py emulates it).  That rounding
// drifts one way (up to half an ulp an instruction, on an H100), so
// ops/decode_step.py::linear_plan keeps a float32 K-slice within 25 boxes:
// 300 instructions into one accumulator.  Bound at B 128:
// the three TF32 products of a layer, 3 x 2 x 128 x 7.08 M flops, 11 us at
// 495 TFLOP/s, above its 28 MB of weights (8.5 us at 3.35 TB/s).
//
// The split (BN, splits, K-slice) comes from ops/decode_step.py::linear_plan,
// once per shape, fitted to the splits' times on an H100
// (scripts/linear_plan_sweep.py): the fewest bytes a block streams, with a
// block on every SM.  At B 128 and D 768 in bf16: QKV 72 column tiles x 3
// slices of 256, attention out-projection 24 x 6 of 128, MLP fc 48 x 4 of
// 192, MLP down-projection 24 x 8 of 384 (144-216 blocks).  Each weight
// byte leaves device memory once a call; the rows (192 KB at K 768) are
// read again by every column tile, from L2.  At 512 rows each column tile's
// weights are read by four row tiles, once from device memory and three
// times from L2 (a role's weights, <= 4.7 MB, stay in its 50 MB).  Tensor
// maps are encoded once per (pointer, shape, box) and cached
// (common.cuh::tma_operand_map), so a call encodes none once its buffers
// recur.
//
// What bounds it at B 128 on the H100 is latency, not bytes: a product
// launch's phases (the TMA round trip, the products, the cluster's two
// barriers and the partials' round trip, the stores) took 5-10 us in every
// split the sweep timed, against the 0.5-1.4 us its weights need.  At 512
// rows MLP fc took 23-29 us in every split, far above its bytes and
// products (1.4 and 2.4 us); by estimate its gelu_new, kept in float64 for
// the int8 step's exactness, holds the SMs' float64 units for several us.
#include "common.cuh"

namespace gic {

constexpr int LIN_BOX = kTmaBox;          // bytes of K a box: one swizzled row
constexpr int LIN_MAX_SPLITS = 8;         // K-slices of a column tile: a portable cluster
constexpr int LIN_MAX_STAGES = 8;
constexpr int LIN_RING_BUDGET = 110 * 1024;  // a block's ring: two blocks an SM
// a block that has an SM to itself: float32's (its threads' registers take
// the SM), or one with the quantization folded in whose grid has no more
// blocks than SMs (so that the whole slice fits the ring: the rows' maxima
// then come from it)
constexpr int LIN_RING_BUDGET_ONE = 220 * 1024;
constexpr int LIN_PAD = 8;                // the partial tile's row pitch is BN + LIN_PAD
constexpr int LIN_MAX_ROWS = 128;         // rows of a block: two consumer warpgroups
constexpr int LIN_CONVERTERS = 256;       // float32: the converter warps' threads
constexpr int LIN_SMEM_MAX = 1024 + LIN_RING_BUDGET_ONE;
constexpr int LIN_BAR_CONSUMERS = 1;      // named barrier of the consumer warpgroups
constexpr int LIN_BAR_WARPGROUP = 2;      // 2 + g: warpgroup g's own (the folded quantization)

// The threads beside the consumer warpgroups: the producer warp, and in
// float32 (E = float) the converter warps with it; a block's most threads
// (two consumer warpgroups); blocks an SM that its registers allow.
template <typename E>
__host__ __device__ constexpr int lin_service() {
  return std::is_same<E, float>::value ? 32 + LIN_CONVERTERS : 32;
}
template <typename E>
__host__ __device__ constexpr int lin_max_threads() {
  return 2 * 128 + lin_service<E>();
}
template <typename E>
__host__ __device__ constexpr int lin_min_blocks() {
  return std::is_same<E, float>::value ? 1 : 2;
}

// A ring stage's bytes: a block's bm rows as abox boxes (1, or with the
// quantization folded in the rows' element bytes: a stage's 128 int8
// K-elements of rows arrive as 2 bf16 or 4 float32 boxes) and W's box, each
// in parts slots (float32: 2, the TF32 hi and lo).  Ring stages of a block:
// every box of its slice, within the budget (so a slice of <= the budget's
// stages has all its boxes in flight at once).  ops/decode_step.py::
// linear_plan_options mirrors this sizing.
__host__ __device__ inline int lin_stage_bytes(int bm, int bn, int abox, int parts) {
  return (bm * abox + bn) * parts * LIN_BOX;
}
static int lin_budget(bool own_sm, int abox, int blocks) {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return own_sm || (abox > 1 && blocks <= sms) ? LIN_RING_BUDGET_ONE : LIN_RING_BUDGET;
}
static int lin_stages(int stage_bytes, int boxes, int budget) {
  const int fit = budget / stage_bytes;
  int stages = boxes < fit ? boxes : fit;
  if (stages > LIN_MAX_STAGES) stages = LIN_MAX_STAGES;
  return stages < 1 ? 1 : stages;
}
static size_t lin_smem(int bm, int bn, int stages, int stage_bytes) {
  const size_t ring = (size_t)stages * stage_bytes;
  const size_t part = (size_t)bm * (bn + LIN_PAD) * 4;
  return 1024 + (ring > part ? ring : part);  // 1024: room to align the ring
}

// float32: one landed box of ``rows`` 128-byte rows split into TF32 hi (in
// place) and lo (the next rows x 128 bytes), by converter thread t of
// LIN_CONVERTERS, four 16-byte loads in flight a thread.  The swizzle
// moves whole 16-byte chunks, so hi and lo keep the box's layout.
__device__ __forceinline__ void lin_split_box(unsigned char* box, int rows, int t) {
  float4* hi = reinterpret_cast<float4*>(box);
  float4* lo = hi + rows * LIN_BOX / 16;
  const int n = rows * LIN_BOX / 16;
  constexpr int U = 4;
  for (int i0 = t; i0 < n; i0 += U * LIN_CONVERTERS) {
    float4 w[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u * LIN_CONVERTERS < n) w[u] = hi[i0 + u * LIN_CONVERTERS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * LIN_CONVERTERS;
      if (i >= n) break;
      float4 h, l;
      tf32_split_bits(w[u].x, h.x, l.x);
      tf32_split_bits(w[u].y, h.y, l.y);
      tf32_split_bits(w[u].z, h.z, l.z);
      tf32_split_bits(w[u].w, h.w, l.w);
      hi[i] = h;
      lo[i] = l;
    }
  }
}

template <typename Acc>
__device__ __forceinline__ void store2(Acc* p, Acc a, Acc b) {
  if constexpr (std::is_same<Acc, float>::value) *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

// The folded quantization (int8 weights, rows A in the compute dtype).  A
// thread serves 4 rows of its warpgroup (r = 64 g + t / 8 + 16 i) and one
// 16-byte chunk of each (c = t % 8): 8 lanes a row.  Each step's loads for
// all four rows are issued together, and the work on them is branch-free,
// so their latencies overlap (two warps a scheduler hide little).
constexpr int kFoldRowsPerThread = 4;

template <typename A>
__device__ __forceinline__ float chunk_absmax(const uint4& u) {
  float v[16 / sizeof(A)];
  unpack16(u, v);
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < (int)(16 / sizeof(A)); ++k) m = fmaxf(m, fabsf(v[k]));
  return m;
}

// The row maxima of one thread's rows over 8 lanes, into fold_max.
__device__ __forceinline__ void fold_store_max(float (&mx)[kFoldRowsPerThread], float* fold_max) {
  const int g = threadIdx.x / 128, t = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < kFoldRowsPerThread; ++i) {
    float m = mx[i];
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
    if (t % 8 == 0) fold_max[64 * g + t / 8 + 16 * i] = m;
  }
}

// Each of the block's rows' max |v| over its K-slice [k0, k1), read from
// global memory (16-byte loads), into fold_max.
template <typename A>
__device__ __forceinline__ void fold_slice_max(const A* rows, int M, int K, int m0, int k0, int k1,
                                               float* fold_max) {
  constexpr int EPC = 16 / (int)sizeof(A);  // elements of a 16-byte chunk
  const int g = threadIdx.x / 128, t = threadIdx.x % 128;
  float mx[kFoldRowsPerThread] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
  for (int k = k0 + (t % 8) * EPC; k < k1; k += 8 * EPC) {
    uint4 u[kFoldRowsPerThread];
#pragma unroll
    for (int i = 0; i < kFoldRowsPerThread; ++i) {
      const int m = m0 + 64 * g + t / 8 + 16 * i;
      u[i] = m < M ? *reinterpret_cast<const uint4*>(rows + (size_t)m * K + k)
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < kFoldRowsPerThread; ++i) mx[i] = fmaxf(mx[i], chunk_absmax<A>(u[i]));
  }
  fold_store_max(mx, fold_max);
}

// The same maxima from the slice's nbox stages when all of them are in the
// ring at once (the rows' boxes as TMA landed them: the 8 lanes of a row
// read its 8 chunks of each box, in whichever order the swizzle put them).
template <typename A>
__device__ __forceinline__ void fold_ring_max(const unsigned char* ring, int stage_bytes,
                                              int nbox, int bm, float* fold_max) {
  constexpr int ABOX = (int)sizeof(A);
  const int g = threadIdx.x / 128, t = threadIdx.x % 128;
  float mx[kFoldRowsPerThread] = {0.f, 0.f, 0.f, 0.f};
  for (int b = 0; b < nbox; ++b) {
    uint4 u[kFoldRowsPerThread][ABOX];
#pragma unroll
    for (int i = 0; i < kFoldRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < ABOX; ++j)
        u[i][j] = *reinterpret_cast<const uint4*>(
            ring + b * stage_bytes + (j * bm + 64 * g + t / 8 + 16 * i) * LIN_BOX + (t % 8) * 16);
#pragma unroll
    for (int i = 0; i < kFoldRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < ABOX; ++j) mx[i] = fmaxf(mx[i], chunk_absmax<A>(u[i][j]));
  }
  fold_store_max(mx, fold_max);
}

// Quantizes warpgroup g's 64 rows of a landed stage (ABOX boxes of A, 128
// int8 K-elements) into int8 in place, into the last box's bytes as a TMA
// int8 box lays them (128-byte rows, 16-byte chunks swizzled by the row):
// the warpgroup reads the last box into registers first, then, a row at a
// time, reads the row's other chunks, runs their fast paths together
// (common.cuh::quant_pack4_fast), fixes up the rare chunk the division must
// decide, and stores.  fold_scale / fold_inv: the rows' scales and their
// reciprocals.
template <typename A>
__device__ __forceinline__ void fold_convert(unsigned char* stage, int bm, const float* fold_scale,
                                             const float* fold_inv) {
  constexpr int ABOX = (int)sizeof(A);
  constexpr int EPB = LIN_BOX / (int)sizeof(A);  // K elements of a box
  constexpr int EPC = 16 / (int)sizeof(A);
  constexpr int WPC = EPC / 4;  // packed words a chunk
  const int g = threadIdx.x / 128, t = threadIdx.x % 128, c = t % 8;
  unsigned char* last = stage + (ABOX - 1) * bm * LIN_BOX;
  uint4 held[kFoldRowsPerThread];
#pragma unroll
  for (int i = 0; i < kFoldRowsPerThread; ++i) {
    const int r = 64 * g + t / 8 + 16 * i;
    held[i] = *reinterpret_cast<const uint4*>(last + r * LIN_BOX + ((c ^ (r & 7)) << 4));
  }
  bar_sync(LIN_BAR_WARPGROUP + g, 128);  // the last box's rows are read: it takes the int8 tile
#pragma unroll
  for (int i = 0; i < kFoldRowsPerThread; ++i) {
    const int r = 64 * g + t / 8 + 16 * i;
    const float s = fold_scale[r], inv = fold_inv[r];
    uint4 u[ABOX];
#pragma unroll
    for (int j = 0; j < ABOX - 1; ++j)
      u[j] = *reinterpret_cast<const uint4*>(stage + (j * bm + r) * LIN_BOX + ((c ^ (r & 7)) << 4));
    u[ABOX - 1] = held[i];
    uint32_t w[ABOX][WPC];
    bool near[ABOX][WPC];
#pragma unroll
    for (int j = 0; j < ABOX; ++j) {
      float v[EPC];
      unpack16(u[j], v);
#pragma unroll
      for (int h = 0; h < WPC; ++h) {
        const float q[4] = {v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]};
        near[j][h] = false;
        w[j][h] = quant_pack4_fast(q, inv, near[j][h]);
      }
    }
#pragma unroll
    for (int j = 0; j < ABOX; ++j) {
#pragma unroll
      for (int h = 0; h < WPC; ++h) {
        if (__builtin_expect(near[j][h], 0)) {
          float v[EPC];
          unpack16(u[j], v);
          w[j][h] =
              quant_pack4_exact(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3], s);
        }
      }
      const int k = j * EPB + c * EPC;  // the chunk's first K index in the stage
      unsigned char* dst = last + r * LIN_BOX + ((((k >> 4) ^ (r & 7))) << 4) + (k & 15);
      if constexpr (WPC == 2) *reinterpret_cast<uint2*>(dst) = make_uint2(w[j][0], w[j][1]);
      else *reinterpret_cast<uint32_t*>(dst) = w[j][0];
    }
  }
  fence_proxy_async();                   // the generic writes, before wgmma's reads
  bar_sync(LIN_BAR_WARPGROUP + g, 128);  // the int8 tile is whole
}

// amap: the (M, K) operand rows, box (128 bytes of K, 64 x consumers rows),
// or with a_split (float32) their (2M, K) TF32 pair, the hi rows then the lo
// rows; wmap: W (N, K), box (128 bytes of K, BN rows); both 128-byte
// swizzled.  E: the operands' type in the products (bf16, int8, or float32
// on TF32); A: the rows' type in memory, E, or with int8 weights bf16 /
// float32, the quantization then folded in (arows: the rows' pointer, read
// for their maxima).  out: (M, N), the compute dtype (float32 where
// out_f32) or, for the residual epilogue, the float32 stream.  sx (M,) and
// sw (N,): the int8 scales (sx unused with the quantization folded in).
// Grid: (column tiles x splits, row tiles); cluster (splits, 1, 1).  Warps 0
// .. 4 consumers - 1 multiply, the next one produces, and in float32 the
// last eight split the landed boxes.  A float32 stage holds the rows' hi
// and lo boxes, then W's hi and lo.
template <typename E, typename A, int BN>
__global__ void __launch_bounds__(lin_max_threads<E>(), lin_min_blocks<E>())
linear_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap wmap, const void* arows,
                    const float* bias, void* out, int out_f32, int epi, int M, int N, int K,
                    int kslice, int stages, const float* sx, const float* sw, int a_split) {
  constexpr bool kInt8 = std::is_same<E, int8_t>::value;
  constexpr bool kTf32 = std::is_same<E, float>::value;
  constexpr bool kFold = kInt8 && !std::is_same<A, int8_t>::value;
  constexpr int ABOX = (int)(sizeof(A) / sizeof(E));  // row boxes a stage
  constexpr int kParts = kTf32 ? 2 : 1;  // slots an operand's box: TF32 hi and lo, or the box
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int BK = LIN_BOX / (int)sizeof(E);  // K elements a stage
  constexpr int R = BN / 2;                     // accumulators a thread
  constexpr int LDP = BN + LIN_PAD;
  constexpr int kFoldRows = kFold ? LIN_MAX_ROWS : 1;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[LIN_MAX_STAGES], empty[LIN_MAX_STAGES];
  __shared__ uint64_t ready[kTf32 ? LIN_MAX_STAGES : 1];  // float32: a stage's boxes split
  __shared__ float fold_max[kFoldRows], fold_scale[kFoldRows], fold_inv[kFoldRows];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int ncons = blockDim.x - lin_service<E>();  // consumer threads
  const int bm = ncons / 2;                          // 64 rows a consumer warpgroup
  const int a_bytes = bm * ABOX * kParts * LIN_BOX;  // the rows' slots of a stage; W's follow
  const int stage_bytes = lin_stage_bytes(bm, BN, ABOX, kParts);
  const int rank = cluster_rank(), splits = gridDim.x / ((N + BN - 1) / BN);
  const int n0 = (blockIdx.x / splits) * BN, m0 = blockIdx.y * bm;
  const int k0 = rank * kslice;
  const int k1 = min(K, k0 + kslice);
  const int nbox = (k1 - k0 + BK - 1) / BK;

  if (threadIdx.x == (unsigned)ncons) {  // the producer's maps, fetched while the barriers start
    tma_prefetch(&amap);
    tma_prefetch(&wmap);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], ncons);
      if constexpr (kTf32) mbar_init(&ready[s], LIN_CONVERTERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= ncons) {
    const int st = threadIdx.x - ncons;  // the service thread
    if constexpr (kFold) cluster_arrive();  // the rows' maxima: nothing of the producer's
    if (st == 0) {
      // ---- producer: one lane keeps the slice's boxes in flight ----
      // the bytes TMA brings a stage: float32 leaves the lo slots it does
      // not load to the converters
      const int tx = kTf32 ? (bm * (a_split ? 2 : 1) + BN) * LIN_BOX : stage_bytes;
      for (int b = 0; b < nbox; ++b) {
        const int s = b % stages;
        if (b >= stages) mbar_wait(&empty[s], (b / stages - 1) & 1);  // box b - stages released
        unsigned char* a = ring + s * stage_bytes;
        mbar_expect_tx(&full[s], tx);
#pragma unroll
        for (int j = 0; j < ABOX; ++j)
          tma_load_2d(a + j * bm * LIN_BOX, &amap, &full[s],
                      k0 + b * BK + j * (LIN_BOX / (int)sizeof(A)), m0);
        if (kTf32 && a_split)  // the lo rows
          tma_load_2d(a + bm * LIN_BOX, &amap, &full[s], k0 + b * BK, M + m0);
        tma_load_2d(a + a_bytes, &wmap, &full[s], k0 + b * BK, n0);
      }
    } else if constexpr (kTf32) {
      // ---- float32 converters: each landed box of W, and of the rows where
      // they came unsplit, into TF32 hi (in place) and lo (its second slot) ----
      for (int b = 0; st >= 32 && b < nbox; ++b) {
        const int s = b % stages;
        mbar_wait(&full[s], (b / stages) & 1);
        unsigned char* stage = ring + s * stage_bytes;
        lin_split_box(stage + a_bytes, BN, st - 32);
        if (!a_split) lin_split_box(stage, bm, st - 32);
        fence_proxy_async();  // the splits, before the consumers' wgmma reads them
        mbar_arrive(&ready[s]);
      }
    }
    __syncwarp();
    if constexpr (kFold) cluster_wait();
  } else {
    // ---- consumer warpgroup g: rows 64 g .. 64 g + 63 of the tile ----
    const int g = threadIdx.x / 128;
    if constexpr (kFold) {
      // each row's max |v| over the whole of K: this slice's, then the
      // cluster's slices' (the max is exact, so every block of the cluster
      // gets the same scale, the one rowquant.cu would give)
      if (nbox <= stages) {  // the whole slice is landing in the ring: read it there
        for (int b = 0; b < nbox; ++b) mbar_wait(&full[b], 0);
        fold_ring_max<A>(ring, stage_bytes, nbox, bm, fold_max);
      } else {
        fold_slice_max<A>(static_cast<const A*>(arows), M, K, m0, k0, k1, fold_max);
      }
      cluster_arrive();
      cluster_wait();
      if (threadIdx.x < (unsigned)bm) {
        const uint32_t own = smem_u32(&fold_max[threadIdx.x]);
        float mx = 0.f;
        for (int p = 0; p < splits; ++p) mx = fmaxf(mx, ld_cluster_f32(cluster_map(own, p)));
        const float s = fmaxf(mx * kInv127, kMinScale);
        fold_scale[threadIdx.x] = s;
        fold_inv[threadIdx.x] = __frcp_rn(s);
      }
      bar_sync(LIN_BAR_CONSUMERS, ncons);
    }
    Acc d[R];
#pragma unroll
    for (int i = 0; i < R; ++i) d[i] = 0;
    for (int b = 0; b < nbox; ++b) {
      const int s = b % stages;
      mbar_wait(&full[s], (b / stages) & 1);
      if constexpr (kTf32) mbar_wait(&ready[s], (b / stages) & 1);
      unsigned char* stage = ring + s * stage_bytes;
      if constexpr (kFold) fold_convert<A>(stage, bm, fold_scale, fold_inv);
      const uint32_t a0 = smem_u32(stage) + ((ABOX - 1) * bm + g * 64) * LIN_BOX;
      const uint32_t w0 = smem_u32(stage) + a_bytes;
      wgmma_fence();
      if constexpr (kTf32) {
        const uint32_t al = a0 + bm * LIN_BOX, wl = w0 + BN * LIN_BOX;  // the lo slots
#pragma unroll
        for (int kk = 0; kk < LIN_BOX / 32; ++kk) {  // k8 a step: 32 bytes of K
          const uint64_t ah = wgmma_desc(a0 + 32 * kk, 16, 1024);
          const uint64_t wh = wgmma_desc(w0 + 32 * kk, 16, 1024);
          Wgmma<BN>::tf32(d, wgmma_desc(al + 32 * kk, 16, 1024), wh);
          Wgmma<BN>::tf32(d, ah, wgmma_desc(wl + 32 * kk, 16, 1024));
          Wgmma<BN>::tf32(d, ah, wh);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < LIN_BOX / 32; ++kk)  // 32 bytes of K a step: k16 bf16, k32 int8
          Wgmma<BN>::mma(d, wgmma_desc(a0 + 32 * kk, 16, 1024),
                         wgmma_desc(w0 + 32 * kk, 16, 1024));
      }
      wgmma_commit();
      if (stages > 1) {
        wgmma_wait<1>();  // box b - 1's products are done: release its slot
        wgmma_fence_regs(d);
        if (b > 0) mbar_arrive(&empty[(b - 1) % stages]);
      } else {  // one slot: box b's products must end before box b + 1 can land
        wgmma_wait<0>();
        wgmma_fence_regs(d);
        mbar_arrive(&empty[0]);
      }
    }
    wgmma_wait<0>();
    wgmma_fence_regs(d);
    bar_sync(LIN_BAR_CONSUMERS, ncons);  // every warpgroup is done with the ring
    // the partial tile over the ring, row-major with pitch LDP
    Acc* part = reinterpret_cast<Acc*>(ring);
    const int lane = threadIdx.x % 32;
    const int r0 = 64 * g + 16 * ((threadIdx.x % 128) / 32) + lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      store2(part + r0 * LDP + 8 * j + c0, d[4 * j], d[4 * j + 1]);
      store2(part + (r0 + 8) * LDP + 8 * j + c0, d[4 * j + 2], d[4 * j + 3]);
    }
  }
  cluster_arrive();  // this block's partial tile is written

  // This block's share of the tile's 4-column groups: the partials of ranks
  // 0 .. splits - 1 added in that order, then the epilogue.  A group's
  // inputs that wait for no block (the bias, the int8 scales, the residual)
  // are loaded before every rank's partial, and a thread's first group's
  // inside the cluster barrier, so they arrive while the cluster finishes.
  const int groups = bm * BN / 4;
  const int lo = groups * rank / splits, hi = groups * (rank + 1) / splits;
  const uint32_t base = smem_u32(ring);
  const bool vec = N % 4 == 0;
  struct EpiIn {
    float y[4], scale[4], row_scale;
    float4 res;
  };
  auto fetch = [&](int q, EpiIn& in) {
    const int m = m0 + q / (BN / 4), n = n0 + (q % (BN / 4)) * 4;
    if (m >= M || n >= N) return false;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = n + e < N ? n + e : n;  // columns past N are computed and not stored
      in.y[e] = bias[col];
      in.scale[e] = kInt8 ? sw[col] : 1.f;
    }
    in.row_scale = kInt8 && !kFold ? sx[m] : 1.f;  // the folded scale: read after the barrier
    in.res = make_float4(0.f, 0.f, 0.f, 0.f);
    if (epi == kEpiResidual && vec)
      in.res = *reinterpret_cast<const float4*>(static_cast<const float*>(out) +
                                                (size_t)m * N + n);
    return true;
  };
  const int first = lo + (int)threadIdx.x;
  EpiIn in;
  bool live = first < hi && fetch(first, in);
  cluster_wait();  // every block's partial tile is written

  bool arrived = false;  // at the second barrier: this thread's reads of the partials are done
  for (int q = first; q < hi; q += blockDim.x) {
    if (q != first) live = fetch(q, in);
    if (!live) continue;
    const int r = q / (BN / 4), c = (q % (BN / 4)) * 4;
    const int m = m0 + r, n = n0 + c;
    const size_t o = (size_t)m * N + n;
    float* y = in.y;
    const float4 res = in.res;
    const uint32_t off = base + (uint32_t)(r * LDP + c) * 4;
    decltype(ld_cluster(off, (Acc*)nullptr)) part[LIN_MAX_SPLITS];
#pragma unroll
    for (int p = 0; p < LIN_MAX_SPLITS; ++p)
      if (p < splits) part[p] = ld_cluster(cluster_map(off, p), (Acc*)nullptr);
#pragma unroll
    for (int p = 1; p < LIN_MAX_SPLITS; ++p) {
      if (p < splits) {
        part[0].x += part[p].x;
        part[0].y += part[p].y;
        part[0].z += part[p].z;
        part[0].w += part[p].w;
      }
    }
    const Acc acc[4] = {part[0].x, part[0].y, part[0].z, part[0].w};
    // the producer warp's threads reduce too: the consumers' fold_scale
    // reaches them through the cluster barrier above
    if constexpr (kFold) in.row_scale = fold_scale[r];
    if (q + (int)blockDim.x >= hi) {  // the last group's partials are read
      cluster_arrive_thread();
      arrived = true;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // int8: float(acc) * sx * sw, then the bias (decode_step.py:286), each
      // operation rounded on its own (no FMA), as ops/quant.py::int8_matmul
      if constexpr (kInt8)
        y[e] = __fadd_rn(y[e], __fmul_rn(__fmul_rn((float)acc[e], in.row_scale), in.scale[e]));
      else y[e] += acc[e];
    }
    if (epi == kEpiResidual) {
      float* dst = static_cast<float*>(out) + o;  // the float32 residual stream, in place
      if (vec) *reinterpret_cast<float4*>(dst) =
          make_float4(res.x + y[0], res.y + y[1], res.z + y[2], res.w + y[3]);
      else for (int e = 0; e < 4 && n + e < N; ++e) dst[e] += y[e];
      continue;
    }
    if (epi == kEpiGelu) {
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = gelu_new(y[e]);
    }
    if (out_f32) {
      float* dst = static_cast<float*>(out) + o;
      if (vec) *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
      else for (int e = 0; e < 4 && n + e < N; ++e) dst[e] = y[e];
    } else {
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + o;
      if (vec) {
        const __nv_bfloat162 lo2 = __floats2bfloat162_rn(y[0], y[1]);
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(y[2], y[3]);
        *reinterpret_cast<uint2*>(dst) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo2),
                                                    *reinterpret_cast<const uint32_t*>(&hi2));
      } else {
        for (int e = 0; e < 4 && n + e < N; ++e) dst[e] = from_f32<__nv_bfloat16>(y[e]);
      }
    }
  }
  if (!arrived) cluster_arrive_thread();
  cluster_wait_thread();  // this block's partial stays until the cluster has read it
}

template <typename E, typename A, int BN>
static int launch_wgmma(const void* a, int a_split, const void* w, const float* bias, void* out,
                        int out_f32, int epi, int M, int N, int K, int kslice, int splits,
                        const float* sx, const float* sw, cudaStream_t s) {
  constexpr bool tf32 = std::is_same<E, float>::value;
  constexpr int BK = LIN_BOX / (int)sizeof(E);
  constexpr int abox = (int)(sizeof(A) / sizeof(E));
  auto kernel = linear_wgmma_kernel<E, A, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instantiation
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, LIN_SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  const int consumers = M <= 64 ? 1 : 2, bm = 64 * consumers;
  const int blocks = (N + BN - 1) / BN * splits * ((M + bm - 1) / bm);
  const int stage_bytes = lin_stage_bytes(bm, BN, abox, tf32 ? 2 : 1);
  const int stages = lin_stages(stage_bytes, kslice / BK, lin_budget(tf32, abox, blocks));
  CUtensorMap amap, wmap;
  int err = tma_operand_map(&amap, a, tf32 && a_split ? 2 * M : M, K, bm, (int)sizeof(A));
  if (!err) err = tma_operand_map(&wmap, w, N, K, BN, (int)sizeof(E));
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + BN - 1) / BN * splits), (unsigned)((M + bm - 1) / bm), 1);
  cfg.blockDim = dim3((unsigned)(128 * consumers + lin_service<E>()), 1, 1);
  cfg.dynamicSmemBytes = lin_smem(bm, BN, stages, stage_bytes);
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, amap, wmap, a, bias, out, out_f32, epi, M, N, K,
                                 kslice, stages, sx, sw, a_split);
}

template <typename E, typename A>
static int dispatch_wgmma(int bn, const void* a, int a_split, const void* w, const float* bias,
                          void* out, int out_f32, int epi, int M, int N, int K, int kslice,
                          int splits, const float* sx, const float* sw, cudaStream_t s) {
  const int bk = LIN_BOX / (int)sizeof(E);
  if (splits < 1 || splits > LIN_MAX_SPLITS || kslice <= 0 || kslice % bk ||
      (K + kslice - 1) / kslice != splits)
    return (int)cudaErrorInvalidValue;
  switch (bn) {
    case 32:
      return launch_wgmma<E, A, 32>(a, a_split, w, bias, out, out_f32, epi, M, N, K, kslice,
                                    splits, sx, sw, s);
    case 64:
      return launch_wgmma<E, A, 64>(a, a_split, w, bias, out, out_f32, epi, M, N, K, kslice,
                                    splits, sx, sw, s);
    case 128:
      return launch_wgmma<E, A, 128>(a, a_split, w, bias, out, out_f32, epi, M, N, K, kslice,
                                     splits, sx, sw, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int linear_wgmma_bf16(const void* a, const void* w, const float* bias, void* out, int epi, int M,
                      int N, int K, int bn, int splits, int kslice, cudaStream_t s) {
  if (M <= 0 || K <= 0 || N <= 0 || epi < kEpiCast || epi > kEpiResidual)
    return (int)cudaErrorInvalidValue;
  return dispatch_wgmma<__nv_bfloat16, __nv_bfloat16>(bn, a, 0, w, bias, out, 0, epi, M, N, K,
                                                      kslice, splits, nullptr, nullptr, s);
}

int linear_wgmma_f32(const float* a, int a_split, const float* w, const float* bias, float* out,
                     int epi, int M, int N, int K, int bn, int splits, int kslice, cudaStream_t s) {
  if (M <= 0 || K <= 0 || N <= 0 || epi < kEpiCast || epi > kEpiResidual)
    return (int)cudaErrorInvalidValue;
  return dispatch_wgmma<float, float>(bn, a, a_split, w, bias, out, 1, epi, M, N, K, kslice,
                                      splits, nullptr, nullptr, s);
}

}  // namespace gic

// x: (M, K) float32 when ln != 0 (the residual stream), else the compute
// dtype; w: (N, K) in the compute dtype, or int8 when w_scale ((N,) float32)
// is given; bias: (N,) float32; out: (M, N) in the compute dtype, or the
// float32 residual stream (read and written) when epi is the residual add.
// Scratch, with ln != 0: xa the operand rows, (M, K) int8 with int8
// weights, (M, K) bf16 with bf16 weights, (2M, K) float32 (the TF32 pair)
// with float32 weights; sx (M,) float32 with int8 weights.  int8 weights
// without ln quantize x inside the product (no scratch).  bn, splits,
// kslice: the split (ops/decode_step.py::linear_plan): BN 32, 64 or 128
// columns a block, 1-8 K-slices of kslice elements (a multiple of 128
// bytes of the weights), every slice non-empty.  Returns the first launch
// error (cudaGetLastError() after the launches).
extern "C" int gic_fused_linear(int dtype, int ln, int epi, const void* x, const void* ln_s,
                                const void* ln_b, float eps, const void* w, const void* w_scale,
                                const void* bias, void* out, void* xa, void* sx, int M, int K,
                                int N, int bn, int splits, int kslice, void* stream) {
  using namespace gic;
  if (M <= 0 || K <= 0 || N <= 0 || epi < kEpiCast || epi > kEpiResidual)
    return (int)cudaErrorInvalidValue;
  if (dtype != kBF16 && dtype != kF32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lns = static_cast<const float*>(ln_s);
  const float* lnb = static_cast<const float*>(ln_b);
  const float* b = static_cast<const float*>(bias);
  const float* ws = static_cast<const float*>(w_scale);
  const bool int8 = w_scale != nullptr;
  const int out_f32 = dtype == kF32;
  int err;
  if (int8 && !ln) {  // the rows quantized inside the product
    err = dtype == kBF16
              ? dispatch_wgmma<int8_t, __nv_bfloat16>(bn, x, 0, w, b, out, out_f32, epi, M, N, K,
                                                      kslice, splits, nullptr, ws, s)
              : dispatch_wgmma<int8_t, float>(bn, x, 0, w, b, out, out_f32, epi, M, N, K, kslice,
                                              splits, nullptr, ws, s);
  } else if (int8) {  // LN, the cast and the quantization in one pre-pass (rowquant.cu)
    int8_t* q = static_cast<int8_t*>(xa);
    float* sxp = static_cast<float*>(sx);
    if (dtype == kBF16)
      launch_rowquant<__nv_bfloat16, true>(s, x, K, lns, lnb, eps, M, K, q, K, sxp);
    else
      launch_rowquant<float, true>(s, x, K, lns, lnb, eps, M, K, q, K, sxp);
    const cudaError_t pre = cudaGetLastError();
    if (pre != cudaSuccess) return (int)pre;
    err = dispatch_wgmma<int8_t, int8_t>(bn, q, 0, w, b, out, out_f32, epi, M, N, K, kslice,
                                         splits, sxp, ws, s);
  } else if (dtype == kF32) {  // wgmma TF32; with the LN its pre-pass writes the TF32 pair
    const float* a = static_cast<const float*>(x);
    if (ln) {
      float* rows = static_cast<float*>(xa);
      launch_ln_rows(s, a, lns, lnb, eps, M, K, rows, rows + (size_t)M * K);
      const cudaError_t pre = cudaGetLastError();
      if (pre != cudaSuccess) return (int)pre;
      a = rows;
    }
    err = linear_wgmma_f32(a, ln, static_cast<const float*>(w), b, static_cast<float*>(out), epi,
                           M, N, K, bn, splits, kslice, s);
  } else {
    const void* a = x;
    if (ln) {
      __nv_bfloat16* rows = static_cast<__nv_bfloat16*>(xa);
      launch_ln_rows(s, static_cast<const float*>(x), lns, lnb, eps, M, K, rows,
                     static_cast<float*>(nullptr));
      const cudaError_t pre = cudaGetLastError();
      if (pre != cudaSuccess) return (int)pre;
      a = rows;
    }
    err = dispatch_wgmma<__nv_bfloat16, __nv_bfloat16>(bn, a, 0, w, b, out, out_f32, epi, M, N,
                                                       K, kslice, splits, nullptr, nullptr, s);
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

// The float32 product kernel's registers and local (spill) bytes a thread
// (cudaFuncGetAttributes: numRegs, localSizeBytes) into out[0], out[1], for
// variant 0, 1, 2: BN 32, 64, 128.  Returns 0 or a cudaError_t.
extern "C" int gic_linear_f32_attrs(int variant, int* out) {
  using namespace gic;
  cudaFuncAttributes a;
  cudaError_t err;
  if (variant == 0) err = cudaFuncGetAttributes(&a, linear_wgmma_kernel<float, float, 32>);
  else if (variant == 1) err = cudaFuncGetAttributes(&a, linear_wgmma_kernel<float, float, 64>);
  else if (variant == 2) err = cudaFuncGetAttributes(&a, linear_wgmma_kernel<float, float, 128>);
  else return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return 0;
}

extern "C" const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
