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
// Routes.  bf16 and int8 (W8A8) weights run the design below; float32 keeps
// the product tile of common.cuh (ln_stats_kernel, then fused_linear_kernel:
// a 64 x 32 tile a block, the three-term TF32 split), unchanged.
//
// Design for Hopper (bf16, int8).  The prologue runs once a call as its own
// launch: the LayerNorm roles normalise their rows into (M, K) bf16
// (common.cuh::ln_rows_kernel), and the int8 route quantizes its rows into
// (M, K) int8 and (M,) scales (rowquant.cu, after the LayerNorm and the cast
// where the role has one).  The product kernel then reads both operands by
// TMA: a block owns a column tile of BN (32, 64 or 128) outputs, all of the
// call's rows up to 128 (two consumer warpgroups of 64 rows on wgmma, one
// where M <= 64; more rows take more row tiles), and one K-slice.  One
// producer warp keeps the slice's 128-byte-deep boxes of rows and weights
// in flight, 128-byte swizzled, in a ring of up to 8 stages (as many as the
// slice has, within 110 KB, so two blocks share an SM: 3 stages at BN 128,
// 5 at BN 32) whose mbarriers the consumers wait on and release.  W is (N,
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
// maps are encoded once per (pointer, shape, box) and cached here, so a
// call encodes none once its buffers recur.
//
// What bounds it at B 128 on the H100 is latency, not bytes: a product
// launch's phases (the TMA round trip, the products, the cluster's two
// barriers and the partials' round trip, the stores) took 5-10 us in every
// split the sweep timed, against the 0.5-1.4 us its weights need.  At 512
// rows MLP fc took 23-29 us in every split, far above its bytes and
// products (1.4 and 2.4 us); by estimate its gelu_new, kept in float64 for
// the int8 step's exactness, holds the SMs' float64 units for several us.
#include <mutex>
#include <unordered_map>

#include "common.cuh"

namespace gic {

constexpr int kEpiCast = 0;
constexpr int kEpiGelu = 1;
constexpr int kEpiResidual = 2;

// ---------------------------------------------------------------------------
// float32: the product tile of common.cuh
// ---------------------------------------------------------------------------

// (mean, rstd) of each float32 row, one warp per row.
__global__ void ln_stats_kernel(const float* x, int M, int K, float eps, float* stats) {
  const int m = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (m >= M) return;
  float mean, rstd;
  row_mean_rstd(x + (size_t)m * K, K, eps, mean, rstd);
  if (threadIdx.x % 32 == 0) {
    stats[2 * (size_t)m] = mean;
    stats[2 * (size_t)m + 1] = rstd;
  }
}

template <bool LN, int EPI>
__global__ void __launch_bounds__(THREADS)
fused_linear_kernel(const void* x, const float* stats, const float* ln_s, const float* ln_b,
                    const float* w, const float* bias, float* out, int M, int K, int N) {
  __shared__ TileSmem<float> sm;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  tile_product<float, LN>(sm, x, stats, ln_s, ln_b, w, M, K, N, m0, n0);
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const float y = sm.cs[r][c] + bias[n];
    const size_t o = (size_t)m * N + n;
    if (EPI == kEpiCast) out[o] = y;
    else if (EPI == kEpiGelu) out[o] = gelu_new(y);
    else out[o] += y;  // the float32 residual stream, in place
  }
}

static void launch_f32(int ln, int epi, cudaStream_t s, const float* x, float* stats,
                       const float* ln_s, const float* ln_b, float eps, const float* w,
                       const float* bias, float* out, int M, int K, int N) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (ln) {
    constexpr int kRowsPerBlock = 4;  // one warp per row
    ln_stats_kernel<<<(M + kRowsPerBlock - 1) / kRowsPerBlock, 32 * kRowsPerBlock, 0, s>>>(
        x, M, K, eps, stats);
  }
#define GIC_LAUNCH(LNV, EPIV)                                                              \
  fused_linear_kernel<LNV, EPIV><<<grid, THREADS, 0, s>>>(x, stats, ln_s, ln_b, w, bias, out, M, \
                                                          K, N)
  if (ln) {
    if (epi == kEpiCast) GIC_LAUNCH(true, kEpiCast);
    else if (epi == kEpiGelu) GIC_LAUNCH(true, kEpiGelu);
    else GIC_LAUNCH(true, kEpiResidual);
  } else {
    if (epi == kEpiCast) GIC_LAUNCH(false, kEpiCast);
    else if (epi == kEpiGelu) GIC_LAUNCH(false, kEpiGelu);
    else GIC_LAUNCH(false, kEpiResidual);
  }
#undef GIC_LAUNCH
}

// ---------------------------------------------------------------------------
// bf16 and int8: TMA ring, wgmma, cluster split-K
// ---------------------------------------------------------------------------

constexpr int LIN_BOX = 128;              // bytes of K a box and a ring stage: one swizzled row
constexpr int LIN_MAX_SPLITS = 8;         // K-slices of a column tile: a portable cluster
constexpr int LIN_MAX_STAGES = 8;
constexpr int LIN_RING_BUDGET = 110 * 1024;  // a block's ring: two blocks an SM
constexpr int LIN_PAD = 8;                // the partial tile's row pitch is BN + LIN_PAD
constexpr int LIN_MAX_THREADS = 2 * 128 + 32;  // two consumer warpgroups and the producer warp
constexpr int LIN_SMEM_MAX = 1024 + LIN_RING_BUDGET;
constexpr int LIN_BAR_CONSUMERS = 1;      // named barrier of the consumer warpgroups

// Ring stages of a block: every box of its slice, within the budget (so a
// slice of <= the budget's stages has all its boxes in flight at once).
// ops/decode_step.py::linear_plan mirrors this sizing.
static int lin_stages(int bm, int bn, int boxes) {
  const int fit = LIN_RING_BUDGET / ((bm + bn) * LIN_BOX);
  int stages = boxes < fit ? boxes : fit;
  if (stages > LIN_MAX_STAGES) stages = LIN_MAX_STAGES;
  return stages < 1 ? 1 : stages;
}
static size_t lin_smem(int bm, int bn, int stages) {
  const size_t ring = (size_t)stages * (bm + bn) * LIN_BOX;
  const size_t part = (size_t)bm * (bn + LIN_PAD) * 4;
  return 1024 + (ring > part ? ring : part);  // 1024: room to align the ring
}

template <typename Acc>
__device__ __forceinline__ void store2(Acc* p, Acc a, Acc b) {
  if constexpr (std::is_same<Acc, float>::value) *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

// amap: the (M, K) operand rows, box (128 bytes of K, 64 x consumers rows);
// wmap: W (N, K), box (128 bytes of K, BN rows); both 128-byte swizzled.
// out: (M, N), the compute dtype (float32 where out_f32) or, for the
// residual epilogue, the float32 stream.  sx (M,) and sw (N,): the int8
// scales.  Grid: (column tiles x splits, row tiles); cluster (splits, 1, 1).
// Warps 0 .. 4 consumers - 1 multiply, the last one produces.
template <typename E, int BN>
__global__ void __launch_bounds__(LIN_MAX_THREADS, 2)
linear_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                    const __grid_constant__ CUtensorMap wmap, const float* bias, void* out,
                    int out_f32, int epi, int M, int N, int K, int kslice, int stages,
                    const float* sx, const float* sw) {
  constexpr bool kInt8 = std::is_same<E, int8_t>::value;
  using Acc = typename std::conditional<kInt8, int, float>::type;
  constexpr int BK = LIN_BOX / (int)sizeof(E);  // K elements a box
  constexpr int R = BN / 2;                     // accumulators a thread
  constexpr int LDP = BN + LIN_PAD;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[LIN_MAX_STAGES], empty[LIN_MAX_STAGES];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int ncons = blockDim.x - 32;  // consumer threads
  const int bm = ncons / 2;           // 64 rows a consumer warpgroup
  const int stage_bytes = (bm + BN) * LIN_BOX;
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
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= ncons) {
    // ---- producer warp: one lane keeps the slice's boxes in flight ----
    if (threadIdx.x == ncons) {
      for (int b = 0; b < nbox; ++b) {
        const int s = b % stages;
        if (b >= stages) mbar_wait(&empty[s], (b / stages - 1) & 1);  // box b - stages released
        unsigned char* a = ring + s * stage_bytes;
        mbar_expect_tx(&full[s], stage_bytes);
        tma_load_2d(a, &amap, &full[s], k0 + b * BK, m0);
        tma_load_2d(a + bm * LIN_BOX, &wmap, &full[s], k0 + b * BK, n0);
      }
    }
    __syncwarp();
  } else {
    // ---- consumer warpgroup g: rows 64 g .. 64 g + 63 of the tile ----
    const int g = threadIdx.x / 128;
    Acc d[R];
#pragma unroll
    for (int i = 0; i < R; ++i) d[i] = 0;
    for (int b = 0; b < nbox; ++b) {
      const int s = b % stages;
      mbar_wait(&full[s], (b / stages) & 1);
      const uint32_t a0 = smem_u32(ring + s * stage_bytes) + g * 64 * LIN_BOX;
      const uint32_t w0 = smem_u32(ring + s * stage_bytes) + bm * LIN_BOX;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < LIN_BOX / 32; ++kk)  // 32 bytes of K a step: k16 bf16, k32 int8
        Wgmma<BN>::mma(d, wgmma_desc(a0 + 32 * kk, 16, 1024), wgmma_desc(w0 + 32 * kk, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // box b - 1's products are done: release its slot
      wgmma_fence_regs(d);
      if (b > 0) mbar_arrive(&empty[(b - 1) % stages]);
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
    in.row_scale = kInt8 ? sx[m] : 1.f;
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
    if (q + (int)blockDim.x >= hi) {  // the last group's partials are read
      cluster_arrive_thread();
      arrived = true;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // int8: float(acc) * sx * sw, then the bias (decode_step.py:286)
      if constexpr (kInt8) y[e] += (float)acc[e] * in.row_scale * in.scale[e];
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

// The TMA map of a (rows, cols) row-major operand (cols = K), box (128 bytes
// of K, box_rows), 128-byte swizzled, zero-filled out of bounds; encoded
// once per (pointer, shape, box) and cached: a map is a function of these
// alone, and the step's weights, and the caching allocator's buffers, recur.
struct MapKey {
  const void* ptr;
  int rows, cols, box_rows, int8;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols && box_rows == o.box_rows &&
           int8 == o.int8;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr);
    for (int v : {k.rows, k.cols, k.box_rows, k.int8}) h = h * 1000003u ^ (size_t)v;
    return h;
  }
};

static int operand_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
                       bool int8) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{ptr, rows, cols, box_rows, int8};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return 0;
  }
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const int el = int8 ? 1 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * el};  // bytes
  const cuuint32_t box[2] = {(cuuint32_t)(LIN_BOX / el), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            2, const_cast<void*>(ptr), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

template <typename E, int BN>
static int launch_wgmma(const void* a, const void* w, const float* bias, void* out, int out_f32,
                        int epi, int M, int N, int K, int kslice, int splits, const float* sx,
                        const float* sw, cudaStream_t s) {
  constexpr bool kInt8 = std::is_same<E, int8_t>::value;
  constexpr int BK = LIN_BOX / (int)sizeof(E);
  auto kernel = linear_wgmma_kernel<E, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instantiation
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, LIN_SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  const int consumers = M <= 64 ? 1 : 2, bm = 64 * consumers;
  const int stages = lin_stages(bm, BN, kslice / BK);
  CUtensorMap amap, wmap;
  int err = operand_map(&amap, a, M, K, bm, kInt8);
  if (!err) err = operand_map(&wmap, w, N, K, BN, kInt8);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + BN - 1) / BN * splits), (unsigned)((M + bm - 1) / bm), 1);
  cfg.blockDim = dim3((unsigned)(128 * consumers + 32), 1, 1);
  cfg.dynamicSmemBytes = lin_smem(bm, BN, stages);
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, amap, wmap, bias, out, out_f32, epi, M, N, K,
                                 kslice, stages, sx, sw);
}

template <typename E>
static int dispatch_wgmma(int bn, const void* a, const void* w, const float* bias, void* out,
                          int out_f32, int epi, int M, int N, int K, int kslice, int splits,
                          const float* sx, const float* sw, cudaStream_t s) {
  switch (bn) {
    case 32:
      return launch_wgmma<E, 32>(a, w, bias, out, out_f32, epi, M, N, K, kslice, splits, sx, sw, s);
    case 64:
      return launch_wgmma<E, 64>(a, w, bias, out, out_f32, epi, M, N, K, kslice, splits, sx, sw, s);
    case 128:
      return launch_wgmma<E, 128>(a, w, bias, out, out_f32, epi, M, N, K, kslice, splits, sx, sw,
                                  s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace gic

// x: (M, K) float32 when ln != 0 (the residual stream), else the compute
// dtype; w: (N, K) in the compute dtype, or int8 when w_scale ((N,) float32)
// is given; bias: (N,) float32; out: (M, N) in the compute dtype, or the
// float32 residual stream (read and written) when epi is the residual add.
// Scratch: stats (M, 2) float32 (float32 with ln != 0); xa the operand rows,
// (M, K) int8 with int8 weights, (M, K) bf16 with bf16 weights and ln != 0;
// sx (M,) float32 with int8 weights.  bn, splits, kslice: the bf16 and int8
// routes' split (ops/decode_step.py::linear_plan; unused by float32): BN
// 32, 64 or 128 columns a block, 1-8 K-slices of kslice elements (a
// multiple of 128 bytes), every slice non-empty.  Returns the first launch
// error (cudaGetLastError() after the launches).
extern "C" int gic_fused_linear(int dtype, int ln, int epi, const void* x, const void* ln_s,
                                const void* ln_b, float eps, const void* w, const void* w_scale,
                                const void* bias, void* out, void* stats, void* xa, void* sx,
                                int M, int K, int N, int bn, int splits, int kslice,
                                void* stream) {
  using namespace gic;
  if (M <= 0 || K <= 0 || N <= 0 || epi < kEpiCast || epi > kEpiResidual)
    return (int)cudaErrorInvalidValue;
  if (dtype != kBF16 && dtype != kF32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lns = static_cast<const float*>(ln_s);
  const float* lnb = static_cast<const float*>(ln_b);
  const float* b = static_cast<const float*>(bias);
  const bool int8 = w_scale != nullptr;
  if (dtype == kF32 && !int8) {
    launch_f32(ln, epi, s, static_cast<const float*>(x), static_cast<float*>(stats), lns, lnb,
               eps, static_cast<const float*>(w), b, static_cast<float*>(out), M, K, N);
    return (int)cudaGetLastError();
  }
  const int bk = LIN_BOX / (int8 ? 1 : 2);
  if (splits < 1 || splits > LIN_MAX_SPLITS || kslice <= 0 || kslice % bk ||
      (K + kslice - 1) / kslice != splits)
    return (int)cudaErrorInvalidValue;
  const void* a = x;
  float* sxp = static_cast<float*>(sx);
  if (int8) {
    int8_t* q = static_cast<int8_t*>(xa);
    if (dtype == kBF16) {
      if (ln) launch_rowquant<__nv_bfloat16, true>(s, x, K, lns, lnb, eps, M, K, q, K, sxp);
      else launch_rowquant<__nv_bfloat16, false>(s, x, K, lns, lnb, eps, M, K, q, K, sxp);
    } else {
      if (ln) launch_rowquant<float, true>(s, x, K, lns, lnb, eps, M, K, q, K, sxp);
      else launch_rowquant<float, false>(s, x, K, lns, lnb, eps, M, K, q, K, sxp);
    }
    a = q;
  } else if (ln) {
    __nv_bfloat16* rows = static_cast<__nv_bfloat16*>(xa);
    ln_rows_kernel<__nv_bfloat16><<<(M + kLnRowsPerBlock - 1) / kLnRowsPerBlock,
                                    32 * kLnRowsPerBlock, 0, s>>>(
        static_cast<const float*>(x), lns, lnb, eps, M, K, rows);
    a = rows;
  }
  const cudaError_t pre = cudaGetLastError();
  if (pre != cudaSuccess) return (int)pre;
  const int out_f32 = dtype == kF32;
  const int err =
      int8 ? dispatch_wgmma<int8_t>(bn, a, w, b, out, out_f32, epi, M, N, K, kslice, splits, sxp,
                                    static_cast<const float*>(w_scale), s)
           : dispatch_wgmma<__nv_bfloat16>(bn, a, w, b, out, out_f32, epi, M, N, K, kslice,
                                           splits, nullptr, nullptr, s);
  if (err) return err;
  return (int)cudaGetLastError();
}

extern "C" const char* gic_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
