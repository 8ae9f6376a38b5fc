// Patch embedding from uint8 pixels: normalise and multiply in one kernel.
//
// Replaces: gpt2_image_captioning_tpu/ops/patch_embed.py::_kernel (:36), as
// fused_patch_embed_pallas (:45) and patch_embed (:97) call it: uint8
// patches (M, K = 3p^2) times 1/255, then (x - mean) * inv_std per element,
// then @ W (K, D) into (M, D) float32; the optional bias is added in the
// epilogue here (outside the TPU kernel there).
//
// Design for Hopper.  The TPU path unfolds the pixels into (M, K) uint8
// patches in XLA first (:118-119).  Here the tile load reads the (B, S, S, 3)
// NHWC pixels directly, doing the unfold in the load, and walks K in the
// pixels' own order: column k' = py * 3p + px * 3 + c = 3r + c of row m = b *
// N + patch, r = py p + px the pixel's index in the patch.  A patch row is
// then 3p contiguous bytes of the image (96 at p 32, 48 at p 16), read as
// 16-byte vectors: the image row (3S = 672 bytes at 224 px) and the patch
// corners (multiples of 3p) keep them aligned.  Column k' multiplies row k =
// c p^2 + r of W as stored ((K, D), the torch conv order of
// models/clip.py::extract_patches), and its mean and inverse std are read
// through the same map, so the permutation costs nothing: seen as the 3-D
// tensor (D, 3, p^2), W gives a stage's 48 columns (16 pixels, 3 channels)
// as one TMA box a 64-column block, already in the kernel's order.  Each
// byte is converted, scaled by 1/255 and normalised in float32 (rounded
// step by step, as the twin and the TPU kernel round it) and cast to the
// operand type on its way into shared memory, so no patch tensor, uint8 or
// float, reaches device memory.
//
// A block owns a 128-row output tile: 128 x 256 in bf16 on wgmma, 128 x 64
// in float32 on mma.sync as the three-term TF32 split of common.cuh (a
// fresh accumulator a 32-deep stage, added in float32).  Its warps are
// specialised.  One producer warpgroup (a thread a row) loads the pixel
// vectors into registers two stages ahead, normalises them into the
// stage's A tile, and has the stage's W boxes (bf16: TMA, signalling an
// mbarrier; float32: cp.async) and mean / inv_std (cp.async) copied two
// stages ahead, into a ring of 4 stages.  Two consumer warpgroups multiply
// (bf16: each m64n256k16 over its 64 rows, three k16 steps a stage, float32
// accumulators in registers, A K-major and B N-major in shared memory,
// 128-byte swizzled, one stage's wgmma in flight while the next is issued).
// Named barriers pass each slot full to the consumers and empty back to
// the producer, so the normalisation runs beside the tensor cores, and at
// 256 columns it is done D / 256 times a row tile.  The epilogue adds the
// bias and stores float32 from registers in 16-byte vectors (a lane pair
// swaps halves of its fragments).  Patch rows that are not 16-byte aligned
// (p 8 at 32 px: 24-byte runs; p 14 at 224 px: 42) take the same kernel
// with one byte load an element.  On an H100 at CLIP b 256 (chip_smoke.py):
// W by per-thread cp.async 0.41 ms, by TMA 0.28; most of what is left is
// the normalisation, and a second producer warpgroup (at 192 columns, for
// registers) did not help.
//
// Bound on the H100: CLIP B/32 at b 256 (M 12,544, K 3,072, D 768) does 59
// GFLOP, 0.060 ms in bf16, against 82 MB moved (0.024 ms): operations.
// ViT-B/16 at b 128 (M 25,088, K 768) is about balanced (30 GFLOP, 98 MB:
// the float32 output dominates the bytes).
#include "common.cuh"

namespace gic {

constexpr int PE_BM = 128;         // output rows (patches) per block
constexpr int PE_CONSUMERS = 256;  // warps 0-7: consumer warp w owns rows 16w .. 16w + 15
constexpr int PE_THREADS = 384;    // and one producer warpgroup
constexpr int PE_STAGES = 4;       // the ring of A / W / mean / inv_std stages

template <typename T> struct PeCfg;
// bf16: A (128 x 48, in 128-byte rows) and B (48 x 256) stages, swizzled;
// 48 columns are 16 pixels of 3 channels, one TMA box of W a 64-column block
template <> struct PeCfg<__nv_bfloat16> {
  static constexpr int BN = 256, BK = 48;
  static constexpr int A_BYTES = PE_BM * 128, B_BYTES = BK * BN * 2;
  // a ring slot: A, B, then mean and inv_std, padded to keep the next slot's
  // tiles on the 1024-byte boundary the swizzle needs
  static constexpr int STAGE = (A_BYTES + B_BYTES + 2 * BK * 4 + 1023) / 1024 * 1024;
};
// float32: pitches of BK + 4 and BN + 8 floats make the TF32 fragment loads
// conflict-free and keep every row 16-byte aligned
template <> struct PeCfg<float> {
  static constexpr int BN = 64, BK = 32, A_LD = BK + 4, B_LD = BN + 8;
  static constexpr int A_BYTES = PE_BM * A_LD * 4, B_BYTES = BK * B_LD * 4;
  static constexpr int STAGE = A_BYTES + B_BYTES + 2 * BK * 4;
};

// Where the 16 normalised values of row r, columns 16 cc .. 16 cc + 15 of a
// stage go.  bf16: the 128-byte swizzle wgmma reads (16-byte piece j of row
// r at piece j ^ (r % 8)); float: a padded row.
__device__ __forceinline__ void a_store(unsigned char* a, int r, int cc, const float (&v)[16],
                                        __nv_bfloat16*) {
  uint32_t h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const __nv_bfloat162 two = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    h[e] = *reinterpret_cast<const uint32_t*>(&two);
  }
  const int sw = r & 7;
  *reinterpret_cast<uint4*>(a + r * 128 + (((2 * cc) ^ sw) << 4)) =
      make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(a + r * 128 + (((2 * cc + 1) ^ sw) << 4)) =
      make_uint4(h[4], h[5], h[6], h[7]);
}
__device__ __forceinline__ void a_store(unsigned char* a, int r, int cc, const float (&v)[16],
                                        float*) {
  float* row = reinterpret_cast<float*>(a) + r * PeCfg<float>::A_LD + cc * 16;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    *reinterpret_cast<float4*>(row + 4 * e) = make_float4(v[4 * e], v[4 * e + 1], v[4 * e + 2],
                                                          v[4 * e + 3]);
}

// Byte offset of W's 16-byte piece (stage row kk, columns n ..) in a
// float32 B stage (bf16 stages come whole from TMA): a padded row.
__device__ __forceinline__ int b_offset(int kk, int n) { return (kk * PeCfg<float>::B_LD + n) * 4; }

template <typename T> struct PeMma;

// bf16: consumer warpgroup g multiplies rows 64g .. 64g + 63 of a stage by
// all 256 columns, four k16 steps, asynchronously; d holds the m64n256
// fragments, acc(j)[e] = d[4j + e]: row 16w + lane/4 (+8 for e >= 2) of
// the block (w its warp among the consumers), column 8j + 2 (lane % 4) +
// e % 2.  One stage's products stay in flight while the next is issued.
template <> struct PeMma<__nv_bfloat16> {
  static constexpr int kLag = 1;  // stages still in flight after issue()
  float d[128];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
  }
  __device__ float* acc(int j) { return &d[4 * j]; }
  __device__ void issue(const unsigned char* a, const unsigned char* b) {
    const uint32_t a0 = smem_u32(a) + (threadIdx.x / 128) * 64 * 128;
    const uint32_t b0 = smem_u32(b);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PeCfg<__nv_bfloat16>::BK / 16; ++kk)
      wgmma_m64n256k16(d, wgmma_desc(a0 + kk * 32, 16, 1024),
                       wgmma_desc(b0 + kk * 16 * 128, PeCfg<__nv_bfloat16>::BK * 128, 1024));
    wgmma_commit();
    // wait for the previous stage's products: its A and B slots are free
    wgmma_wait<1>();
    wgmma_fence_regs(d);
  }
  __device__ void finish() {
    wgmma_wait<0>();
    wgmma_fence_regs(d);
  }
};

// float: consumer warp w multiplies rows 16w .. 16w + 15 by all 64 columns
// as m16n8k8 TF32 triples, synchronously; each stage into a fresh tile added
// once in float32, so the tensor cores' truncating sums reach over 12
// products at most.
template <> struct PeMma<float> {
  static constexpr int kLag = 0;
  static constexpr int NB = PeCfg<float>::BN / 8;
  float c[NB][4];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  }
  __device__ float* acc(int j) { return c[j]; }
  __device__ void issue(const unsigned char* a, const unsigned char* b) {
    using Cfg = PeCfg<float>;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const float* as = reinterpret_cast<const float*>(a);
    const float* bs = reinterpret_cast<const float*>(b);
    float part[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
    const float* x0 = as + (warp * 16 + g) * Cfg::A_LD + t;
    const float* x1 = x0 + 8 * Cfg::A_LD;
#pragma unroll
    for (int kk = 0; kk < Cfg::BK; kk += 8) {
      uint32_t ah[4], al[4];
      split_tf32(x0[kk], ah[0], al[0]);
      split_tf32(x1[kk], ah[1], al[1]);
      split_tf32(x0[kk + 4], ah[2], al[2]);
      split_tf32(x1[kk + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const float* w = bs + (kk + t) * Cfg::B_LD + j * 8 + g;
        uint32_t bh[2], bl[2];
        split_tf32(w[0], bh[0], bl[0]);
        split_tf32(w[4 * Cfg::B_LD], bh[1], bl[1]);
        mma_tf32x3(part[j], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[j][e] += part[j][e];
  }
  __device__ void finish() {}
};

// Named barriers (0 is __syncthreads): stage slot s is full (the producer
// arrives, the consumers wait) or empty (the reverse); the producer's own.
constexpr int BAR_FULL = 1, BAR_EMPTY = BAR_FULL + PE_STAGES, BAR_PRODUCER = BAR_EMPTY + PE_STAGES;

// px: (B, S, S, 3) uint8; w: (K, D); mean/inv: (K,) float32; bias: (D,)
// float32 or null; out: (B * N, D) float32, N = (S / p)^2; wmap: W's TMA
// map (bf16 only).  kAligned: every patch row starts on a 16-byte boundary
// and is a multiple of 16 bytes long.  Warps 0-7 consume (products,
// epilogue), warps 8-11 produce (copies, pixel loads, normalisation), one
// producer thread a row of the tile.
template <typename T, bool kAligned>
__global__ void __launch_bounds__(PE_THREADS, 1)
patch_embed_kernel(const uint8_t* px, const T* w, const float* mean, const float* inv,
                   const float* bias, float* out, int B, int S, int p, int D,
                   const __grid_constant__ CUtensorMap wmap) {
  using Cfg = PeCfg<T>;
  constexpr bool kTma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int BN = Cfg::BN, BK = Cfg::BK;
  constexpr int STAGE = Cfg::STAGE;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t b_full[PE_STAGES];  // bf16: slot s's W stage has landed
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // slot s: A at ring + s * STAGE, B after it, then mean and inv_std (BK each)
  auto a_slot = [&](int s) { return ring + s * STAGE; };
  auto b_slot = [&](int s) { return ring + s * STAGE + Cfg::A_BYTES; };
  auto mi_slot = [&](int s) {
    return reinterpret_cast<float*>(ring + s * STAGE + Cfg::A_BYTES + Cfg::B_BYTES);
  };

  const int gs = S / p, n_patch = gs * gs, pp = p * p;
  const int M = B * n_patch, K = 3 * pp;
  const int m0 = blockIdx.y * PE_BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  constexpr int ALL = PE_THREADS, CONSUMERS = PE_CONSUMERS;
  if constexpr (kTma) {
    if (threadIdx.x == 0)
      for (int i = 0; i < PE_STAGES; ++i) mbar_init(&b_full[i], 1);
    __syncthreads();
  }

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: thread pt owns row m0 + pt of the tile ----
    constexpr int PT = PE_THREADS - PE_CONSUMERS;
    static_assert(PT == PE_BM, "one producer thread a row");
    constexpr int P = 2;        // stages of copies in flight ahead
    constexpr int CH = BK / 16; // 16-byte pixel vectors of a row a stage
    const int pt = threadIdx.x - CONSUMERS;

    long long base = -1;  // byte offset of this row's patch corner, -1 past M
    if (m0 + pt < M) {
      const int b = (m0 + pt) / n_patch, patch = (m0 + pt) % n_patch;
      base = (((long long)b * S + (patch / gs) * p) * S + (patch % gs) * p) * 3;
    }
    // column k' = 3r + c (r = py p + px, the pixel's index in the patch) ->
    // its row c p^2 + r of W (and of mean / inv_std), and its byte offset
    // from the patch corner, py (3S) + px 3 + c = k' + py 3 (S - p)
    auto wrow = [&](int k) { return (k % 3) * pp + k / 3; };
    auto koff = [&](int k) { return (long long)k + (long long)(k / 3 / p) * 3 * (S - p); };
    // stage kt's W rows and mean / inv_std into its slot; one commit group
    // a stage, empty past the end, so the waits count evenly
    auto copies = [&](int kt) {
      if (kt < nk) {
        const int k0 = kt * BK, slot = kt % PE_STAGES;
        if constexpr (kTma) {
          if (pt == 0) {
            mbar_expect_tx(&b_full[slot], Cfg::B_BYTES);
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load_3d(b_slot(slot) + j * BK * 128, &wmap, &b_full[slot], n0 + 64 * j, 0,
                          k0 / 3);
          }
        } else {
          constexpr int WE = 16 / sizeof(T);  // W elements a 16-byte piece
          constexpr int TPR = PT / BK;        // producer threads a W row of a stage
          constexpr int PPT = BN / WE / TPR;  // W pieces a producer thread a stage
          const int kk = pt / TPR, k = k0 + kk;
          const bool kin = k < K;
          const T* row = kin ? w + (size_t)wrow(k) * D : w;
#pragma unroll
          for (int j = 0; j < PPT; ++j) {
            const int n = ((pt % TPR) * PPT + j) * WE, col = n0 + n;
            const bool in = kin && col < D;
            cp_async16(b_slot(slot) + b_offset(kk, n), in ? row + col : w, in);
          }
        }
        if (pt < 2 * BK) {
          const int k = k0 + pt % BK;
          const float* vec = pt < BK ? mean : inv;
          cp_async4(mi_slot(slot) + pt, k < K ? vec + wrow(k) : vec, k < K);
        }
      }
      cp_async_commit();
    };
    // this row's pixel vectors of stage kt
    auto load_px = [&](uint4 (&raw)[CH], int kt) {
      if (kt >= nk) return;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int k = kt * BK + 16 * c;
        if constexpr (kAligned) {
          raw[c] = base >= 0 && k < K ? *reinterpret_cast<const uint4*>(px + base + koff(k))
                                      : make_uint4(0, 0, 0, 0);
        } else {
          uint8_t* bytes = reinterpret_cast<uint8_t*>(&raw[c]);
#pragma unroll
          for (int e = 0; e < 16; ++e)
            bytes[e] = base >= 0 && k + e < K ? px[base + koff(k + e)] : 0;
        }
      }
    };
    // stage kt: normalise its pixels (loaded two stages earlier) into its A
    // tile, pass the slot to the consumers, load the pixels of stage kt + 2
    // into the same registers and issue the copies of stage kt + P
    auto produce = [&](uint4 (&raw)[CH], int kt) {
      const int slot = kt % PE_STAGES;
      cp_async_wait<P - 1>();      // this thread's copies of stage kt landed
      bar_sync(BAR_PRODUCER, PT);  // and every producer's: the stage's mean / inv_std
      // patch_embed.py:39-40, rounded step by step as there; columns past K
      // have mean and inv_std 0, so 0.  A byte b becomes float as the bits
      // 0x4B0000bb (2^23 + b) less 2^23, exactly: a byte permute and an
      // add, not the quarter-rate integer-to-float converter.
      const float* mv = mi_slot(slot);
      const float* iv = mv + BK;
      const float scale = 1.f / 255.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const uint32_t* words = reinterpret_cast<const uint32_t*>(&raw[c]);
        float v[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const uint32_t bits = __byte_perm(words[e / 4], 0x4B000000u, 0x7540u | (e % 4));
          const float x = __fsub_rn(__uint_as_float(bits), 8388608.f);
          v[e] = __fmul_rn(__fsub_rn(__fmul_rn(x, scale), mv[16 * c + e]), iv[16 * c + e]);
        }
        a_store(a_slot(slot), pt, c, v, (T*)nullptr);
      }
      load_px(raw, kt + 2);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      bar_arrive(BAR_FULL + slot, ALL);
      // the copies of stage kt + P go into the slot of stage kt + P - PE_STAGES
      if (kt + P < nk && kt + P >= PE_STAGES) bar_sync(BAR_EMPTY + (kt + P) % PE_STAGES, ALL);
      copies(kt + P);
    };

    uint4 even[CH], odd[CH];  // the pixels of the even and the odd stages
    for (int kt = 0; kt < P; ++kt) copies(kt);
    load_px(even, 0);
    load_px(odd, 1);
    for (int kt = 0; kt < nk; kt += 2) {
      produce(even, kt);
      if (kt + 1 < nk) produce(odd, kt + 1);
    }
    return;
  }

  // ---- consumer warpgroups ----
  PeMma<T> mma;
  mma.zero();
  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt % PE_STAGES;
    bar_sync(BAR_FULL + slot, ALL);
    if constexpr (kTma) mbar_wait(&b_full[slot], (kt / PE_STAGES) & 1);
    mma.issue(a_slot(slot), b_slot(slot));
    // the stage now done frees its slot, if the producer will refill it
    const int done = kt - PeMma<T>::kLag;
    if (done >= 0 && done + PE_STAGES < nk) bar_arrive(BAR_EMPTY + done % PE_STAGES, ALL);
  }
  mma.finish();

  // epilogue: lanes 2u and 2u + 1 swap halves, so each holds four adjacent
  // columns of one row (the even lane row g, the odd lane row g + 8)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bool odd = t & 1;
  const int m = m0 + warp * 16 + g + (odd ? 8 : 0);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float* a = mma.acc(j);
    const float s0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
    const float s1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
    float4 v = odd ? make_float4(s0, s1, a[2], a[3]) : make_float4(a[0], a[1], s0, s1);
    const int n = n0 + j * 8 + 2 * (t & 2);
    if (m < M && n < D) {
      if (bias) {
        const float4 bv = *reinterpret_cast<const float4*>(bias + n);
        v = make_float4(v.x + bv.x, v.y + bv.y, v.z + bv.z, v.w + bv.w);
      }
      *reinterpret_cast<float4*>(out + (size_t)m * D + n) = v;
    }
  }
}

template <typename T>
static size_t pe_smem_bytes() {
  return 1024 + PE_STAGES * (size_t)PeCfg<T>::STAGE;  // 1024: room to align the ring
}

// The bf16 W stage by TMA: W (K, D) seen as the 3-D tensor (D, 3, p^2) —
// column n, channel c (p^2 D elements apart), pixel r = py p + px of the
// patch (D apart) — so that the box (64, 3, 16) at pixel r0 is the stage's
// 48 rows k' = 3r + c in the kernel's order, 128-byte swizzled as wgmma's
// N-major operand reads them; each copy signals its slot's mbarrier.
static int w_map(CUtensorMap* map, const void* w, int p, int D) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, 3, (cuuint64_t)p * p};
  const cuuint64_t strides[2] = {(cuuint64_t)p * p * D * 2, (cuuint64_t)D * 2};  // bytes
  const cuuint32_t box[3] = {64, 3, (cuuint32_t)PeCfg<__nv_bfloat16>::BK / 3};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, bool kAligned>
static int launch(const uint8_t* px, const T* w, const float* mean, const float* inv,
                  const float* bias, float* out, int B, int S, int p, int D, cudaStream_t s) {
  auto kernel = patch_embed_kernel<T, kAligned>;
  const size_t bytes = pe_smem_bytes<T>();
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instantiation
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap map = {};
  if (std::is_same<T, __nv_bfloat16>::value) {
    const int err = w_map(&map, w, p, D);
    if (err) return err;
  }
  const int M = B * (S / p) * (S / p);
  const dim3 grid((D + PeCfg<T>::BN - 1) / PeCfg<T>::BN, (M + PE_BM - 1) / PE_BM);
  kernel<<<grid, PE_THREADS, bytes, s>>>(px, w, mean, inv, bias, out, B, S, p, D, map);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const uint8_t* px, const void* w, const float* mean, const float* inv,
                    const float* bias, float* out, int B, int S, int p, int D, cudaStream_t s) {
  const bool aligned = (3 * p) % 16 == 0 && (3 * S) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(px) % 16 == 0;
  const T* wt = static_cast<const T*>(w);
  return aligned ? launch<T, true>(px, wt, mean, inv, bias, out, B, S, p, D, s)
                 : launch<T, false>(px, wt, mean, inv, bias, out, B, S, p, D, s);
}

}  // namespace gic

// pixels (B, S, S, 3) uint8, S a multiple of patch; w (3 * patch^2, D) in
// the element type, D a multiple of 8 (bf16) or 4 (float32), 16-byte
// aligned; mean / inv_std (3 * patch^2,) float32 in w's row order; bias (D,)
// float32, 16-byte aligned, or NULL; out (B * (S / patch)^2, D) float32.
// Returns the launch's error (cudaGetLastError()).
extern "C" int gic_patch_embed(int dtype, const void* pixels, const void* w, const void* mean,
                               const void* inv_std, const void* bias, void* out, int B, int S,
                               int patch, int D, void* stream) {
  using namespace gic;
  if (B <= 0 || patch <= 0 || S < patch || S % patch || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* px = static_cast<const uint8_t*>(pixels);
  const float* mv = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv_std);
  const float* bv = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  if (dtype == kBF16) return dispatch<__nv_bfloat16>(px, w, mv, iv, bv, o, B, S, patch, D, s);
  if (dtype == kF32) return dispatch<float>(px, w, mv, iv, bv, o, B, S, patch, D, s);
  return (int)cudaErrorInvalidValue;
}
