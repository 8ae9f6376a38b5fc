// Patch embedding from uint8 pixels: normalise and multiply in one kernel.
//
// Replaces: gpt2_image_captioning_tpu/ops/patch_embed.py::_kernel (:36), as
// fused_patch_embed_pallas (:45) and patch_embed (:97) call it: uint8
// patches (M, K = 3p^2) times 1/255, then (x - mean) * inv_std per element,
// then @ W (K, D) into (M, D) float32; the optional bias is added in the
// epilogue here (outside the TPU kernel there).
//
// Both routes unfold in the load.  The TPU path unfolds the pixels into (M,
// K) uint8 patches in XLA first (:118-119).  Here a producer thread owns a
// row of the output tile (a patch) and reads its pixels straight from the
// (B, S, S, 3) NHWC image in the pixels' own order: k' = py * 3p + px * 3 +
// c = 3r + c, r = py p + px the pixel's index in the patch.  A patch row is
// 3p contiguous bytes of the image (96 at p 32, 48 at p 16), read as 16-byte
// vectors: the image row (3S = 672 bytes at 224 px) and the patch corners
// (multiples of 3p) keep them aligned.  Patch rows that are not 16-byte
// aligned (p 8 at 32 px: 24-byte runs; p 14 at 224 px: 42) take the same
// kernel with one byte load an element (kAligned false; dispatch alone
// decides).  Column k' multiplies row k = c p^2 + r of W as stored ((K, D),
// the torch conv order of models/clip.py::extract_patches), and its mean and
// inverse std are read through the same map; seen as the 3-D tensor (D, 3,
// p^2), W gives a TMA box of any pixels and channels already in the order
// the kernel wants.  Each byte becomes float as the bits 0x4B0000bb (2^23 +
// b) less 2^23 (a byte permute and an add, not the quarter-rate converter),
// then is scaled by 1/255 and normalised in float32, rounded step by step as
// the twin and the TPU kernel round it, on its way into shared memory, so no
// patch tensor, uint8 or float, reaches device memory.  The epilogue adds the
// bias and stores float32 from registers in 16-byte vectors (a lane pair
// swaps halves of its fragments); rows past M and columns past D are masked.
//
// bf16 (wgmma bf16).  A block owns a 128 x 256 output tile.  One producer
// warpgroup (a thread a row) loads the pixel vectors into registers two
// stages ahead, normalises them into the stage's A tile (128 x 48 bf16,
// K-major, 128-byte swizzled), has the stage's W (one (64, 3, 16) TMA box a
// 64-column block: 48 columns are 16 pixels of 3 channels) copied two stages
// ahead into a ring of 4 stages, and keeps the stage's mean / inv_std in a
// register from two stages ahead until it stores them for the producers.
// Two consumer warpgroups each run m64n256k16 over their 64 rows, three k16
// steps a stage, float32 accumulators in registers, B N-major, one stage's
// wgmma in flight while the next is issued.  Named barriers pass each slot
// full to the consumers and empty back to the producer, so the normalisation
// runs beside the tensor cores, and at 256 columns it is done D / 256 times
// a row tile.  On an H100 at CLIP b 256 (chip_smoke.py): W by per-thread
// copies 0.41 ms, by TMA 0.28; most of what is left is the normalisation,
// and a second producer warpgroup (at 192 columns, for registers) did not
// help.
//
// float32 (wgmma TF32, the three-term split).  .tf32 takes only K-major
// operands from shared memory, and W is stored (K, D), N-major; so the block
// computes the transposed tile, out^T = W^T X^T, with W^T as wgmma's
// register operand (loaded by each thread in the fragment layout, any
// layout will do) and the pixels X as the K-major shared-memory operand.  A
// block owns 128 patches x 128 output columns, 384 threads: two consumer
// warpgroups of 64 columns and one service warpgroup, no register trade,
// every mbarrier wait bounded (wait_or_trap).  K is walked in stages of 32
// pixels of one channel, a pixel group's three channels in turn (k = c p^2
// + 32 g + j), so a stage is one 128-byte swizzled row of floats a patch.
//   - The service warpgroup, a thread a patch: its group's 96 pixel bytes
//     one group ahead (the addresses stepped from the last group's, no
//     division); each normalised value written as its TF32 pair, hi =
//     tf32(x) and lo = tf32(x - hi) (common.cuh::tf32_split_bits), into the
//     stage's K-major X hi and X lo tiles; then fence.proxy.async and the
//     stage's ready mbarrier.  mean / inv_std: where they hold one value a
//     channel over K (as normalization_vectors makes them; the service
//     checks once a block), three pairs in registers; else each stage's
//     read through the L1.  Its thread
//     0 has the stage's W landed by TMA beside them, four (32, 1, 32) boxes
//     of the (D, 3, p^2) map, 128-byte swizzled: W is read as the caller
//     passes it on every call, never through a cached derived copy.
//   - Each consumer thread loads its k8 step's W^T fragment (two 8-byte
//     loads; the columns' order inside the tile is chosen so that a half
//     warp's loads meet no bank conflict under the swizzle), splits it into
//     its TF32 pair in registers, and its warpgroup runs m64n128k8 .tf32 with
//     A from registers three times, the small terms first (wl xh, wh xl, wh
//     xh), into a fresh accumulator for at most PE_TF32_CHAIN (12) k8 steps,
//     which it then adds into its float32 running tile, so the tensor core's
//     float32 accumulation (which drifts one way on the card: PERF.md)
//     reaches over 36 instructions at most; the two warpgroups fold one
//     stage apart.  Each k8 step's products are waited for before the next
//     fragment overwrites the registers they read; the other warpgroup's
//     keep the tensor cores busy meanwhile.  The second accumulator set
//     costs 64 registers a thread: both (128) and a fragment fit the 168
//     that 12 warps an SM leave a thread.
// A ring stage is X hi and X lo (16 KB each) and W's boxes (16 KB): 4
// stages, 193 KB.  So W is never transposed through shared memory: an
// earlier version with converter warps (W landed N-major, transposed into
// K-major hi and lo tiles for a shared-memory B operand) moved 240 KB
// through shared memory a stage against 160 KB here, and its single
// service warpgroup, normalising and converting, left the tensor cores
// idle most of the time (PERF.md).  Error: as the projections' TF32 route
// (fused_linear.cu), an output lies within 2^-20 sum_k |x_k w_k| of the
// exact sum before the float32 additions, each adding at most one rounding
// of its running sum (tests/test_torch_patch_tf32.py emulates it at the
// three towers).  The epilogue adds the bias and stores each thread's
// column pairs (8 bytes) row by row.
//
// Bound on the H100: CLIP B/32 at b 256 (M 12,544, K 3,072, D 768) does 59
// GFLOP: 0.060 ms in bf16 at 989 TFLOP/s; in float32, three TF32 products
// each at 495 TFLOP/s, 0.359 ms; against 82 MB moved (float32: 87 MB, 0.026
// ms): operations in both.  ViT-B/16 at b 128 (M 25,088, K 768) is about
// balanced in bf16 (30 GFLOP, 98 MB: the float32 output dominates the bytes)
// and bound by operations in float32 (0.179 ms).
#include "common.cuh"

namespace gic {

constexpr int PE_BM = 128;         // output rows (patches) per block
constexpr int PE_CONSUMERS = 256;  // warps 0-7: consumer warp w owns rows 16w .. 16w + 15
constexpr int PE_THREADS = 384;    // and one producer (service) warpgroup, a thread a row
constexpr int PE_PRODUCERS = PE_THREADS - PE_CONSUMERS;
static_assert(PE_PRODUCERS == PE_BM, "one producer thread a row");

// Word i of a 16-byte vector (i known at compile time: registers, no
// local memory).
__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ float word_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The byte b of a 16-byte pixel vector as float32, exactly.
__device__ __forceinline__ float pixel(const uint4& raw, int b) {
  const uint32_t word = word_of(raw, b / 4);
  return __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | (b % 4))),
                   8388608.f);
}

// patch_embed.py:39-40, rounded step by step as there.
__device__ __forceinline__ float normalised(float x, float mean, float inv) {
  return __fmul_rn(__fsub_rn(__fmul_rn(x, 1.f / 255.f), mean), inv);
}

// bf16's epilogue of a consumer warp's fragments d (d[4j + e]: row 16 w +
// lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2 of the block's
// tile, w the warp among the consumers): lanes 2u and 2u + 1 swap halves,
// so each holds four adjacent columns of one row (the even lane row g, the
// odd lane row g + 8); the bias, then 16-byte stores of rows < M, columns
// < D.
template <int R>
__device__ __forceinline__ void store_tile(const float (&d)[R], int m0, int n0, int M, int D,
                                           const float* bias, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bool odd = t & 1;
  const int m = m0 + warp * 16 + g + (odd ? 8 : 0);
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const float* a = &d[4 * j];
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

// This producer thread's row: the byte offset of its patch corner in the
// image, -1 past M.
__device__ __forceinline__ long long patch_corner(int m, int M, int S, int p) {
  if (m >= M) return -1;
  const int gs = S / p, n_patch = gs * gs;
  const int b = m / n_patch, patch = m % n_patch;
  return (((long long)b * S + (patch / gs) * p) * S + (patch % gs) * p) * 3;
}

// CH 16-byte vectors of a row's pixels from column k0 in the pixels' order:
// k' = 3r + c at byte k' + py 3 (S - p) from the patch corner; past K (or a
// row past M: base -1) zero.  kAligned: whole vectors (every patch row is
// 16-byte aligned and a multiple of 16 bytes long, so none straddles two),
// else a byte at a time.
template <bool kAligned, int CH>
__device__ __forceinline__ void load_pixels(uint4 (&raw)[CH], const uint8_t* px, long long base,
                                            int k0, int K, int S, int p) {
  auto koff = [&](int k) { return (long long)k + (long long)(k / 3 / p) * 3 * (S - p); };
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int k = k0 + 16 * c;
    if constexpr (kAligned) {
      raw[c] = base >= 0 && k < K ? *reinterpret_cast<const uint4*>(px + base + koff(k))
                                  : make_uint4(0, 0, 0, 0);
    } else {
      uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int e = 0; e < 16; ++e)
        words[e / 4] |= (base >= 0 && k + e < K ? (uint32_t)px[base + koff(k + e)] : 0u)
                        << (8 * (e % 4));
      raw[c] = make_uint4(words[0], words[1], words[2], words[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

constexpr int PE_STAGES = 4;  // the ring of A / W / mean / inv_std stages
// A (128 x 48, in 128-byte rows) and B (48 x 256) stages, swizzled; 48
// columns are 16 pixels of 3 channels, one TMA box of W a 64-column block
constexpr int PE_BN = 256, PE_BK = 48;
constexpr int PE_A_BYTES = PE_BM * 128, PE_B_BYTES = PE_BK * PE_BN * 2;
// a ring slot: A, B, then mean and inv_std, padded to keep the next slot's
// tiles on the 1024-byte boundary the swizzle needs
constexpr int PE_STAGE = (PE_A_BYTES + PE_B_BYTES + 2 * PE_BK * 4 + 1023) / 1024 * 1024;
constexpr int PE_SMEM = 1024 + PE_STAGES * PE_STAGE;  // 1024: room to align the ring

// Where the 16 normalised values of row r, columns 16 cc .. 16 cc + 15 of a
// stage go: the 128-byte swizzle wgmma reads (16-byte piece j of row r at
// piece j ^ (r % 8)).
__device__ __forceinline__ void a_store(unsigned char* a, int r, int cc, const float (&v)[16]) {
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

// Consumer warpgroup g multiplies rows 64g .. 64g + 63 of a stage by all 256
// columns, three k16 steps, asynchronously; d holds the m64n256 fragments.
// One stage's products stay in flight while the next is issued.
struct PeMma {
  float d[128];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0.f;
  }
  __device__ void issue(const unsigned char* a, const unsigned char* b) {
    const uint32_t a0 = smem_u32(a) + (threadIdx.x / 128) * 64 * 128;
    const uint32_t b0 = smem_u32(b);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PE_BK / 16; ++kk)
      wgmma_m64n256k16(d, wgmma_desc(a0 + kk * 32, 16, 1024),
                       wgmma_desc(b0 + kk * 16 * 128, PE_BK * 128, 1024));
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

// Named barriers (0 is __syncthreads): stage slot s is full (the producer
// arrives, the consumers wait) or empty (the reverse); the producer's own.
constexpr int BAR_FULL = 1, BAR_EMPTY = BAR_FULL + PE_STAGES, BAR_PRODUCER = BAR_EMPTY + PE_STAGES;

// px: (B, S, S, 3) uint8; mean/inv: (K,) float32 in W's row order; bias: (D,)
// float32 or null; out: (B * N, D) float32, N = (S / p)^2; wmap: W's TMA map.
// Warps 0-7 consume (products, epilogue), warps 8-11 produce (copies, pixel
// loads, normalisation), one producer thread a row of the tile.
template <bool kAligned>
__global__ void __launch_bounds__(PE_THREADS, 1)
patch_embed_kernel(const uint8_t* px, const float* mean, const float* inv, const float* bias,
                   float* out, int B, int S, int p, int D,
                   const __grid_constant__ CUtensorMap wmap) {
  constexpr int BN = PE_BN, BK = PE_BK;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t b_full[PE_STAGES];  // slot s's W stage has landed
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // slot s: A at ring + s * PE_STAGE, B after it, then mean and inv_std (BK each)
  auto a_slot = [&](int s) { return ring + s * PE_STAGE; };
  auto b_slot = [&](int s) { return ring + s * PE_STAGE + PE_A_BYTES; };
  auto mi_slot = [&](int s) {
    return reinterpret_cast<float*>(ring + s * PE_STAGE + PE_A_BYTES + PE_B_BYTES);
  };

  const int pp = p * p;
  const int M = B * (S / p) * (S / p), K = 3 * pp;
  const int m0 = blockIdx.y * PE_BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;
  constexpr int ALL = PE_THREADS, CONSUMERS = PE_CONSUMERS;
  if (threadIdx.x == 0)
    for (int i = 0; i < PE_STAGES; ++i) mbar_init(&b_full[i], 1);
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: thread pt owns row m0 + pt of the tile ----
    constexpr int PT = PE_PRODUCERS;
    constexpr int P = 2;        // stages of copies in flight ahead
    constexpr int CH = BK / 16; // 16-byte pixel vectors of a row a stage
    const int pt = threadIdx.x - CONSUMERS;
    const long long base = patch_corner(m0 + pt, M, S, p);
    // column k' = 3r + c -> its row c p^2 + r of W (and of mean / inv_std)
    auto wrow = [&](int k) { return (k % 3) * pp + k / 3; };
    // stage kt's W rows into its slot by TMA; its mean / inv_std element of
    // this thread (threads 0 .. 2 BK - 1) into ``pend``, which produce()
    // stores when stage kt comes (0 past K)
    auto copies = [&](int kt, float& pend) {
      if (kt >= nk) return;
      const int k0 = kt * BK, slot = kt % PE_STAGES;
      if (pt == 0) {
        mbar_expect_tx(&b_full[slot], PE_B_BYTES);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d(b_slot(slot) + j * BK * 128, &wmap, &b_full[slot], n0 + 64 * j, 0, k0 / 3);
      }
      if (pt < 2 * BK) {
        const int k = k0 + pt % BK;
        pend = k < K ? (pt < BK ? mean : inv)[wrow(k)] : 0.f;
      }
    };
    // stage kt: store its mean / inv_std (loaded two stages earlier),
    // normalise its pixels (loaded two stages earlier) into its A tile, pass
    // the slot to the consumers, load the pixels of stage kt + 2 into the
    // same registers and issue the copies of stage kt + P
    auto produce = [&](uint4 (&raw)[CH], float& pend, int kt) {
      const int slot = kt % PE_STAGES;
      if (pt < 2 * BK) mi_slot(slot)[pt] = pend;
      bar_sync(BAR_PRODUCER, PT);  // every producer's mean / inv_std of stage kt
      // columns past K have mean and inv_std 0, so 0
      const float* mv = mi_slot(slot);
      const float* iv = mv + BK;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float v[16];
#pragma unroll
        for (int e = 0; e < 16; ++e)
          v[e] = normalised(pixel(raw[c], e), mv[16 * c + e], iv[16 * c + e]);
        a_store(a_slot(slot), pt, c, v);
      }
      load_pixels<kAligned>(raw, px, base, (kt + 2) * BK, K, S, p);
      fence_proxy_async();  // visible to wgmma
      bar_arrive(BAR_FULL + slot, ALL);
      // the copies of stage kt + P go into the slot of stage kt + P - PE_STAGES
      if (kt + P < nk && kt + P >= PE_STAGES) bar_sync(BAR_EMPTY + (kt + P) % PE_STAGES, ALL);
      copies(kt + P, pend);
    };

    uint4 even[CH], odd[CH];  // the pixels of the even and the odd stages
    float pend_even = 0.f, pend_odd = 0.f;
    copies(0, pend_even);
    copies(1, pend_odd);
    load_pixels<kAligned>(even, px, base, 0, K, S, p);
    load_pixels<kAligned>(odd, px, base, BK, K, S, p);
    for (int kt = 0; kt < nk; kt += 2) {
      produce(even, pend_even, kt);
      if (kt + 1 < nk) produce(odd, pend_odd, kt + 1);
    }
    return;
  }

  // ---- consumer warpgroups ----
  PeMma mma;
  mma.zero();
  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt % PE_STAGES;
    bar_sync(BAR_FULL + slot, ALL);
    mbar_wait(&b_full[slot], (kt / PE_STAGES) & 1);
    mma.issue(a_slot(slot), b_slot(slot));
    // the stage before this one is done: it frees its slot, if the producer
    // will refill it
    const int done = kt - 1;
    if (done >= 0 && done + PE_STAGES < nk) bar_arrive(BAR_EMPTY + done % PE_STAGES, ALL);
  }
  mma.finish();
  store_tile(mma.d, m0, n0, M, D, bias, out);
}

// ---------------------------------------------------------------------------
// float32: wgmma TF32
// ---------------------------------------------------------------------------

constexpr int PF_BN = 128;        // output columns of a block: two consumer warpgroups of 64
constexpr int PF_BK = 32;         // K of a stage: 32 pixels of one channel
constexpr int PF_K8 = PF_BK / 8;  // k8 steps a stage
constexpr int PF_STAGES = 4;      // ring stages: the pixels' TF32 pair and W as landed
// k8 steps a fresh accumulator takes before it is added into the running
// tile: ops/patch_embed.py::PE_TF32_CHAIN, held there to PATCH_TOL / 10 at
// CLIP's K 3,072 by a CPU emulation
constexpr int PE_TF32_CHAIN = 12;
constexpr int PF_CHAIN_STAGES = PE_TF32_CHAIN / PF_K8;
static_assert(PE_TF32_CHAIN % PF_K8 == 0 && PE_TF32_CHAIN <= 100,
              "a chain is whole stages, within LINEAR_TF32_BOXES' 300 instructions");
constexpr int PF_X_TILE = PE_BM * PF_BK * 4;  // the pixels' hi or lo: 128 rows of 128 bytes
constexpr int PF_W_BOX = 32 * PF_BK * 4;      // a landed W box: 32 rows k of 32 columns n
constexpr int PF_LAND = (PF_BN / 32) * PF_W_BOX;
constexpr int PF_STAGE = 2 * PF_X_TILE + PF_LAND;  // X hi, X lo, then W's boxes
constexpr int PF_SMEM = 1024 + PF_STAGES * PF_STAGE;
static_assert(PF_SMEM + 1024 <= 232448, "a block's shared memory, its barriers beside it");
constexpr int PF_BAR_SERVICE = 1;  // named barrier of the service warpgroup
// Registers: ptxas gives each of the block's 12 warps' threads 168 (each of
// the SM's four sub-partitions holds 16,384 and three of the warps), which
// hold a consumer's two accumulator sets (128) and one k8 step's W fragment
// (8) with no trade between the warpgroups (setmaxnreg).
static_assert(PF_BN + 8 + 24 <= 16384 / 32 / (PE_THREADS / 32 / 4), "both accumulator sets fit");

// Stage (group g, channel C) of this service thread's row: the 32 values j
// of pixels 32 g + j, channel C (byte 3 j + C of the group's vectors),
// normalised with mean / inv_std of W's rows C p^2 + 32 g + j (0 past p^2)
// and split into TF32 pairs, into row ``row`` of the K-major hi and lo
// tiles (16-byte chunk q at q ^ (row % 8): the 128-byte swizzle; a warp's
// stores free of conflicts).  kChannel: mean and inv_std are one value a
// channel (``cm``, ``ci``), as normalization_vectors makes them; else the
// stage's are read through the L1 (every service thread reads the same 64
// floats): 16-byte loads where the stage's 32 lie whole and aligned
// (``vec``).
template <int C, bool kChannel>
__device__ __forceinline__ void pf_normalise(const uint4 (&raw)[6], float cm, float ci,
                                             const float* mean, const float* inv, int k0,
                                             int valid, bool vec, unsigned char* x_hi,
                                             unsigned char* x_lo, int row) {
#pragma unroll
  for (int q = 0; q < PF_BK / 4; ++q) {
    float m[4], iv[4];
    if (kChannel) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m[e] = cm;
        iv[e] = ci;
      }
    } else if (vec) {
      const float4 m4 = __ldg(reinterpret_cast<const float4*>(mean + k0) + q);
      const float4 i4 = __ldg(reinterpret_cast<const float4*>(inv + k0) + q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m[e] = word_of(m4, e);
        iv[e] = word_of(i4, e);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = 4 * q + e < valid;
        m[e] = in ? __ldg(mean + k0 + 4 * q + e) : 0.f;
        iv[e] = in ? __ldg(inv + k0 + 4 * q + e) : 0.f;
      }
    }
    float h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int b = 3 * (4 * q + e) + C;
      tf32_split_bits(normalised(pixel(raw[b / 16], b % 16), m[e], iv[e]), h[e], l[e]);
    }
    const int off = row * 128 + ((q ^ (row & 7)) << 4);
    *reinterpret_cast<float4*>(x_hi + off) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(x_lo + off) = make_float4(l[0], l[1], l[2], l[3]);
  }
}

// Whether ``v`` holds in every thread of named barrier ``id``'s ``n``.
__device__ __forceinline__ bool bar_all(int id, int n, bool v) {
  uint32_t all;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\nbar.red.and.pred q, %2, %3, p;\n"
      "selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(all) : "r"((uint32_t)v), "r"(id), "r"(n) : "memory");
  return all != 0;
}

// Arguments as patch_embed_kernel's, wmap: W's float32 map (w_map).  Warps
// 0-7 multiply (consumer warpgroup g: output columns 64 g .. 64 g + 63 of
// the tile), warps 8-11 serve (pixel loads and normalisation, a thread a
// row; thread 0 W's TMA).
template <bool kAligned>
__global__ void __launch_bounds__(PE_THREADS, 1)
patch_embed_kernel_tf32(const uint8_t* px, const float* mean, const float* inv,
                        const float* bias, float* out, int B, int S, int p, int D,
                        const __grid_constant__ CUtensorMap wmap) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t landed[PF_STAGES], ready[PF_STAGES], empty[PF_STAGES];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int pp = p * p;
  const int M = B * (S / p) * (S / p), K = 3 * pp;
  const int m0 = blockIdx.y * PE_BM, n0 = blockIdx.x * PF_BN;
  const int groups = (pp + PF_BK - 1) / PF_BK;  // 32-pixel groups of a patch
  const int nk = 3 * groups;                    // stages: stage kt is group kt / 3, channel kt % 3
  // the warp's index as lane 0 has it: warp-uniform to the compiler, so the
  // role branch and the chains' fold points below are too (a fold point
  // that ptxas takes for divergent makes it serialize every wgmma)
  const int warp = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < PF_STAGES; ++s) {
      mbar_init(&landed[s], 1);
      mbar_init(&ready[s], PE_PRODUCERS);
      mbar_init(&empty[s], PE_CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= PE_CONSUMERS / 32) {
    // ---- the service warpgroup: thread st owns row m0 + st of the tile ----
    const int st = threadIdx.x - PE_CONSUMERS;
    const long long base = patch_corner(m0 + st, M, S, p);
    const bool mi_aligned = pp % 4 == 0 && reinterpret_cast<uintptr_t>(mean) % 16 == 0 &&
                            reinterpret_cast<uintptr_t>(inv) % 16 == 0;
    if (st == 0) tma_prefetch(&wmap);
    // mean and inv_std one value a channel over the whole of K: then those
    // three pairs in registers, and no load a stage
    bool one = true;
    for (int c = 0; c < 3; ++c)
      for (int r = st; r < pp; r += PE_PRODUCERS)
        one &= __ldg(mean + c * pp + r) == __ldg(mean + c * pp) &&
               __ldg(inv + c * pp + r) == __ldg(inv + c * pp);
    const bool per_channel = bar_all(PF_BAR_SERVICE, PE_PRODUCERS, one);
    float cm[3], ci[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      cm[c] = per_channel ? __ldg(mean + c * pp) : 0.f;
      ci[c] = per_channel ? __ldg(inv + c * pp) : 0.f;
    }
    // a group's 96 pixel bytes (32 pixels of 3 channels): on the 16-byte
    // route from patch row ``grow``, byte ``gcol`` (each vector lies inside
    // one patch row: 3p is a multiple of 16), then the next group's start;
    // on the byte route from column 96 g in the pixels' order
    int grow = 0, gcol = 0, gk = 0;
    auto load_group = [&](uint4 (&raw)[6]) {
      if constexpr (kAligned) {
#pragma unroll
        for (int v = 0; v < 6; ++v) {
          raw[v] = base >= 0 && grow < p
                       ? *reinterpret_cast<const uint4*>(px + base + (long long)grow * 3 * S + gcol)
                       : make_uint4(0, 0, 0, 0);
          gcol += 16;
          if (gcol >= 3 * p) {
            gcol -= 3 * p;
            ++grow;
          }
        }
      } else {
        load_pixels<false>(raw, px, base, gk, K, S, p);
        gk += 3 * PF_BK;
      }
    };
    uint4 cur[6], next[6];
    load_group(cur);
    // stage kt = 3 grp + C into its slot: W's boxes by TMA (zero past p^2
    // and D), the pixels' TF32 pair
    auto stage = [&](auto channel, int grp) {
      constexpr int C = decltype(channel)::value;
      const int kt = 3 * grp + C, slot = kt % PF_STAGES;
      if (kt >= PF_STAGES) wait_or_trap(&empty[slot], (kt / PF_STAGES - 1) & 1);
      unsigned char* tiles = ring + slot * PF_STAGE;
      if (st == 0) {
        mbar_expect_tx(&landed[slot], PF_LAND);
#pragma unroll
        for (int b = 0; b < PF_BN / 32; ++b)
          tma_load_3d(tiles + 2 * PF_X_TILE + b * PF_W_BOX, &wmap, &landed[slot], n0 + 32 * b, C,
                      PF_BK * grp);
      }
      const int valid = min(PF_BK, pp - PF_BK * grp);
      if (per_channel)
        pf_normalise<C, true>(cur, cm[C], ci[C], mean, inv, 0, 0, false, tiles,
                              tiles + PF_X_TILE, st);
      else
        pf_normalise<C, false>(cur, 0.f, 0.f, mean, inv, C * pp + PF_BK * grp, valid,
                               mi_aligned && valid == PF_BK, tiles, tiles + PF_X_TILE, st);
      fence_proxy_async();  // the tiles, before the consumers' wgmma reads them
      mbar_arrive(&ready[slot]);
    };
    for (int grp = 0; grp < groups; ++grp) {
      if (grp + 1 < groups) load_group(next);
      stage(std::integral_constant<int, 0>(), grp);
      stage(std::integral_constant<int, 1>(), grp);
      stage(std::integral_constant<int, 2>(), grp);
#pragma unroll
      for (int v = 0; v < 6; ++v) cur[v] = next[v];
    }
    return;
  }

  // ---- consumer warpgroup g: output columns 64 g .. 64 g + 63 of the tile ----
  // D = W^T X^T on wgmma m64n128k8 .tf32, register A: W^T's 64 rows (this
  // warpgroup's columns n) from the landed boxes, split into TF32 pairs in
  // registers; B: the pixels' K-major tiles (all 128 rows).  Lane (g, t) of
  // warp w holds A rows 16 w + g and + 8, which are the columns n and n + 1
  // of one 8-byte piece of a landed box row: box 2 g + w / 2, 16-byte chunk
  // c below, half g % 2.  At rows k = t and t + 4 of a k8 step (k % 8 = t,
  // t + 4) the 128-byte swizzle puts chunk c at c ^ t and c ^ (t + 4), so a
  // half warp's 16 8-byte loads cover the 8 chunks' 16 halves: no conflict.
  const int g = warp / 4, w = warp % 4, lane = threadIdx.x % 32, gq = lane / 4, t = lane % 4;
  const int box = 2 * g + w / 2;
  const int chunk = 4 * ((gq >> 1) & 1) + (gq >> 2) + 2 * (w & 1);
  const int n = n0 + 32 * box + 4 * chunk + 2 * (gq & 1);  // the lane's columns n, n + 1
  const int frag_a = box * PF_W_BOX + t * 128 + ((chunk ^ t) << 4) + 8 * (gq & 1);
  const int frag_b = box * PF_W_BOX + (t + 4) * 128 + ((chunk ^ (t + 4)) << 4) + 8 * (gq & 1);
  float acc[64], run[64];  // the chain's fresh accumulator, the running tile
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = run[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int slot = kt % PF_STAGES;
    wait_or_trap(&landed[slot], (kt / PF_STAGES) & 1);
    wait_or_trap(&ready[slot], (kt / PF_STAGES) & 1);
    const unsigned char* land = ring + slot * PF_STAGE + 2 * PF_X_TILE;
    const uint32_t xh = smem_u32(ring + slot * PF_STAGE), xl = xh + PF_X_TILE;
#pragma unroll
    for (int kk = 0; kk < PF_K8; ++kk) {
      // this k8 step's fragment (rows k = 8 kk + t, + 4): W[k][n], W[k][n + 1]
      const float2 v0 = *reinterpret_cast<const float2*>(land + kk * 8 * 128 + frag_a);
      const float2 v1 = *reinterpret_cast<const float2*>(land + kk * 8 * 128 + frag_b);
      const float f[4] = {v0.x, v0.y, v1.x, v1.y};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float h, l;
        tf32_split_bits(f[e], h, l);
        ah[e] = __float_as_uint(h);
        al[e] = __float_as_uint(l);
      }
      wgmma_fence_regs(ah);
      wgmma_fence_regs(al);
      wgmma_fence();
      const uint64_t dxh = wgmma_desc(xh + 32 * kk, 16, 1024);
      WgmmaRS128::tf32(acc, al, dxh);
      WgmmaRS128::tf32(acc, ah, wgmma_desc(xl + 32 * kk, 16, 1024));
      WgmmaRS128::tf32(acc, ah, dxh);
      wgmma_commit();
      // the fragment's registers are read until the products are done
      wgmma_wait<0>();
      wgmma_fence_regs(acc);
      wgmma_fence_regs(ah);
      wgmma_fence_regs(al);
    }
    mbar_arrive(&empty[slot]);  // the stage's W was read into registers, its pixels by wgmma
    // the chain ends every PF_CHAIN_STAGES stages, warpgroup 1 one stage
    // before warpgroup 0, and at the last stage
    if ((kt + g) % PF_CHAIN_STAGES == PF_CHAIN_STAGES - 1 || kt + 1 == nk) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        run[i] += acc[i];
        acc[i] = 0.f;
      }
    }
  }

  // epilogue: acc(j) = run[4 j ..]: columns n (e 0, 1) and n + 1 (e 2, 3) of
  // output rows m = 8 j + 2 t + e % 2; the bias, then 8-byte stores
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t + e;
      if (m < M && n < D) {
        float2 v = make_float2(run[4 * j + e], run[4 * j + 2 + e]);
        if (bias) {
          const float2 bv = *reinterpret_cast<const float2*>(bias + n);
          v = make_float2(v.x + bv.x, v.y + bv.y);
        }
        *reinterpret_cast<float2*>(out + (size_t)m * D + n) = v;
      }
    }
  }
}

// W (K, D) seen as the 3-D tensor (D, 3, p^2) — column n, channel c (p^2 D
// elements apart), pixel r = py p + px of the patch (D apart).  bf16: the box
// (64, 3, 16) at pixel r0 is a stage's 48 rows k' = 3r + c in the kernel's
// order, 128-byte swizzled as wgmma's N-major operand reads them.  float32:
// the box (32, 1, 32) at (column n0, channel c, pixel r0) is 32 rows k of
// 32 columns of stage (r0 / 32, c), 128-byte swizzled, for the consumers'
// fragment loads; boxes past p^2 and D are zero-filled.  Each copy signals
// its slot's mbarrier.
static int w_map(CUtensorMap* map, const void* w, int el, int p, int D) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const bool f32 = el == 4;
  const cuuint64_t dims[3] = {(cuuint64_t)D, 3, (cuuint64_t)p * p};
  const cuuint64_t strides[2] = {(cuuint64_t)p * p * D * el, (cuuint64_t)D * el};  // bytes
  const cuuint32_t box[3] = {f32 ? 32u : 64u, f32 ? 1u : 3u,
                             f32 ? (cuuint32_t)PF_BK : (cuuint32_t)PE_BK / 3};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            3, const_cast<void*>(w), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A route's kernel; its dynamic shared memory; its output tile's columns.
template <bool kTf32, bool kAligned>
static auto route_kernel() {
  if constexpr (kTf32) return patch_embed_kernel_tf32<kAligned>;
  else return patch_embed_kernel<kAligned>;
}
template <bool kTf32> constexpr int route_smem() { return kTf32 ? PF_SMEM : PE_SMEM; }
template <bool kTf32> constexpr int route_bn() { return kTf32 ? PF_BN : PE_BN; }

template <bool kTf32, bool kAligned>
static int launch(const uint8_t* px, const void* w, const float* mean, const float* inv,
                  const float* bias, float* out, int B, int S, int p, int D, cudaStream_t s) {
  const auto kernel = route_kernel<kTf32, kAligned>();
  constexpr int smem = route_smem<kTf32>(), bn = route_bn<kTf32>();
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instantiation
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap map = {};
  const int err = w_map(&map, w, kTf32 ? 4 : 2, p, D);
  if (err) return err;
  const int M = B * (S / p) * (S / p);
  const dim3 grid((D + bn - 1) / bn, (M + PE_BM - 1) / PE_BM);
  kernel<<<grid, PE_THREADS, smem, s>>>(px, mean, inv, bias, out, B, S, p, D, map);
  return (int)cudaGetLastError();
}

template <bool kTf32>
static int dispatch(const uint8_t* px, const void* w, const float* mean, const float* inv,
                    const float* bias, float* out, int B, int S, int p, int D, cudaStream_t s) {
  const bool aligned = (3 * p) % 16 == 0 && (3 * S) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(px) % 16 == 0;
  return aligned ? launch<kTf32, true>(px, w, mean, inv, bias, out, B, S, p, D, s)
                 : launch<kTf32, false>(px, w, mean, inv, bias, out, B, S, p, D, s);
}

template <bool kTf32, bool kAligned>
static int layout(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, route_kernel<kTf32, kAligned>());
  if (err != cudaSuccess) return (int)err;
  out[0] = route_smem<kTf32>();
  out[1] = PE_BM;
  out[2] = route_bn<kTf32>();
  out[3] = kTf32 ? PF_BK : PE_BK;
  out[4] = kTf32 ? PF_STAGES : PE_STAGES;
  out[5] = PE_THREADS;
  out[6] = kTf32 ? PE_TF32_CHAIN : 0;
  out[7] = (int)a.sharedSizeBytes;
  out[8] = a.numRegs;
  out[9] = (int)a.localSizeBytes;
  return 0;
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
  if (dtype == kBF16) return dispatch<false>(px, w, mv, iv, bv, o, B, S, patch, D, s);
  if (dtype == kF32) return dispatch<true>(px, w, mv, iv, bv, o, B, S, patch, D, s);
  return (int)cudaErrorInvalidValue;
}

// A route's layout (ops/patch_embed.py::patch_layout mirrors out[0 .. 6]):
// dynamic shared memory, output rows and columns of a block, K of a stage,
// ring stages, threads, the k8 steps of an accumulator chain (float32; 0:
// the whole of K), then its static shared memory, registers and local
// (spill) bytes a thread (cudaFuncGetAttributes) into out[0 .. 9], for
// dtype and the 16-byte (aligned 1) or byte route.  Returns 0 or a
// cudaError_t.
extern "C" int gic_patch_layout(int dtype, int aligned, int* out) {
  using namespace gic;
  if (dtype == kBF16) return aligned ? layout<false, true>(out) : layout<false, false>(out);
  if (dtype == kF32) return aligned ? layout<true, true>(out) : layout<true, false>(out);
  return (int)cudaErrorInvalidValue;
}
