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
// NHWC pixels directly, doing the unfold in the load: row m = b * N +
// patch, column k = c * p^2 + py * p + px, the torch-conv order of
// models/clip.py::extract_patches.  Each byte is converted to float, scaled
// by 1/255, normalised with its channel's mean and inverse std (from the
// (K,) vectors, as the TPU kernel reads them) and cast to the operand type
// on its way into shared memory, so no patch tensor, uint8 or float, reaches
// device memory.  bf16 operands run on the tensor cores (WMMA 16x16x16,
// float32 accumulators), as the towers round their patches to the compute
// dtype; float32 runs as plain FMA in full float32.  W is read as stored
// ((K, D), the towers' matmul layout), 16 bytes a thread.  One block owns a
// 64 x 64 output tile and walks K in 32-deep stages; each thread keeps one
// column of the stage, so the unfold's index arithmetic is done once a
// column a stage and once a row a block, not once an element; the next
// stage's bytes and weights are loaded into registers during the MMAs.
//
// Bound on the H100: CLIP B/32 at b 256 (M 12,544, K 3,072, D 768) does 59
// GFLOP, 0.060 ms in bf16, against 82 MB moved (0.024 ms): operations.
// ViT-B/16 at b 128 (M 25,088, K 768) is about balanced (30 GFLOP, 98 MB:
// the float32 output dominates the bytes).  The byte-wise im2col load and
// the single stage in flight keep this first kernel well above either.
#include "common.cuh"

namespace gic {

constexpr int PE_BM = 64;       // output rows (patches) per block
constexpr int PE_BN = 64;       // output columns per block
constexpr int PE_BK = 32;       // depth of one stage
constexpr int PE_THREADS = 128; // 4 warps
constexpr int PE_LDA = PE_BK + 8;
constexpr int PE_LDB = PE_BN + 8;
constexpr int PE_LDC = PE_BN + 4;

template <typename T>
struct __align__(32) PatchSmem {
  __align__(32) T xs[PE_BM][PE_LDA];  // normalised patches, (row, k)
  __align__(32) T ws[PE_BK][PE_LDB];  // weights, (k, col)
  __align__(32) float cs[PE_BM][PE_LDC];
};

template <typename T> struct PatchMma;

// bf16: warp w owns rows 16w .. 16w+15 and all 64 columns.
template <> struct PatchMma<__nv_bfloat16> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[PE_BN / 16];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < PE_BN / 16; ++j) nvcuda::wmma::fill_fragment(acc[j], 0.f);
  }
  __device__ void step(PatchSmem<__nv_bfloat16>& sm) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int kk = 0; kk < PE_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &sm.xs[warp * 16][kk], PE_LDA);
#pragma unroll
      for (int j = 0; j < PE_BN / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, &sm.ws[kk][j * 16], PE_LDB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  __device__ void store(PatchSmem<__nv_bfloat16>& sm) {
    const int warp = threadIdx.x / 32;
#pragma unroll
    for (int j = 0; j < PE_BN / 16; ++j)
      nvcuda::wmma::store_matrix_sync(&sm.cs[warp * 16][j * 16], acc[j], PE_LDC,
                                      nvcuda::wmma::mem_row_major);
  }
};

// float: thread (ty, tx) of a 16 x 8 grid owns a 4 x 8 block of the tile.
template <> struct PatchMma<float> {
  float acc[4][8];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  __device__ void step(PatchSmem<float>& sm) {
    const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
    for (int k = 0; k < PE_BK; ++k) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.xs[ty * 4 + i][k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = sm.ws[k][tx * 8 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __device__ void store(PatchSmem<float>& sm) {
    const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sm.cs[ty * 4 + i][tx * 8 + j] = acc[i][j];
  }
};

// px: (B, S, S, 3) uint8; w: (K, D); mean/inv: (K,) float32; bias: (D,)
// float32 or null; out: (B * N, D) float32, N = (S / p)^2.
template <typename T>
__global__ void __launch_bounds__(PE_THREADS)
patch_embed_kernel(const uint8_t* px, const T* w, const float* mean, const float* inv,
                   const float* bias, float* out, int B, int S, int p, int D) {
  __shared__ PatchSmem<T> sm;
  __shared__ long long row_base[PE_BM];  // byte offset of each row's patch corner, -1 past M
  const int gs = S / p, n_patch = gs * gs, pp = p * p;
  const int M = B * n_patch, K = 3 * pp;
  const int m0 = blockIdx.y * PE_BM, n0 = blockIdx.x * PE_BN;
  const float scale = 1.f / 255.f;
  for (int r = threadIdx.x; r < PE_BM; r += PE_THREADS) {
    const int m = m0 + r;
    long long base = -1;
    if (m < M) {
      const int b = m / n_patch, patch = m % n_patch;
      base = (((long long)b * S + (patch / gs) * p) * S + (patch % gs) * p) * 3;
    }
    row_base[r] = base;
  }
  __syncthreads();
  // each thread loads one column kk of the stage for rows r0, r0 + 4, ...:
  // the column's (c, py, px) offset, mean and inverse std are worked out
  // once a stage, the row's patch corner once a block.  A stage's bytes and
  // weights are loaded into registers while the previous stage multiplies.
  static_assert(PE_THREADS % PE_BK == 0, "a thread keeps its column");
  constexpr int RS = PE_THREADS / PE_BK;      // row stride of a thread's loads
  constexpr int NA = PE_BM / RS;              // bytes a thread loads a stage
  constexpr int WE = 16 / sizeof(T);          // weights per 16-byte vector
  constexpr int NW = PE_BK * PE_BN / WE / PE_THREADS;
  const int kk = threadIdx.x % PE_BK, r0 = threadIdx.x / PE_BK;
  uint8_t a_reg[NA];
  uint4 w_reg[NW];
  int col = -1;
  float mk = 0.f, ik = 0.f;
  auto load = [&](int k0) {
    const int k = k0 + kk;
    col = -1;
    if (k < K) {
      const int c = k / pp, rem = k % pp;
      col = ((rem / p) * S + rem % p) * 3 + c;
      mk = mean[k];
      ik = inv[k];
    }
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const long long base = row_base[r0 + j * RS];
      a_reg[j] = (base >= 0 && col >= 0) ? px[base + col] : 0;
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int i = threadIdx.x + j * PE_THREADS;
      const int wk = i / (PE_BN / WE), c = (i % (PE_BN / WE)) * WE;
      const int kw = k0 + wk, n = n0 + c;
      w_reg[j] = (kw < K && n < D) ? *reinterpret_cast<const uint4*>(w + (size_t)kw * D + n)
                                   : make_uint4(0, 0, 0, 0);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int r = r0 + j * RS;
      // patch_embed.py:39-40, rounded step by step as there; zero padding
      const float v = (row_base[r] >= 0 && col >= 0)
                          ? __fmul_rn(__fsub_rn(__fmul_rn((float)a_reg[j], scale), mk), ik)
                          : 0.f;
      sm.xs[r][kk] = from_f32<T>(v);
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const int i = threadIdx.x + j * PE_THREADS;
      const int wk = i / (PE_BN / WE), c = (i % (PE_BN / WE)) * WE;
      *reinterpret_cast<uint4*>(&sm.ws[wk][c]) = w_reg[j];
    }
  };
  PatchMma<T> mma;
  mma.zero();
  load(0);
  for (int k0 = 0; k0 < K; k0 += PE_BK) {
    store();
    __syncthreads();
    if (k0 + PE_BK < K) load(k0 + PE_BK);  // in flight during the MMAs
    mma.step(sm);
    __syncthreads();
  }
  mma.store(sm);
  __syncthreads();
  for (int i = threadIdx.x; i < PE_BM * PE_BN; i += PE_THREADS) {
    const int r = i / PE_BN, c = i % PE_BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < D) out[(size_t)m * D + n] = sm.cs[r][c] + (bias ? bias[n] : 0.f);
  }
}

}  // namespace gic

// pixels (B, S, S, 3) uint8, S a multiple of patch; w (3 * patch^2, D) in
// the element type, D a multiple of 8 (bf16) or 4 (float32), 16-byte
// aligned; mean / inv_std (3 * patch^2,) float32; bias (D,) float32 or NULL;
// out (B * (S / patch)^2, D) float32.  Returns cudaGetLastError().
extern "C" int gic_patch_embed(int dtype, const void* pixels, const void* w, const void* mean,
                               const void* inv_std, const void* bias, void* out, int B, int S,
                               int patch, int D, void* stream) {
  using namespace gic;
  if (B <= 0 || patch <= 0 || S < patch || S % patch || D <= 0) return (int)cudaErrorInvalidValue;
  const int M = B * (S / patch) * (S / patch);
  const dim3 grid((D + PE_BN - 1) / PE_BN, (M + PE_BM - 1) / PE_BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* px = static_cast<const uint8_t*>(pixels);
  const float* mv = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(inv_std);
  const float* bv = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  if (dtype == kBF16)
    patch_embed_kernel<__nv_bfloat16><<<grid, PE_THREADS, 0, s>>>(
        px, static_cast<const __nv_bfloat16*>(w), mv, iv, bv, o, B, S, patch, D);
  else if (dtype == kF32)
    patch_embed_kernel<float><<<grid, PE_THREADS, 0, s>>>(px, static_cast<const float*>(w), mv, iv,
                                                          bv, o, B, S, patch, D);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
