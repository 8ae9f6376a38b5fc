// Flash-attention forward: softmax(q k^T / sqrt(hd) + masks) v, with the
// (Tq, Tk) scores kept on chip.
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
// Bound on the H100: reading q, k, v and writing the output once, 4 B H T hd
// elements (51 MB in bf16 at the GPT-2 training shape B 128, H 12, T 65,
// hd 64: 15 us at 3.35 TB/s); the products are 4 hd flops per (query, key)
// pair, under 1 us on the tensor cores at these short sequences.
//
// Design, simple first: one block of 4 warps per (batch row, head, 64-query
// tile); each warp owns 16 query rows.  The query tile stays in shared
// memory; K and V walk through shared memory in 64-key tiles (a causal tile
// stops at its last row's diagonal).  Per tile:
//   1. S = Q K^T into a float32 tile (bf16: WMMA 16x16x16 fragments with
//      float accumulators; float: FMA, so the float build is full float32);
//   2. two threads per row scale S, mask it, and fold it into the row's
//      running (max, sum); P = exp(S - max) is written in the element type
//      (bf16 rounds p before P V, about one bf16 ulp against the float32
//      twin; the TPU kernel keeps p in float32);
//   3. O = O * alpha + P V (bf16: WMMA on a float32 accumulator tile in
//      shared memory; float: FMA into registers).
// A row that saw no valid key (l = 0) reads the mean of v over [0, Tk) from
// device memory when it stores its output: no row of the captioner's paths
// is one, so the slow loop never runs there.
// q, k, v and the output are taken with their own strides (unit stride on
// hd), so the permuted views that split_heads gives are read in place and
// the output can be written straight into merge_heads' layout.  Ragged
// lengths need no padded copies: key rows >= Tk are zero-filled and masked,
// query rows >= Tq are computed on zeros and never stored.
#include "common.cuh"

#include <math.h>

namespace gic {
namespace flash {

constexpr int BQ = 64;      // query rows per block, 16 per warp
constexpr int BKV = 64;     // keys per shared-memory tile
constexpr int WARPS = 4;
constexpr int NT = 32 * WARPS;
static_assert(BQ == BKV, "load_rows copies BQ rows for Q, K and V tiles alike");

struct Strides {
  long long b, h, t;  // elements between consecutive batch rows, heads, positions
};

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  const int* key_mask;  // (B, Tk), nonzero = attend; null = every key
  Strides qs, ks, vs, os;
  int H, Tq, Tk, causal, q_offset;
  float scale;
};

// Every member is a multiple of 32 bytes long, so each starts 32-byte
// aligned, as WMMA's loads and stores need.
template <typename T, int HD>
struct Smem {
  static constexpr int LDX = HD + 8;   // pitch of the Q/K/V tiles, elements
  static constexpr int LDS = BKV + 4;  // pitch of the float score tile
  static constexpr int LDP = BKV + 8;  // pitch of the P tile, elements
  static constexpr int LDO = HD + 4;   // pitch of the float output tile (bf16 path)
  T q[BQ][LDX];
  T k[BKV][LDX];
  T v[BKV][LDX];
  float s[BQ][LDS];
  T p[BQ][LDP];
  float o[BQ][LDO];
  float alpha[BQ];  // this tile's rescale of each row's accumulator
  float l[BQ];      // each row's final softmax sum
  int kval[BKV];    // 1 where this tile's key is inside Tk and unmasked
};

// Copy rows [t0, t0 + BQ) of one head into a shared tile with 16-byte
// vectors; rows at or past tlim are zero-filled.
template <typename T, int HD, int LDX>
__device__ void load_rows(T (*dst)[LDX], const T* src, long long st, int t0, int tlim) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int VPR = HD / VE;  // vectors per row
  for (int i = threadIdx.x; i < BQ * VPR; i += NT) {
    const int r = i / VPR, c = (i % VPR) * VE;
    const int t = t0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < tlim) val = *reinterpret_cast<const uint4*>(src + (long long)t * st + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

// Column c of the mean of v over the Tk keys of one head: the output of a
// row with no valid key.
template <typename T>
__device__ float mean_v(const T* vp, long long st, int Tk, int c) {
  float s = 0.f;
  for (int t = 0; t < Tk; ++t) s += to_f32(vp[(long long)t * st + c]);
  return Tk > 0 ? s / (float)Tk : 0.f;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_attention_kernel(Args<T> a) {
  using S = Smem<T, HD>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  S& sm = *reinterpret_cast<S*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const T* qp = a.q + b * a.qs.b + h * a.qs.h;
  const T* kp = a.k + b * a.ks.b + h * a.ks.h;
  const T* vp = a.v + b * a.vs.b + h * a.vs.h;
  T* op = a.out + b * a.os.b + h * a.os.h;
  const int* mask = a.key_mask ? a.key_mask + (long long)b * a.Tk : nullptr;

  // keys this tile of queries can see
  int kend = a.Tk;
  if (a.causal) kend = min(kend, max(0, min(q0 + BQ, a.Tq) + a.q_offset));

  load_rows<T, HD, S::LDX>(sm.q, qp, a.qs.t, q0, a.Tq);
  constexpr bool kF32Path = std::is_same<T, float>::value;
  if (!kF32Path)
    for (int i = tid; i < BQ * S::LDO; i += NT) (&sm.o[0][0])[i] = 0.f;

  // softmax state of row r = tid / 2, held by both threads of the pair
  const int r = tid / 2, half = tid % 2;
  const int qpos = q0 + r + a.q_offset;  // last key position this row may see
  float m = -INFINITY, l = 0.f;
  constexpr int OPT = HD / 2;  // float path: output columns per thread
  float acc[kF32Path ? OPT : 1];
#pragma unroll
  for (int c = 0; c < (kF32Path ? OPT : 1); ++c) acc[c] = 0.f;

  __syncthreads();  // Q and the zeroed O tile are visible to every warp
  for (int k0 = 0; k0 < kend; k0 += BKV) {
    if (k0 > 0) __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<T, HD, S::LDX>(sm.k, kp, a.ks.t, k0, a.Tk);
    load_rows<T, HD, S::LDX>(sm.v, vp, a.vs.t, k0, a.Tk);
    for (int j = tid; j < BKV; j += NT) {
      const int t = k0 + j;
      sm.kval[j] = t < a.Tk && (mask == nullptr || mask[t] != 0);
    }
    __syncthreads();

    // 1. S = Q K^T for this warp's 16 rows
    if constexpr (!kF32Path) {
      using namespace nvcuda;
#pragma unroll
      for (int jn = 0; jn < BKV / 16; ++jn) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
        wmma::fill_fragment(sacc, 0.f);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> qa;
          // B = K^T: element (d, j) sits at k[j][d], column-major with pitch LDX
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> kb;
          wmma::load_matrix_sync(qa, &sm.q[warp * 16][kk * 16], S::LDX);
          wmma::load_matrix_sync(kb, &sm.k[jn * 16][kk * 16], S::LDX);
          wmma::mma_sync(sacc, qa, kb, sacc);
        }
        wmma::store_matrix_sync(&sm.s[warp * 16][jn * 16], sacc, S::LDS, wmma::mem_row_major);
      }
    } else {
      float d[BKV / 2];
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j) d[j] = 0.f;
      for (int e = 0; e < HD; ++e) {
        const float qe = sm.q[r][e];
#pragma unroll
        for (int j = 0; j < BKV / 2; ++j) d[j] = fmaf(qe, sm.k[half * (BKV / 2) + j][e], d[j]);
      }
#pragma unroll
      for (int j = 0; j < BKV / 2; ++j) sm.s[r][half * (BKV / 2) + j] = d[j];
    }
    __syncwarp();

    // 2. masks and the online softmax: this thread's half of row r
    float sv[BKV / 2];
    float cmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV / 2; ++j) {
      const int c = half * (BKV / 2) + j;
      const bool ok = sm.kval[c] && (!a.causal || k0 + c <= qpos);
      sv[j] = ok ? sm.s[r][c] * a.scale : -INFINITY;
      cmax = fmaxf(cmax, sv[j]);
    }
    cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
    const float m_new = fmaxf(m, cmax);
    // no valid key yet: keep the (empty) state as it is
    const float alpha = m_new == -INFINITY ? 1.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BKV / 2; ++j) {
      const float p = sv[j] == -INFINITY ? 0.f : expf(sv[j] - m_new);
      psum += p;
      sm.p[r][half * (BKV / 2) + j] = from_f32<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    if (half == 0) sm.alpha[r] = alpha;
    __syncwarp();

    // 3. O = O * alpha + P V
    if constexpr (!kF32Path) {
      using namespace nvcuda;
      for (int i = lane; i < 16 * HD; i += 32) {
        const int rr = warp * 16 + i / HD;
        sm.o[rr][i % HD] *= sm.alpha[rr];
      }
      __syncwarp();
#pragma unroll
      for (int dn = 0; dn < HD / 16; ++dn) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
        wmma::load_matrix_sync(oacc, &sm.o[warp * 16][dn * 16], S::LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> pa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> vb;
          wmma::load_matrix_sync(pa, &sm.p[warp * 16][kk * 16], S::LDP);
          wmma::load_matrix_sync(vb, &sm.v[kk * 16][dn * 16], S::LDX);
          wmma::mma_sync(oacc, pa, vb, oacc);
        }
        wmma::store_matrix_sync(&sm.o[warp * 16][dn * 16], oacc, S::LDO, wmma::mem_row_major);
      }
    } else {
#pragma unroll
      for (int c = 0; c < OPT; ++c) acc[c] *= alpha;
      for (int j = 0; j < BKV; ++j) {
        const float pj = to_f32(sm.p[r][j]);
#pragma unroll
        for (int c = 0; c < OPT; ++c) acc[c] = fmaf(pj, to_f32(sm.v[j][half * OPT + c]), acc[c]);
      }
    }
    __syncwarp();
  }

  // a row with no valid key has l == 0: it stores the mean of v instead
  if constexpr (!kF32Path) {
    if (half == 0) sm.l[r] = l;
    __syncwarp();
    for (int i = lane; i < 16 * HD; i += 32) {
      const int rr = warp * 16 + i / HD, c = i % HD;
      const int t = q0 + rr;
      if (t < a.Tq) {
        const float o = sm.l[rr] == 0.f ? mean_v(vp, a.vs.t, a.Tk, c) : sm.o[rr][c] / sm.l[rr];
        op[(long long)t * a.os.t + c] = from_f32<T>(o);
      }
    }
  } else {
    const int t = q0 + r;
    if (t < a.Tq) {
#pragma unroll
      for (int c = 0; c < OPT; ++c) {
        const int col = half * OPT + c;
        op[(long long)t * a.os.t + col] = l == 0.f ? mean_v(vp, a.vs.t, a.Tk, col) : acc[c] / l;
      }
    }
  }
}

template <typename T, int HD>
int launch(const Args<T>& a, int B, cudaStream_t stream) {
  constexpr int bytes = (int)sizeof(Smem<T, HD>);
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.H, B);
  kernel<<<grid, NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, const int* key_mask, int B,
             int H, int Tq, int Tk, int hd, const long long* st, int causal, int q_offset,
             cudaStream_t stream) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.out = static_cast<T*>(out);
  a.key_mask = key_mask;
  a.qs = {st[0], st[1], st[2]};
  a.ks = {st[3], st[4], st[5]};
  a.vs = {st[6], st[7], st[8]};
  a.os = {st[9], st[10], st[11]};
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.causal = causal;
  a.q_offset = q_offset;
  a.scale = (float)(1.0 / sqrt((double)hd));
  if (hd == 64) return launch<T, 64>(a, B, stream);
  if (hd == 96) return launch<T, 96>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash
}  // namespace gic

// q, k, v: (B, H, Tq or Tk, hd) in the element type, any strides with a unit
// stride on hd, 16-byte aligned rows; out: (B, H, Tq, hd), likewise.
// strides: 12 host int64s, (batch, head, position) for q, k, v and out, in
// elements.  key_mask: (B, Tk) int32 contiguous, or null.  hd must be 64 or
// 96.  A row with no valid key writes the mean of v (zeros if Tk == 0).  Returns
// cudaGetLastError() of the launch.
extern "C" int gic_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                   void* out, const int* key_mask, int B, int H, int Tq, int Tk,
                                   int hd, const long long* strides, int causal, int q_offset,
                                   void* stream) {
  using namespace gic;
  if (B <= 0 || H <= 0 || Tq <= 0 || Tk < 0 || (hd != 64 && hd != 96))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return flash::dispatch<__nv_bfloat16>(q, k, v, out, key_mask, B, H, Tq, Tk, hd, strides,
                                          causal, q_offset, s);
  if (dtype == kF32)
    return flash::dispatch<float>(q, k, v, out, key_mask, B, H, Tq, Tk, hd, strides, causal,
                                  q_offset, s);
  return (int)cudaErrorInvalidValue;
}
