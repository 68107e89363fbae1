// Fused self-attention at short sequence length, forward and backward:
//   o = softmax(q k^T * scale, invalid keys at -1e9) v   per (cloud, head)
// q, k, v: bf16 views of shape (B, T, H, d) with unit stride along d and one
// set of (cloud, token, head) strides, so the three slices of a
// (B, T, 3, H, d) projection are read in place; o: (B, T, H, d) f32.
// Products take bf16 operands and accumulate in f32; the softmax is f32
// with row-max subtraction; the probabilities are rounded to bf16 for the
// product with v. The backward recomputes the probabilities, rounds the
// cotangent and ds * scale to bf16 before their products, uses the f32
// probabilities in ds = p * (dp - sum(dp * p)), and writes dq, dk, dv as
// bf16 into the three slices of one (B, T, 3, H, d) buffer.
//
// Replaces point_dae_tpu/ops/pallas_attn.py:fused_attention (_fwd_kernel and
// _bwd_kernel).
//
// Design. The TPU kernel packs several clouds into one block-diagonal score
// tile to fill a 128x128 matrix unit; here one block owns one (cloud, head):
// q, k, v (T x 64 bf16 each) and the T x T scores live in shared memory and
// never reach device memory in either pass. Warp w owns query rows
// [16w, 16w + 16) for the scores, the softmax and every product whose rows
// are queries, and key rows [16w, 16w + 16) for dk and dv, so the forward
// needs one block barrier and the backward three. Products are WMMA
// 16x16x16 bf16 fragments with f32 accumulators.
//
// Bound on the H100: bytes. A forward launch at B 256, H 6, T 32 reads 9.4 MB
// of q, k, v and writes 12.6 MB; the products are 0.4 GFLOP. The blocks are
// small (2 or 4 warps) and many (1536), so the time is set by how many fit
// an SM at once and by the launch itself.
#include <cuda_bf16.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int D = 64;          // head dim the kernels are built for
constexpr int PADH = 8;        // bf16 row padding
constexpr int PADF = 4;        // f32 row padding
constexpr int LDQ = D + PADH;  // q, k, v, g tiles
constexpr int LDO = D + PADF;  // f32 staging of a (16, d) result

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Shared-memory layout for sequence length T (a multiple of 16, at most 64).
struct Layout {
  int lds, ldp;                       // f32 (T, T) and bf16 (T, T) row strides
  size_t q, k, v, s, p;               // forward
  size_t g, dp, ds, stage, bytes_fwd, bytes_bwd;
  __host__ __device__ explicit Layout(int T) {
    lds = T + PADF;
    ldp = T + PADH;
    const size_t tile = align128(size_t(T) * LDQ * 2);
    const size_t sq = align128(size_t(T) * lds * 4);
    const size_t pb = align128(size_t(T) * ldp * 2);
    q = 0;
    k = q + tile;
    v = k + tile;
    s = v + tile;
    p = s + sq;
    bytes_fwd = p + pb;
    g = bytes_fwd;
    dp = g + tile;
    ds = dp + sq;
    stage = ds + pb;
    bytes_bwd = stage + align128(size_t(T) * LDO * 4);
  }
};

// (T, 64) bf16 rows at `src` (row stride `st` elements) -> shared tile.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long st, int T) {
  for (int v = threadIdx.x; v < T * (D / 8); v += blockDim.x) {
    const int r = v / (D / 8), c = (v % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDQ + c) =
        *reinterpret_cast<const uint4*>(src + r * st + c);
  }
}

// Scores of this warp's 16 query rows into s_s (f32), then the softmax in
// place and its bf16 rounding into s_p. Warp-local: no block barrier.
__device__ __forceinline__ void scores_softmax(const bf16* s_q, const bf16* s_k,
                                               float* s_s, bf16* s_p,
                                               const unsigned char* mask_row, int T,
                                               int lds, int ldp, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = 0; j < T / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA a;
      FragBT b;
      wmma::load_matrix_sync(a, s_q + warp * 16 * LDQ + kk * 16, LDQ);
      wmma::load_matrix_sync(b, s_k + j * 16 * LDQ + kk * 16, LDQ);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(s_s + warp * 16 * lds + j * 16, acc, lds, wmma::mem_row_major);
  }
  __syncwarp();
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float sv[2];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = lane + 32 * i;
      sv[i] = -INFINITY;
      if (c < T) {
        const bool ok = mask_row == nullptr || mask_row[c] != 0;
        sv[i] = ok ? s_s[r * lds + c] * scale : -1e9f;
        mx = fmaxf(mx, sv[i]);
      }
    }
    mx = warp_max(mx);
    float e[2], sum = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      e[i] = (lane + 32 * i < T) ? expf(sv[i] - mx) : 0.f;
      sum += e[i];
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = lane + 32 * i;
      if (c < T) {
        const float p = e[i] / sum;
        s_s[r * lds + c] = p;
        s_p[r * ldp + c] = __float2bfloat16(p);
      }
    }
  }
  __syncwarp();
}

__global__ void attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                     const bf16* __restrict__ v,
                                     const unsigned char* __restrict__ mask,
                                     float* __restrict__ o, int T, int H, long long sb,
                                     long long st, long long sh, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(T);
  bf16* s_q = reinterpret_cast<bf16*>(smem + L.q);
  bf16* s_k = reinterpret_cast<bf16*>(smem + L.k);
  bf16* s_v = reinterpret_cast<bf16*>(smem + L.v);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  bf16* s_p = reinterpret_cast<bf16*>(smem + L.p);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long base = b * sb + h * sh;
  load_rows(s_q, q + base, st, T);
  load_rows(s_k, k + base, st, T);
  load_rows(s_v, v + base, st, T);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  scores_softmax(s_q, s_k, s_s, s_p, mask == nullptr ? nullptr : mask + size_t(b) * T, T,
                 L.lds, L.ldp, scale);

  // o rows of this warp = p @ v, stored straight to (B, T, H, d) f32
  float* o_rows = o + ((size_t(b) * T + warp * 16) * H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < T / 16; ++kk) {
      FragA a;
      FragB bv;
      wmma::load_matrix_sync(a, s_p + warp * 16 * L.ldp + kk * 16, L.ldp);
      wmma::load_matrix_sync(bv, s_v + kk * 16 * LDQ + j * 16, LDQ);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(o_rows + j * 16, acc, H * D, wmma::mem_row_major);
  }
}

// This warp's (16, d) f32 result in its staging rows -> bf16 rows of one
// slice of the (B, T, 3, H, d) gradient buffer.
__device__ __forceinline__ void store_rows_bf16(const float* stage, bf16* dst, int H) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D, c = e % D;
    dst[size_t(r) * 3 * H * D + c] = __float2bfloat16(stage[r * LDO + c]);
  }
  __syncwarp();
}

__global__ void attention_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                     const bf16* __restrict__ v,
                                     const unsigned char* __restrict__ mask,
                                     const float* __restrict__ g, bf16* __restrict__ dq,
                                     bf16* __restrict__ dk, bf16* __restrict__ dv, int T,
                                     int H, long long sb, long long st, long long sh,
                                     float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(T);
  bf16* s_q = reinterpret_cast<bf16*>(smem + L.q);
  bf16* s_k = reinterpret_cast<bf16*>(smem + L.k);
  bf16* s_v = reinterpret_cast<bf16*>(smem + L.v);
  float* s_s = reinterpret_cast<float*>(smem + L.s);     // p, f32
  bf16* s_p = reinterpret_cast<bf16*>(smem + L.p);       // p, bf16
  bf16* s_g = reinterpret_cast<bf16*>(smem + L.g);       // cotangent, bf16
  float* s_dp = reinterpret_cast<float*>(smem + L.dp);
  bf16* s_ds = reinterpret_cast<bf16*>(smem + L.ds);     // ds * scale, bf16
  float* s_stage = reinterpret_cast<float*>(smem + L.stage);

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = b * sb + h * sh;
  load_rows(s_q, q + base, st, T);
  load_rows(s_k, k + base, st, T);
  load_rows(s_v, v + base, st, T);
  const float* g_bh = g + (size_t(b) * T * H + h) * D;
  for (int e = threadIdx.x; e < T * D; e += blockDim.x) {
    const int r = e / D, c = e % D;
    s_g[r * LDQ + c] = __float2bfloat16(g_bh[size_t(r) * H * D + c]);
  }
  __syncthreads();

  scores_softmax(s_q, s_k, s_s, s_p, mask == nullptr ? nullptr : mask + size_t(b) * T, T,
                 L.lds, L.ldp, scale);

  // dp rows of this warp = g @ v^T, then ds = p * (dp - sum(dp * p))
  for (int j = 0; j < T / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA a;
      FragBT bv;
      wmma::load_matrix_sync(a, s_g + warp * 16 * LDQ + kk * 16, LDQ);
      wmma::load_matrix_sync(bv, s_v + j * 16 * LDQ + kk * 16, LDQ);
      wmma::mma_sync(acc, a, bv, acc);
    }
    wmma::store_matrix_sync(s_dp + warp * 16 * L.lds + j * 16, acc, L.lds,
                            wmma::mem_row_major);
  }
  __syncwarp();
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float dot = 0.f;
    for (int c = lane; c < T; c += 32) dot += s_dp[r * L.lds + c] * s_s[r * L.lds + c];
    dot = warp_sum(dot);
    for (int c = lane; c < T; c += 32) {
      const float ds = s_s[r * L.lds + c] * (s_dp[r * L.lds + c] - dot);
      s_ds[r * L.ldp + c] = __float2bfloat16(ds * scale);
    }
  }
  __syncwarp();

  float* stage = s_stage + warp * 16 * LDO;
  const size_t out_row = ((size_t(b) * T + warp * 16) * 3 * H + h) * D;

  // dq rows of this warp = ds @ k
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < T / 16; ++kk) {
      FragA a;
      FragB bk;
      wmma::load_matrix_sync(a, s_ds + warp * 16 * L.ldp + kk * 16, L.ldp);
      wmma::load_matrix_sync(bk, s_k + kk * 16 * LDQ + j * 16, LDQ);
      wmma::mma_sync(acc, a, bk, acc);
    }
    wmma::store_matrix_sync(stage + j * 16, acc, LDO, wmma::mem_row_major);
  }
  store_rows_bf16(stage, dq + out_row, H);

  __syncthreads();   // every warp's p and ds are complete

  // dv rows (keys) of this warp = p^T @ g
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < T / 16; ++kk) {
      FragAT a;
      FragB bg;
      wmma::load_matrix_sync(a, s_p + kk * 16 * L.ldp + warp * 16, L.ldp);
      wmma::load_matrix_sync(bg, s_g + kk * 16 * LDQ + j * 16, LDQ);
      wmma::mma_sync(acc, a, bg, acc);
    }
    wmma::store_matrix_sync(stage + j * 16, acc, LDO, wmma::mem_row_major);
  }
  store_rows_bf16(stage, dv + out_row, H);

  // dk rows (keys) of this warp = ds^T @ q
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < T / 16; ++kk) {
      FragAT a;
      FragB bq;
      wmma::load_matrix_sync(a, s_ds + kk * 16 * L.ldp + warp * 16, L.ldp);
      wmma::load_matrix_sync(bq, s_q + kk * 16 * LDQ + j * 16, LDQ);
      wmma::mma_sync(acc, a, bq, acc);
    }
    wmma::store_matrix_sync(stage + j * 16, acc, LDO, wmma::mem_row_major);
  }
  store_rows_bf16(stage, dk + out_row, H);
}

bool shape_ok(int B, int T, int H, int d, int sb, int st, int sh) {
  return B > 0 && H > 0 && d == D && T >= 16 && T <= 64 && T % 16 == 0 && sb % 8 == 0 &&
         st % 8 == 0 && sh % 8 == 0;
}

}  // namespace

PDAE_EXPORT int attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                              float* o, int B, int T, int H, int d, int sb, int st, int sh,
                              float scale, void* stream) {
  if (!shape_ok(B, T, H, d, sb, st, sh)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Layout(T).bytes_fwd;
  cudaError_t err = set_smem(attention_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_fwd_kernel<<<B * H, 2 * T, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const unsigned char*>(mask), o, T, H, sb, st, sh, scale);
  return static_cast<int>(cudaGetLastError());
}

// dq, dk, dv: the slices [:, :, 0], [:, :, 1], [:, :, 2] of one contiguous
// (B, T, 3, H, d) bf16 buffer; g: (B, T, H, d) f32, contiguous.
PDAE_EXPORT int attention_bwd(const void* q, const void* k, const void* v, const void* mask,
                              const float* g, void* dq, void* dk, void* dv, int B, int T,
                              int H, int d, int sb, int st, int sh, float scale,
                              void* stream) {
  if (!shape_ok(B, T, H, d, sb, st, sh)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Layout(T).bytes_bwd;
  cudaError_t err = set_smem(attention_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_bwd_kernel<<<B * H, 2 * T, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const unsigned char*>(mask), g, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H, sb, st, sh, scale);
  return static_cast<int>(cudaGetLastError());
}
