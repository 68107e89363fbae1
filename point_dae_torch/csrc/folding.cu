// Fused two-stage folding head, forward and backward. For every token x_t
// (C wide) and every grid point p of n:
//   h0 = gp1[p] + x_t @ ks1 + b01        a0 = relu(h0)
//   h1 = a0 @ k11 + b11                   a1 = relu(h1)
//   f1 = a1 @ k21 + b21                   (3 wide)
//   h2 = f1 @ ke2 + x_t @ ks2 + b02       a2 = relu(h2)
//   h3 = a2 @ k12 + b12                   a3 = relu(h3)
//   out = a3 @ k22 + b22                  (3 wide)
// Every product takes bf16 operands and accumulates in f32; bias adds and
// ReLUs are f32; only the next product's operand is rounded to bf16. The
// backward recomputes the chain, rounds every cotangent to bf16 before each
// product, takes the ReLU masks from the f32 activations and sums the bias
// gradients from the unrounded cotangents. gp1 = grid @ ke1 is computed by
// the caller (it does not depend on the token).
//
// Replaces point_dae_tpu/ops/pallas_folding.py:fused_folding (_fwd_kernel and
// _bwd_kernel).
//
// Design. The expanded (tokens * n, F) hiddens are the largest tensors of
// the train step and never reach device memory here, in either pass. The TPU
// kernel holds every weight and a 128-token tile in its fast memory; a block
// here has 227 KB, so a block owns a few tokens (MR rows), keeps their
// (MR, F) activation resident as bf16 and streams the (F, F) weights from L2
// in 64-column chunks. The second product of each stage is only 3 wide, so it
// is accumulated chunk by chunk with plain FMAs and the (MR, F) output of the
// wide product never exists as a whole. The two per-token products x @ ks1
// and x @ ks2 run first as one small GEMM into an f32 scratch (T, 2F); their
// gradients (dx and dks) are two small GEMMs at the end.
// The TPU backward summed the weight gradients over a sequential grid. Here
// it is two passes, none with atomics, so results repeat from run to run:
//   rows pass (persistent blocks, a few tokens per step): recompute the
//     chain, walk the cotangent back to dh0; writes f1, df1 (3 wide), the
//     ReLU masks of a1 and a3 (one bit an element) and the per-token sums
//     dsp1, dsp2 as scratch, and per-block sums of every bias and narrow
//     kernel gradient and of dgp1. a1 of the block's current rows passes
//     through a per-block scratch that stays in L2;
//   weights pass (one block per stage, 128 x 128 tile of dk11 or dk12 and
//     row partition): rebuilds its columns of a0 and dh1 (or a2 and dh3)
//     elementwise from the 3-wide scratch and the mask bits, 64 rows at a
//     time, and keeps its tile in WMMA accumulators: no product is
//     recomputed and no (rows, F) tensor is read;
//   then the partials are summed.
//
// Bound on the H100: operations. At 13056 tokens x 36 points, C = F = 384 the
// forward is 0.29 TFLOP of bf16 products against 16 MB moved; the backward
// does the four wide products of the rows pass and the two weight-gradient
// products of the weights pass. Plain WMMA loops with synchronous staging: a
// fraction of the tensor-core peak.
#include <cuda_bf16.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int CH = 64;            // columns of a weight chunk
constexpr int PADH = 8;           // bf16 row padding (keeps 32-byte fragment alignment)
constexpr int PADF = 4;           // f32 row padding
constexpr int LDW = CH + PADH;    // weight chunk (F, CH) and cotangent chunk (MR, CH), bf16
constexpr int LDHF = CH + PADF;   // product staging (MR, CH), f32
constexpr int GT = 64;            // tile of the small GEMMs
constexpr int MR_FWD = 144;       // rows a forward block owns (4 tokens of 36 points)
constexpr int MR_BWD = 80;        // rows a backward block owns (2 tokens of 36 points)
constexpr int F_MAX = 384;
constexpr int WT = 128;           // tile of dk11 / dk12 a weights-pass block owns
constexpr int KR = 64;            // rows a weights-pass block takes per step
constexpr int LDT = WT + PADH;

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

__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The narrow f32 operands (bf16-rounded values), one vector of 13 F + 8:
// b01 | b11 | b02 | b12 | k21 (F, 3) | k22 (F, 3) | ke2 (3, F) | b21, 0 | b22, 0
struct Small {
  const float *b01, *b11, *b02, *b12, *k21, *k22, *ke2, *b21, *b22;
  __device__ Small(const float* s, int F)
      : b01(s), b11(s + F), b02(s + 2 * F), b12(s + 3 * F), k21(s + 4 * F),
        k22(s + 7 * F), ke2(s + 10 * F), b21(s + 13 * F), b22(s + 13 * F + 4) {}
};

// rows x cols bf16 tile, global row stride gld -> shared row stride sld;
// cols and both strides are multiples of 8 (16-byte vectors).
__device__ __forceinline__ void load_tile(bf16* dst, int sld, const bf16* src, size_t gld,
                                          int rows, int cols) {
  const int vpr = cols / 8;
  for (int v = threadIdx.x; v < rows * vpr; v += blockDim.x) {
    const int r = v / vpr, c = (v % vpr) * 8;
    *reinterpret_cast<uint4*>(dst + r * sld + c) =
        *reinterpret_cast<const uint4*>(src + r * gld + c);
  }
}

// s_h (MR, CH) f32 = s_a (MR, K) @ s_w (K, CH). MR / 16 * 2 warps: warp
// (rf, half) owns row fragment rf and two of the four column fragments.
template <int MR>
__device__ __forceinline__ void tile_gemm_nn(const bf16* s_a, int lda, const bf16* s_w,
                                             float* s_h, int K) {
  constexpr int NRF = MR / 16;
  const int warp = threadIdx.x >> 5;
  const int rf = warp % NRF, half = warp / NRF;
  FragC acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int kk = 0; kk < K / 16; ++kk) {
    FragA a;
    wmma::load_matrix_sync(a, s_a + rf * 16 * lda + kk * 16, lda);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      FragB b;
      wmma::load_matrix_sync(b, s_w + kk * 16 * LDW + (half * 2 + i) * 16, LDW);
      wmma::mma_sync(acc[i], a, b, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    wmma::store_matrix_sync(s_h + rf * 16 * LDHF + (half * 2 + i) * 16, acc[i], LDHF,
                            wmma::mem_row_major);
}

// s_h (MR, CH) f32 = s_a (MR, K) @ s_w^T with s_w (CH, K), row stride ldk.
template <int MR>
__device__ __forceinline__ void tile_gemm_nt(const bf16* s_a, int lda, const bf16* s_w,
                                             int ldk, float* s_h, int K) {
  constexpr int NRF = MR / 16;
  const int warp = threadIdx.x >> 5;
  const int rf = warp % NRF, half = warp / NRF;
  FragC acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int kk = 0; kk < K / 16; ++kk) {
    FragA a;
    wmma::load_matrix_sync(a, s_a + rf * 16 * lda + kk * 16, lda);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      FragBT b;
      wmma::load_matrix_sync(b, s_w + (half * 2 + i) * 16 * ldk + kk * 16, ldk);
      wmma::mma_sync(acc[i], a, b, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    wmma::store_matrix_sync(s_h + rf * 16 * LDHF + (half * 2 + i) * 16, acc[i], LDHF,
                            wmma::mem_row_major);
}

// a0 = relu(gp1[p] + sp1[t] + b01) as bf16 rows of s_a (zero past `rows`);
// the masks a0 > 0 go to s_m (one bit a column) when given.
template <int MR>
__device__ __forceinline__ void build_a0(bf16* s_a, int lda, unsigned* s_m,
                                         const float* __restrict__ sp,
                                         const bf16* __restrict__ gp1, const float* b01,
                                         int t0, int rows, int n, int F) {
  constexpr int NW = MR / 16 * 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < MR; r += NW) {
    const bool live = r < rows;
    const int t = t0 + r / n, p = r % n;
    for (int c = lane; c < F; c += 32) {
      float v = 0.f;
      if (live)
        v = (__bfloat162float(gp1[p * F + c]) + sp[size_t(t) * 2 * F + c]) + b01[c];
      v = fmaxf(v, 0.f);
      s_a[r * lda + c] = __float2bfloat16(v);
      if (s_m != nullptr) {
        const unsigned bits = __ballot_sync(0xffffffffu, v > 0.f);
        if (lane == 0) s_m[r * (F / 32) + c / 32] = bits;
      }
    }
  }
}

// a2 = relu(f1b @ ke2 + sp2[t] + b02) as bf16 rows of s_a (zero past `rows`),
// with f1b the bf16-rounded stage-1 output in s_f1 (MR, 4).
template <int MR>
__device__ __forceinline__ void build_a2(bf16* s_a, int lda, const float* s_f1,
                                         const float* __restrict__ sp, const float* ke2,
                                         const float* b02, int t0, int rows, int n, int F) {
  constexpr int NW = MR / 16 * 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < MR; r += NW) {
    const bool live = r < rows;
    const int t = t0 + r / n;
    const float f0 = s_f1[r * 4], f1 = s_f1[r * 4 + 1], f2 = s_f1[r * 4 + 2];
    for (int c = lane; c < F; c += 32) {
      float v = 0.f;
      if (live) {
        const float pp = (f0 * ke2[c] + f1 * ke2[F + c]) + f2 * ke2[2 * F + c];
        v = (pp + sp[size_t(t) * 2 * F + F + c]) + b02[c];
      }
      s_a[r * lda + c] = __float2bfloat16(fmaxf(v, 0.f));
    }
  }
}

// One stage's two upper layers over the resident activation s_a:
//   s_acc[r] += bf16(relu(s_a @ k[:, chunk] + bias)) @ k3[chunk]   per chunk,
// with k (F, F) bf16 in global memory and k3 (F, 3) f32. When s_m is given
// the masks of relu go there, one bit a column, and when a_out is given the
// rounded activations go there (row stride F). s_acc (MR, 4) must be zero.
template <int MR>
__device__ __forceinline__ void stage_upper(const bf16* s_a, int lda, bf16* s_w, float* s_h,
                                            float* s_acc, unsigned* s_m, bf16* a_out,
                                            const bf16* __restrict__ k, const float* bias,
                                            const float* k3, int F) {
  constexpr int NW = MR / 16 * 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j = 0; j < F / CH; ++j) {
    __syncthreads();
    load_tile(s_w, LDW, k + j * CH, F, F, CH);
    __syncthreads();
    tile_gemm_nn<MR>(s_a, lda, s_w, s_h, F);
    __syncthreads();
    for (int r = warp; r < MR; r += NW) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < CH / 32; ++i) {
        const int c = lane + 32 * i, col = j * CH + c;
        const float h = s_h[r * LDHF + c] + bias[col];
        const bf16 ab = __float2bfloat16(fmaxf(h, 0.f));
        const float a = __bfloat162float(ab);
        if (a_out != nullptr) a_out[size_t(r) * F + col] = ab;
        s0 += a * k3[col * 3];
        s1 += a * k3[col * 3 + 1];
        s2 += a * k3[col * 3 + 2];
        if (s_m != nullptr) {
          const unsigned bits = __ballot_sync(0xffffffffu, h > 0.f);
          if (lane == 0) s_m[r * (F / 32) + col / 32] = bits;
        }
      }
      s0 = warp_sum(s0);
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        s_acc[r * 4] += s0;
        s_acc[r * 4 + 1] += s1;
        s_acc[r * 4 + 2] += s2;
      }
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------------ forward

struct FwdLayout {
  int lda;
  size_t a, w, h, acc, f1, bytes;
  __host__ __device__ FwdLayout(int MR, int F) {
    lda = F + PADH;
    a = 0;
    w = a + align128(size_t(MR) * lda * 2);
    h = w + align128(size_t(F) * LDW * 2);
    acc = h + align128(size_t(MR) * LDHF * 4);
    f1 = acc + align128(size_t(MR) * 4 * 4);
    bytes = f1 + align128(size_t(MR) * 4 * 4);
  }
};

template <int MR>
__global__ void __launch_bounds__(MR / 16 * 64, 1)
fold_fwd_kernel(const float* __restrict__ sp, const bf16* __restrict__ gp1,
                const bf16* __restrict__ k11, const bf16* __restrict__ k12,
                const float* __restrict__ small, float* __restrict__ out, int Tp, int F,
                int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L(MR, F);
  bf16* s_a = reinterpret_cast<bf16*>(smem + L.a);
  bf16* s_w = reinterpret_cast<bf16*>(smem + L.w);
  float* s_h = reinterpret_cast<float*>(smem + L.h);
  float* s_acc = reinterpret_cast<float*>(smem + L.acc);
  float* s_f1 = reinterpret_cast<float*>(smem + L.f1);
  const Small S(small, F);

  const int tok = MR / n;
  const int t0 = blockIdx.x * tok;
  const int rows = min(tok, Tp - t0) * n;

  for (int e = threadIdx.x; e < MR * 4; e += blockDim.x) s_acc[e] = 0.f;
  build_a0<MR>(s_a, L.lda, nullptr, sp, gp1, S.b01, t0, rows, n, F);
  stage_upper<MR>(s_a, L.lda, s_w, s_h, s_acc, nullptr, nullptr, k11, S.b11, S.k21, F);
  for (int e = threadIdx.x; e < MR * 4; e += blockDim.x) {
    s_f1[e] = bf_round(s_acc[e] + S.b21[e & 3]);
    s_acc[e] = 0.f;
  }
  __syncthreads();
  build_a2<MR>(s_a, L.lda, s_f1, sp, S.ke2, S.b02, t0, rows, n, F);
  stage_upper<MR>(s_a, L.lda, s_w, s_h, s_acc, nullptr, nullptr, k12, S.b12, S.k22, F);
  for (int e = threadIdx.x; e < rows * 3; e += blockDim.x) {
    const int r = e / 3, o = e % 3;
    out[(size_t(t0) * n + r) * 3 + o] = s_acc[r * 4 + o] + S.b22[o];
  }
}

// ------------------------------------------------------ backward, rows pass

struct RowsLayout {
  int lda;                            // also the row stride of a transposed weight chunk
  size_t a, d, w, h, acc, f1, g, df, m0, m1, red, bytes;
  __host__ __device__ RowsLayout(int MR, int F) {
    lda = F + PADH;
    a = 0;
    d = a + align128(size_t(MR) * lda * 2);
    w = d + align128(size_t(MR) * lda * 2);
    h = w + align128(size_t(F) * LDW * 2);     // >= (CH, F + 8) for the transposed use
    acc = h + align128(size_t(MR) * LDHF * 4);
    f1 = acc + align128(size_t(MR) * 4 * 4);
    g = f1 + align128(size_t(MR) * 4 * 4);
    df = g + align128(size_t(MR) * 4 * 4);
    m0 = df + align128(size_t(MR) * 4 * 4);
    m1 = m0 + align128(size_t(MR) * (F / 32) * 4);
    red = m1 + align128(size_t(MR) * (F / 32) * 4);
    bytes = red + align128(size_t(MR / 16) * CH * 4 * 4);
  }
};

// Per-block sums of the rows pass, NA = n F + 12 F + 4 floats a block:
// dgp1 (n, F) | db02 (F) | dke2 (3, F) | db12 (F) | dk22 (F, 3) | db11 (F) |
// dk21 (F, 3) | db21 (3), 0
template <int MR>
__global__ void __launch_bounds__(MR / 16 * 64, 1)
fold_bwd_rows_kernel(const float* __restrict__ sp, const bf16* __restrict__ gp1,
                     const bf16* __restrict__ k11, const bf16* __restrict__ k12,
                     const float* __restrict__ small, const float* __restrict__ g,
                     float* __restrict__ f1s, float* __restrict__ df1s,
                     unsigned* __restrict__ m1g, unsigned* __restrict__ m3g, bf16* a1s,
                     bf16* __restrict__ dspb, float* __restrict__ part_a, int Tp, int F,
                     int n, int ntiles) {
  constexpr int NW = MR / 16 * 2;
  constexpr int NG = MR / 16;      // thread groups of CH columns
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsLayout L(MR, F);
  bf16* s_a = reinterpret_cast<bf16*>(smem + L.a);
  bf16* s_d = reinterpret_cast<bf16*>(smem + L.d);
  bf16* s_w = reinterpret_cast<bf16*>(smem + L.w);
  float* s_h = reinterpret_cast<float*>(smem + L.h);
  float* s_acc = reinterpret_cast<float*>(smem + L.acc);
  float* s_f1 = reinterpret_cast<float*>(smem + L.f1);
  float* s_g = reinterpret_cast<float*>(smem + L.g);
  float* s_df = reinterpret_cast<float*>(smem + L.df);
  unsigned* s_m0 = reinterpret_cast<unsigned*>(smem + L.m0);
  unsigned* s_m1 = reinterpret_cast<unsigned*>(smem + L.m1);
  float* s_red = reinterpret_cast<float*>(smem + L.red);
  const Small S(small, F);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = threadIdx.x / CH, cc = threadIdx.x % CH;
  const int tok = MR / n;
  const int MW = F / 32;
  float* part = part_a + size_t(blockIdx.x) * (size_t(n) * F + 12 * F + 4);
  float* p_dgp1 = part;
  float* p_db02 = part + size_t(n) * F;
  float* p_dke2 = p_db02 + F;
  float* p_db12 = p_dke2 + 3 * F;
  float* p_dk22 = p_db12 + F;
  float* p_db11 = p_dk22 + 3 * F;
  float* p_dk21 = p_db11 + F;
  float* p_db21 = p_dk21 + 3 * F;
  bf16* a1_blk = a1s + size_t(blockIdx.x) * MR * F;   // a1 of the current rows

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int t0 = tile * tok;
    const int ntok = min(tok, Tp - t0);
    const int rows = ntok * n;
    const size_t row0 = size_t(t0) * n;

    __syncthreads();
    for (int e = threadIdx.x; e < MR * 4; e += blockDim.x) {
      const int r = e >> 2, o = e & 3;
      s_g[e] = (r < rows && o < 3) ? bf_round(g[(row0 + r) * 3 + o]) : 0.f;
      s_acc[e] = 0.f;
      s_df[e] = 0.f;
    }

    // recompute: stage 1 (masks of a0 and a1 kept as bits), f1, a2
    build_a0<MR>(s_a, L.lda, s_m0, sp, gp1, S.b01, t0, rows, n, F);
    stage_upper<MR>(s_a, L.lda, s_w, s_h, s_acc, s_m1, a1_blk, k11, S.b11, S.k21, F);
    for (int e = threadIdx.x; e < MR * 4; e += blockDim.x) {
      const int r = e >> 2;
      const float v = bf_round(s_acc[e] + S.b21[e & 3]);
      s_f1[e] = v;
      if (r < rows) f1s[row0 * 4 + e] = v;
    }
    for (int e = threadIdx.x; e < rows * MW; e += blockDim.x) m1g[row0 * MW + e] = s_m1[e];
    __syncthreads();
    build_a2<MR>(s_a, L.lda, s_f1, sp, S.ke2, S.b02, t0, rows, n, F);

    // s_d = bf16(dh3), dh3 = (h3 > 0) * (gb @ k22^T), h3 chunk by chunk; the
    // masks go to scratch, db12 and dk22 = a3b^T @ gb to the block's sums
    for (int j = 0; j < F / CH; ++j) {
      __syncthreads();
      load_tile(s_w, LDW, k12 + j * CH, F, F, CH);
      __syncthreads();
      tile_gemm_nn<MR>(s_a, L.lda, s_w, s_h, F);
      __syncthreads();
      const int col = j * CH + cc;
      {
        const float b12c = S.b12[col];
        const float w0 = S.k22[col * 3], w1 = S.k22[col * 3 + 1], w2 = S.k22[col * 3 + 2];
        float sb = 0.f, e0 = 0.f, e1 = 0.f, e2 = 0.f;
        for (int r = grp; r < MR; r += NG) {
          const float g0 = s_g[r * 4], g1 = s_g[r * 4 + 1], g2 = s_g[r * 4 + 2];
          const float h3 = s_h[r * LDHF + cc] + b12c;
          const float a3 = bf_round(fmaxf(h3, 0.f));
          const float dh3 = h3 > 0.f ? (g0 * w0 + g1 * w1) + g2 * w2 : 0.f;
          s_d[r * L.lda + col] = __float2bfloat16(dh3);
          const unsigned bits = __ballot_sync(0xffffffffu, h3 > 0.f);
          if (lane == 0 && r < rows) m3g[(row0 + r) * MW + col / 32] = bits;
          sb += dh3;
          e0 += a3 * g0;
          e1 += a3 * g1;
          e2 += a3 * g2;
        }
        float* red = s_red + (grp * CH + cc) * 4;
        red[0] = sb;
        red[1] = e0;
        red[2] = e1;
        red[3] = e2;
      }
      __syncthreads();
      if (grp == 0) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        for (int q = 0; q < NG; ++q)
#pragma unroll
          for (int k = 0; k < 4; ++k) t[k] += s_red[(q * CH + cc) * 4 + k];
        p_db12[col] += t[0];
        p_dk22[col * 3] += t[1];
        p_dk22[col * 3 + 1] += t[2];
        p_dk22[col * 3 + 2] += t[3];
      }
    }

    // dh2 = (a2 > 0) * (dh3b @ k12^T) in chunks of output columns; from it
    // df1 (per row), dsp2 (per token), db02 and dke2 (per column)
    for (int jc = 0; jc < F / CH; ++jc) {
      __syncthreads();
      load_tile(s_w, L.lda, k12 + size_t(jc) * CH * F, F, CH, F);
      __syncthreads();
      tile_gemm_nt<MR>(s_d, L.lda, s_w, L.lda, s_h, F);
      __syncthreads();
      for (int r = warp; r < MR; r += NW) {
        float d0 = 0.f, d1 = 0.f, d2 = 0.f;
#pragma unroll
        for (int i = 0; i < CH / 32; ++i) {
          const int c = lane + 32 * i, col = jc * CH + c;
          const bool on = __bfloat162float(s_a[r * L.lda + col]) > 0.f;
          const float dh2 = on ? s_h[r * LDHF + c] : 0.f;
          s_h[r * LDHF + c] = dh2;
          const float b = bf_round(dh2);
          d0 += b * S.ke2[col];
          d1 += b * S.ke2[F + col];
          d2 += b * S.ke2[2 * F + col];
        }
        d0 = warp_sum(d0);
        d1 = warp_sum(d1);
        d2 = warp_sum(d2);
        if (lane == 0) {
          s_df[r * 4] += d0;
          s_df[r * 4 + 1] += d1;
          s_df[r * 4 + 2] += d2;
        }
      }
      __syncthreads();
      {
        const int col = jc * CH + cc;
        float sb = 0.f, e0 = 0.f, e1 = 0.f, e2 = 0.f;
        for (int tk = grp; tk < ntok; tk += NG) {
          float ts = 0.f;
          for (int p = 0; p < n; ++p) {
            const int r = tk * n + p;
            const float v = s_h[r * LDHF + cc];
            const float b = bf_round(v);
            ts += v;
            e0 += s_f1[r * 4] * b;
            e1 += s_f1[r * 4 + 1] * b;
            e2 += s_f1[r * 4 + 2] * b;
          }
          dspb[size_t(t0 + tk) * 2 * F + F + col] = __float2bfloat16(ts);
          sb += ts;
        }
        float* red = s_red + (grp * CH + cc) * 4;
        red[0] = sb;
        red[1] = e0;
        red[2] = e1;
        red[3] = e2;
      }
      __syncthreads();
      if (grp == 0) {
        const int col = jc * CH + cc;
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        for (int q = 0; q < NG; ++q)
#pragma unroll
          for (int k = 0; k < 4; ++k) t[k] += s_red[(q * CH + cc) * 4 + k];
        p_db02[col] += t[0];
        p_dke2[col] += t[1];
        p_dke2[F + col] += t[2];
        p_dke2[2 * F + col] += t[3];
      }
    }
    __syncthreads();

    // df1 is complete: db21 from the unrounded sums, df1b to s_acc and scratch
    if (warp == 0) {
      float t0s = 0.f, t1s = 0.f, t2s = 0.f;
      for (int r = lane; r < MR; r += 32) {
        t0s += s_df[r * 4];
        t1s += s_df[r * 4 + 1];
        t2s += s_df[r * 4 + 2];
      }
      t0s = warp_sum(t0s);
      t1s = warp_sum(t1s);
      t2s = warp_sum(t2s);
      if (lane == 0) {
        p_db21[0] += t0s;
        p_db21[1] += t1s;
        p_db21[2] += t2s;
      }
    }
    for (int e = threadIdx.x; e < MR * 4; e += blockDim.x) {
      const float v = bf_round(s_df[e]);
      s_acc[e] = v;
      if ((e >> 2) < rows) df1s[row0 * 4 + e] = v;
    }
    __syncthreads();

    // s_d = bf16(dh1), dh1 = (a1 > 0) * (df1b @ k21^T); db11 and
    // dk21 = a1b^T @ df1b to the block's sums (a thread owns its columns)
    for (int c = threadIdx.x; c < F; c += blockDim.x) {
      const float w0 = S.k21[c * 3], w1 = S.k21[c * 3 + 1], w2 = S.k21[c * 3 + 2];
      const int word = c / 32;
      const unsigned bit = 1u << (c % 32);
      float sb = 0.f, e0 = 0.f, e1 = 0.f, e2 = 0.f;
      for (int r = 0; r < MR; ++r) {
        const float d0 = s_acc[r * 4], d1 = s_acc[r * 4 + 1], d2 = s_acc[r * 4 + 2];
        const float dh1 = (s_m1[r * MW + word] & bit) ? (d0 * w0 + d1 * w1) + d2 * w2 : 0.f;
        s_d[r * L.lda + c] = __float2bfloat16(dh1);
        const float a1 = __bfloat162float(a1_blk[size_t(r) * F + c]);
        sb += dh1;
        e0 += a1 * d0;
        e1 += a1 * d1;
        e2 += a1 * d2;
      }
      p_db11[c] += sb;
      p_dk21[c * 3] += e0;
      p_dk21[c * 3 + 1] += e1;
      p_dk21[c * 3 + 2] += e2;
    }

    // dh0 = (a0 > 0) * (dh1b @ k11^T) in chunks of output columns; from it
    // dsp1 (per token) and dgp1 (per grid point)
    for (int jc = 0; jc < F / CH; ++jc) {
      __syncthreads();
      load_tile(s_w, L.lda, k11 + size_t(jc) * CH * F, F, CH, F);
      __syncthreads();
      tile_gemm_nt<MR>(s_d, L.lda, s_w, L.lda, s_h, F);
      __syncthreads();
      const int col = jc * CH + cc;
      const int word = col / 32;
      const unsigned bit = 1u << (col % 32);
      for (int tk = grp; tk < ntok; tk += NG) {
        float ts = 0.f;
        for (int p = 0; p < n; ++p) {
          const int r = tk * n + p;
          if (s_m0[r * MW + word] & bit) ts += s_h[r * LDHF + cc];
        }
        dspb[size_t(t0 + tk) * 2 * F + col] = __float2bfloat16(ts);
      }
      for (int p = grp; p < n; p += NG) {
        float gs = 0.f;
        for (int tk = 0; tk < ntok; ++tk) {
          const int r = tk * n + p;
          if (s_m0[r * MW + word] & bit) gs += s_h[r * LDHF + cc];
        }
        p_dgp1[size_t(p) * F + col] += gs;
      }
    }
  }
}

// --------------------------------------------------- backward, weights pass

// grid ((F / WT)^2 tiles, parts, 2 stages), 256 threads. Block (tile, part,
// s) owns the WT x WT tile (i0, j0) of stage s's wide weight gradient
//   dk11 = a0b^T @ dh1b   or   dk12 = a2b^T @ dh3b
// over the rows of its partition, KR rows a step: its WT columns of both
// operands are rebuilt elementwise (a0 from gp1, sp1, b01; dh1 from the mask
// bits of a1, df1b and k21; a2 from f1b, ke2, sp2, b02; dh3 from the mask
// bits of a3, gb and k22). Output: dkp (2, parts, F, F) f32.
__global__ void __launch_bounds__(256)
fold_bwd_weights_kernel(const float* __restrict__ sp, const bf16* __restrict__ gp1,
                        const float* __restrict__ small, const float* __restrict__ g,
                        const float* __restrict__ f1s, const float* __restrict__ df1s,
                        const unsigned* __restrict__ m1g, const unsigned* __restrict__ m3g,
                        float* __restrict__ dkp, long long rows_total, int F, int n,
                        int chunks_per_part) {
  __shared__ __align__(128) bf16 s_at[KR * LDT];   // operand whose columns are dk's rows
  __shared__ __align__(128) bf16 s_dt[KR * LDT];   // cotangent operand
  __shared__ float s_v[KR * 4];                    // df1b (stage 1) or gb (stage 2)
  __shared__ float s_f1[KR * 4];                   // f1b (stage 2)
  __shared__ int s_tok[KR], s_pt[KR];
  const Small S(small, F);

  const int warp = threadIdx.x >> 5;
  const int wi = warp >> 1, wj = warp & 1;         // 2 x 4 fragments of the 8 x 8
  const int tiles = F / WT;
  const int i0 = (blockIdx.x / tiles) * WT, j0 = (blockIdx.x % tiles) * WT;
  const int part = blockIdx.y, stage = blockIdx.z, parts = gridDim.y;
  const int MW = F / 32;
  const int c = threadIdx.x % WT, rsub = threadIdx.x / WT;   // column, row parity
  const int ci = i0 + c, cj = j0 + c;
  const unsigned bit = 1u << (cj % 32);
  const int word = cj / 32;
  const unsigned* mg = stage ? m3g : m1g;
  const float* k3 = (stage ? S.k22 : S.k21) + cj * 3;
  const float w0 = k3[0], w1 = k3[1], w2 = k3[2];
  const float bi = stage ? S.b02[ci] : S.b01[ci];
  const float e0 = S.ke2[ci], e1 = S.ke2[F + ci], e2 = S.ke2[2 * F + ci];

  FragC acc[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) wmma::fill_fragment(acc[a][b], 0.f);

  const long long nchunks = (rows_total + KR - 1) / KR;
  const long long first = static_cast<long long>(part) * chunks_per_part;
  const long long last = min(nchunks, first + chunks_per_part);
  for (long long chunk = first; chunk < last; ++chunk) {
    const long long r0 = chunk * KR;
    __syncthreads();
    for (int e = threadIdx.x; e < KR * 4; e += blockDim.x) {
      const int r = e >> 2, o = e & 3;
      const long long row = r0 + r;
      float v = 0.f, f = 0.f;
      if (row < rows_total && o < 3) {
        v = stage ? bf_round(g[row * 3 + o]) : df1s[row * 4 + o];
        f = f1s[row * 4 + o];
      }
      s_v[e] = v;
      s_f1[e] = f;
      if (o == 0) {
        s_tok[r] = static_cast<int>(row / n);
        s_pt[r] = static_cast<int>(row % n);
      }
    }
    __syncthreads();
    for (int r = rsub; r < KR; r += 256 / WT) {
      const long long row = r0 + r;
      float a = 0.f, d = 0.f;
      if (row < rows_total) {
        const size_t t2f = size_t(s_tok[r]) * 2 * F;
        if (stage) {
          const float pp = (s_f1[r * 4] * e0 + s_f1[r * 4 + 1] * e1) + s_f1[r * 4 + 2] * e2;
          a = (pp + sp[t2f + F + ci]) + bi;
        } else {
          a = (__bfloat162float(gp1[s_pt[r] * F + ci]) + sp[t2f + ci]) + bi;
        }
        if (mg[row * MW + word] & bit)
          d = (s_v[r * 4] * w0 + s_v[r * 4 + 1] * w1) + s_v[r * 4 + 2] * w2;
      }
      s_at[r * LDT + c] = __float2bfloat16(fmaxf(a, 0.f));
      s_dt[r * LDT + c] = __float2bfloat16(d);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KR / 16; ++kk) {
      FragAT fa[2];
      FragB fb[4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        wmma::load_matrix_sync(fa[a], s_at + kk * 16 * LDT + (wi * 2 + a) * 16, LDT);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        wmma::load_matrix_sync(fb[b], s_dt + kk * 16 * LDT + (wj * 4 + b) * 16, LDT);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
    }
  }

  float* dk = dkp + (size_t(stage) * parts + part) * F * F;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      wmma::store_matrix_sync(dk + size_t(i0 + (wi * 2 + a) * 16) * F + j0 + (wj * 4 + b) * 16,
                              acc[a][b], F, wmma::mem_row_major);
}

// ------------------------------------------------- small GEMMs and the sums

// C (M, N) f32 = op(A) @ op(B), bf16 operands read from global memory:
//   TA false: A (M, K) row-major; true: A (K, M) row-major (C = A^T @ ...)
//   TB false: B (K, N) row-major; true: B (N, K) row-major (C = ... @ B^T)
// M, N multiples of 64, K of 16. One 64 x 64 tile a block, 4 warps.
template <bool TA, bool TB>
__global__ void __launch_bounds__(128)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ C,
            int M, int N, int K) {
  const int warp = threadIdx.x >> 5;
  const int m0 = blockIdx.y * GT + warp * 16, n0 = blockIdx.x * GT;
  FragC acc[GT / 16];
#pragma unroll
  for (int i = 0; i < GT / 16; ++i) wmma::fill_fragment(acc[i], 0.f);
  for (int kk = 0; kk < K / 16; ++kk) {
    typename std::conditional<TA, FragAT, FragA>::type a;
    if (TA)
      wmma::load_matrix_sync(a, A + size_t(kk) * 16 * M + m0, M);
    else
      wmma::load_matrix_sync(a, A + size_t(m0) * K + kk * 16, K);
#pragma unroll
    for (int i = 0; i < GT / 16; ++i) {
      typename std::conditional<TB, FragBT, FragB>::type b;
      if (TB)
        wmma::load_matrix_sync(b, B + size_t(n0 + i * 16) * K + kk * 16, K);
      else
        wmma::load_matrix_sync(b, B + size_t(kk) * 16 * N + n0 + i * 16, N);
      wmma::mma_sync(acc[i], a, b, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < GT / 16; ++i)
    wmma::store_matrix_sync(C + size_t(m0) * N + n0 + i * 16, acc[i], N, wmma::mem_row_major);
}

template <bool TA, bool TB>
cudaError_t gemm(const bf16* A, const bf16* B, float* C, int M, int N, int K,
                 cudaStream_t stream) {
  gemm_kernel<TA, TB><<<dim3(N / GT, M / GT), 128, 0, stream>>>(A, B, C, M, N, K);
  return cudaGetLastError();
}

__global__ void sum_partials_kernel(const float* __restrict__ in, int parts, long long n,
                                    float* __restrict__ out) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += in[p * n + e];
    out[e] = s;
  }
}

cudaError_t sum_partials(const float* in, int parts, long long n, float* out,
                         cudaStream_t stream) {
  const long long want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  sum_partials_kernel<<<blocks, 256, 0, stream>>>(in, parts, n, out);
  return cudaGetLastError();
}

bool shape_ok(int Tp, int C, int F, int n) {
  return Tp > 0 && Tp % GT == 0 && C > 0 && C % 128 == 0 && F > 0 && F % 128 == 0 &&
         F <= F_MAX && n >= 2 && n <= 64;
}

}  // namespace

// xb (Tp, C) bf16, ksc (C, 2F) bf16 = [ks1 | ks2], gp1 (n, F) bf16, k11 and
// k12 (F, F) bf16, small (13 F + 8) f32; scratch sp (Tp, 2F) f32;
// out (Tp * n, 3) f32.
PDAE_EXPORT int folding_fwd(const void* xb, const void* ksc, const void* gp1, const void* k11,
                            const void* k12, const float* small, float* sp, float* out,
                            int Tp, int C, int F, int n, void* stream) {
  if (!shape_ok(Tp, C, F, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = gemm<false, false>(static_cast<const bf16*>(xb),
                                       static_cast<const bf16*>(ksc), sp, Tp, 2 * F, C, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = FwdLayout(MR_FWD, F).bytes;
  if ((err = set_smem(fold_fwd_kernel<MR_FWD>, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int tok = MR_FWD / n;
  fold_fwd_kernel<MR_FWD><<<(Tp + tok - 1) / tok, MR_FWD / 16 * 64, smem, s>>>(
      sp, static_cast<const bf16*>(gp1), static_cast<const bf16*>(k11),
      static_cast<const bf16*>(k12), small, out, Tp, F, n);
  return static_cast<int>(cudaGetLastError());
}

// g (Tp * n, 3) f32. Scratch: sp (Tp, 2F) f32; f1s, df1s (Tp * n, 4) f32;
// m1, m3 (Tp * n, F / 32) mask words; a1s (blocks, MR_BWD, F) bf16;
// dspb (Tp, 2F) bf16; part_a (blocks, n F + 12 F + 4) f32, zeroed by the
// caller; dkp (2, parts, F, F) f32.
// Outputs, f32: dx (Tp, C); dksc (C, 2F); rows (n F + 12 F + 4) = dgp1 | db02 |
// dke2 | db12 | dk22 | db11 | dk21 | db21; dk (2, F, F) = dk11, dk12.
PDAE_EXPORT int folding_bwd(const void* xb, const void* ksc, const void* gp1, const void* k11,
                            const void* k12, const float* small, const float* g, float* sp,
                            float* f1s, float* df1s, void* m1, void* m3, void* a1s,
                            void* dspb, float* part_a, float* dkp, float* dx, float* dksc,
                            float* rows, float* dk, int Tp, int C, int F, int n, int blocks,
                            int parts, void* stream) {
  if (!shape_ok(Tp, C, F, n) || blocks < 1 || parts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(xb);
  const bf16* ks = static_cast<const bf16*>(ksc);
  const bf16* gp = static_cast<const bf16*>(gp1);
  bf16* dsp = static_cast<bf16*>(dspb);
  unsigned* m1w = static_cast<unsigned*>(m1);
  unsigned* m3w = static_cast<unsigned*>(m3);
  cudaError_t err = gemm<false, false>(x, ks, sp, Tp, 2 * F, C, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int tok = MR_BWD / n;
  const int ntiles = (Tp + tok - 1) / tok;
  const size_t smem_r = RowsLayout(MR_BWD, F).bytes;
  if ((err = set_smem(fold_bwd_rows_kernel<MR_BWD>, smem_r)) != cudaSuccess)
    return static_cast<int>(err);
  fold_bwd_rows_kernel<MR_BWD><<<blocks < ntiles ? blocks : ntiles, MR_BWD / 16 * 64, smem_r,
                                 s>>>(sp, gp, static_cast<const bf16*>(k11),
                                      static_cast<const bf16*>(k12), small, g, f1s, df1s, m1w,
                                      m3w, static_cast<bf16*>(a1s), dsp, part_a, Tp, F, n,
                                      ntiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const long long rows_total = static_cast<long long>(Tp) * n;
  const long long nchunks = (rows_total + KR - 1) / KR;
  const int tiles = (F / WT) * (F / WT);
  fold_bwd_weights_kernel<<<dim3(tiles, parts, 2), 256, 0, s>>>(
      sp, gp, small, g, f1s, df1s, m1w, m3w, dkp, rows_total, F, n,
      static_cast<int>((nchunks + parts - 1) / parts));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  if ((err = gemm<false, true>(dsp, ks, dx, Tp, C, 2 * F, s)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = gemm<true, false>(x, dsp, dksc, C, 2 * F, Tp, s)) != cudaSuccess)
    return static_cast<int>(err);

  const long long na = static_cast<long long>(n) * F + 12 * F + 4;
  if ((err = sum_partials(part_a, blocks, na, rows, s)) != cudaSuccess)
    return static_cast<int>(err);
  const long long ff = static_cast<long long>(F) * F;
  for (int st = 0; st < 2; ++st)
    if ((err = sum_partials(dkp + st * parts * ff, parts, ff, dk + st * ff, s)) != cudaSuccess)
      return static_cast<int>(err);
  return static_cast<int>(cudaSuccess);
}
