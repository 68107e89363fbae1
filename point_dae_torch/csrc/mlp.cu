// The ViT block's MLP, forward and backward, in two forms:
//   mlp_ln: y = x + s * (GELU_erf(LN(x) @ k1 + b1) @ k2 + b2), the pre-norm
//     sub-block with LayerNorm, stochastic-depth row scale and residual;
//     x, y f32 (R, C); LN eps as given (flax: 1e-6), var = E[x^2] - E[x]^2;
//     s an optional per-row scale.
//   mlp: out = GELU_erf(x @ k1 + b1) @ k2 + b2 alone, x bf16 (R, C), out
//     f32 (R, C); the block takes it when its residual stream is not f32.
// k1 (C, H) and k2 (H, C) bf16; products in bf16 with f32 accumulation;
// GELU in f32 with erff (the TPU kernels use the Abramowitz-Stegun erf,
// 1.5e-7 from it).
//
// Replaces point_dae_tpu/ops/pallas_mlp.py:fused_mlp_ln (_fwd_ln_kernel and
// _bwd_ln_kernel) and fused_mlp (_fwd_kernel and _bwd_kernel).
//
// Design (C in 128, 256, 384; wider rows take the wide form further down,
// a few plain tiled products a direction). A block owns 64 rows. The forward puts them into shared memory
// as bf16 (mlp_ln: normalised), then walks the hidden dimension in chunks:
// h = x @ k1c, GELU, out += a @ k2c. The (64, H) hidden never leaves the
// chip, as in the TPU kernels. Products are WMMA 16x16x16 bf16 fragments
// with f32 accumulators; the (64, C) output accumulator stays in registers
// across the chunks.
// The TPU backwards accumulated the weight gradients over a sequential
// grid, which Hopper does not have. Here each is three launches, none with
// atomics, so the sums are the same from run to run:
//   A (one block per 64 rows): recompute the hidden chunk by chunk and
//     dx = dh @ k1^T (mlp_ln: through the LN backward); write the branch
//     cotangent as bf16 (R, C) scratch (mlp_ln: and LN(x)) and per-block
//     partial column sums (mlp_ln: dgamma, dbeta, db2; mlp: db2).
//   B (one block per hidden chunk and row partition): recompute h and dh
//     from the bf16 rows and cotangent, accumulate dk1 (C, chunk), dk2
//     (chunk, C) and db1 over the partition's rows in registers, write
//     per-partition partials. Both forms share it.
//   C: sum the partials (dk1 and dk2 rounded to bf16, as the TPU kernels'
//     callers round them).
//
// Bound on the H100: operations. At the flagship decoder shape (R 16384,
// C 384, H 1536) the forward is 39 GFLOP of bf16 products against 50 MB
// moved; the backward 97 GFLOP. These plain WMMA loops without TMA, wgmma
// or pipelining reach a fraction of the tensor-core peak; that is later
// work.
#include <cuda_bf16.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int TR = 64;     // rows per block
constexpr int NT = 256;    // threads per block
constexpr int NW = NT / 32;
constexpr int HCF = 64;    // hidden chunk, forward
constexpr int HCB = 32;    // hidden chunk, backward
constexpr int PADH = 8;    // bf16 row padding (keeps 32-byte fragment alignment)
constexpr int PADF = 4;    // f32 row padding

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float gelu(float h) {
  return 0.5f * h * (1.0f + erff(h * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_grad(float h) {
  const float cdf = 0.5f * (1.0f + erff(h * 0.70710678118654752f));
  return cdf + h * 0.3989422804014327f * expf(-0.5f * h * h);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows x cols bf16 tile, global row stride gld -> shared row stride sld;
// cols and both strides are multiples of 8 (16-byte vectors).
__device__ __forceinline__ void load_tile(bf16* dst, int sld, const bf16* src,
                                          size_t gld, int rows, int cols) {
  const int vpr = cols / 8;
  for (int v = threadIdx.x; v < rows * vpr; v += NT) {
    const int r = v / vpr, c = (v % vpr) * 8;
    *reinterpret_cast<uint4*>(dst + r * sld + c) =
        *reinterpret_cast<const uint4*>(src + r * gld + c);
  }
}

// LayerNorm statistics of one row held as V values a lane (c = lane + 32k).
template <int C>
__device__ __forceinline__ void row_stats(const float (&v)[C / 32], float eps,
                                          float& mu, float& rs) {
  float s = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < C / 32; ++k) {
    s += v[k];
    s2 += v[k] * v[k];
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  mu = s / C;
  rs = rsqrtf(s2 / C - mu * mu + eps);
}

// ------------------------------------------------------------------ forward

template <int C>
struct FwdLayout {
  static constexpr int LDH = C + PADH;     // hin     (TR, C)  bf16
  static constexpr int LDK1 = HCF + PADH;  // k1 chunk (C, HCF) bf16
  static constexpr int LDK2 = C + PADH;    // k2 chunk (HCF, C) bf16
  static constexpr int LDHF = HCF + PADF;  // h       (TR, HCF) f32
  static constexpr int LDA = HCF + PADH;   // gelu(h) (TR, HCF) bf16
  static constexpr int LDO = C + PADF;     // output  (TR, C)  f32, over hin..k2
  static constexpr size_t HIN = 0;
  static constexpr size_t K1 = align128(HIN + size_t(TR) * LDH * 2);
  static constexpr size_t K2 = align128(K1 + size_t(C) * LDK1 * 2);
  static constexpr size_t HF = align128(K2 + size_t(HCF) * LDK2 * 2);
  static constexpr size_t A = align128(HF + size_t(TR) * LDHF * 4);
  static constexpr size_t BYTES = align128(A + size_t(TR) * LDA * 2);
  static_assert(size_t(TR) * LDO * 4 <= HF, "output tile must fit over hin, k1, k2");
};

// The forward's hidden loop over the block's 64 bf16 rows in shared memory
// (hin): GELU(hin @ k1 + b1) @ k2 chunk by chunk, then the (64, C) result
// in f32 at s_out (over hin, k1 and k2) with a barrier after it.
template <int C>
__device__ __forceinline__ void fwd_hidden(unsigned char* smem, const bf16* __restrict__ k1,
                                           const float* __restrict__ b1,
                                           const bf16* __restrict__ k2, int H) {
  using L = FwdLayout<C>;
  constexpr int NF = C / 32;  // output column fragments a warp owns
  const bf16* s_hin = reinterpret_cast<const bf16*>(smem + L::HIN);
  bf16* s_k1 = reinterpret_cast<bf16*>(smem + L::K1);
  bf16* s_k2 = reinterpret_cast<bf16*>(smem + L::K2);
  float* s_h = reinterpret_cast<float*>(smem + L::HF);
  bf16* s_a = reinterpret_cast<bf16*>(smem + L::A);
  float* s_out = reinterpret_cast<float*>(smem);

  const int warp = threadIdx.x >> 5;
  const int rw = warp & 3, half = warp >> 2;
  FragC acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int h0 = 0; h0 < H; h0 += HCF) {
    __syncthreads();
    load_tile(s_k1, L::LDK1, k1 + h0, H, C, HCF);
    load_tile(s_k2, L::LDK2, k2 + size_t(h0) * C, C, HCF, C);
    __syncthreads();
#pragma unroll
    for (int f = 0; f < HCF / 32; ++f) {
      const int cf = half * (HCF / 32) + f;
      FragC hacc;
      wmma::fill_fragment(hacc, 0.f);
#pragma unroll 4
      for (int kk = 0; kk < C / 16; ++kk) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, s_hin + rw * 16 * L::LDH + kk * 16, L::LDH);
        wmma::load_matrix_sync(b, s_k1 + kk * 16 * L::LDK1 + cf * 16, L::LDK1);
        wmma::mma_sync(hacc, a, b, hacc);
      }
      wmma::store_matrix_sync(s_h + rw * 16 * L::LDHF + cf * 16, hacc, L::LDHF,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < TR * HCF; e += NT) {
      const int r = e / HCF, c = e % HCF;
      s_a[r * L::LDA + c] = __float2bfloat16(gelu(s_h[r * L::LDHF + c] + b1[h0 + c]));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HCF / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, s_a + rw * 16 * L::LDA + kk * 16, L::LDA);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, s_k2 + kk * 16 * L::LDK2 + (half * NF + j) * 16, L::LDK2);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(s_out + rw * 16 * L::LDO + (half * NF + j) * 16, acc[j],
                            L::LDO, wmma::mem_row_major);
  __syncthreads();
}

template <int C>
__global__ void __launch_bounds__(NT, 1)
mlp_ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gm,
                  const float* __restrict__ bt, const bf16* __restrict__ k1,
                  const float* __restrict__ b1, const bf16* __restrict__ k2,
                  const float* __restrict__ b2, const float* __restrict__ sc,
                  float* __restrict__ y, int H, float eps) {
  using L = FwdLayout<C>;
  constexpr int V = C / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_hin = reinterpret_cast<bf16*>(smem + L::HIN);
  const float* s_out = reinterpret_cast<const float*>(smem);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t r0 = size_t(blockIdx.x) * TR;

  for (int rr = warp; rr < TR; rr += NW) {
    const float* xr = x + (r0 + rr) * C;
    float v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = xr[lane + 32 * k];
    float mu, rs;
    row_stats<C>(v, eps, mu, rs);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      s_hin[rr * L::LDH + c] = __float2bfloat16((v[k] - mu) * rs * gm[c] + bt[c]);
    }
  }
  fwd_hidden<C>(smem, k1, b1, k2, H);
  for (int e = threadIdx.x; e < TR * C; e += NT) {
    const int r = e / C, c = e % C;
    float v = s_out[r * L::LDO + c] + b2[c];
    if (sc != nullptr) v *= sc[r0 + r];
    y[(r0 + r) * C + c] = x[(r0 + r) * C + c] + v;
  }
}

// out = GELU(x @ k1 + b1) @ k2 + b2 for x already bf16.
template <int C>
__global__ void __launch_bounds__(NT, 1)
mlp_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ k1,
               const float* __restrict__ b1, const bf16* __restrict__ k2,
               const float* __restrict__ b2, float* __restrict__ y, int H) {
  using L = FwdLayout<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* s_out = reinterpret_cast<const float*>(smem);
  const size_t r0 = size_t(blockIdx.x) * TR;

  load_tile(reinterpret_cast<bf16*>(smem + L::HIN), L::LDH, x + r0 * C, C, TR, C);
  fwd_hidden<C>(smem, k1, b1, k2, H);
  for (int e = threadIdx.x; e < TR * C; e += NT) {
    const int r = e / C, c = e % C;
    y[(r0 + r) * C + c] = s_out[r * L::LDO + c] + b2[c];
  }
}

// ------------------------------------------------------- backward, pass A

template <int C>
struct BwdALayout {
  static constexpr int LDH = C + PADH;     // hin      (TR, C)  bf16
  static constexpr int LDG = C + PADH;     // s * g    (TR, C)  bf16
  static constexpr int LDK1 = HCB + PADH;  // k1 chunk (C, HCB) bf16
  static constexpr int LDK2 = C + PADH;    // k2 chunk (HCB, C) bf16
  static constexpr int LDHF = HCB + PADF;  // h, da    (TR, HCB) f32
  static constexpr int LDDH = HCB + PADH;  // dh       (TR, HCB) bf16
  static constexpr int LDO = C + PADF;     // dxin     (TR, C) f32, over hin and g
  static constexpr size_t HIN = 0;
  static constexpr size_t G = align128(HIN + size_t(TR) * LDH * 2);
  static constexpr size_t K1 = align128(G + size_t(TR) * LDG * 2);
  static constexpr size_t K2 = align128(K1 + size_t(C) * LDK1 * 2);
  static constexpr size_t HF = align128(K2 + size_t(HCB) * LDK2 * 2);
  static constexpr size_t DA = align128(HF + size_t(TR) * LDHF * 4);
  static constexpr size_t DH = align128(DA + size_t(TR) * LDHF * 4);
  static constexpr size_t BYTES = align128(DH + size_t(TR) * LDDH * 2);
  static constexpr size_t WPART = align128(size_t(TR) * LDO * 4);  // NW x 3 x C f32
  static_assert(size_t(TR) * LDO * 4 <= K1, "dxin tile must fit over hin and g");
  static_assert(WPART + size_t(NW) * 3 * C * 4 <= BYTES, "warp partials must fit");
};

// The rows pass's hidden loop over the block's 64 bf16 rows (hin) and
// bf16 branch cotangent (g) in shared memory: recompute h chunk by chunk,
// dh = (g @ k2^T) * GELU'(h + b1) rounded to bf16, and dxin = dh @ k1^T,
// left in f32 at s_dx (over hin and g) with a barrier after it.
template <int C>
__device__ __forceinline__ void bwd_rows_hidden(unsigned char* smem,
                                                const bf16* __restrict__ k1,
                                                const float* __restrict__ b1,
                                                const bf16* __restrict__ k2, int H) {
  using L = BwdALayout<C>;
  constexpr int NF = C / 32;
  const bf16* s_hin = reinterpret_cast<const bf16*>(smem + L::HIN);
  const bf16* s_g = reinterpret_cast<const bf16*>(smem + L::G);
  bf16* s_k1 = reinterpret_cast<bf16*>(smem + L::K1);
  bf16* s_k2 = reinterpret_cast<bf16*>(smem + L::K2);
  float* s_h = reinterpret_cast<float*>(smem + L::HF);
  float* s_da = reinterpret_cast<float*>(smem + L::DA);
  bf16* s_dh = reinterpret_cast<bf16*>(smem + L::DH);
  float* s_dx = reinterpret_cast<float*>(smem);

  const int warp = threadIdx.x >> 5;
  const int rw = warp & 3, half = warp >> 2, cf = warp >> 2;
  FragC acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int h0 = 0; h0 < H; h0 += HCB) {
    __syncthreads();
    load_tile(s_k1, L::LDK1, k1 + h0, H, C, HCB);
    load_tile(s_k2, L::LDK2, k2 + size_t(h0) * C, C, HCB, C);
    __syncthreads();
    {
      FragC hacc, dacc;
      wmma::fill_fragment(hacc, 0.f);
      wmma::fill_fragment(dacc, 0.f);
#pragma unroll 4
      for (int kk = 0; kk < C / 16; ++kk) {
        FragA a, ga;
        FragB b;
        FragBT bt2;
        wmma::load_matrix_sync(a, s_hin + rw * 16 * L::LDH + kk * 16, L::LDH);
        wmma::load_matrix_sync(b, s_k1 + kk * 16 * L::LDK1 + cf * 16, L::LDK1);
        wmma::mma_sync(hacc, a, b, hacc);
        wmma::load_matrix_sync(ga, s_g + rw * 16 * L::LDG + kk * 16, L::LDG);
        wmma::load_matrix_sync(bt2, s_k2 + cf * 16 * L::LDK2 + kk * 16, L::LDK2);
        wmma::mma_sync(dacc, ga, bt2, dacc);
      }
      wmma::store_matrix_sync(s_h + rw * 16 * L::LDHF + cf * 16, hacc, L::LDHF,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(s_da + rw * 16 * L::LDHF + cf * 16, dacc, L::LDHF,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < TR * HCB; e += NT) {
      const int r = e / HCB, c = e % HCB;
      const float h = s_h[r * L::LDHF + c] + b1[h0 + c];
      s_dh[r * L::LDDH + c] = __float2bfloat16(s_da[r * L::LDHF + c] * gelu_grad(h));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HCB / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, s_dh + rw * 16 * L::LDDH + kk * 16, L::LDDH);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        FragBT b;
        wmma::load_matrix_sync(b, s_k1 + (half * NF + j) * 16 * L::LDK1 + kk * 16, L::LDK1);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(s_dx + rw * 16 * L::LDO + (half * NF + j) * 16, acc[j],
                            L::LDO, wmma::mem_row_major);
  __syncthreads();

}

template <int C>
__global__ void __launch_bounds__(NT, 1)
mlp_ln_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ gm,
                       const float* __restrict__ bt, const bf16* __restrict__ k1,
                       const float* __restrict__ b1, const bf16* __restrict__ k2,
                       const float* __restrict__ sc, const float* __restrict__ g,
                       float* __restrict__ dx, bf16* __restrict__ hin_out,
                       bf16* __restrict__ gbr_out, float* __restrict__ part,
                       int H, float eps) {
  using L = BwdALayout<C>;
  constexpr int V = C / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_hin = reinterpret_cast<bf16*>(smem + L::HIN);
  bf16* s_g = reinterpret_cast<bf16*>(smem + L::G);
  const float* s_dx = reinterpret_cast<const float*>(smem);
  float* s_wpart = reinterpret_cast<float*>(smem + L::WPART);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t r0 = size_t(blockIdx.x) * TR;

  // LN(x) and the branch cotangent s * g, to shared memory and to scratch
  for (int rr = warp; rr < TR; rr += NW) {
    const size_t row = (r0 + rr) * C;
    float v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = x[row + lane + 32 * k];
    float mu, rs;
    row_stats<C>(v, eps, mu, rs);
    const float srow = sc != nullptr ? sc[r0 + rr] : 1.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      const bf16 hb = __float2bfloat16((v[k] - mu) * rs * gm[c] + bt[c]);
      const bf16 gb = __float2bfloat16(g[row + c] * srow);
      s_hin[rr * L::LDH + c] = hb;
      s_g[rr * L::LDG + c] = gb;
      hin_out[row + c] = hb;
      gbr_out[row + c] = gb;
    }
  }

  bwd_rows_hidden<C>(smem, k1, b1, k2, H);

  // row-local LayerNorm backward; column partials of dgamma, dbeta, db2
  float pg[V], pb[V], p2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) pg[k] = pb[k] = p2[k] = 0.f;
  for (int rr = warp; rr < TR; rr += NW) {
    const size_t row = (r0 + rr) * C;
    float v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = x[row + lane + 32 * k];
    float mu, rs;
    row_stats<C>(v, eps, mu, rs);
    const float srow = sc != nullptr ? sc[r0 + rr] : 1.f;
    float xh[V], dxh[V];
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      const float dxin = s_dx[rr * L::LDO + c];
      xh[k] = (v[k] - mu) * rs;
      dxh[k] = dxin * gm[c];
      m1 += dxh[k];
      m2 += dxh[k] * xh[k];
      pg[k] += dxin * xh[k];
      pb[k] += dxin;
    }
    m1 = warp_sum(m1) / C;
    m2 = warp_sum(m2) / C;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      const float gk = g[row + c];
      p2[k] += gk * srow;
      dx[row + c] = gk + rs * (dxh[k] - m1 - xh[k] * m2);
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = lane + 32 * k;
    s_wpart[(warp * 3 + 0) * C + c] = pg[k];
    s_wpart[(warp * 3 + 1) * C + c] = pb[k];
    s_wpart[(warp * 3 + 2) * C + c] = p2[k];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * C; e += NT) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += s_wpart[w * 3 * C + e];
    part[size_t(blockIdx.x) * 3 * C + e] = s;
  }
}

// The rows pass of mlp: x already bf16, the cotangent unscaled; dx out in
// bf16 (as the TPU kernel's caller rounds it) and per-block column sums of
// g (db2 partials).
template <int C>
__global__ void __launch_bounds__(NT, 1)
mlp_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ k1,
                    const float* __restrict__ b1, const bf16* __restrict__ k2,
                    const float* __restrict__ g, bf16* __restrict__ dx,
                    bf16* __restrict__ gbr_out, float* __restrict__ part, int H) {
  using L = BwdALayout<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_g = reinterpret_cast<bf16*>(smem + L::G);
  const float* s_dx = reinterpret_cast<const float*>(smem);
  const size_t r0 = size_t(blockIdx.x) * TR;

  load_tile(reinterpret_cast<bf16*>(smem + L::HIN), L::LDH, x + r0 * C, C, TR, C);
  for (int e = threadIdx.x; e < TR * C; e += NT) {
    const int r = e / C, c = e % C;
    const bf16 gb = __float2bfloat16(g[(r0 + r) * C + c]);
    s_g[r * L::LDG + c] = gb;
    gbr_out[(r0 + r) * C + c] = gb;
  }
  bwd_rows_hidden<C>(smem, k1, b1, k2, H);
  for (int e = threadIdx.x; e < TR * C; e += NT) {
    const int r = e / C, c = e % C;
    dx[(r0 + r) * C + c] = __float2bfloat16(s_dx[r * L::LDO + c]);
  }
  for (int c = threadIdx.x; c < C; c += NT) {
    float sum = 0.f;
    for (int r = 0; r < TR; ++r) sum += g[(r0 + r) * C + c];
    part[size_t(blockIdx.x) * C + c] = sum;
  }
}

// ------------------------------------------------------- backward, pass B

template <int C>
struct BwdBLayout {
  static constexpr int LDH = C + PADH;     // hin tile  (TR, C)  bf16
  static constexpr int LDG = C + PADH;     // s*g tile  (TR, C)  bf16
  static constexpr int LDK1 = HCB + PADH;  // k1 chunk  (C, HCB) bf16
  static constexpr int LDK2 = C + PADH;    // k2 chunk  (HCB, C) bf16
  static constexpr int LDHF = HCB + PADF;  // h, da->dh (TR, HCB) f32
  static constexpr int LDA = HCB + PADH;   // gelu(h), dh (TR, HCB) bf16
  static constexpr size_t HIN = 0;
  static constexpr size_t G = align128(HIN + size_t(TR) * LDH * 2);
  static constexpr size_t K1 = align128(G + size_t(TR) * LDG * 2);
  static constexpr size_t K2 = align128(K1 + size_t(C) * LDK1 * 2);
  static constexpr size_t HF = align128(K2 + size_t(HCB) * LDK2 * 2);
  static constexpr size_t DH32 = align128(HF + size_t(TR) * LDHF * 4);
  static constexpr size_t A = align128(DH32 + size_t(TR) * LDHF * 4);
  static constexpr size_t DHB = align128(A + size_t(TR) * LDA * 2);
  static constexpr size_t BYTES = align128(DHB + size_t(TR) * LDA * 2);
};

template <int C>
__global__ void __launch_bounds__(NT, 1)
mlp_bwd_weights_kernel(const bf16* __restrict__ hin, const bf16* __restrict__ gbr,
                          const bf16* __restrict__ k1, const float* __restrict__ b1,
                          const bf16* __restrict__ k2, float* __restrict__ dk1p,
                          float* __restrict__ dk2p, float* __restrict__ db1p,
                          int R, int H, int tiles_per_part) {
  using L = BwdBLayout<C>;
  constexpr int NF2 = C / 64;  // fragments a warp owns in dk1 and in dk2
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_hin = reinterpret_cast<bf16*>(smem + L::HIN);
  bf16* s_g = reinterpret_cast<bf16*>(smem + L::G);
  bf16* s_k1 = reinterpret_cast<bf16*>(smem + L::K1);
  bf16* s_k2 = reinterpret_cast<bf16*>(smem + L::K2);
  float* s_h = reinterpret_cast<float*>(smem + L::HF);
  float* s_dh32 = reinterpret_cast<float*>(smem + L::DH32);
  bf16* s_a = reinterpret_cast<bf16*>(smem + L::A);
  bf16* s_dhb = reinterpret_cast<bf16*>(smem + L::DHB);

  const int warp = threadIdx.x >> 5;
  const int tid = threadIdx.x;
  const int h0 = blockIdx.x * HCB;
  const int p = blockIdx.y;
  const int n_tiles = R / TR;
  const int t_begin = p * tiles_per_part;
  const int t_end = min(n_tiles, t_begin + tiles_per_part);

  load_tile(s_k1, L::LDK1, k1 + h0, H, C, HCB);
  load_tile(s_k2, L::LDK2, k2 + size_t(h0) * C, C, HCB, C);

  const int rw = warp & 3, cf = warp >> 2;   // h / da fragment of this warp
  const int sub = warp & 1;                  // 16-wide slice of the chunk
  const int base = (warp >> 1) * NF2;        // first C-fragment of this warp
  FragC acc2[NF2], acc1[NF2];
#pragma unroll
  for (int j = 0; j < NF2; ++j) {
    wmma::fill_fragment(acc2[j], 0.f);
    wmma::fill_fragment(acc1[j], 0.f);
  }
  float db1 = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();
    load_tile(s_hin, L::LDH, hin + size_t(t) * TR * C, C, TR, C);
    load_tile(s_g, L::LDG, gbr + size_t(t) * TR * C, C, TR, C);
    __syncthreads();
    {
      FragC hacc, dacc;
      wmma::fill_fragment(hacc, 0.f);
      wmma::fill_fragment(dacc, 0.f);
#pragma unroll 4
      for (int kk = 0; kk < C / 16; ++kk) {
        FragA a, ga;
        FragB b;
        FragBT bt2;
        wmma::load_matrix_sync(a, s_hin + rw * 16 * L::LDH + kk * 16, L::LDH);
        wmma::load_matrix_sync(b, s_k1 + kk * 16 * L::LDK1 + cf * 16, L::LDK1);
        wmma::mma_sync(hacc, a, b, hacc);
        wmma::load_matrix_sync(ga, s_g + rw * 16 * L::LDG + kk * 16, L::LDG);
        wmma::load_matrix_sync(bt2, s_k2 + cf * 16 * L::LDK2 + kk * 16, L::LDK2);
        wmma::mma_sync(dacc, ga, bt2, dacc);
      }
      wmma::store_matrix_sync(s_h + rw * 16 * L::LDHF + cf * 16, hacc, L::LDHF,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(s_dh32 + rw * 16 * L::LDHF + cf * 16, dacc, L::LDHF,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = tid; e < TR * HCB; e += NT) {
      const int r = e / HCB, c = e % HCB;
      const float h = s_h[r * L::LDHF + c] + b1[h0 + c];
      const float dh = s_dh32[r * L::LDHF + c] * gelu_grad(h);
      s_dh32[r * L::LDHF + c] = dh;
      s_a[r * L::LDA + c] = __float2bfloat16(gelu(h));
      s_dhb[r * L::LDA + c] = __float2bfloat16(dh);
    }
    __syncthreads();
    if (tid < HCB)
      for (int r = 0; r < TR; ++r) db1 += s_dh32[r * L::LDHF + tid];
#pragma unroll
    for (int kk = 0; kk < TR / 16; ++kk) {
      // dk2 (HCB, C) += gelu(h)^T @ (s*g)
      FragAT at;
      wmma::load_matrix_sync(at, s_a + kk * 16 * L::LDA + sub * 16, L::LDA);
#pragma unroll
      for (int j = 0; j < NF2; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, s_g + kk * 16 * L::LDG + (base + j) * 16, L::LDG);
        wmma::mma_sync(acc2[j], at, b, acc2[j]);
      }
      // dk1 (C, HCB) += hin^T @ dh
      FragB bd;
      wmma::load_matrix_sync(bd, s_dhb + kk * 16 * L::LDA + sub * 16, L::LDA);
#pragma unroll
      for (int i = 0; i < NF2; ++i) {
        FragAT ah;
        wmma::load_matrix_sync(ah, s_hin + kk * 16 * L::LDH + (base + i) * 16, L::LDH);
        wmma::mma_sync(acc1[i], ah, bd, acc1[i]);
      }
    }
  }

  float* dk2_part = dk2p + size_t(p) * H * C;
  float* dk1_part = dk1p + size_t(p) * C * H;
#pragma unroll
  for (int j = 0; j < NF2; ++j) {
    wmma::store_matrix_sync(dk2_part + size_t(h0 + sub * 16) * C + (base + j) * 16,
                            acc2[j], C, wmma::mem_row_major);
    wmma::store_matrix_sync(dk1_part + size_t(base + j) * 16 * H + h0 + sub * 16,
                            acc1[j], H, wmma::mem_row_major);
  }
  if (tid < HCB) db1p[size_t(p) * H + h0 + tid] = db1;
}

// ----------------------------------------------- backward, pass C (reduce)

__global__ void sum_partials_kernel(const float* __restrict__ in, int parts,
                                    long long n, float* __restrict__ out_f32,
                                    bf16* __restrict__ out_bf16) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += in[p * n + e];
    if (out_bf16 != nullptr)
      out_bf16[e] = __float2bfloat16(s);
    else
      out_f32[e] = s;
  }
}

cudaError_t sum_partials(const float* in, int parts, long long n, float* out_f32,
                         bf16* out_bf16, cudaStream_t stream) {
  const long long want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  sum_partials_kernel<<<blocks, 256, 0, stream>>>(in, parts, n, out_f32, out_bf16);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_fwd(const float* x, const float* gm, const float* bt, const bf16* k1,
                       const float* b1, const bf16* k2, const float* b2, const float* sc,
                       float* y, int R, int H, float eps, cudaStream_t stream) {
  const size_t smem = FwdLayout<C>::BYTES;
  cudaError_t err = set_smem(mlp_ln_fwd_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  mlp_ln_fwd_kernel<C><<<R / TR, NT, smem, stream>>>(x, gm, bt, k1, b1, k2, b2, sc, y, H, eps);
  return cudaGetLastError();
}

// Pass B over the bf16 rows and cotangent; per-partition partials.
template <int C>
cudaError_t launch_bwd_weights(const bf16* hin_s, const bf16* gbr_s, const bf16* k1,
                               const float* b1, const bf16* k2, float* dk1p, float* dk2p,
                               float* db1p, int R, int H, int P, cudaStream_t stream) {
  const size_t smem_b = BwdBLayout<C>::BYTES;
  cudaError_t err = set_smem(mlp_bwd_weights_kernel<C>, smem_b);
  if (err != cudaSuccess) return err;
  const int n_tiles = R / TR;
  const int tpp = (n_tiles + P - 1) / P;
  mlp_bwd_weights_kernel<C><<<dim3(H / HCB, P), NT, smem_b, stream>>>(
      hin_s, gbr_s, k1, b1, k2, dk1p, dk2p, db1p, R, H, tpp);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_bwd(const float* x, const float* gm, const float* bt, const bf16* k1,
                       const float* b1, const bf16* k2, const float* sc, const float* g,
                       float* dx, bf16* hin_s, bf16* gbr_s, float* part_a, float* dk1p,
                       float* dk2p, float* db1p, int R, int H, int P, float eps,
                       cudaStream_t stream) {
  const size_t smem_a = BwdALayout<C>::BYTES;
  cudaError_t err = set_smem(mlp_ln_bwd_rows_kernel<C>, smem_a);
  if (err != cudaSuccess) return err;
  mlp_ln_bwd_rows_kernel<C><<<R / TR, NT, smem_a, stream>>>(
      x, gm, bt, k1, b1, k2, sc, g, dx, hin_s, gbr_s, part_a, H, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_bwd_weights<C>(hin_s, gbr_s, k1, b1, k2, dk1p, dk2p, db1p, R, H, P, stream);
}

template <int C>
cudaError_t launch_mlp_fwd(const bf16* x, const bf16* k1, const float* b1, const bf16* k2,
                           const float* b2, float* y, int R, int H, cudaStream_t stream) {
  const size_t smem = FwdLayout<C>::BYTES;
  cudaError_t err = set_smem(mlp_fwd_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  mlp_fwd_kernel<C><<<R / TR, NT, smem, stream>>>(x, k1, b1, k2, b2, y, H);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_mlp_bwd(const bf16* x, const bf16* k1, const float* b1, const bf16* k2,
                           const float* g, bf16* dx, bf16* gbr_s, float* part_a,
                           float* dk1p, float* dk2p, float* db1p, int R, int H, int P,
                           cudaStream_t stream) {
  const size_t smem_a = BwdALayout<C>::BYTES;
  cudaError_t err = set_smem(mlp_bwd_rows_kernel<C>, smem_a);
  if (err != cudaSuccess) return err;
  mlp_bwd_rows_kernel<C><<<R / TR, NT, smem_a, stream>>>(x, k1, b1, k2, g, dx, gbr_s,
                                                         part_a, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_bwd_weights<C>(x, gbr_s, k1, b1, k2, dk1p, dk2p, db1p, R, H, P, stream);
}

// Pass C for the weights: dk1, dk2 (bf16) and db1 from P partitions.
cudaError_t sum_weight_partials(const float* dk1p, const float* dk2p, const float* db1p,
                                int P, int C, int H, void* dk1, void* dk2, float* db1,
                                cudaStream_t s) {
  const long long ch = static_cast<long long>(C) * H;
  cudaError_t err = sum_partials(dk1p, P, ch, nullptr, static_cast<bf16*>(dk1), s);
  if (err != cudaSuccess) return err;
  if ((err = sum_partials(dk2p, P, ch, nullptr, static_cast<bf16*>(dk2), s)) != cudaSuccess)
    return err;
  return sum_partials(db1p, P, H, db1, nullptr, s);
}

bool shape_ok(int R, int C, int H) {
  return R > 0 && R % TR == 0 && H % HCF == 0 && (C == 128 || C == 256 || C == 384);
}

// ------------------------------------------------ the wide form, any C % 64
//
// Rows wider than 384 do not fit the one-block form (its (64, C) output
// accumulator in registers and three tiles in shared memory: about 233 KB at
// C 512). Here each direction is a few launches of one plain tiled product,
// 64 x 64 output tiles, 32-deep k chunks, WMMA bf16 fragments with f32
// accumulators, and an epilogue that rounds where the one-block form rounds:
//   forward: [LN rows to bf16], a = bf16(GELU(x @ k1 + b1)) written once
//     (R, H), then out = a @ k2 + b2 (mlp_ln: times s, plus x);
//   backward: [LN rows and bf16(s * g)], one dual product giving h and
//     da = g @ k2^T per tile, so dh = da * GELU'(h) is rounded to bf16 and
//     written with bf16(GELU(h)) and per-tile column sums of the f32 dh
//     (db1); dx from dh @ k1^T (mlp_ln: through the LN backward, one block
//     per 64 rows); dk1 = x^T @ dh and dk2 = a^T @ g, each output element
//     summed over all R rows by one block in a fixed order, then rounded to
//     bf16. No atomics.

constexpr int GT = 64;                 // output tile
constexpr int GK = 32;                 // k chunk
constexpr int GNT = 128;               // threads
constexpr int LDC = GT + PADF;         // f32 staging of an output tile

enum Epi { EPI_GELU, EPI_OUT_LN, EPI_OUT, EPI_DH, EPI_F32, EPI_BF16 };

struct EpiArgs {
  const float* bias;   // per output column (b1 or b2)
  const float* x;      // residual (EPI_OUT_LN)
  const float* sc;     // per-row scale or null (EPI_OUT_LN)
  void* out;           // f32 or bf16, row stride ldo
  bf16* out2;          // bf16(GELU(h)) (EPI_DH)
  float* part;         // per-row-tile column sums of dh (EPI_DH), row stride ldo
  int ldo;
};

// A is (M, K) row-major, or stored (K, M) when AT; B is (K, N) row-major,
// or stored (N, K) when BT. With DUAL a second product A2 @ B2 (A2 (M, K)
// row-major, B2 stored (N, K)) accumulates beside the first.
template <bool AT, bool BT, bool DUAL>
struct GemmLayout {
  static constexpr int LDA = AT ? GT + PADH : GK + PADH;
  static constexpr int LDB = BT ? GK + PADH : GT + PADH;
  static constexpr int LDA2 = GK + PADH, LDB2 = GK + PADH;
  static constexpr size_t A = 0;
  static constexpr size_t B = align128(A + size_t(AT ? GK : GT) * LDA * 2);
  static constexpr size_t A2 = align128(B + size_t(BT ? GT : GK) * LDB * 2);
  static constexpr size_t B2 = align128(A2 + (DUAL ? size_t(GT) * LDA2 * 2 : 0));
  static constexpr size_t OPS = align128(B2 + (DUAL ? size_t(GT) * LDB2 * 2 : 0));
  static constexpr size_t STAGE = align128(size_t(GT) * LDC * 4);
  static constexpr size_t STAGES = (DUAL ? 2 : 1) * STAGE;   // over the operands
  static constexpr size_t BYTES = OPS > STAGES ? OPS : STAGES;
};

// rows x cols bf16 chunk of a row-major matrix (row stride ld) -> shared
// memory (row stride sld); cols a multiple of 8.
__device__ __forceinline__ void load_chunk(bf16* dst, int sld, const bf16* src, size_t ld,
                                           int rows, int cols) {
  const int vpr = cols / 8;
  for (int v = threadIdx.x; v < rows * vpr; v += GNT) {
    const int r = v / vpr, c = (v % vpr) * 8;
    *reinterpret_cast<uint4*>(dst + r * sld + c) =
        *reinterpret_cast<const uint4*>(src + r * ld + c);
  }
}

template <bool AT, bool BT, bool DUAL, int EPI>
__global__ void __launch_bounds__(GNT)
mlp_wide_gemm_kernel(const bf16* __restrict__ A, int lda, const bf16* __restrict__ B, int ldb,
                     const bf16* __restrict__ A2, int lda2, const bf16* __restrict__ B2,
                     int ldb2, int K, EpiArgs ep) {
  using L = GemmLayout<AT, BT, DUAL>;
  __shared__ __align__(128) unsigned char smem[L::BYTES];
  bf16* s_a = reinterpret_cast<bf16*>(smem + L::A);
  bf16* s_b = reinterpret_cast<bf16*>(smem + L::B);
  bf16* s_a2 = reinterpret_cast<bf16*>(smem + L::A2);
  bf16* s_b2 = reinterpret_cast<bf16*>(smem + L::B2);
  float* s_c = reinterpret_cast<float*>(smem);
  float* s_c2 = reinterpret_cast<float*>(smem + L::STAGE);

  const int m0 = blockIdx.x * GT, n0 = blockIdx.y * GT;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  FragC acc[2][2], acc2[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0.f);
      wmma::fill_fragment(acc2[i][j], 0.f);
    }

  for (int k0 = 0; k0 < K; k0 += GK) {
    __syncthreads();
    if constexpr (AT)
      load_chunk(s_a, L::LDA, A + size_t(k0) * lda + m0, lda, GK, GT);
    else
      load_chunk(s_a, L::LDA, A + size_t(m0) * lda + k0, lda, GT, GK);
    if constexpr (BT)
      load_chunk(s_b, L::LDB, B + size_t(n0) * ldb + k0, ldb, GT, GK);
    else
      load_chunk(s_b, L::LDB, B + size_t(k0) * ldb + n0, ldb, GK, GT);
    if constexpr (DUAL) {
      load_chunk(s_a2, L::LDA2, A2 + size_t(m0) * lda2 + k0, lda2, GT, GK);
      load_chunk(s_b2, L::LDB2, B2 + size_t(n0) * ldb2 + k0, ldb2, GT, GK);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        std::conditional_t<AT, FragAT, FragA> a;
        if constexpr (AT)
          wmma::load_matrix_sync(a, s_a + kk * L::LDA + wm + 16 * i, L::LDA);
        else
          wmma::load_matrix_sync(a, s_a + (wm + 16 * i) * L::LDA + kk, L::LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          std::conditional_t<BT, FragBT, FragB> b;
          if constexpr (BT)
            wmma::load_matrix_sync(b, s_b + (wn + 16 * j) * L::LDB + kk, L::LDB);
          else
            wmma::load_matrix_sync(b, s_b + kk * L::LDB + wn + 16 * j, L::LDB);
          wmma::mma_sync(acc[i][j], a, b, acc[i][j]);
        }
        if constexpr (DUAL) {
          FragA a2;
          wmma::load_matrix_sync(a2, s_a2 + (wm + 16 * i) * L::LDA2 + kk, L::LDA2);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            FragBT b2;
            wmma::load_matrix_sync(b2, s_b2 + (wn + 16 * j) * L::LDB2 + kk, L::LDB2);
            wmma::mma_sync(acc2[i][j], a2, b2, acc2[i][j]);
          }
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(s_c + (wm + 16 * i) * LDC + wn + 16 * j, acc[i][j], LDC,
                              wmma::mem_row_major);
      if constexpr (DUAL)
        wmma::store_matrix_sync(s_c2 + (wm + 16 * i) * LDC + wn + 16 * j, acc2[i][j], LDC,
                                wmma::mem_row_major);
    }
  __syncthreads();

  for (int e = threadIdx.x; e < GT * GT; e += GNT) {
    const int r = e / GT, c = e % GT;
    const size_t o = size_t(m0 + r) * ep.ldo + n0 + c;
    const float v = s_c[r * LDC + c];
    if constexpr (EPI == EPI_GELU) {
      static_cast<bf16*>(ep.out)[o] = __float2bfloat16(gelu(v + ep.bias[n0 + c]));
    } else if constexpr (EPI == EPI_OUT_LN) {
      float u = v + ep.bias[n0 + c];
      if (ep.sc != nullptr) u *= ep.sc[m0 + r];
      static_cast<float*>(ep.out)[o] = ep.x[o] + u;
    } else if constexpr (EPI == EPI_OUT) {
      static_cast<float*>(ep.out)[o] = v + ep.bias[n0 + c];
    } else if constexpr (EPI == EPI_DH) {
      const float h = v + ep.bias[n0 + c];
      const float dh = s_c2[r * LDC + c] * gelu_grad(h);
      s_c2[r * LDC + c] = dh;
      static_cast<bf16*>(ep.out)[o] = __float2bfloat16(dh);
      ep.out2[o] = __float2bfloat16(gelu(h));
    } else if constexpr (EPI == EPI_F32) {
      static_cast<float*>(ep.out)[o] = v;
    } else {
      static_cast<bf16*>(ep.out)[o] = __float2bfloat16(v);
    }
  }
  if constexpr (EPI == EPI_DH) {
    __syncthreads();
    if (threadIdx.x < GT) {
      float sum = 0.f;
      for (int r = 0; r < GT; ++r) sum += s_c2[r * LDC + threadIdx.x];
      ep.part[size_t(blockIdx.x) * ep.ldo + n0 + threadIdx.x] = sum;
    }
  }
}

template <bool AT, bool BT, bool DUAL, int EPI>
cudaError_t wide_gemm(const bf16* A, int lda, const bf16* B, int ldb, int M, int N, int K,
                      const EpiArgs& ep, cudaStream_t stream, const bf16* A2 = nullptr,
                      int lda2 = 0, const bf16* B2 = nullptr, int ldb2 = 0) {
  mlp_wide_gemm_kernel<AT, BT, DUAL, EPI><<<dim3(M / GT, N / GT), GNT, 0, stream>>>(
      A, lda, B, ldb, A2, lda2, B2, ldb2, K, ep);
  return cudaGetLastError();
}

// One warp a row: hin = bf16(LN(x)) and, where g is given, gbr = bf16(s * g).
__global__ void mlp_wide_ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ gm,
                                        const float* __restrict__ bt,
                                        const float* __restrict__ g,
                                        const float* __restrict__ sc, bf16* __restrict__ hin,
                                        bf16* __restrict__ gbr, int R, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const size_t r = size_t(blockIdx.x) * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (r >= size_t(R)) return;
  const float* xr = x + r * C;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < C; c += 32) {
    s += xr[c];
    s2 += xr[c] * xr[c];
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / C, rs = rsqrtf(s2 / C - mu * mu + eps);
  const float srow = sc != nullptr ? sc[r] : 1.f;
  for (int c = lane; c < C; c += 32) {
    hin[r * C + c] = __float2bfloat16((xr[c] - mu) * rs * gm[c] + bt[c]);
    if (g != nullptr) gbr[r * C + c] = __float2bfloat16(g[r * C + c] * srow);
  }
}

// The LayerNorm backward of 64 rows a block from dxin = dh @ k1^T (f32):
// dx, and the block's column sums of dgamma, dbeta and db2 (s * g) into
// part (R / 64, 3, C).
__global__ void __launch_bounds__(NT)
mlp_wide_ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gm,
                       const float* __restrict__ sc, const float* __restrict__ g,
                       const float* __restrict__ dxin, float* __restrict__ dx,
                       float* __restrict__ part, int C, float eps) {
  __shared__ float s_mu[TR], s_rs[TR], s_m1[TR], s_m2[TR];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t r0 = size_t(blockIdx.x) * TR;
  for (int rr = warp; rr < TR; rr += NW) {
    const float* xr = x + (r0 + rr) * C;
    const float* dr = dxin + (r0 + rr) * C;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      s += xr[c];
      s2 += xr[c] * xr[c];
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / C, rs = rsqrtf(s2 / C - mu * mu + eps);
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dxh = dr[c] * gm[c];
      m1 += dxh;
      m2 += dxh * ((xr[c] - mu) * rs);
    }
    if (lane == 0) {
      s_mu[rr] = mu;
      s_rs[rr] = rs;
    }
    m1 = warp_sum(m1);
    m2 = warp_sum(m2);
    if (lane == 0) {
      s_m1[rr] = m1 / C;
      s_m2[rr] = m2 / C;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    float pg = 0.f, pb = 0.f, p2 = 0.f;
    for (int rr = 0; rr < TR; ++rr) {
      const size_t o = (r0 + rr) * C + c;
      const float xh = (x[o] - s_mu[rr]) * s_rs[rr];
      const float d = dxin[o];
      const float dxh = d * gm[c];
      pg += d * xh;
      pb += d;
      p2 += g[o] * (sc != nullptr ? sc[r0 + rr] : 1.f);
      dx[o] = g[o] + s_rs[rr] * (dxh - s_m1[rr] - xh * s_m2[rr]);
    }
    part[size_t(blockIdx.x) * 3 * C + c] = pg;
    part[size_t(blockIdx.x) * 3 * C + C + c] = pb;
    part[size_t(blockIdx.x) * 3 * C + 2 * C + c] = p2;
  }
}

// gbr = bf16(g) and each 64-row block's column sums of g (db2 partials).
__global__ void __launch_bounds__(NT)
mlp_wide_cot_kernel(const float* __restrict__ g, bf16* __restrict__ gbr,
                    float* __restrict__ part, int C) {
  const size_t r0 = size_t(blockIdx.x) * TR;
  for (int c = threadIdx.x; c < C; c += NT) {
    float sum = 0.f;
    for (int rr = 0; rr < TR; ++rr) {
      const float v = g[(r0 + rr) * C + c];
      gbr[(r0 + rr) * C + c] = __float2bfloat16(v);
      sum += v;
    }
    part[size_t(blockIdx.x) * C + c] = sum;
  }
}

bool wide_shape_ok(int R, int C, int H) {
  return R > 0 && C > 0 && H > 0 && R % GT == 0 && C % GT == 0 && H % GT == 0;
}

cudaError_t ln_rows(const float* x, const float* gm, const float* bt, const float* g,
                    const float* sc, bf16* hin, bf16* gbr, int R, int C, float eps,
                    cudaStream_t stream) {
  mlp_wide_ln_rows_kernel<<<(R + NW - 1) / NW, NT, 0, stream>>>(x, gm, bt, g, sc, hin, gbr, R,
                                                                C, eps);
  return cudaGetLastError();
}

// The hidden of the forward, a = bf16(GELU(xin @ k1 + b1)) (R, H), then the
// output product with its epilogue.
template <int EPI>
cudaError_t wide_fwd(const bf16* xin, const bf16* k1, const float* b1, const bf16* k2,
                     const float* b2, const float* x, const float* sc, float* y, bf16* a_s,
                     int R, int C, int H, cudaStream_t stream) {
  EpiArgs e1{b1, nullptr, nullptr, a_s, nullptr, nullptr, H};
  cudaError_t err = wide_gemm<false, false, false, EPI_GELU>(xin, C, k1, H, R, H, C, e1, stream);
  if (err != cudaSuccess) return err;
  EpiArgs e2{b2, x, sc, y, nullptr, nullptr, C};
  return wide_gemm<false, false, false, EPI>(a_s, H, k2, C, R, C, H, e2, stream);
}

// The backward's products shared by both forms, from the bf16 rows xin and
// cotangent gbr: dh and a (R, H) bf16 with db1 partials (R / 64, H); dk1,
// dk2 (bf16).
cudaError_t wide_bwd_hidden(const bf16* xin, const bf16* gbr, const bf16* k1, const float* b1,
                            const bf16* k2, bf16* dh_s, bf16* a_s, float* db1p, bf16* dk1,
                            bf16* dk2, int R, int C, int H, cudaStream_t stream) {
  EpiArgs e{b1, nullptr, nullptr, dh_s, a_s, db1p, H};
  cudaError_t err =
      wide_gemm<false, false, true, EPI_DH>(xin, C, k1, H, R, H, C, e, stream, gbr, C, k2, C);
  if (err != cudaSuccess) return err;
  EpiArgs w1{nullptr, nullptr, nullptr, dk1, nullptr, nullptr, H};
  if ((err = wide_gemm<true, false, false, EPI_BF16>(xin, C, dh_s, H, C, H, R, w1, stream)) !=
      cudaSuccess)
    return err;
  EpiArgs w2{nullptr, nullptr, nullptr, dk2, nullptr, nullptr, C};
  return wide_gemm<true, false, false, EPI_BF16>(a_s, H, gbr, C, H, C, R, w2, stream);
}

}  // namespace

PDAE_EXPORT int mlp_ln_fwd(const float* x, const float* gm, const float* bt,
                           const void* k1, const float* b1, const void* k2,
                           const float* b2, const float* sc, float* y, int R, int C,
                           int H, float eps, void* stream) {
  if (!shape_ok(R, C, H)) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* k1b = static_cast<const bf16*>(k1);
  const bf16* k2b = static_cast<const bf16*>(k2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 128: err = launch_fwd<128>(x, gm, bt, k1b, b1, k2b, b2, sc, y, R, H, eps, s); break;
    case 256: err = launch_fwd<256>(x, gm, bt, k1b, b1, k2b, b2, sc, y, R, H, eps, s); break;
    default: err = launch_fwd<384>(x, gm, bt, k1b, b1, k2b, b2, sc, y, R, H, eps, s); break;
  }
  return static_cast<int>(err);
}

// Scratch and outputs, all allocated by the caller:
//   hin_s, gbr_s (R, C) bf16; part_a (R/64, 3, C) f32;
//   dk1p (P, C, H), dk2p (P, H, C), db1p (P, H) f32;
//   dk1 (C, H), dk2 (H, C) bf16; db1 (H) f32; dln (3, C) f32 = dgamma, dbeta, db2.
PDAE_EXPORT int mlp_ln_bwd(const float* x, const float* gm, const float* bt,
                           const void* k1, const float* b1, const void* k2,
                           const float* sc, const float* g, float* dx, void* hin_s,
                           void* gbr_s, float* part_a, float* dk1p, float* dk2p,
                           float* db1p, void* dk1, void* dk2, float* db1, float* dln,
                           int R, int C, int H, int P, float eps, void* stream) {
  if (!shape_ok(R, C, H) || P < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* k1b = static_cast<const bf16*>(k1);
  const bf16* k2b = static_cast<const bf16*>(k2);
  bf16* hs = static_cast<bf16*>(hin_s);
  bf16* gs = static_cast<bf16*>(gbr_s);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 128:
      err = launch_bwd<128>(x, gm, bt, k1b, b1, k2b, sc, g, dx, hs, gs, part_a, dk1p, dk2p,
                            db1p, R, H, P, eps, s);
      break;
    case 256:
      err = launch_bwd<256>(x, gm, bt, k1b, b1, k2b, sc, g, dx, hs, gs, part_a, dk1p, dk2p,
                            db1p, R, H, P, eps, s);
      break;
    default:
      err = launch_bwd<384>(x, gm, bt, k1b, b1, k2b, sc, g, dx, hs, gs, part_a, dk1p, dk2p,
                            db1p, R, H, P, eps, s);
      break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = sum_weight_partials(dk1p, dk2p, db1p, P, C, H, dk1, dk2, db1, s)) != cudaSuccess)
    return static_cast<int>(err);
  err = sum_partials(part_a, R / TR, 3LL * C, dln, nullptr, s);
  return static_cast<int>(err);
}

// out (R, C) f32 = GELU(x @ k1 + b1) @ k2 + b2; x (R, C), k1, k2 bf16.
PDAE_EXPORT int mlp_fwd(const void* x, const void* k1, const float* b1, const void* k2,
                        const float* b2, float* y, int R, int C, int H, void* stream) {
  if (!shape_ok(R, C, H)) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* k1b = static_cast<const bf16*>(k1);
  const bf16* k2b = static_cast<const bf16*>(k2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 128: err = launch_mlp_fwd<128>(xb, k1b, b1, k2b, b2, y, R, H, s); break;
    case 256: err = launch_mlp_fwd<256>(xb, k1b, b1, k2b, b2, y, R, H, s); break;
    default: err = launch_mlp_fwd<384>(xb, k1b, b1, k2b, b2, y, R, H, s); break;
  }
  return static_cast<int>(err);
}

// Scratch and outputs, all allocated by the caller:
//   gbr_s (R, C) bf16; part_a (R/64, C) f32; dk1p (P, C, H), dk2p (P, H, C),
//   db1p (P, H) f32; dx (R, C), dk1 (C, H), dk2 (H, C) bf16; db1 (H), db2 (C) f32.
PDAE_EXPORT int mlp_bwd(const void* x, const void* k1, const float* b1, const void* k2,
                        const float* g, void* dx, void* gbr_s, float* part_a, float* dk1p,
                        float* dk2p, float* db1p, void* dk1, void* dk2, float* db1,
                        float* db2, int R, int C, int H, int P, void* stream) {
  if (!shape_ok(R, C, H) || P < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* k1b = static_cast<const bf16*>(k1);
  const bf16* k2b = static_cast<const bf16*>(k2);
  bf16* dxb = static_cast<bf16*>(dx);
  bf16* gs = static_cast<bf16*>(gbr_s);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (C) {
    case 128:
      err = launch_mlp_bwd<128>(xb, k1b, b1, k2b, g, dxb, gs, part_a, dk1p, dk2p, db1p, R,
                                H, P, s);
      break;
    case 256:
      err = launch_mlp_bwd<256>(xb, k1b, b1, k2b, g, dxb, gs, part_a, dk1p, dk2p, db1p, R,
                                H, P, s);
      break;
    default:
      err = launch_mlp_bwd<384>(xb, k1b, b1, k2b, g, dxb, gs, part_a, dk1p, dk2p, db1p, R,
                                H, P, s);
      break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = sum_weight_partials(dk1p, dk2p, db1p, P, C, H, dk1, dk2, db1, s)) != cudaSuccess)
    return static_cast<int>(err);
  err = sum_partials(part_a, R / TR, C, db2, nullptr, s);
  return static_cast<int>(err);
}

// ------------------------------------------------------------ wide entries
// The wide form (any R, C, H multiple of 64); scratch and outputs allocated
// by the caller.

// hin_s (R, C), a_s (R, H) bf16 scratch.
PDAE_EXPORT int mlp_ln_fwd_wide(const float* x, const float* gm, const float* bt,
                                const void* k1, const float* b1, const void* k2,
                                const float* b2, const float* sc, float* y, void* hin_s,
                                void* a_s, int R, int C, int H, float eps, void* stream) {
  if (!wide_shape_ok(R, C, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* hs = static_cast<bf16*>(hin_s);
  cudaError_t err = ln_rows(x, gm, bt, nullptr, nullptr, hs, nullptr, R, C, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = wide_fwd<EPI_OUT_LN>(hs, static_cast<const bf16*>(k1), b1, static_cast<const bf16*>(k2),
                             b2, x, sc, y, static_cast<bf16*>(a_s), R, C, H, s);
  return static_cast<int>(err);
}

// hin_s, gbr_s (R, C) bf16; dh_s, a_s (R, H) bf16; db1p (R/64, H), dxin (R, C),
// part_a (R/64, 3, C) f32; dk1 (C, H), dk2 (H, C) bf16; db1 (H); dln (3, C) =
// dgamma, dbeta, db2.
PDAE_EXPORT int mlp_ln_bwd_wide(const float* x, const float* gm, const float* bt,
                                const void* k1, const float* b1, const void* k2,
                                const float* sc, const float* g, float* dx, void* hin_s,
                                void* gbr_s, void* dh_s, void* a_s, float* db1p, float* dxin,
                                float* part_a, void* dk1, void* dk2, float* db1, float* dln,
                                int R, int C, int H, float eps, void* stream) {
  if (!wide_shape_ok(R, C, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* k1b = static_cast<const bf16*>(k1);
  bf16* hs = static_cast<bf16*>(hin_s);
  bf16* gs = static_cast<bf16*>(gbr_s);
  bf16* dhs = static_cast<bf16*>(dh_s);
  cudaError_t err = ln_rows(x, gm, bt, g, sc, hs, gs, R, C, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = wide_bwd_hidden(hs, gs, k1b, b1, static_cast<const bf16*>(k2), dhs,
                             static_cast<bf16*>(a_s), db1p, static_cast<bf16*>(dk1),
                             static_cast<bf16*>(dk2), R, C, H, s)) != cudaSuccess)
    return static_cast<int>(err);
  EpiArgs ed{nullptr, nullptr, nullptr, dxin, nullptr, nullptr, C};
  if ((err = wide_gemm<false, true, false, EPI_F32>(dhs, H, k1b, H, R, C, H, ed, s)) !=
      cudaSuccess)
    return static_cast<int>(err);
  mlp_wide_ln_bwd_kernel<<<R / TR, NT, 0, s>>>(x, gm, sc, g, dxin, dx, part_a, C, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = sum_partials(db1p, R / TR, H, db1, nullptr, s)) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(sum_partials(part_a, R / TR, 3LL * C, dln, nullptr, s));
}

// a_s (R, H) bf16 scratch.
PDAE_EXPORT int mlp_fwd_wide(const void* x, const void* k1, const float* b1, const void* k2,
                             const float* b2, float* y, void* a_s, int R, int C, int H,
                             void* stream) {
  if (!wide_shape_ok(R, C, H)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(wide_fwd<EPI_OUT>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(k1), b1,
      static_cast<const bf16*>(k2), b2, nullptr, nullptr, y, static_cast<bf16*>(a_s), R, C, H,
      static_cast<cudaStream_t>(stream)));
}

// gbr_s (R, C), dh_s, a_s (R, H) bf16; db1p (R/64, H), part_a (R/64, C) f32;
// dx (R, C), dk1 (C, H), dk2 (H, C) bf16; db1 (H), db2 (C) f32.
PDAE_EXPORT int mlp_bwd_wide(const void* x, const void* k1, const float* b1, const void* k2,
                             const float* g, void* dx, void* gbr_s, void* dh_s, void* a_s,
                             float* db1p, float* part_a, void* dk1, void* dk2, float* db1,
                             float* db2, int R, int C, int H, void* stream) {
  if (!wide_shape_ok(R, C, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* k1b = static_cast<const bf16*>(k1);
  bf16* gs = static_cast<bf16*>(gbr_s);
  bf16* dhs = static_cast<bf16*>(dh_s);
  mlp_wide_cot_kernel<<<R / TR, NT, 0, s>>>(g, gs, part_a, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((err = wide_bwd_hidden(xb, gs, k1b, b1, static_cast<const bf16*>(k2), dhs,
                             static_cast<bf16*>(a_s), db1p, static_cast<bf16*>(dk1),
                             static_cast<bf16*>(dk2), R, C, H, s)) != cudaSuccess)
    return static_cast<int>(err);
  EpiArgs ed{nullptr, nullptr, nullptr, dx, nullptr, nullptr, C};
  if ((err = wide_gemm<false, true, false, EPI_BF16>(dhs, H, k1b, H, R, C, H, ed, s)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if ((err = sum_partials(db1p, R / TR, H, db1, nullptr, s)) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(sum_partials(part_a, R / TR, C, db2, nullptr, s));
}
