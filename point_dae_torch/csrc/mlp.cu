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
// Design. A block owns 64 rows. The forward puts them into shared memory
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
