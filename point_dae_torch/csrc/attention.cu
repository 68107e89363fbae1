// Fused self-attention, forward and backward:
//   o = softmax(q k^T * scale, invalid keys at -1e9) v   per (cloud, head)
// q, k, v: bf16 views of shape (B, T, H, d) with unit stride along d and one
// set of (cloud, token, head) strides, so the three slices of a
// (B, T, 3, H, d) projection are read in place; o: (B, T, H, d) f32.
// Products take bf16 operands and accumulate in f32; the softmax is f32
// with row-max subtraction; the probabilities are rounded to bf16 for the
// product with v. The backward recomputes the probabilities, rounds the
// cotangent and ds * scale to bf16 before their products, uses the f32
// probabilities in ds = p * (dp - sum(dp * p)), and writes dq, dk, dv as
// bf16 into the three slices of one (B, T, 3, H, d) buffer. An invalid key
// *replaces* its score by -1e9, so a cloud without a valid key attends
// uniformly over its own T keys; keys past T (padding) take no weight.
//
// Replaces point_dae_tpu/ops/pallas_attn.py:fused_attention (_fwd_kernel and
// _bwd_kernel).
//
// Design. Every product is mma.sync.m16n8k16 (bf16 in, f32 accumulate)
// through inline PTX, its operands read from shared memory by ldmatrix
// (.trans where an operand is read transposed). A warp owns 16 query rows:
// their (16, 64) score tile stays in registers (32 floats a thread), the
// masked, scaled softmax runs on them with quad shuffles, and the
// accumulator layout of m16n8k16 is its A-operand layout, so the bf16
// probabilities (and in the backward ds * scale) feed the next product
// from registers. q, k and v reach shared memory by 16-byte cp.async, with
// zeros past T and past d: d is padded to the instantiated width D (32, 64,
// 128 or 256), which leaves the scores alone and drops v's padded columns.
//   T <= 64 (the models' shapes): a block holds as many (cloud, head)
//   units as fill 4 warps (T 32: 2 units of 2 warps), one key tile. The
//   backward first owns query rows (scores, p, dp = g v^T, ds, dq = ds k),
//   leaves p and ds * scale as bf16 in shared memory, then owns key rows
//   (dv = p^T g, dk = ds^T q through ldmatrix.trans): one barrier, no
//   atomics.
//   T > 64: the forward streams 64-key tiles twice, first for each row's
//   max and denominator, then for p = exp(s - m) / l and p v, so p is
//   rounded where the short path rounds it. The backward is two launches:
//   dq by 64-row query tiles (which also writes each row's m, l and
//   sum(dp * p)), then dk and dv by 64-row key tiles from those statistics,
//   each warp holding its keys' transposed score tile in registers.
//
// Bound on the H100: bytes. A forward at B 256, H 6, T 64, d 64 reads 18.9
// MB of q, k, v and writes 25.2 MB; its products are 1.6 GFLOP, 1.6 us of
// tensor-core time. The backward also reads the f32 cotangent and writes
// three bf16 gradients.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int KT = 64;          // keys a tile; query rows a tile past T 64
constexpr int NJ = KT / 8;      // 8-column tiles of a score tile
constexpr int PAD = 8;          // bf16 row padding: ldmatrix rows fall in distinct banks
constexpr int LDP = KT + PAD;   // p and ds rows of the short backward
constexpr int NW = 4;           // warps a block

template <int D>
struct Dims {
  static constexpr int LD = D + PAD;           // q, k, v, g rows in shared memory
  static constexpr int DC = D < 64 ? D : 64;   // output columns a pass
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A score tile in registers: s[j][e] is row (lane / 4) + 8 * (e / 2),
// column 8 j + 2 (lane % 4) + e % 2 of a warp's (16, 64) tile.
using Tile = float[NJ][4];
using Frags = uint32_t[NJ / 2][4];

// rows x D bf16 tile -> shared memory (row stride D + PAD), rows >= n and
// columns >= d as zeros; src rows are st elements apart.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long st, int rows,
                                          int n, int d, int t, int nt) {
  constexpr int V = D / 8;
  for (int i = t; i < rows * V; i += nt) {
    const int r = i / V, c = (i % V) * 8;
    const bool ok = r < n && c < d;
    cp_async16(dst + r * Dims<D>::LD + c, ok ? src + r * st + c : src, ok);
  }
}

// rows x D tile of the f32 cotangent (rows rs elements apart) -> bf16 in
// shared memory, rounded once, zeros past n and d.
template <int D>
__device__ __forceinline__ void load_cot(bf16* dst, const float* src, long long rs, int rows,
                                         int n, int d, int t, int nt) {
  constexpr int V = D / 8;
  for (int i = t; i < rows * V; i += nt) {
    const int r = i / V, c = (i % V) * 8;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (r < n && c < d) {
      const float4 a = *reinterpret_cast<const float4*>(src + r * rs + c);
      const float4 b = *reinterpret_cast<const float4*>(src + r * rs + c + 4);
      w = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                     pack_bf16(b.z, b.w));
    }
    *reinterpret_cast<uint4*>(dst + r * Dims<D>::LD + c) = w;
  }
}

// s = a[m0 : m0 + 16, :D] b[:8 nj, :D]^T for nj (even) 8-column tiles; a and
// b bf16 rows in shared memory.
template <int D>
__device__ __forceinline__ void mma_abt(Tile& s, const bf16* a, int m0, const bf16* b, int nj) {
  constexpr int LD = Dims<D>::LD;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (m0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < NJ / 2; ++jj) {
      if (2 * jj < nj) {
        uint32_t bf[4];
        ldsm_x4(bf, b + (16 * jj + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma(s[2 * jj], af, bf[0], bf[1]);
        mma(s[2 * jj + 1], af, bf[2], bf[3]);
      }
    }
  }
}

// o += A b[:16 nk, c0 : c0 + DC] with A (16, 16 nk) in register fragments
// and b bf16 rows [k][n] in shared memory (row stride LD), read transposed.
template <int DC, int LD>
__device__ __forceinline__ void mma_frag_b(float (&o)[DC / 8][4], const Frags& af, const bf16* b,
                                           int c0, int nk) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    if (kk < nk) {
#pragma unroll
      for (int jd = 0; jd < DC / 16; ++jd) {
        uint32_t bf[4];
        ldsm_x4_t(bf, b + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 + 16 * jd +
                          (lane >> 4) * 8);
        mma(o[2 * jd], af[kk], bf[0], bf[1]);
        mma(o[2 * jd + 1], af[kk], bf[2], bf[3]);
      }
    }
  }
}

// o += a[:16 nk, m0 : m0 + 16]^T b[:16 nk, c0 : c0 + DC]: both operands bf16
// rows [k][.] in shared memory, read transposed.
template <int DC, int LDA, int LDB>
__device__ __forceinline__ void mma_atb(float (&o)[DC / 8][4], const bf16* a, int m0,
                                        const bf16* b, int c0, int nk) {
  const int lane = threadIdx.x & 31;
  for (int kk = 0; kk < nk; ++kk) {
    uint32_t af[4];
    ldsm_x4_t(af, a + (16 * kk + (lane & 7) + ((lane >> 4) << 3)) * LDA + m0 +
                      ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int jd = 0; jd < DC / 16; ++jd) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + c0 + 16 * jd +
                        (lane >> 4) * 8);
      mma(o[2 * jd], af, bf[0], bf[1]);
      mma(o[2 * jd + 1], af, bf[2], bf[3]);
    }
  }
}

template <int DC>
__device__ __forceinline__ void zero(float (&o)[DC / 8][4]) {
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
}

// Scores whose columns are keys key0 + ...: scaled; an invalid key's score
// replaced by -1e9; a key past T at -inf.
__device__ __forceinline__ void mask_scores(Tile& s, int nj, int key0, int T,
                                            const unsigned char* mrow, float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j < nj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * j + 2 * t + e;
        if (key >= T) {
          s[j][e] = s[j][e + 2] = -INFINITY;
        } else if (mrow != nullptr && mrow[key] == 0) {
          s[j][e] = s[j][e + 2] = -1e9f;
        } else {
          s[j][e] *= scale;
          s[j][e + 2] *= scale;
        }
      }
    }
  }
}

// The whole row in one tile: s -> softmax(s) in place, rows not ok zeroed.
__device__ __forceinline__ void softmax_rows(Tile& s, int nj, const bool (&ok)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j < nj) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    mx = quad_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        s[j][2 * i] = expf(s[j][2 * i] - mx);
        s[j][2 * i + 1] = expf(s[j][2 * i + 1] - mx);
        sum += s[j][2 * i] + s[j][2 * i + 1];
      }
    }
    const float tot = quad_sum(sum);   // every lane: the shuffle's mask is the whole warp
    const float inv = ok[i] ? 1.f / tot : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j][2 * i] *= inv;
      s[j][2 * i + 1] *= inv;
    }
  }
}

// Running row max m and denominator l over one more (full) key tile.
__device__ __forceinline__ void online_stats(const Tile& s, float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    const float mn = fmaxf(m[i], quad_max(mx));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) sum += expf(s[j][2 * i] - mn) + expf(s[j][2 * i + 1] - mn);
    l[i] = l[i] * expf(m[i] - mn) + quad_sum(sum);
    m[i] = mn;
  }
}

// p = exp(s - m) * il in place (il = 1 / l, 0 for a row past T).
__device__ __forceinline__ void probs(Tile& s, const float (&m)[2], const float (&il)[2]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = expf(s[j][e] - m[e >> 1]) * il[e >> 1];
}

// A-operand fragments of bf16(mul * s): the accumulator layout of a score
// tile is the A layout of the next product over its columns.
__device__ __forceinline__ void to_frags(Frags& f, const Tile& s, float mul) {
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    f[kk][0] = pack_bf16(s[2 * kk][0] * mul, s[2 * kk][1] * mul);
    f[kk][1] = pack_bf16(s[2 * kk][2] * mul, s[2 * kk][3] * mul);
    f[kk][2] = pack_bf16(s[2 * kk + 1][0] * mul, s[2 * kk + 1][1] * mul);
    f[kk][3] = pack_bf16(s[2 * kk + 1][2] * mul, s[2 * kk + 1][3] * mul);
  }
}

// A warp's (16, DC) accumulator -> rows r0 + ... (< n) and columns c0 + ...
// (< d) of a row-major output, rows rs elements apart: f32 pairs or bf16 pairs.
template <int DC>
__device__ __forceinline__ void store_rows(float* out, long long rs, int r0, int n, int c0, int d,
                                           const float (&o)[DC / 8][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) {
    const int c = c0 + 8 * j + 2 * t;
    if (c >= d) continue;
    if (r0 + g < n) *reinterpret_cast<float2*>(out + (r0 + g) * rs + c) = make_float2(o[j][0], o[j][1]);
    if (r0 + g + 8 < n)
      *reinterpret_cast<float2*>(out + (r0 + g + 8) * rs + c) = make_float2(o[j][2], o[j][3]);
  }
}

template <int DC>
__device__ __forceinline__ void store_rows(bf16* out, long long rs, int r0, int n, int c0, int d,
                                           const float (&o)[DC / 8][4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) {
    const int c = c0 + 8 * j + 2 * t;
    if (c >= d) continue;
    if (r0 + g < n) *reinterpret_cast<uint32_t*>(out + (r0 + g) * rs + c) = pack_bf16(o[j][0], o[j][1]);
    if (r0 + g + 8 < n)
      *reinterpret_cast<uint32_t*>(out + (r0 + g + 8) * rs + c) = pack_bf16(o[j][2], o[j][3]);
  }
}

// Which (cloud, head) unit and which row tile a warp's group of wpg warps
// serves. A short launch (T <= 64) packs blockDim / (32 wpg) units a block;
// a long one is one 64-row tile of one unit a block.
struct Place {
  int grp, m0, rows, unit, r0, b, h, t, nt;
  bool live;
  __device__ Place(int units, int T, int H, int wpg) {
    const int warp = threadIdx.x >> 5;
    const int gpb = blockDim.x / (32 * wpg);
    grp = warp / wpg;
    m0 = (warp % wpg) * 16;
    rows = wpg * 16;
    const int tiles = (T + rows - 1) / rows;
    const int item = blockIdx.x * gpb + grp;
    live = item < units * tiles;
    unit = live ? item / tiles : 0;
    r0 = live ? (item % tiles) * rows : 0;
    b = unit / H;
    h = unit % H;
    t = threadIdx.x - grp * wpg * 32;
    nt = wpg * 32;
  }
};

// ------------------------------------------------------------------ forward

// MINB: blocks an SM the registers are capped for (1: no cap).
template <int D, int MINB>
__global__ void __launch_bounds__(NW * 32, MINB)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
                     float* __restrict__ o, int units, int T, int H, int d, long long sb,
                     long long st, long long sh, float scale, int wpg) {
  constexpr int LD = Dims<D>::LD, DC = Dims<D>::DC;
  extern __shared__ __align__(16) unsigned char smem[];
  const Place P(units, T, H, wpg);
  const int rows = P.rows, nj = rows / 8, nkt = (T + rows - 1) / rows;
  bf16* s_q = reinterpret_cast<bf16*>(smem) + P.grp * 3 * rows * LD;
  bf16* s_k = s_q + rows * LD;
  bf16* s_v = s_k + rows * LD;
  const long long base = P.b * sb + P.h * sh;
  const unsigned char* mrow = mask == nullptr ? nullptr : mask + size_t(P.b) * T;
  float* o_unit = o + (size_t(P.b) * T * H + P.h) * d;
  const long long ors = static_cast<long long>(H) * d;
  const int g = (threadIdx.x & 31) >> 2;

  if (P.live) load_tile<D>(s_q, q + base + P.r0 * st, st, rows, min(rows, T - P.r0), d, P.t, P.nt);
  Tile s;
  Frags pf;
  float acc[DC / 8][4];

  if (nkt == 1) {   // one key tile: p stays in registers for every output pass
    if (P.live) {
      load_tile<D>(s_k, k + base, st, rows, T, d, P.t, P.nt);
      load_tile<D>(s_v, v + base, st, rows, T, d, P.t, P.nt);
    }
    cp_async_wait_all();
    __syncthreads();
    if (!P.live) return;
    const bool ok[2] = {true, true};
    mma_abt<D>(s, s_q, P.m0, s_k, nj);
    mask_scores(s, nj, 0, T, mrow, scale);
    softmax_rows(s, nj, ok);
    to_frags(pf, s, 1.f);
#pragma unroll
    for (int c0 = 0; c0 < D; c0 += DC) {
      zero<DC>(acc);
      mma_frag_b<DC, LD>(acc, pf, s_v, c0, nj / 2);
      store_rows<DC>(o_unit, ors, P.r0 + P.m0, T, c0, d, acc);
    }
    return;
  }

  // T > 64: each row's max and denominator over every key tile, then p v
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    load_tile<D>(s_k, k + base + kt * KT * st, st, KT, min(KT, T - kt * KT), d, P.t, P.nt);
    cp_async_wait_all();
    __syncthreads();
    mma_abt<D>(s, s_q, P.m0, s_k, NJ);
    mask_scores(s, NJ, kt * KT, T, mrow, scale);
    online_stats(s, m, l);
  }
  const float il[2] = {P.r0 + P.m0 + g < T ? 1.f / l[0] : 0.f,
                       P.r0 + P.m0 + g + 8 < T ? 1.f / l[1] : 0.f};
  for (int c0 = 0; c0 < D; c0 += DC) {
    zero<DC>(acc);
    for (int kt = 0; kt < nkt; ++kt) {
      __syncthreads();
      const int n = min(KT, T - kt * KT);
      load_tile<D>(s_k, k + base + kt * KT * st, st, KT, n, d, P.t, P.nt);
      load_tile<D>(s_v, v + base + kt * KT * st, st, KT, n, d, P.t, P.nt);
      cp_async_wait_all();
      __syncthreads();
      mma_abt<D>(s, s_q, P.m0, s_k, NJ);
      mask_scores(s, NJ, kt * KT, T, mrow, scale);
      probs(s, m, il);
      to_frags(pf, s, 1.f);
      mma_frag_b<DC, LD>(acc, pf, s_v, c0, NJ / 2);
    }
    store_rows<DC>(o_unit, ors, P.r0 + P.m0, T, c0, d, acc);
  }
}

// ------------------------------------------------------ backward, T <= 64

template <int D>
__global__ void __launch_bounds__(NW * 32)
attention_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
                     const float* __restrict__ g, bf16* __restrict__ dq, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int units, int T, int H, int d, long long sb,
                     long long st, long long sh, float scale, int wpg) {
  constexpr int LD = Dims<D>::LD, DC = Dims<D>::DC;
  extern __shared__ __align__(16) unsigned char smem[];
  const Place P(units, T, H, wpg);
  const int rows = P.rows, nj = rows / 8;
  bf16* s_q = reinterpret_cast<bf16*>(smem) + P.grp * (4 * rows * LD + 2 * rows * LDP);
  bf16* s_k = s_q + rows * LD;
  bf16* s_v = s_k + rows * LD;
  bf16* s_g = s_v + rows * LD;
  bf16* s_p = s_g + rows * LD;     // p, bf16
  bf16* s_ds = s_p + rows * LDP;   // ds * scale, bf16
  const long long base = P.b * sb + P.h * sh;
  const unsigned char* mrow = mask == nullptr ? nullptr : mask + size_t(P.b) * T;
  const long long grs = static_cast<long long>(H) * d, drs = 3LL * H * d;
  const size_t out0 = (size_t(P.b) * T * 3 * H + P.h) * d;
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;

  if (P.live) {
    load_tile<D>(s_q, q + base, st, rows, T, d, P.t, P.nt);
    load_tile<D>(s_k, k + base, st, rows, T, d, P.t, P.nt);
    load_tile<D>(s_v, v + base, st, rows, T, d, P.t, P.nt);
    load_cot<D>(s_g, g + (size_t(P.b) * T * H + P.h) * d, grs, rows, T, d, P.t, P.nt);
  }
  cp_async_wait_all();
  __syncthreads();
  if (!P.live) return;   // whole groups leave: the barrier below counts one group

  // query rows m0 ..: p, dp, ds, dq
  Tile s, dp;
  Frags df;
  float acc[DC / 8][4];
  const int m0 = P.m0;
  const bool ok[2] = {m0 + gr < T, m0 + gr + 8 < T};
  mma_abt<D>(s, s_q, m0, s_k, nj);
  mask_scores(s, nj, 0, T, mrow, scale);
  softmax_rows(s, nj, ok);
  mma_abt<D>(dp, s_g, m0, s_v, nj);
  float dot[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dot[e >> 1] += j < nj ? s[j][e] * dp[j][e] : 0.f;
  dot[0] = quad_sum(dot[0]);
  dot[1] = quad_sum(dot[1]);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - dot[e >> 1]);
    if (j < nj) {
      const int c = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(s_p + (m0 + gr) * LDP + c) = pack_bf16(s[j][0], s[j][1]);
      *reinterpret_cast<uint32_t*>(s_p + (m0 + gr + 8) * LDP + c) = pack_bf16(s[j][2], s[j][3]);
      *reinterpret_cast<uint32_t*>(s_ds + (m0 + gr) * LDP + c) =
          pack_bf16(dp[j][0] * scale, dp[j][1] * scale);
      *reinterpret_cast<uint32_t*>(s_ds + (m0 + gr + 8) * LDP + c) =
          pack_bf16(dp[j][2] * scale, dp[j][3] * scale);
    }
  }
  to_frags(df, dp, scale);
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += DC) {
    zero<DC>(acc);
    mma_frag_b<DC, LD>(acc, df, s_k, c0, nj / 2);
    store_rows<DC>(dq + out0, drs, m0, T, c0, d, acc);
  }

  // every warp of the group has written its p and ds rows: named barrier
  // over the group's threads only (ids 1.. ; 0 is __syncthreads)
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + P.grp), "r"(P.nt) : "memory");

  // key rows m0 ..: dv = p^T g, dk = ds^T q
#pragma unroll
  for (int c0 = 0; c0 < D; c0 += DC) {
    zero<DC>(acc);
    mma_atb<DC, LDP, LD>(acc, s_p, m0, s_g, c0, rows / 16);
    store_rows<DC>(dv + out0, drs, m0, T, c0, d, acc);
    zero<DC>(acc);
    mma_atb<DC, LDP, LD>(acc, s_ds, m0, s_q, c0, rows / 16);
    store_rows<DC>(dk + out0, drs, m0, T, c0, d, acc);
  }
}

// ------------------------------------------------------- backward, T > 64

// dq by 64-row query tiles; also each row's m, l and sum(dp * p) into
// stats (3, units * T) f32 for the key-tile launch.
template <int D>
__global__ void __launch_bounds__(NW * 32)
attention_bwd_q_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
                       const float* __restrict__ g, bf16* __restrict__ dq,
                       float* __restrict__ stats, int units, int T, int H, int d, long long sb,
                       long long st, long long sh, float scale) {
  constexpr int LD = Dims<D>::LD, DC = Dims<D>::DC;
  extern __shared__ __align__(16) unsigned char smem[];
  const Place P(units, T, H, NW);
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_g = s_q + KT * LD;
  bf16* s_k = s_g + KT * LD;
  bf16* s_v = s_k + KT * LD;
  const int nkt = (T + KT - 1) / KT;
  const long long base = P.b * sb + P.h * sh;
  const unsigned char* mrow = mask == nullptr ? nullptr : mask + size_t(P.b) * T;
  const int lane = threadIdx.x & 31, gr = lane >> 2;
  const int n = min(KT, T - P.r0);
  load_tile<D>(s_q, q + base + P.r0 * st, st, KT, n, d, P.t, P.nt);
  load_cot<D>(s_g, g + ((size_t(P.b) * T + P.r0) * H + P.h) * d, static_cast<long long>(H) * d,
              KT, n, d, P.t, P.nt);

  Tile s, dp;
  Frags df;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < nkt; ++kt) {
    __syncthreads();
    load_tile<D>(s_k, k + base + kt * KT * st, st, KT, min(KT, T - kt * KT), d, P.t, P.nt);
    cp_async_wait_all();
    __syncthreads();
    mma_abt<D>(s, s_q, P.m0, s_k, NJ);
    mask_scores(s, NJ, kt * KT, T, mrow, scale);
    online_stats(s, m, l);
  }
  const int row = P.r0 + P.m0 + gr;
  const float il[2] = {row < T ? 1.f / l[0] : 0.f, row + 8 < T ? 1.f / l[1] : 0.f};

  // pass over the keys for sum(dp * p), then one a DC-column slice of dq
  float dot[2] = {0.f, 0.f};
  float acc[DC / 8][4];
  for (int c0 = -DC; c0 < D; c0 += DC) {
    zero<DC>(acc);
    for (int kt = 0; kt < nkt; ++kt) {
      __syncthreads();
      const int nk = min(KT, T - kt * KT);
      load_tile<D>(s_k, k + base + kt * KT * st, st, KT, nk, d, P.t, P.nt);
      load_tile<D>(s_v, v + base + kt * KT * st, st, KT, nk, d, P.t, P.nt);
      cp_async_wait_all();
      __syncthreads();
      mma_abt<D>(s, s_q, P.m0, s_k, NJ);
      mask_scores(s, NJ, kt * KT, T, mrow, scale);
      probs(s, m, il);
      mma_abt<D>(dp, s_g, P.m0, s_v, NJ);
      if (c0 < 0) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dot[e >> 1] += s[j][e] * dp[j][e];
        continue;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - dot[e >> 1]);
      to_frags(df, dp, scale);
      mma_frag_b<DC, LD>(acc, df, s_k, c0, NJ / 2);
    }
    if (c0 < 0) {
      dot[0] = quad_sum(dot[0]);
      dot[1] = quad_sum(dot[1]);
      if ((lane & 3) == 0) {
        const size_t ut = size_t(units) * T, r = size_t(P.unit) * T + row;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (row + 8 * i < T) {
            stats[r + 8 * i] = m[i];
            stats[ut + r + 8 * i] = l[i];
            stats[2 * ut + r + 8 * i] = dot[i];
          }
        }
      }
      continue;
    }
    store_rows<DC>(dq + (size_t(P.b) * T * 3 * H + P.h) * d, 3LL * H * d, P.r0 + P.m0, T, c0,
                   d, acc);
  }
}

// dk and dv by 64-row key tiles: each warp owns 16 keys and holds their
// transposed scores against a 64-row query tile in registers.
template <int D>
__global__ void __launch_bounds__(NW * 32)
attention_bwd_kv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const unsigned char* __restrict__ mask,
                        const float* __restrict__ g, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, const float* __restrict__ stats, int units, int T,
                        int H, int d, long long sb, long long st, long long sh, float scale) {
  constexpr int LD = Dims<D>::LD, DC = Dims<D>::DC;
  extern __shared__ __align__(16) unsigned char smem[];
  const Place P(units, T, H, NW);
  bf16* s_k = reinterpret_cast<bf16*>(smem);
  bf16* s_v = s_k + KT * LD;
  bf16* s_q = s_v + KT * LD;
  bf16* s_g = s_q + KT * LD;
  float* s_m = reinterpret_cast<float*>(s_g + KT * LD);
  float* s_il = s_m + KT;
  float* s_dot = s_il + KT;
  const int nqt = (T + KT - 1) / KT;
  const long long base = P.b * sb + P.h * sh;
  const int lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int n = min(KT, T - P.r0);
  load_tile<D>(s_k, k + base + P.r0 * st, st, KT, n, d, P.t, P.nt);
  load_tile<D>(s_v, v + base + P.r0 * st, st, KT, n, d, P.t, P.nt);

  // this thread's two keys: past T, invalid (-1e9) or valid
  int kind[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = P.r0 + P.m0 + gr + 8 * i;
    kind[i] = key >= T ? 0 : (mask != nullptr && mask[size_t(P.b) * T + key] == 0 ? 1 : 2);
  }
  const size_t ut = size_t(units) * T;
  const float* st_unit = stats + size_t(P.unit) * T;

  Tile s, dp;
  Frags pf, df;
  float acc_v[DC / 8][4], acc_k[DC / 8][4];
  for (int c0 = 0; c0 < D; c0 += DC) {
    zero<DC>(acc_v);
    zero<DC>(acc_k);
    for (int qt = 0; qt < nqt; ++qt) {
      __syncthreads();
      const int nq = min(KT, T - qt * KT);
      load_tile<D>(s_q, q + base + qt * KT * st, st, KT, nq, d, P.t, P.nt);
      load_cot<D>(s_g, g + ((size_t(P.b) * T + qt * KT) * H + P.h) * d,
                  static_cast<long long>(H) * d, KT, nq, d, P.t, P.nt);
      for (int r = P.t; r < KT; r += P.nt) {
        const bool in = r < nq;
        s_m[r] = in ? st_unit[qt * KT + r] : 0.f;
        s_il[r] = in ? 1.f / st_unit[ut + qt * KT + r] : 0.f;
        s_dot[r] = in ? st_unit[2 * ut + qt * KT + r] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();
      mma_abt<D>(s, s_k, P.m0, s_q, NJ);    // (key, query)
      mma_abt<D>(dp, s_v, P.m0, s_g, NJ);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1), i = e >> 1;
          const float sc = kind[i] == 2 ? s[j][e] * scale : (kind[i] == 1 ? -1e9f : -INFINITY);
          const float p = expf(sc - s_m[c]) * s_il[c];
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - s_dot[c]);
        }
      }
      to_frags(pf, s, 1.f);
      to_frags(df, dp, scale);
      mma_frag_b<DC, LD>(acc_v, pf, s_g, c0, NJ / 2);
      mma_frag_b<DC, LD>(acc_k, df, s_q, c0, NJ / 2);
    }
    const size_t out0 = (size_t(P.b) * T * 3 * H + P.h) * d;
    store_rows<DC>(dv + out0, 3LL * H * d, P.r0 + P.m0, T, c0, d, acc_v);
    store_rows<DC>(dk + out0, 3LL * H * d, P.r0 + P.m0, T, c0, d, acc_k);
  }
}

// ------------------------------------------------------------------- launch

// Warps a unit's row tile takes, units a block, and dynamic shared memory.
struct Plan {
  int wpg, gpb, blocks;
  size_t smem_fwd, smem_bwd;
  Plan(int units, int T, int D) {
    const int rows = T <= KT ? (T + 15) / 16 * 16 : KT;
    wpg = rows / 16;
    gpb = T <= KT ? (NW / wpg > 0 ? NW / wpg : 1) : 1;
    const long long items = static_cast<long long>(units) * ((T + rows - 1) / rows);
    blocks = static_cast<int>((items + gpb - 1) / gpb);
    const size_t tile = size_t(rows) * (D + PAD) * 2;
    smem_fwd = gpb * 3 * tile;
    smem_bwd = T <= KT ? gpb * (4 * tile + 2 * size_t(rows) * LDP * 2) : 4 * tile + 3 * KT * 4;
  }
};

int padded_width(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256; }

bool shape_ok(int B, int T, int H, int d, int sb, int st, int sh) {
  return B >= 0 && H >= 0 && T >= 1 && d >= 0 && d <= 256 && d % 8 == 0 && sb % 8 == 0 &&
         st % 8 == 0 && sh % 8 == 0;
}

template <int D, int MINB>
cudaError_t launch_fwd_capped(const bf16* q, const bf16* k, const bf16* v,
                              const unsigned char* mask, float* o, int units, int T, int H, int d,
                              int sb, int st, int sh, float scale, cudaStream_t stream) {
  const Plan pl(units, T, D);
  cudaError_t err = set_smem(attention_fwd_kernel<D, MINB>, pl.smem_fwd);
  if (err != cudaSuccess) return err;
  attention_fwd_kernel<D, MINB><<<pl.blocks, pl.gpb * pl.wpg * 32, pl.smem_fwd, stream>>>(
      q, k, v, mask, o, units, T, H, d, sb, st, sh, scale, pl.wpg);
  return cudaGetLastError();
}

// At the models' width (d 64, one key tile) the registers are capped so that
// 6 blocks an SM fit at T <= 32 and 5 above (uncapped: 4 blocks); each cap
// ran faster on the H100 at its path shape, spills and all. Other shapes
// run uncapped.
template <int D>
cudaError_t launch_fwd(const bf16* q, const bf16* k, const bf16* v, const unsigned char* mask,
                       float* o, int units, int T, int H, int d, int sb, int st, int sh,
                       float scale, cudaStream_t stream) {
  if constexpr (D == 64) {
    if (T <= 32)
      return launch_fwd_capped<64, 6>(q, k, v, mask, o, units, T, H, d, sb, st, sh, scale, stream);
    if (T <= KT)
      return launch_fwd_capped<64, 5>(q, k, v, mask, o, units, T, H, d, sb, st, sh, scale, stream);
  }
  return launch_fwd_capped<D, 1>(q, k, v, mask, o, units, T, H, d, sb, st, sh, scale, stream);
}

template <int D>
cudaError_t launch_bwd(const bf16* q, const bf16* k, const bf16* v, const unsigned char* mask,
                       const float* g, bf16* dq, bf16* dk, bf16* dv, float* stats, int units,
                       int T, int H, int d, int sb, int st, int sh, float scale,
                       cudaStream_t stream) {
  const Plan pl(units, T, D);
  cudaError_t err;
  if (T <= KT) {
    if ((err = set_smem(attention_bwd_kernel<D>, pl.smem_bwd)) != cudaSuccess) return err;
    attention_bwd_kernel<D><<<pl.blocks, pl.gpb * pl.wpg * 32, pl.smem_bwd, stream>>>(
        q, k, v, mask, g, dq, dk, dv, units, T, H, d, sb, st, sh, scale, pl.wpg);
    return cudaGetLastError();
  }
  if (stats == nullptr) return cudaErrorInvalidValue;
  const size_t smem_q = 4 * size_t(KT) * (D + PAD) * 2;
  if ((err = set_smem(attention_bwd_q_kernel<D>, smem_q)) != cudaSuccess) return err;
  if ((err = set_smem(attention_bwd_kv_kernel<D>, pl.smem_bwd)) != cudaSuccess) return err;
  attention_bwd_q_kernel<D><<<pl.blocks, NW * 32, smem_q, stream>>>(
      q, k, v, mask, g, dq, stats, units, T, H, d, sb, st, sh, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attention_bwd_kv_kernel<D><<<pl.blocks, NW * 32, pl.smem_bwd, stream>>>(
      q, k, v, mask, g, dk, dv, stats, units, T, H, d, sb, st, sh, scale);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a launch (bytes): forward (bwd 0) or backward.
PDAE_EXPORT long long attention_smem_bytes(int T, int d, int bwd) {
  const Plan pl(1, T, padded_width(d));
  return static_cast<long long>(bwd ? pl.smem_bwd : pl.smem_fwd);
}

PDAE_EXPORT int attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                              float* o, int B, int T, int H, int d, int sb, int st, int sh,
                              float scale, void* stream) {
  if (!shape_ok(B, T, H, d, sb, st, sh)) return static_cast<int>(cudaErrorInvalidValue);
  const int units = B * H;
  if (units == 0) return static_cast<int>(cudaSuccess);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (padded_width(d)) {
    case 32: err = launch_fwd<32>(qb, kb, vb, m, o, units, T, H, d, sb, st, sh, scale, s); break;
    case 64: err = launch_fwd<64>(qb, kb, vb, m, o, units, T, H, d, sb, st, sh, scale, s); break;
    case 128: err = launch_fwd<128>(qb, kb, vb, m, o, units, T, H, d, sb, st, sh, scale, s); break;
    default: err = launch_fwd<256>(qb, kb, vb, m, o, units, T, H, d, sb, st, sh, scale, s); break;
  }
  return static_cast<int>(err);
}

// dq, dk, dv: the slices [:, :, 0], [:, :, 1], [:, :, 2] of one contiguous
// (B, T, 3, H, d) bf16 buffer; g: (B, T, H, d) f32, contiguous; stats:
// (3, B * H * T) f32 scratch for T > 64, else unused (may be null).
PDAE_EXPORT int attention_bwd(const void* q, const void* k, const void* v, const void* mask,
                              const float* g, void* dq, void* dk, void* dv, float* stats, int B,
                              int T, int H, int d, int sb, int st, int sh, float scale,
                              void* stream) {
  if (!shape_ok(B, T, H, d, sb, st, sh)) return static_cast<int>(cudaErrorInvalidValue);
  const int units = B * H;
  if (units == 0) return static_cast<int>(cudaSuccess);
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v);
  bf16 *dqb = static_cast<bf16*>(dq), *dkb = static_cast<bf16*>(dk), *dvb = static_cast<bf16*>(dv);
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (padded_width(d)) {
    case 32:
      err = launch_bwd<32>(qb, kb, vb, m, g, dqb, dkb, dvb, stats, units, T, H, d, sb, st, sh,
                           scale, s);
      break;
    case 64:
      err = launch_bwd<64>(qb, kb, vb, m, g, dqb, dkb, dvb, stats, units, T, H, d, sb, st, sh,
                           scale, s);
      break;
    case 128:
      err = launch_bwd<128>(qb, kb, vb, m, g, dqb, dkb, dvb, stats, units, T, H, d, sb, st, sh,
                            scale, s);
      break;
    default:
      err = launch_bwd<256>(qb, kb, vb, m, g, dqb, dkb, dvb, stats, units, T, H, d, sb, st, sh,
                            scale, s);
      break;
  }
  return static_cast<int>(err);
}
