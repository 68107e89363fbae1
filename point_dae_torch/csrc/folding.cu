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
// Bound on the H100: operations. At 13056 tokens x 36 points, C = F = 384 the
// forward is 0.29 TFLOP of bf16 products against 16 MB moved; the backward
// does four wide products in its rows pass and two in its weights pass,
// 0.83 TFLOP.
//
// Design (F <= 512, the one-block form). The expanded (tokens * n, F)
// hiddens are the largest tensors of the train step and never reach device
// memory. A block owns a row tile of tok whole tokens (tok 1, 2, 4 or 8,
// the most whose n tok rows fit MR = 80: 2 tokens of 36 points, 72 rows),
// rows ordered point-major (row p tok + k is point p of the tile's token
// k), so the per-token and per-point sums are warp shuffles. The tile's one
// (MR, F) bf16 operand stays resident in shared memory; the (F, F) weights
// stream from L2 in (32, 128) slices through a three-stage cp.async ring,
// so the next slices' copies overlap the current product. Products are
// mma.sync m16n8k16 from ldmatrix (csrc/mma.cuh): 4 warps, each 32 output
// columns of a 128-column chunk over all MR rows, accumulators in
// registers; at F 384 a block takes 110 KB of shared memory, so two blocks
// share an SM and one's builds and epilogues overlap the other's products.
// The epilogues (bias, ReLU, mask bits, rounding, the FMAs against the
// 3-wide k21 / k22 / ke2, the masked cotangent, per-row, per-column,
// per-token and per-point sums) run on the accumulator registers after
// each chunk's k loop: no f32 staging tile. Rows past n tok are padding
// (zero operands, zero cotangents).
//   forward (a block a tile): build a0; a0 @ k11 with f1 summed in the
//     epilogue; build a2; a2 @ k12 with out summed in the epilogue.
//   backward, two passes, no atomics, sums in a fixed order (two calls
//   agree bit for bit):
//   rows pass (persistent, two blocks an SM): a0 -> a0 @ k11: a1 (to a
//     per-block slot that stays in L2, in fragment order), its mask bits,
//     f1 -> a2 -> a2 @ k12: the mask bits of a3, db12, dk22 -> the operand
//     becomes dh3 (rebuilt from those bits, g and k22) -> dh3 @ k12^T: dh2
//     by the mask of a2, df1, db02, dke2, dsp2 -> the operand becomes dh1
//     (from the bits of a1, df1 and k21; db11 and dk21 beside it) -> dh1 @
//     k11^T: dh0 by the mask of a0, dsp1, dgp1. Writes f1, df1 (3 wide) and
//     the bits of a1 and a3 as scratch, and per-block sums of every bias
//     and narrow kernel gradient and of dgp1, each with one owner thread;
//   weights pass (a block per 128 x 128 tile of dk11 or dk12 and row
//     partition): rebuilds its columns of a0 and dh1 (or a2 and dh3)
//     elementwise from the 3-wide scratch and the mask bits, 64 rows a
//     slab, double-buffered so that one slab is built while the last is
//     multiplied; accumulators in registers;
//   then the partials are summed, and the per-token products x @ [ks1 | ks2],
//   dx and dks run as tiled mma.sync GEMMs.
// What bounds it (PERF.md): the rows' operand, which each of the four warps
// reads again for its columns, and the weights pass's elementwise rebuild.
// Wider F (the wide form, any F % 128 == 0): the chain as tiled products
// whose (rows, F) hiddens go through device memory, with elementwise,
// row and column passes between them; same numerics, no atomics.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int NT = 128;              // threads of a one-block-form block (4 warps)
constexpr int NWARP = NT / 32;
constexpr int MT = 5;                // m16 fragments of a row tile
constexpr int MR = MT * 16;          // rows of a tile (2 tokens of 36 points)
constexpr int NJ = 4;                // n8 tiles a warp owns in a chunk (32 columns)
constexpr int CH = NWARP * NJ * 8;   // output columns of a chunk
constexpr int KS = 32;               // depth of a weight slice
constexpr int STAGES = 3;            // slices in the ring
constexpr int LDN = CH + 8;          // slice k[k0 : k0 + KS, c0 : c0 + CH] (row stride)
constexpr int LDK = KS + 8;          // slice k[c0 : c0 + CH, k0 : k0 + KS] (row stride)
constexpr int SLICE = (KS * LDN > CH * LDK) ? KS * LDN : CH * LDK;   // bf16 elements
constexpr int F_ONE_BLOCK = 512;     // widest F of the one-block form
constexpr int WNT = 256;             // threads of a weights-pass block (8 warps)
constexpr int WT = 128;              // tile of dk11 / dk12 a weights-pass block owns
constexpr int KR = 64;               // rows of a weights-pass slab
constexpr int LDT = WT + 8;
constexpr int KSPLIT = 4;            // K splits of the transposed small GEMMs

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float bf_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float2 bf2_to_f2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The narrow f32 operands (bf16-rounded values), one vector of 13 F + 8:
// b01 | b11 | b02 | b12 | k21 (F, 3) | k22 (F, 3) | ke2 (3, F) | b21, 0 | b22, 0
struct Small {
  const float *b01, *b11, *b02, *b12, *k21, *k22, *ke2, *b21, *b22;
  __host__ __device__ Small(const float* s, int F)
      : b01(s), b11(s + F), b02(s + 2 * F), b12(s + 3 * F), k21(s + 4 * F),
        k22(s + 7 * F), ke2(s + 10 * F), b21(s + 13 * F), b22(s + 13 * F + 4) {}
};

// Per-block sums of the rows pass, n F + 12 F + 4 floats a block:
// dgp1 (n, F) | db02 (F) | dke2 (3, F) | db12 (F) | dk22 (F, 3) | db11 (F) |
// dk21 (F, 3) | db21 (3), 0
struct Sums {
  float *dgp1, *db02, *dke2, *db12, *dk22, *db11, *dk21, *db21;
  __host__ __device__ Sums(float* s, int F, int n)
      : dgp1(s), db02(s + size_t(n) * F), dke2(db02 + F), db12(dke2 + 3 * F),
        dk22(db12 + F), db11(dk22 + 3 * F), dk21(db11 + F), db21(dk21 + 3 * F) {}
};

// ----------------------------------------------------- the one-block form

// A row tile: tok tokens from t0, row r is point r >> ltok of token
// t0 + (r & (tok - 1)); rows >= n tok are padding.
struct Tile {
  int t0, tok, ltok, n, rows, mt_live;
  __device__ Tile(int tile, int ltok_, int n_)
      : t0(tile << ltok_), tok(1 << ltok_), ltok(ltok_), n(n_), rows(n_ << ltok_),
        mt_live(((n_ << ltok_) + 15) / 16) {}
  __device__ __forceinline__ long long grow(int r) const {   // row of the (Tp * n) arrays
    return static_cast<long long>(t0 + (r & (tok - 1))) * n + (r >> ltok);
  }
};

struct Layout {
  int ldx = 0, mw = 0;   // operand row stride (bf16); mask units (16 bits) a row
  size_t x = 0, ring = 0, g = 0, f1 = 0, df = 0, m0 = 0, m1 = 0, m2 = 0, m3 = 0, bytes = 0;
  __host__ __device__ constexpr Layout(int F, bool bwd) {
    ldx = F + 8;
    mw = F / 16;
    x = 0;
    ring = x + align128(size_t(MR) * ldx * 2);
    g = ring + align128(size_t(STAGES) * SLICE * 2);
    f1 = g + align128(MR * 4 * 4);
    df = f1 + align128(MR * 4 * 4);
    m0 = df + align128(MR * 4 * 4);
    const size_t mb = bwd ? align128(size_t(MR) * mw * 2) : 0;
    m1 = m0 + mb;
    m2 = m1 + mb;
    m3 = m2 + mb;
    bytes = m3 + mb;
  }
};

using Acc = float[MT][NJ][4];     // acc[m][j][e]: row 16 m + lane / 4 + 8 (e / 2),
                                  // column 32 warp + 8 j + 2 (lane % 4) + e % 2
using RowAcc = float[MT][2];      // a per-row sum over columns, output lane % 4
using RowPart = float[MT][2][3];  // per-row partials of the three outputs

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
}

__device__ __forceinline__ void zero(RowAcc& ra) {
#pragma unroll
  for (int m = 0; m < MT; ++m) ra[m][0] = ra[m][1] = 0.f;
}

__device__ __forceinline__ void zero(RowPart& s) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) s[m][h][0] = s[m][h][1] = s[m][h][2] = 0.f;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ unsigned quad_or(unsigned v) {
  v |= __shfl_xor_sync(0xffffffffu, v, 1);
  return v | __shfl_xor_sync(0xffffffffu, v, 2);
}

// sum over the eight row groups of a warp (lane / 4): column totals
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// The live rows' mask bits s_m (MR, F / 16) to gm ((Tp n), F / 16), 16 bytes
// a thread.
__device__ __forceinline__ void copy_bits(const uint16_t* s_m, uint16_t* __restrict__ gm,
                                          const Tile& T, int F) {
  const int vr = F / 128;   // 16-byte vectors a row
  for (int v = threadIdx.x; v < T.rows * vr; v += NT) {
    const int r = v / vr, k = v % vr;
    reinterpret_cast<uint4*>(gm + T.grow(r) * (F / 16))[k] =
        reinterpret_cast<const uint4*>(s_m + r * (F / 16))[k];
  }
}

// The row partials of a chunk into ra: ra[m][h] += the partial of output
// lane % 4 (lane % 4 == 3 adds a value nobody reads).
__device__ __forceinline__ void fold_rows(RowPart& s, RowAcc& ra, int mt_live) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= mt_live) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float s0 = quad_sum(s[m][h][0]), s1 = quad_sum(s[m][h][1]),
                  s2 = quad_sum(s[m][h][2]);
      ra[m][h] += q == 0 ? s0 : (q == 1 ? s1 : s2);
    }
  }
}

// One product over the resident operand s_x (MR, F) for every 128-column
// chunk of the output, the epilogue called with each chunk's accumulators:
//   NTR false: s_x @ W          W (F, F) row-major, slices (KS, CH)
//   NTR true:  s_x @ W^T        slices of W's rows (CH, KS)
// The slices stream through the STAGES-deep ring by cp.async. A warp owns
// 32 columns of the chunk over all MR rows: a k16 step is 5 A and 2 B
// fragment loads for 20 products.
template <bool NTR, typename Epi>
__device__ __forceinline__ void product(const bf16* s_x, int ldx, int mt_live, bf16* ring,
                                        const bf16* __restrict__ W, int F, Epi&& epi) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ns = (F / CH) * (F / KS);
  int lk = 0, lc = 0, lst = 0;   // the next slice to load: k and column offsets, stage
  auto load_next = [&]() {
    bf16* dst = ring + lst * SLICE;
    if (!NTR) {
#pragma unroll
      for (int v = tid; v < KS * (CH / 8); v += NT) {
        const int r = v / (CH / 8), c = (v % (CH / 8)) * 8;
        cp_async16(dst + r * LDN + c, W + size_t(lk + r) * F + lc + c);
      }
    } else {
#pragma unroll
      for (int v = tid; v < CH * (KS / 8); v += NT) {
        const int r = v / (KS / 8), c = (v % (KS / 8)) * 8;
        cp_async16(dst + r * LDK + c, W + size_t(lc + r) * F + lk + c);
      }
    }
    lst = lst + 1 == STAGES ? 0 : lst + 1;
    lk += KS;
    if (lk == F) {
      lk = 0;
      lc += CH;
    }
  };
  Acc acc;
  zero(acc);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ns) load_next();
    cp_async_commit();
  }
  int to_load = ns - (STAGES - 1), st = 0;   // slices not yet loaded; stage multiplied
  for (int c0 = 0; c0 < F; c0 += CH) {
    for (int k0 = 0; k0 < F; k0 += KS) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (to_load-- > 0) load_next();
      cp_async_commit();
      const bf16* b = ring + st * SLICE;
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        uint32_t bfr[NJ / 2][4];
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj) {
          if (!NTR)
            ldsm_x4_t(bfr[jj], b + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN +
                                   warp * 32 + jj * 16 + (lane >> 4) * 8);
          else
            ldsm_x4(bfr[jj], b + (warp * 32 + jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDK +
                                 16 * kk + ((lane >> 3) & 1) * 8);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m < mt_live) {
            uint32_t af[4];
            ldsm_x4(af, s_x + (m * 16 + (lane & 15)) * ldx + k0 + 16 * kk + (lane >> 4) * 8);
#pragma unroll
            for (int jj = 0; jj < NJ / 2; ++jj) {
              mma(acc[m][2 * jj], af, bfr[jj][0], bfr[jj][1]);
              mma(acc[m][2 * jj + 1], af, bfr[jj][2], bfr[jj][3]);
            }
          }
        }
      }
      st = st + 1 == STAGES ? 0 : st + 1;
    }
    epi(acc, c0);
    zero(acc);
  }
  cp_async_wait_all();
  __syncthreads();
}

// The mask bits v > 0 of a thread's four columns, gathered over the four
// lanes of a 16-column unit and stored by the first.
__device__ __forceinline__ void store_bits(uint16_t* dst, const float4& v) {
  const int lane = threadIdx.x & 31;
  unsigned bits = (unsigned(v.x > 0.f) | (unsigned(v.y > 0.f) << 1) |
                   (unsigned(v.z > 0.f) << 2) | (unsigned(v.w > 0.f) << 3))
                  << (4 * (lane & 3));
  bits = quad_or(bits);
  if ((lane & 3) == 0) *dst = static_cast<uint16_t>(bits);
}

__device__ __forceinline__ void store_bf16x4(bf16* dst, const float4& v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

__device__ __forceinline__ float4 load_bf16x4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 relu4(const float4& v) {
  return make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
}

constexpr int RQ = 4;             // row quarters of a build
constexpr int RB = MR / RQ / 2;   // rows a build step loads before it computes

// The builds of the resident operand: a work item is four columns of a row
// quarter (3 items a thread at F 384); its rows go RB at a time with their
// loads in flight together. The four lanes of a 16-column unit share a row
// quarter.
// a0 = relu((gp1[p] + sp1[t]) + b01); the masks a0 > 0 to s_m when given.
__device__ __forceinline__ void build_a0(bf16* s_x, int ldx, uint16_t* s_m, int mw,
                                         const float* __restrict__ sp,
                                         const bf16* __restrict__ gp1, const float* b01,
                                         const Tile& T, int F) {
  for (int it = threadIdx.x; it < (F / 4) * RQ; it += NT) {
    const int c = 4 * (it % (F / 4)), rq = it / (F / 4);
    const float4 bb = *reinterpret_cast<const float4*>(b01 + c);
    for (int r0 = rq * (MR / RQ); r0 < (rq + 1) * (MR / RQ); r0 += RB) {
      float4 s[RB], gq[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = r0 + i;
        s[i] = gq[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < T.rows) {
          const int t = T.t0 + (r & (T.tok - 1)), p = r >> T.ltok;
          s[i] = *reinterpret_cast<const float4*>(sp + size_t(t) * 2 * F + c);
          gq[i] = load_bf16x4(gp1 + size_t(p) * F + c);
        }
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = r0 + i;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < T.rows)
          v = make_float4((gq[i].x + s[i].x) + bb.x, (gq[i].y + s[i].y) + bb.y,
                          (gq[i].z + s[i].z) + bb.z, (gq[i].w + s[i].w) + bb.w);
        if (s_m != nullptr) store_bits(s_m + r * mw + c / 16, v);
        store_bf16x4(s_x + r * ldx + c, relu4(v));
      }
    }
  }
}

// a2 = relu(((f1b @ ke2) + sp2[t]) + b02) with f1b in s_f1 (MR, 4); masks as
// build_a0.
__device__ __forceinline__ void build_a2(bf16* s_x, int ldx, uint16_t* s_m, int mw,
                                         const float* s_f1, const float* __restrict__ sp,
                                         const Small& S, const Tile& T, int F) {
  for (int it = threadIdx.x; it < (F / 4) * RQ; it += NT) {
    const int c = 4 * (it % (F / 4)), rq = it / (F / 4);
    const float4 e0 = *reinterpret_cast<const float4*>(S.ke2 + c);
    const float4 e1 = *reinterpret_cast<const float4*>(S.ke2 + F + c);
    const float4 e2 = *reinterpret_cast<const float4*>(S.ke2 + 2 * F + c);
    const float4 bb = *reinterpret_cast<const float4*>(S.b02 + c);
    for (int r0 = rq * (MR / RQ); r0 < (rq + 1) * (MR / RQ); r0 += RB) {
      float4 s[RB];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = r0 + i;
        s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < T.rows)
          s[i] = *reinterpret_cast<const float4*>(sp + size_t(T.t0 + (r & (T.tok - 1))) * 2 * F +
                                                  F + c);
      }
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const int r = r0 + i;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < T.rows) {
          const float f0 = s_f1[r * 4], f1 = s_f1[r * 4 + 1], f2 = s_f1[r * 4 + 2];
          v = make_float4((((f0 * e0.x + f1 * e1.x) + f2 * e2.x) + s[i].x) + bb.x,
                          (((f0 * e0.y + f1 * e1.y) + f2 * e2.y) + s[i].y) + bb.y,
                          (((f0 * e0.z + f1 * e1.z) + f2 * e2.z) + s[i].z) + bb.z,
                          (((f0 * e0.w + f1 * e1.w) + f2 * e2.w) + s[i].w) + bb.w);
        }
        if (s_m != nullptr) store_bits(s_m + r * mw + c / 16, v);
        store_bf16x4(s_x + r * ldx + c, relu4(v));
      }
    }
  }
}

// The mask bits of a chunk's n8 tile pair (jj = 0, 1 of unit uu): bits[m][h]
// of the thread's columns, gathered over the quad and stored to s_m by lane %
// 4 == 0.
__device__ __forceinline__ void store_unit_bits(unsigned (&bits)[MT][2], const Tile& T,
                                                uint16_t* s_m, int mw, int u) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= T.mt_live) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned b = quad_or(bits[m][h]);
      const int r = m * 16 + (lane >> 2) + 8 * h;
      if ((lane & 3) == 0) s_m[r * mw + u] = static_cast<uint16_t>(b);
    }
  }
}

// The per-block a1 slot keeps the tile's rounded a1 in fragment order: the
// 16-byte vector of (chunk cc, warp w, m, h, lane) holds that lane's four
// packed column pairs (n8 tiles 0-3) of row 16 m + lane / 4 + 8 h.
__device__ __forceinline__ int a1_frag(int cc, int w, int m, int h, int lane) {
  return (((cc * NWARP + w) * MT + m) * 2 + h) * 32 + lane;
}

// Epilogue of an upper layer: ra[m][h] += sum over the chunk's columns of
// bf16(relu(acc + bias)) * k3[c][lane % 4]. BWD: also the masks h > 0 to
// s_m and the rounded activations to the a1 slot (a1_frag).
template <bool BWD>
__device__ __forceinline__ void epi_upper(const Acc& acc, RowAcc& ra, int c0, const float* bias,
                                          const float* k3, int F, const Tile& T,
                                          uint16_t* s_m = nullptr, int mw = 0,
                                          uint4* a1 = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  RowPart s;
  zero(s);
  uint32_t pk[MT][2][NJ];   // the rounded activations, packed pairs (BWD)
#pragma unroll
  for (int uu = 0; uu < NJ / 2; ++uu) {
    unsigned bits[MT][2] = {};
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * uu + jj;
      const int c = c0 + warp * 32 + j * 8 + 2 * q;
      const float2 bb = *reinterpret_cast<const float2*>(bias + c);
      float wk[2][3];
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        wk[0][o] = k3[c * 3 + o];
        wk[1][o] = k3[c * 3 + 3 + o];
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= T.mt_live) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float h0 = acc[m][j][2 * h] + bb.x, h1 = acc[m][j][2 * h + 1] + bb.y;
          const float a0 = bf_round(fmaxf(h0, 0.f)), a1v = bf_round(fmaxf(h1, 0.f));
#pragma unroll
          for (int o = 0; o < 3; ++o) s[m][h][o] += a0 * wk[0][o] + a1v * wk[1][o];
          if (BWD) {
            bits[m][h] |= (unsigned(h0 > 0.f) | (unsigned(h1 > 0.f) << 1)) << (jj * 8 + 2 * q);
            pk[m][h][j] = pack_bf16(a0, a1v);
          }
        }
      }
    }
    if (BWD) store_unit_bits(bits, T, s_m, mw, (c0 + warp * 32) / 16 + uu);
  }
  if (BWD)   // the slot in fragment order: 16 bytes a lane, a warp's 512 contiguous
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m >= T.mt_live) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a1[a1_frag(c0 / CH, warp, m, h, lane)] =
            make_uint4(pk[m][h][0], pk[m][h][1], pk[m][h][2], pk[m][h][3]);
    }
  fold_rows(s, ra, T.mt_live);
}

// A lane's kept column pair (lane / 4 == j, j < NJ: columns c0 + 8 j + 2
// (lane % 4) + e): s0[c] += keep[e][0] and s1[c sc + o so] += keep[e][1 + o],
// every old value loaded before any is stored (one round trip to L2).
__device__ __forceinline__ void add_cols(const float (&keep)[2][4], int c0, float* s0,
                                         float* s1, int sc, int so) {
  const int lane = threadIdx.x & 31;
  if ((lane >> 2) >= NJ) return;
  const int c = c0 + 8 * (lane >> 2) + 2 * (lane & 3);
  float old[2][4];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    old[e][0] = s0[c + e];
#pragma unroll
    for (int o = 0; o < 3; ++o) old[e][1 + o] = s1[(c + e) * sc + o * so];
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    s0[c + e] = old[e][0] + keep[e][0];
#pragma unroll
    for (int o = 0; o < 3; ++o) s1[(c + e) * sc + o * so] = old[e][1 + o] + keep[e][1 + o];
  }
}

// Column totals of cs (the thread's rows) over the warp; lane / 4 == j keeps
// them.
__device__ __forceinline__ void keep_cols(float (&cs)[2][4], float (&keep)[2][4], int j) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v = col_sum(cs[e][k]);
      if ((lane >> 2) == j) keep[e][k] = v;
    }
}

// Per-token sums of a column pair: ts over the thread's rows (all of token
// lane / 4 mod tok), summed over the lanes of that token; lanes lane / 4 <
// tok store bf16 to dspb[(t0 + lane / 4) 2F + off + c].
__device__ __forceinline__ void store_token_sums(float (&ts)[2], const Tile& T, bf16* dspb,
                                                 int F, int off, int c) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < 2; ++e)
    for (int sh = 4 << T.ltok; sh <= 16; sh <<= 1) ts[e] += __shfl_xor_sync(0xffffffffu, ts[e], sh);
  if ((lane >> 2) < T.tok)
    *reinterpret_cast<uint32_t*>(dspb + size_t(T.t0 + (lane >> 2)) * 2 * F + off + c) =
        pack_bf16(ts[0], ts[1]);
}

// The per-row sums of the warps (in warp order) after a product: fin(r, o,
// sum) for every row r < MR and o < 3. red is the idle ring.
template <typename Fin>
__device__ __forceinline__ void reduce_rows(const RowAcc& ra, const Tile& T, float* red,
                                            Fin&& fin) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= T.mt_live) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (q < 3) red[(warp * MR + m * 16 + (lane >> 2) + 8 * h) * 3 + q] = ra[m][h];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < MR * 3; e += NT) {
    const int r = e / 3, o = e % 3;
    float s = 0.f;
    if (r < T.mt_live * 16)
      for (int w = 0; w < NWARP; ++w) s += red[(w * MR + r) * 3 + o];
    fin(r, o, s);
  }
  __syncthreads();
}

// ------------------------------------------------------------------ forward

// One block a tile of tok tokens, two blocks an SM.
__global__ void __launch_bounds__(NT, 2)
fold_fwd_kernel(const float* __restrict__ sp, const bf16* __restrict__ gp1,
                const bf16* __restrict__ k11, const bf16* __restrict__ k12,
                const float* __restrict__ small, float* __restrict__ out, int F, int n,
                int ltok) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(F, false);
  bf16* s_x = reinterpret_cast<bf16*>(smem + L.x);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  float* s_f1 = reinterpret_cast<float*>(smem + L.f1);
  const Small S(small, F);
  const Tile T(blockIdx.x, ltok, n);

  RowAcc ra;
  build_a0(s_x, L.ldx, nullptr, 0, sp, gp1, S.b01, T, F);
  zero(ra);
  product<false>(s_x, L.ldx, T.mt_live, ring, k11, F, [&](const Acc& acc, int c0) {
    epi_upper<false>(acc, ra, c0, S.b11, S.k21, F, T);
  });
  reduce_rows(ra, T, reinterpret_cast<float*>(ring), [&](int r, int o, float s) {
    s_f1[r * 4 + o] = bf_round(s + S.b21[o]);
  });
  build_a2(s_x, L.ldx, nullptr, 0, s_f1, sp, S, T, F);
  zero(ra);
  product<false>(s_x, L.ldx, T.mt_live, ring, k12, F, [&](const Acc& acc, int c0) {
    epi_upper<false>(acc, ra, c0, S.b12, S.k22, F, T);
  });
  reduce_rows(ra, T, reinterpret_cast<float*>(ring), [&](int r, int o, float s) {
    if (r < T.rows) out[T.grow(r) * 3 + o] = s + S.b22[o];
  });
}

// ------------------------------------------------------ backward, rows pass

__global__ void __launch_bounds__(NT, 2)
fold_bwd_rows_kernel(const float* __restrict__ sp, const bf16* __restrict__ gp1,
                     const bf16* __restrict__ k11, const bf16* __restrict__ k12,
                     const float* __restrict__ small, const float* __restrict__ g,
                     float* __restrict__ f1s, float* __restrict__ df1s,
                     uint16_t* __restrict__ m1g, uint16_t* __restrict__ m3g, bf16* a1s,
                     bf16* __restrict__ dspb, float* __restrict__ part_a, int F, int n,
                     int ltok, int ntiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(F, true);
  bf16* s_x = reinterpret_cast<bf16*>(smem + L.x);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  float* red = reinterpret_cast<float*>(ring);
  float* s_g = reinterpret_cast<float*>(smem + L.g);
  float* s_f1 = reinterpret_cast<float*>(smem + L.f1);
  float* s_df = reinterpret_cast<float*>(smem + L.df);
  uint16_t* s_m0 = reinterpret_cast<uint16_t*>(smem + L.m0);
  uint16_t* s_m1 = reinterpret_cast<uint16_t*>(smem + L.m1);
  uint16_t* s_m2 = reinterpret_cast<uint16_t*>(smem + L.m2);
  uint16_t* s_m3 = reinterpret_cast<uint16_t*>(smem + L.m3);
  const Small S(small, F);
  const Sums P(part_a + size_t(blockIdx.x) * (size_t(n) * F + 12 * F + 4), F, n);
  uint4* a1 = reinterpret_cast<uint4*>(a1s + size_t(blockIdx.x) * MR * F);   // a1 of the tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
  const int mw = L.mw, ldx = L.ldx;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const Tile T(tile, ltok, n);
    for (int e = threadIdx.x; e < MR * 4; e += NT) {
      const int r = e >> 2, o = e & 3;
      s_g[e] = (r < T.rows && o < 3) ? bf_round(g[T.grow(r) * 3 + o]) : 0.f;
    }

    // stage 1 recomputed: a1 (slot), its bits, f1
    RowAcc ra;
    build_a0(s_x, ldx, s_m0, mw, sp, gp1, S.b01, T, F);
    zero(ra);
    product<false>(s_x, ldx, T.mt_live, ring, k11, F, [&](const Acc& acc, int c0) {
      epi_upper<true>(acc, ra, c0, S.b11, S.k21, F, T, s_m1, mw, a1);
    });
    copy_bits(s_m1, m1g, T, F);
    reduce_rows(ra, T, red, [&](int r, int o, float s) {
      const float v = bf_round(s + S.b21[o]);
      s_f1[r * 4 + o] = v;
      if (r < T.rows) f1s[T.grow(r) * 4 + o] = v;
    });

    // stage 2 recomputed: the bits of a3, db12, dk22
    build_a2(s_x, ldx, s_m2, mw, s_f1, sp, S, T, F);
    product<false>(s_x, ldx, T.mt_live, ring, k12, F, [&](const Acc& acc, int c0) {
      float keep[2][4] = {};
#pragma unroll
      for (int uu = 0; uu < NJ / 2; ++uu) {
        unsigned bits[MT][2] = {};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * uu + jj;
          const int c = c0 + warp * 32 + j * 8 + 2 * q;
          const float2 b12 = *reinterpret_cast<const float2*>(S.b12 + c);
          float w[2][3], cs[2][4] = {};
#pragma unroll
          for (int o = 0; o < 3; ++o) {
            w[0][o] = S.k22[c * 3 + o];
            w[1][o] = S.k22[c * 3 + 3 + o];
          }
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m >= T.mt_live) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = m * 16 + (lane >> 2) + 8 * h;
              const float g0 = s_g[r * 4], g1 = s_g[r * 4 + 1], g2 = s_g[r * 4 + 2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float hv = acc[m][j][2 * h + e] + (e ? b12.y : b12.x);
                const bool on = hv > 0.f;
                const float a3 = bf_round(fmaxf(hv, 0.f));
                const float dh3 = on ? (g0 * w[e][0] + g1 * w[e][1]) + g2 * w[e][2] : 0.f;
                cs[e][0] += dh3;
                cs[e][1] += a3 * g0;
                cs[e][2] += a3 * g1;
                cs[e][3] += a3 * g2;
                bits[m][h] |= unsigned(on) << (jj * 8 + 2 * q + e);
              }
            }
          }
          keep_cols(cs, keep, j);
        }
        store_unit_bits(bits, T, s_m3, mw, (c0 + warp * 32) / 16 + uu);
      }
      add_cols(keep, c0 + warp * 32, P.db12, P.dk22, 3, 1);
    });
    copy_bits(s_m3, m3g, T, F);

    // the operand becomes bf16(dh3), dh3 = (h3 > 0) (gb @ k22^T)
    for (int it = threadIdx.x; it < (F / 4) * RQ; it += NT) {
      const int c = 4 * (it % (F / 4)), rq = it / (F / 4);
      float w[4][3];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int o = 0; o < 3; ++o) w[k][o] = S.k22[(c + k) * 3 + o];
      for (int r = rq * (MR / RQ); r < (rq + 1) * (MR / RQ); ++r) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        if (r < T.rows) {
          const unsigned word = s_m3[r * mw + c / 16] >> (c % 16);
          const float g0 = s_g[r * 4], g1 = s_g[r * 4 + 1], g2 = s_g[r * 4 + 2];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if ((word >> k) & 1u) d[k] = (g0 * w[k][0] + g1 * w[k][1]) + g2 * w[k][2];
        }
        store_bf16x4(s_x + r * ldx + c, make_float4(d[0], d[1], d[2], d[3]));
      }
    }

    // dh2 = (a2 > 0) (dh3b @ k12^T): df1, db02, dke2, dsp2
    zero(ra);
    product<true>(s_x, ldx, T.mt_live, ring, k12, F, [&](const Acc& acc, int c0) {
      RowPart s;
      zero(s);
      float keep[2][4] = {};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = c0 + warp * 32 + j * 8 + 2 * q;
        const int u = (c0 + warp * 32) / 16 + (j >> 1);
        float ke[2][3], cs[2][4] = {}, ts[2] = {0.f, 0.f};
#pragma unroll
        for (int o = 0; o < 3; ++o) {
          ke[0][o] = S.ke2[o * F + c];
          ke[1][o] = S.ke2[o * F + c + 1];
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m >= T.mt_live) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m * 16 + (lane >> 2) + 8 * h;
            const unsigned word = unsigned(s_m2[r * mw + u]) >> ((j & 1) * 8 + 2 * q);
            const float f0 = s_f1[r * 4], f1 = s_f1[r * 4 + 1], f2 = s_f1[r * 4 + 2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dh = (word >> e) & 1u ? acc[m][j][2 * h + e] : 0.f;
              const float b = bf_round(dh);
#pragma unroll
              for (int o = 0; o < 3; ++o) s[m][h][o] += b * ke[e][o];
              cs[e][0] += dh;
              cs[e][1] += f0 * b;
              cs[e][2] += f1 * b;
              cs[e][3] += f2 * b;
              ts[e] += dh;
            }
          }
        }
        store_token_sums(ts, T, dspb, F, F, c);
        keep_cols(cs, keep, j);
      }
      fold_rows(s, ra, T.mt_live);
      add_cols(keep, c0 + warp * 32, P.db02, P.dke2, 1, F);
    });
    reduce_rows(ra, T, red, [&](int r, int o, float s) { s_df[r * 4 + o] = s; });

    // df1 is complete: db21 from the unrounded sums, df1b to s_df and scratch
    if (threadIdx.x < 3) {
      float s = 0.f;
      for (int r = 0; r < T.rows; ++r) s += s_df[r * 4 + threadIdx.x];
      P.db21[threadIdx.x] += s;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < MR * 4; e += NT) {
      const int r = e >> 2, o = e & 3;
      const float v = o < 3 ? bf_round(s_df[e]) : 0.f;
      s_df[e] = v;
      if (r < T.rows) df1s[T.grow(r) * 4 + o] = v;
    }
    __syncthreads();

    // the operand becomes bf16(dh1), dh1 = (a1 > 0) (df1b @ k21^T); db11
    // and dk21 = a1b^T @ df1b beside it (a thread owns four columns)
    for (int cq = threadIdx.x; cq < F / 4; cq += NT) {
      const int c = 4 * cq;
      float w[4][3], ek[4][3] = {}, sb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int o = 0; o < 3; ++o) w[k][o] = S.k21[(c + k) * 3 + o];
      for (int r0 = 0; r0 < MR; r0 += RB) {
        float4 av[RB];
#pragma unroll
        for (int i = 0; i < RB; ++i) {   // padding rows' slot entries may be stale
          const int r = r0 + i;
          av[i] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (r < T.rows) {
            // columns c, c + 1 and c + 2, c + 3: lanes l and l + 1 of n8 tile j
            const uint32_t* v = reinterpret_cast<const uint32_t*>(
                a1 + a1_frag(c / CH, (c % CH) / 32, r / 16, (r / 8) & 1, (r % 8) * 4 + (c / 2) % 4));
            const int j = (c / 8) % 4;
            const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v + j));
            const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v + 4 + j));
            av[i] = make_float4(lo.x, lo.y, hi.x, hi.y);
          }
        }
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const int r = r0 + i;
          const float d0 = s_df[r * 4], d1 = s_df[r * 4 + 1], d2 = s_df[r * 4 + 2];
          const unsigned word = s_m1[r * mw + c / 16] >> (c % 16);
          float hk[4] = {0.f, 0.f, 0.f, 0.f};
          const float a[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (r < T.rows && ((word >> k) & 1u)) hk[k] = (d0 * w[k][0] + d1 * w[k][1]) + d2 * w[k][2];
            sb[k] += hk[k];
            ek[k][0] += a[k] * d0;
            ek[k][1] += a[k] * d1;
            ek[k][2] += a[k] * d2;
          }
          store_bf16x4(s_x + r * ldx + c, make_float4(hk[0], hk[1], hk[2], hk[3]));
        }
      }
      const float4 ob = *reinterpret_cast<const float4*>(P.db11 + c);
      float4 ok[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) ok[i] = reinterpret_cast<const float4*>(P.dk21 + c * 3)[i];
      *reinterpret_cast<float4*>(P.db11 + c) =
          make_float4(ob.x + sb[0], ob.y + sb[1], ob.z + sb[2], ob.w + sb[3]);
      float* okf = reinterpret_cast<float*>(ok);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int o = 0; o < 3; ++o) okf[k * 3 + o] += ek[k][o];
#pragma unroll
      for (int i = 0; i < 3; ++i) reinterpret_cast<float4*>(P.dk21 + c * 3)[i] = ok[i];
    }

    // dh0 = (a0 > 0) (dh1b @ k11^T): dsp1 (per token), dgp1 (per point)
    product<true>(s_x, ldx, T.mt_live, ring, k11, F, [&](const Acc& acc, int c0) {
      const bool own = ((lane >> 2) & (T.tok - 1)) == 0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = c0 + warp * 32 + j * 8 + 2 * q;
        const int u = (c0 + warp * 32) / 16 + (j >> 1);
        float ts[2] = {0.f, 0.f}, v[MT][2][2];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m >= T.mt_live) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned word =
                unsigned(s_m0[(m * 16 + (lane >> 2) + 8 * h) * mw + u]) >> ((j & 1) * 8 + 2 * q);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dh = (word >> e) & 1u ? acc[m][j][2 * h + e] : 0.f;
              ts[e] += dh;
              float x = dh;   // summed over the tile's tokens: the point's total
              for (int sh = 4; sh < (4 << T.ltok); sh <<= 1)
                x += __shfl_xor_sync(0xffffffffu, x, sh);
              v[m][h][e] = x;
            }
          }
        }
        store_token_sums(ts, T, dspb, F, 0, c);
        // the points' partials of dgp1, loaded together, then stored
        float2 cur[MT][2];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = (m * 16 + (lane >> 2) + 8 * h) >> T.ltok;
            cur[m][h] = own && m < T.mt_live && p < T.n
                            ? *reinterpret_cast<const float2*>(P.dgp1 + size_t(p) * F + c)
                            : make_float2(0.f, 0.f);
          }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = (m * 16 + (lane >> 2) + 8 * h) >> T.ltok;
            if (own && m < T.mt_live && p < T.n)
              *reinterpret_cast<float2*>(P.dgp1 + size_t(p) * F + c) =
                  make_float2(cur[m][h].x + v[m][h][0], cur[m][h].y + v[m][h][1]);
          }
      }
    });
  }
}

// --------------------------------------------------- backward, weights pass

// grid ((F / WT)^2 tiles, parts, 2 stages), 256 threads. Block (tile, part,
// s) owns the WT x WT tile (i0, j0) of stage s's wide weight gradient
//   dk11 = a0b^T @ dh1b   or   dk12 = a2b^T @ dh3b
// over the rows of its partition, KR rows a slab: its WT columns of both
// operands are rebuilt elementwise (a0 from gp1, sp1, b01; dh1 from the mask
// bits of a1, df1b and k21; a2 from f1b, ke2, sp2, b02; dh3 from the mask
// bits of a3, gb and k22). A slab's row facts (the offsets of its sp and
// gp1 rows, the 3-wide values, the tile's four mask words) are read once
// into shared memory two slabs ahead; its elements are built one slab ahead, into one buffer while
// the other is multiplied. Warps 2 x 4, a warp 64 x 32 of the tile.
// Output: dkp (2, parts, F, F) f32.
struct SlabInfo {
  int tp[KR][2];        // offsets of the row's sp half and gp1 row (-1: past the rows)
  float v[KR][4];       // df1b (stage 1) or gb (stage 2)
  float f[KR][4];       // f1b (stage 2)
  uint32_t m[KR][4];    // the tile's mask words
};

constexpr size_t WEIGHTS_SMEM = 2 * (2 * KR * LDT * 2 + sizeof(SlabInfo));

__global__ void __launch_bounds__(WNT, 2)
fold_bwd_weights_kernel(const float* __restrict__ sp, const bf16* __restrict__ gp1,
                        const float* __restrict__ small, const float* __restrict__ g,
                        const float* __restrict__ f1s, const float* __restrict__ df1s,
                        const uint32_t* __restrict__ m1g, const uint32_t* __restrict__ m3g,
                        float* __restrict__ dkp, int rows_total, int F, int n,
                        int chunks_per_part) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf = reinterpret_cast<bf16*>(smem);   // 2 x (s_at, s_dt), each KR x LDT
  SlabInfo* info = reinterpret_cast<SlabInfo*>(smem + 2 * 2 * KR * LDT * 2);
  const Small S(small, F);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wi = warp >> 2, wj = warp & 3;
  const int tiles = F / WT;
  const int i0 = (blockIdx.x / tiles) * WT, j0 = (blockIdx.x % tiles) * WT;
  const int part = blockIdx.y, stage = blockIdx.z, parts = gridDim.y;
  const int MW = F / 32;
  const int cp = threadIdx.x % (WT / 2), rq = threadIdx.x / (WT / 2);   // column pair, row lane
  const int ci = i0 + 2 * cp;
  const uint32_t* mg = stage ? m3g : m1g;
  const float* k3 = (stage ? S.k22 : S.k21) + (j0 + 2 * cp) * 3;
  float w[2][3];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int o = 0; o < 3; ++o) w[e][o] = k3[e * 3 + o];
  const float2 bi = *reinterpret_cast<const float2*>((stage ? S.b02 : S.b01) + ci);
  const float2 e0 = *reinterpret_cast<const float2*>(S.ke2 + ci);
  const float2 e1 = *reinterpret_cast<const float2*>(S.ke2 + F + ci);
  const float2 e2 = *reinterpret_cast<const float2*>(S.ke2 + 2 * F + ci);
  const int mword = cp / 16, mshift = (2 * cp) % 32;

  const int nchunks = (rows_total + KR - 1) / KR;
  const int first = part * chunks_per_part;
  const int last = min(nchunks, first + chunks_per_part);

  // a slab row's facts, fetched into registers (threads < KR) and stored later
  struct Facts {
    int t, p;
    float4 v, f;
    uint4 m;
  };
  auto fetch = [&](int chunk) {
    Facts x{-1, 0, make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f),
            make_uint4(0u, 0u, 0u, 0u)};
    const int row = chunk * KR + static_cast<int>(threadIdx.x);
    if (row >= rows_total) return x;
    const int t = row / n;
    x.t = t * 2 * F + (stage ? F : 0);
    x.p = (row - t * n) * F;
    if (stage) {
      x.v = make_float4(bf_round(g[size_t(row) * 3]), bf_round(g[size_t(row) * 3 + 1]),
                        bf_round(g[size_t(row) * 3 + 2]), 0.f);
      x.f = *reinterpret_cast<const float4*>(f1s + size_t(row) * 4);
    } else {
      x.v = *reinterpret_cast<const float4*>(df1s + size_t(row) * 4);
    }
    x.m = *reinterpret_cast<const uint4*>(mg + size_t(row) * MW + j0 / 32);
    return x;
  };
  auto commit = [&](const Facts& x, SlabInfo& in) {
    const int r = threadIdx.x;
    in.tp[r][0] = x.t;
    in.tp[r][1] = x.p;
    *reinterpret_cast<float4*>(in.v[r]) = x.v;
    *reinterpret_cast<float4*>(in.f[r]) = x.f;
    *reinterpret_cast<uint4*>(in.m[r]) = x.m;
  };

  constexpr int RPT = KR / (WNT / (WT / 2));   // rows a thread builds a slab (16)
  constexpr int WB = 8;                         // rows whose loads go out together
  const float* spc = sp + ci;
  const bf16* gpc = gp1 + ci;
  auto build = [&](const SlabInfo& in, bf16* s_at) {
    bf16* s_dt = s_at + KR * LDT;
#pragma unroll
    for (int r0 = 0; r0 < RPT; r0 += WB) {
      float2 sv[WB], gv[WB];
#pragma unroll
      for (int i = 0; i < WB; ++i) {
        const int r = rq + 4 * (r0 + i);
        const int2 tp = *reinterpret_cast<const int2*>(in.tp[r]);
        sv[i] = gv[i] = make_float2(0.f, 0.f);
        if (tp.x >= 0) {
          sv[i] = *reinterpret_cast<const float2*>(spc + tp.x);
          if (!stage) gv[i] = bf2_to_f2(gpc + tp.y);
        }
      }
#pragma unroll
      for (int i = 0; i < WB; ++i) {
        const int r = rq + 4 * (r0 + i);
        float a0 = 0.f, a1 = 0.f, d0 = 0.f, d1 = 0.f;
        if (in.tp[r][0] >= 0) {
          if (stage) {
            const float f0 = in.f[r][0], f1 = in.f[r][1], f2 = in.f[r][2];
            a0 = (((f0 * e0.x + f1 * e1.x) + f2 * e2.x) + sv[i].x) + bi.x;
            a1 = (((f0 * e0.y + f1 * e1.y) + f2 * e2.y) + sv[i].y) + bi.y;
          } else {
            a0 = (gv[i].x + sv[i].x) + bi.x;
            a1 = (gv[i].y + sv[i].y) + bi.y;
          }
          const float v0 = in.v[r][0], v1 = in.v[r][1], v2 = in.v[r][2];
          const unsigned word = in.m[r][mword] >> mshift;
          if (word & 1u) d0 = (v0 * w[0][0] + v1 * w[0][1]) + v2 * w[0][2];
          if (word & 2u) d1 = (v0 * w[1][0] + v1 * w[1][1]) + v2 * w[1][2];
        }
        *reinterpret_cast<uint32_t*>(s_at + r * LDT + 2 * cp) =
            pack_bf16(fmaxf(a0, 0.f), fmaxf(a1, 0.f));
        *reinterpret_cast<uint32_t*>(s_dt + r * LDT + 2 * cp) = pack_bf16(d0, d1);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

  // info of slab k sits in info[k & 1], its elements in buf[k & 1]
  const bool fetcher = threadIdx.x < KR;
  if (fetcher && first < last) commit(fetch(first), info[0]);
  if (fetcher && first + 1 < last) commit(fetch(first + 1), info[1]);
  __syncthreads();
  if (first < last) build(info[0], buf);
  __syncthreads();
  for (int chunk = first; chunk < last; ++chunk) {
    const int cur = (chunk - first) & 1;
    const bool ahead = fetcher && chunk + 2 < last;
    Facts nxt;
    if (ahead) nxt = fetch(chunk + 2);
    if (chunk + 1 < last) build(info[cur ^ 1], buf + (cur ^ 1) * 2 * KR * LDT);
    const bf16* s_at = buf + cur * 2 * KR * LDT;
    const bf16* s_dt = s_at + KR * LDT;
#pragma unroll
    for (int kk = 0; kk < KR / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        ldsm_x4_t(af[a], s_at + (16 * kk + (lane & 7) + ((lane >> 4) & 1) * 8) * LDT + wi * 64 +
                             a * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, s_dt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDT + wj * 32 +
                           b * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          mma(acc[a][2 * b], af[a], bfr[0], bfr[1]);
          mma(acc[a][2 * b + 1], af[a], bfr[2], bfr[3]);
        }
      }
    }
    if (ahead) commit(nxt, info[cur]);
    __syncthreads();
  }

  float* dk = dkp + (size_t(stage) * parts + part) * F * F;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + wi * 64 + a * 16 + (lane >> 2) + 8 * h;
        const int j = j0 + wj * 32 + b * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(dk + size_t(i) * F + j) =
            make_float2(acc[a][b][2 * h], acc[a][b][2 * h + 1]);
      }
}

// ------------------------------------------------- small GEMMs and the sums

// C (M, N) f32 = op(A) @ op(B), bf16 operands, mma.sync from 64 x 128
// tiles of C; K in slices of 32 through a three-stage cp.async ring; 4
// warps, each 32 x 64 of the tile.
//   TA false: A (M, K) row-major; true: A (K, M) row-major (C = A^T @ ...)
//   TB false: B (K, N) row-major; true: B (N, K) row-major (C = ... @ B^T)
// M % 64 == 0, N % 128 == 0, K % 8 == 0 (a ragged last slice reads zeros).
// blockIdx.z takes K rows [z kc, (z + 1) kc) into the z-th (M, N) slice of C.
constexpr int GBM = 64, GBN = 128, GBK = 32, GST = 3;
constexpr int GSA = (GBK * (GBM + 8) > GBM * (GBK + 8)) ? GBK * (GBM + 8) : GBM * (GBK + 8);
constexpr int GSB = (GBK * (GBN + 8) > GBN * (GBK + 8)) ? GBK * (GBN + 8) : GBN * (GBK + 8);

template <bool TA, bool TB>
__global__ void __launch_bounds__(128)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ C,
            int M, int N, int K, int kc) {
  __shared__ __align__(128) bf16 sa[GST][GSA];
  __shared__ __align__(128) bf16 sb[GST][GSB];
  constexpr int LA = TA ? GBM + 8 : GBK + 8, LB = TB ? GBK + 8 : GBN + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int kb = blockIdx.z * kc, ke = min(K, kb + kc);
  C += size_t(blockIdx.z) * M * N;
  const int ns = ke > kb ? (ke - kb + GBK - 1) / GBK : 0;

  auto load = [&](int s) {
    const int k0 = kb + s * GBK, st = s % GST;
    for (int v = tid; v < GBM * GBK / 8; v += 128) {
      if (TA) {   // rows k, columns m
        const int r = v / (GBM / 8), c = (v % (GBM / 8)) * 8;
        const bool ok = k0 + r < ke;
        cp_async16(&sa[st][r * LA + c], A + (ok ? size_t(k0 + r) * M + m0 + c : 0), ok);
      } else {    // rows m, columns k
        const int r = v / (GBK / 8), c = (v % (GBK / 8)) * 8;
        const bool ok = k0 + c < ke;
        cp_async16(&sa[st][r * LA + c], A + (ok ? size_t(m0 + r) * K + k0 + c : 0), ok);
      }
    }
    for (int v = tid; v < GBN * GBK / 8; v += 128) {
      if (TB) {   // rows n, columns k
        const int r = v / (GBK / 8), c = (v % (GBK / 8)) * 8;
        const bool ok = k0 + c < ke;
        cp_async16(&sb[st][r * LB + c], B + (ok ? size_t(n0 + r) * K + k0 + c : 0), ok);
      } else {    // rows k, columns n
        const int r = v / (GBN / 8), c = (v % (GBN / 8)) * 8;
        const bool ok = k0 + r < ke;
        cp_async16(&sb[st][r * LB + c], B + (ok ? size_t(k0 + r) * N + n0 + c : 0), ok);
      }
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < GST - 1; ++s) {
    if (s < ns) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < ns; ++s) {
    cp_async_wait<GST - 2>();
    __syncthreads();
    if (s + GST - 1 < ns) load(s + GST - 1);
    cp_async_commit();
    const bf16* a = sa[s % GST];
    const bf16* b = sb[s % GST];
#pragma unroll
    for (int kk = 0; kk < GBK / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (TA)
          ldsm_x4_t(af[i], a + (16 * kk + (lane & 7) + ((lane >> 4) & 1) * 8) * LA + wm * 32 +
                               i * 16 + ((lane >> 3) & 1) * 8);
        else
          ldsm_x4(af[i], a + (wm * 32 + i * 16 + (lane & 15)) * LA + 16 * kk + (lane >> 4) * 8);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t bfr[4];
        if (TB)
          ldsm_x4(bfr, b + (wn * 64 + jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LB + 16 * kk +
                           ((lane >> 3) & 1) * 8);
        else
          ldsm_x4_t(bfr, b + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LB + wn * 64 +
                             jj * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(acc[i][2 * jj], af[i], bfr[0], bfr[1]);
          mma(acc[i][2 * jj + 1], af[i], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait_all();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm * 32 + i * 16 + (lane >> 2) + 8 * h;
        const int c = n0 + wn * 64 + j * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(C + size_t(r) * N + c) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

template <bool TA, bool TB>
cudaError_t gemm(const bf16* A, const bf16* B, float* C, int M, int N, int K,
                 cudaStream_t stream) {
  gemm_kernel<TA, TB><<<dim3(N / GBN, M / GBM), 128, 0, stream>>>(A, B, C, M, N, K, K);
  return cudaGetLastError();
}

__global__ void fold_sum_partials_kernel(const float* __restrict__ in, int parts, long long n,
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
  fold_sum_partials_kernel<<<blocks, 256, 0, stream>>>(in, parts, n, out);
  return cudaGetLastError();
}

// C (M, N) = A^T @ B with A (K, M), B (K, N), K split KSPLIT ways into
// kpart (KSPLIT, M, N), then summed in order.
cudaError_t gemm_tn_split(const bf16* A, const bf16* B, float* C, float* kpart, int M, int N,
                          long long K, cudaStream_t stream) {
  const long long kc = ((K + KSPLIT - 1) / KSPLIT + GBK - 1) / GBK * GBK;
  gemm_kernel<true, false><<<dim3(N / GBN, M / GBM, KSPLIT), 128, 0, stream>>>(
      A, B, kpart, M, N, static_cast<int>(K), static_cast<int>(kc));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials(kpart, KSPLIT, static_cast<long long>(M) * N, C, stream);
}

// --------------------------------------------------------------- wide form
// Rows are token-major (row t n + p), R = Tp n; every pass a grid-stride
// loop. A..D bf16 (R, F) hiddens, H an f32 (R, F) product.

inline int grid_for(long long work) {
  const long long want = (work + 255) / 256;
  return static_cast<int>(want < 132 * 16 ? want : 132 * 16);
}

#define PDAE_GRID_LOOP(i, total)                                                       \
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;    \
       i < (total); i += static_cast<long long>(gridDim.x) * blockDim.x)

// a0 (stage 0) = relu((gp1[p] + sp1[t]) + b01); a2 (stage 1) =
// relu(((f1b @ ke2) + sp2[t]) + b02)
__global__ void wide_build_kernel(const float* __restrict__ sp, const bf16* __restrict__ gp1,
                                  const float* __restrict__ f1, const float* __restrict__ small,
                                  bf16* __restrict__ A, long long R, int F, int n, int stage) {
  const Small S(small, F);
  PDAE_GRID_LOOP(i, R * (F / 2)) {
    const long long row = i / (F / 2);
    const int c = static_cast<int>(i % (F / 2)) * 2;
    const long long t = row / n;
    const int p = static_cast<int>(row % n);
    float v[2];
    for (int e = 0; e < 2; ++e) {
      if (stage == 0) {
        v[e] = (__bfloat162float(gp1[size_t(p) * F + c + e]) + sp[t * 2 * F + c + e]) +
               S.b01[c + e];
      } else {
        const float* f = f1 + row * 4;
        const float pp = (f[0] * S.ke2[c + e] + f[1] * S.ke2[F + c + e]) + f[2] * S.ke2[2 * F + c + e];
        v[e] = (pp + sp[t * 2 * F + F + c + e]) + S.b02[c + e];
      }
    }
    *reinterpret_cast<uint32_t*>(A + row * F + c) = pack_bf16(fmaxf(v[0], 0.f), fmaxf(v[1], 0.f));
  }
}

// A = bf16(relu(H + bias))
__global__ void wide_relu_bias_kernel(const float* __restrict__ H, const float* __restrict__ bias,
                                      bf16* __restrict__ A, long long R, int F) {
  PDAE_GRID_LOOP(i, R * F) {
    A[i] = __float2bfloat16(fmaxf(H[i] + bias[i % F], 0.f));
  }
}

// out[r, o] = sum_c A[r, c] w[o ws_o + c ws_c] (+ bias[o]), rounded to bf16
// when asked; a warp a row, out rows `ostride` floats apart.
__global__ void wide_rowdot3_kernel(const bf16* __restrict__ A, const float* __restrict__ w,
                                    int ws_o, int ws_c, const float* __restrict__ bias,
                                    int round, float* __restrict__ out, int ostride,
                                    long long R, int F) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  for (long long row = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) / 32;
       row < R; row += warps) {
    float s[3] = {0.f, 0.f, 0.f};
    for (int c = lane; c < F; c += 32) {
      const float a = __bfloat162float(A[row * F + c]);
      for (int o = 0; o < 3; ++o) s[o] += a * w[o * ws_o + c * ws_c];
    }
    for (int o = 0; o < 3; ++o) {
      float v = warp_sum(s[o]);
      if (bias != nullptr) v += bias[o];
      if (lane == 0) out[row * ostride + o] = round ? bf_round(v) : v;
    }
    if (lane == 0 && ostride == 4) out[row * 4 + 3] = 0.f;
  }
}

// Column sums over a row partition, one block per 32 columns and partition,
// 8 row lanes; partials (parts, 4, F): sum d and sum u v[o].
//   MODE 0 (dh3): d = (M > 0) (bf16(v) @ k3[c]), v = g (3 wide); u = M = a3b
//   MODE 1 (dh2): d = (M > 0) H, written back to H; u = bf16(d); v = f1b
//   MODE 2 (dh1): d = (M > 0) (bf16(v) @ k3[c]), v = df1 (4 wide); u = M = a1b
// Each writes D = bf16(d).
template <int MODE>
__global__ void __launch_bounds__(256)
wide_cols_kernel(const bf16* __restrict__ M, const float* __restrict__ v, int vs,
                 const float* __restrict__ k3, float* H, bf16* __restrict__ D,
                 float* __restrict__ part, long long R, int F, long long rows_per_part) {
  __shared__ float red[8][32][4];
  const int cl = threadIdx.x & 31, rl = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + cl;
  const long long r0 = blockIdx.y * rows_per_part;
  const long long r1 = min(R, r0 + rows_per_part);
  float w[3] = {0.f, 0.f, 0.f};
  if (MODE != 1)
    for (int o = 0; o < 3; ++o) w[o] = k3[c * 3 + o];
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (long long r = r0 + rl; r < r1; r += 8) {
    const size_t i = size_t(r) * F + c;
    const float m = __bfloat162float(M[i]);
    float vv[3];
    for (int o = 0; o < 3; ++o) vv[o] = MODE == 1 ? v[r * vs + o] : bf_round(v[r * vs + o]);
    float d, u;
    if (MODE == 1) {
      d = m > 0.f ? H[i] : 0.f;
      H[i] = d;
      u = bf_round(d);
    } else {
      d = m > 0.f ? (vv[0] * w[0] + vv[1] * w[1]) + vv[2] * w[2] : 0.f;
      u = m;
    }
    D[i] = __float2bfloat16(d);
    s[0] += d;
    for (int o = 0; o < 3; ++o) s[1 + o] += u * vv[o];
  }
  for (int k = 0; k < 4; ++k) red[rl][cl][k] = s[k];
  __syncthreads();
  if (rl == 0)
    for (int k = 0; k < 4; ++k) {
      float t = 0.f;
      for (int l = 0; l < 8; ++l) t += red[l][cl][k];
      part[(size_t(blockIdx.y) * 4 + k) * F + c] = t;
    }
}

// out0[c] = sum of the parts' first row; out1[o so + c sc] of row 1 + o
__global__ void wide_sum_cols_kernel(const float* __restrict__ part, int parts, int F,
                                     float* __restrict__ out0, float* __restrict__ out1, int so,
                                     int sc) {
  PDAE_GRID_LOOP(e, 4LL * F) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += part[size_t(p) * 4 * F + e];
    const int k = static_cast<int>(e / F), c = static_cast<int>(e % F);
    if (k == 0)
      out0[c] = s;
    else
      out1[(k - 1) * so + c * sc] = s;
  }
}

// dspb[t, off + c] = bf16(sum_p (M > 0) H) per token
__global__ void wide_token_sum_kernel(const float* __restrict__ H, const bf16* __restrict__ M,
                                      bf16* __restrict__ dspb, int off, long long Tp, int F,
                                      int n) {
  PDAE_GRID_LOOP(i, Tp * F) {
    const long long t = i / F;
    const int c = static_cast<int>(i % F);
    float s = 0.f;
    for (int p = 0; p < n; ++p) {
      const size_t j = size_t(t * n + p) * F + c;
      if (__bfloat162float(M[j]) > 0.f) s += H[j];
    }
    dspb[t * 2 * F + off + c] = __float2bfloat16(s);
  }
}

// dgp1[p, c] = sum_t (M > 0) H per grid point
__global__ void wide_point_sum_kernel(const float* __restrict__ H, const bf16* __restrict__ M,
                                      float* __restrict__ dgp1, long long Tp, int F, int n) {
  PDAE_GRID_LOOP(i, static_cast<long long>(n) * F) {
    const int p = static_cast<int>(i / F), c = static_cast<int>(i % F);
    float s = 0.f;
    for (long long t = 0; t < Tp; ++t) {
      const size_t j = size_t(t * n + p) * F + c;
      if (__bfloat162float(M[j]) > 0.f) s += H[j];
    }
    dgp1[i] = s;
  }
}

// out[o] = sum_r x[r, o] (x (R, 4), o < 3), out[3] = 0; one block, fixed order
__global__ void wide_sum_rows3_kernel(const float* __restrict__ x, long long R,
                                      float* __restrict__ out) {
  __shared__ float red[256][3];
  float s[3] = {0.f, 0.f, 0.f};
  for (long long r = threadIdx.x; r < R; r += 256)
    for (int o = 0; o < 3; ++o) s[o] += x[r * 4 + o];
  for (int o = 0; o < 3; ++o) red[threadIdx.x][o] = s[o];
  __syncthreads();
  if (threadIdx.x < 3) {
    float t = 0.f;
    for (int l = 0; l < 256; ++l) t += red[l][threadIdx.x];
    out[threadIdx.x] = t;
  }
  if (threadIdx.x == 3) out[3] = 0.f;
}

// ------------------------------------------------------------------ shapes

bool shape_ok(int Tp, int C, int F, int n) {
  return Tp > 0 && Tp % GBM == 0 && C > 0 && C % 128 == 0 && F > 0 && F % 128 == 0 &&
         n >= 2 && n <= 64;
}

// log2 of the tokens a one-block tile holds: the most of 8, 4, 2, 1 whose
// rows fit
int tile_ltok(int n) {
  int l = 3;
  while (l > 0 && (n << l) > MR) --l;
  return l;
}

static_assert(Layout(F_ONE_BLOCK, true).bytes <= 232448, "one-block rows pass exceeds 227 KB");
static_assert(NWARP * MR * 3 * 4 <= STAGES * SLICE * 2, "row sums do not fit the ring");

#define PDAE_TRY(call)                                   \
  do {                                                   \
    const cudaError_t err_ = (call);                     \
    if (err_ != cudaSuccess) return static_cast<int>(err_); \
  } while (0)

}  // namespace

// xb (Tp, C) bf16, ksc (C, 2F) bf16 = [ks1 | ks2], gp1 (n, F) bf16, k11 and
// k12 (F, F) bf16, small (13 F + 8) f32; scratch sp (Tp, 2F) f32;
// out (Tp * n, 3) f32. F <= 512.
PDAE_EXPORT int folding_fwd(const void* xb, const void* ksc, const void* gp1, const void* k11,
                            const void* k12, const float* small, float* sp, float* out,
                            int Tp, int C, int F, int n, void* stream) {
  if (!shape_ok(Tp, C, F, n) || F > F_ONE_BLOCK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PDAE_TRY((gemm<false, false>(static_cast<const bf16*>(xb), static_cast<const bf16*>(ksc), sp,
                               Tp, 2 * F, C, s)));
  const size_t smem = Layout(F, false).bytes;
  PDAE_TRY(set_smem(fold_fwd_kernel, smem));
  const int ltok = tile_ltok(n);
  fold_fwd_kernel<<<Tp >> ltok, NT, smem, s>>>(sp, static_cast<const bf16*>(gp1),
                                              static_cast<const bf16*>(k11),
                                              static_cast<const bf16*>(k12), small, out, F, n,
                                              ltok);
  return static_cast<int>(cudaGetLastError());
}

// g (Tp * n, 3) f32. Scratch: sp (Tp, 2F) f32; f1s, df1s (Tp * n, 4) f32;
// m1, m3 (Tp * n, F / 32) mask words; a1s (blocks, 80, F) bf16;
// dspb (Tp, 2F) bf16; part_a (blocks, n F + 12 F + 4) f32, zeroed by the
// caller; dkp (2, parts, F, F) f32; kpart (4, C, 2F) f32.
// Outputs, f32: dx (Tp, C); dksc (C, 2F); rows (n F + 12 F + 4) = dgp1 | db02 |
// dke2 | db12 | dk22 | db11 | dk21 | db21; dk (2, F, F) = dk11, dk12. F <= 512.
PDAE_EXPORT int folding_bwd(const void* xb, const void* ksc, const void* gp1, const void* k11,
                            const void* k12, const float* small, const float* g, float* sp,
                            float* f1s, float* df1s, void* m1, void* m3, void* a1s,
                            void* dspb, float* part_a, float* dkp, float* kpart, float* dx,
                            float* dksc, float* rows, float* dk, int Tp, int C, int F, int n,
                            int blocks, int parts, void* stream) {
  if (!shape_ok(Tp, C, F, n) || F > F_ONE_BLOCK || blocks < 1 || parts < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* x = static_cast<const bf16*>(xb);
  const bf16* ks = static_cast<const bf16*>(ksc);
  const bf16* gp = static_cast<const bf16*>(gp1);
  bf16* dsp = static_cast<bf16*>(dspb);
  PDAE_TRY((gemm<false, false>(x, ks, sp, Tp, 2 * F, C, s)));

  const int ltok = tile_ltok(n);
  const int ntiles = Tp >> ltok;
  const size_t smem_r = Layout(F, true).bytes;
  PDAE_TRY(set_smem(fold_bwd_rows_kernel, smem_r));
  fold_bwd_rows_kernel<<<blocks < ntiles ? blocks : ntiles, NT, smem_r, s>>>(
      sp, gp, static_cast<const bf16*>(k11), static_cast<const bf16*>(k12), small, g, f1s, df1s,
      static_cast<uint16_t*>(m1), static_cast<uint16_t*>(m3), static_cast<bf16*>(a1s), dsp,
      part_a, F, n, ltok, ntiles);
  PDAE_TRY(cudaGetLastError());

  const int rows_total = Tp * n;
  const int nchunks = (rows_total + KR - 1) / KR;
  const int tiles = (F / WT) * (F / WT);
  PDAE_TRY(set_smem(fold_bwd_weights_kernel, WEIGHTS_SMEM));
  fold_bwd_weights_kernel<<<dim3(tiles, parts, 2), WNT, WEIGHTS_SMEM, s>>>(
      sp, gp, small, g, f1s, df1s, static_cast<const uint32_t*>(m1),
      static_cast<const uint32_t*>(m3), dkp, rows_total, F, n, (nchunks + parts - 1) / parts);
  PDAE_TRY(cudaGetLastError());

  PDAE_TRY((gemm<false, true>(dsp, ks, dx, Tp, C, 2 * F, s)));
  PDAE_TRY(gemm_tn_split(x, dsp, dksc, kpart, C, 2 * F, Tp, s));

  const long long na = static_cast<long long>(n) * F + 12 * F + 4;
  PDAE_TRY(sum_partials(part_a, blocks, na, rows, s));
  const long long ff = static_cast<long long>(F) * F;
  for (int st = 0; st < 2; ++st) PDAE_TRY(sum_partials(dkp + st * parts * ff, parts, ff, dk + st * ff, s));
  return static_cast<int>(cudaSuccess);
}

// The wide form of folding_fwd, any F % 128 == 0. Scratch: sp (Tp, 2F) f32,
// A (Tp n, F) bf16, H (Tp n, F) f32, f1 (Tp n, 4) f32.
PDAE_EXPORT int folding_fwd_wide(const void* xb, const void* ksc, const void* gp1,
                                 const void* k11, const void* k12, const float* small,
                                 float* sp, void* A, float* H, float* f1, float* out, int Tp,
                                 int C, int F, int n, void* stream) {
  if (!shape_ok(Tp, C, F, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Small S(small, F);
  bf16* a = static_cast<bf16*>(A);
  const long long R = static_cast<long long>(Tp) * n;
  const int Ri = static_cast<int>(R);
  PDAE_TRY((gemm<false, false>(static_cast<const bf16*>(xb), static_cast<const bf16*>(ksc), sp,
                               Tp, 2 * F, C, s)));
  wide_build_kernel<<<grid_for(R * F / 2), 256, 0, s>>>(sp, static_cast<const bf16*>(gp1),
                                                        nullptr, small, a, R, F, n, 0);
  PDAE_TRY(cudaGetLastError());
  PDAE_TRY((gemm<false, false>(a, static_cast<const bf16*>(k11), H, Ri, F, F, s)));
  wide_relu_bias_kernel<<<grid_for(R * F), 256, 0, s>>>(H, S.b11, a, R, F);
  wide_rowdot3_kernel<<<grid_for(R * 32), 256, 0, s>>>(a, S.k21, 1, 3, S.b21, 1, f1, 4, R, F);
  wide_build_kernel<<<grid_for(R * F / 2), 256, 0, s>>>(sp, nullptr, f1, small, a, R, F, n, 1);
  PDAE_TRY(cudaGetLastError());
  PDAE_TRY((gemm<false, false>(a, static_cast<const bf16*>(k12), H, Ri, F, F, s)));
  wide_relu_bias_kernel<<<grid_for(R * F), 256, 0, s>>>(H, S.b12, a, R, F);
  wide_rowdot3_kernel<<<grid_for(R * 32), 256, 0, s>>>(a, S.k22, 1, 3, S.b22, 0, out, 3, R, F);
  return static_cast<int>(cudaGetLastError());
}

// The wide form of folding_bwd, any F % 128 == 0, same outputs. Scratch: sp
// (Tp, 2F) f32; A0..A3 and D (Tp n, F) bf16; H (Tp n, F) f32; f1, df1
// (Tp n, 4) f32; dspb (Tp, 2F) bf16; cpart (parts, 4, F) f32; kpart
// (4, max(F F, C 2F)) f32.
PDAE_EXPORT int folding_bwd_wide(const void* xb, const void* ksc, const void* gp1,
                                 const void* k11, const void* k12, const float* small,
                                 const float* g, float* sp, void* A0, void* A1, void* A2,
                                 void* A3, void* Dh, float* H, float* f1, float* df1,
                                 void* dspb, float* cpart, float* kpart, float* dx, float* dksc,
                                 float* rows, float* dk, int Tp, int C, int F, int n, int parts,
                                 void* stream) {
  if (!shape_ok(Tp, C, F, n) || parts < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Small S(small, F);
  const bf16* x = static_cast<const bf16*>(xb);
  const bf16* ks = static_cast<const bf16*>(ksc);
  const bf16* w11 = static_cast<const bf16*>(k11);
  const bf16* w12 = static_cast<const bf16*>(k12);
  bf16 *a0 = static_cast<bf16*>(A0), *a1 = static_cast<bf16*>(A1);
  bf16 *a2 = static_cast<bf16*>(A2), *a3 = static_cast<bf16*>(A3);
  bf16* D = static_cast<bf16*>(Dh);
  bf16* dsp = static_cast<bf16*>(dspb);
  Sums out(rows, F, n);
  const long long R = static_cast<long long>(Tp) * n;
  const int Ri = static_cast<int>(R);
  const long long per = (R + parts - 1) / parts;
  const dim3 cgrid(F / 32, parts);

  // the chain recomputed, every hidden kept
  PDAE_TRY((gemm<false, false>(x, ks, sp, Tp, 2 * F, C, s)));
  wide_build_kernel<<<grid_for(R * F / 2), 256, 0, s>>>(sp, static_cast<const bf16*>(gp1),
                                                        nullptr, small, a0, R, F, n, 0);
  PDAE_TRY(cudaGetLastError());
  PDAE_TRY((gemm<false, false>(a0, w11, H, Ri, F, F, s)));
  wide_relu_bias_kernel<<<grid_for(R * F), 256, 0, s>>>(H, S.b11, a1, R, F);
  wide_rowdot3_kernel<<<grid_for(R * 32), 256, 0, s>>>(a1, S.k21, 1, 3, S.b21, 1, f1, 4, R, F);
  wide_build_kernel<<<grid_for(R * F / 2), 256, 0, s>>>(sp, nullptr, f1, small, a2, R, F, n, 1);
  PDAE_TRY(cudaGetLastError());
  PDAE_TRY((gemm<false, false>(a2, w12, H, Ri, F, F, s)));
  wide_relu_bias_kernel<<<grid_for(R * F), 256, 0, s>>>(H, S.b12, a3, R, F);

  // stage 2: dh3 (db12, dk22), dk12, dh2 (db02, dke2, df1, dsp2)
  wide_cols_kernel<0><<<cgrid, 256, 0, s>>>(a3, g, 3, S.k22, nullptr, D, cpart, R, F, per);
  wide_sum_cols_kernel<<<grid_for(4LL * F), 256, 0, s>>>(cpart, parts, F, out.db12, out.dk22, 1, 3);
  PDAE_TRY(cudaGetLastError());
  PDAE_TRY(gemm_tn_split(a2, D, dk + size_t(F) * F, kpart, F, F, R, s));
  PDAE_TRY((gemm<false, true>(D, w12, H, Ri, F, F, s)));
  wide_cols_kernel<1><<<cgrid, 256, 0, s>>>(a2, f1, 4, nullptr, H, D, cpart, R, F, per);
  wide_sum_cols_kernel<<<grid_for(4LL * F), 256, 0, s>>>(cpart, parts, F, out.db02, out.dke2, F, 1);
  wide_rowdot3_kernel<<<grid_for(R * 32), 256, 0, s>>>(D, S.ke2, F, 1, nullptr, 0, df1, 4, R, F);
  wide_token_sum_kernel<<<grid_for(Tp * F), 256, 0, s>>>(H, a2, dsp, F, Tp, F, n);
  wide_sum_rows3_kernel<<<1, 256, 0, s>>>(df1, R, out.db21);
  PDAE_TRY(cudaGetLastError());

  // stage 1: dh1 (db11, dk21), dk11, dh0 (dsp1, dgp1)
  wide_cols_kernel<2><<<cgrid, 256, 0, s>>>(a1, df1, 4, S.k21, nullptr, D, cpart, R, F, per);
  wide_sum_cols_kernel<<<grid_for(4LL * F), 256, 0, s>>>(cpart, parts, F, out.db11, out.dk21, 1, 3);
  PDAE_TRY(cudaGetLastError());
  PDAE_TRY(gemm_tn_split(a0, D, dk, kpart, F, F, R, s));
  PDAE_TRY((gemm<false, true>(D, w11, H, Ri, F, F, s)));
  wide_token_sum_kernel<<<grid_for(Tp * F), 256, 0, s>>>(H, a0, dsp, 0, Tp, F, n);
  wide_point_sum_kernel<<<grid_for(static_cast<long long>(n) * F), 256, 0, s>>>(H, a0, out.dgp1,
                                                                               Tp, F, n);
  PDAE_TRY(cudaGetLastError());

  PDAE_TRY((gemm<false, true>(dsp, ks, dx, Tp, C, 2 * F, s)));
  PDAE_TRY(gemm_tn_split(x, dsp, dksc, kpart, C, 2 * F, Tp, s));
  return static_cast<int>(cudaSuccess);
}
