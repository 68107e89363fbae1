// The ViT block's MLP, forward and backward, in two forms:
//   mlp_ln: y = x + s * (GELU_erf(LN(x) @ k1 + b1) @ k2 + b2), the pre-norm
//     sub-block with LayerNorm, stochastic-depth row scale and residual;
//     x, y f32 (R, C); LN eps as given (flax: 1e-6), var = E[x^2] - E[x]^2;
//     s an optional per-row scale.
//   mlp: out = GELU_erf(x @ k1 + b1) @ k2 + b2 alone, x bf16 (R, C), out
//     f32 (R, C); the block takes it when its residual stream is not f32.
// k1 (C, H) and k2 (H, C) bf16; products in bf16 with f32 accumulation;
// GELU in f32 with erff (the TPU kernels use the Abramowitz-Stegun erf,
// 1.5e-7 from it). Every R, C, H multiple of 64, both directions.
//
// Replaces point_dae_tpu/ops/pallas_mlp.py:fused_mlp_ln (_fwd_ln_kernel and
// _bwd_ln_kernel) and fused_mlp (_fwd_kernel and _bwd_kernel).
//
// Every product of both directions is a dense GEMM of one engine written
// for Hopper (gemm_tile below), with the TPU kernels' rounding points. The
// TPU kernels keep the (R, H) hidden in VMEM; here it is written once in
// bf16 and read once (2 x 48 MiB at R 16384, C 384, H 1536: about 30 us of
// 3.35 TB/s each way, much of it in the 50 MB L2), and every product has
// K >= 64 and 128 x 128 output tiles. Keeping the hidden on chip would take
// one fused pass whose warpgroup holds a 64 x C f32 output accumulator
// (192 registers a thread at C 384, beside the hidden tile's): it spills.
//
// Forward, two products in three launches (two for mlp, whose x enters
// bf16):
//   1. (mlp_ln) LN rows, one warp a row: hin = bf16(LN(x)) (R, C);
//   2. hidden: a = bf16(GELU(hin k1 + b1)) (R, H); bias and GELU on the
//      accumulators in f32, the bf16 tile staged in the ring's shared
//      memory and stored as 16-byte stores along rows;
//   3. out: y = x + s (a k2 + b2) (mlp_ln; x read as float2 where y is
//      written) or y = a k2 + b2 (mlp), float2 stores from the accumulators.
// Bound on the H100: operations. At the flagship decoder shape the two
// products are 38.65 GFLOP of bf16, 0.0391 ms at 989 TFLOP/s, against
// about 0.02 ms for x, y and the weights at 3.35 TB/s. Both product
// launches run two blocks an SM, so that one tile's epilogue (the hidden's
// erff and its stores) runs beside another tile's k loop: the hidden
// product has only C / 64 k tiles (6 at C 384).
//
// Backward: five products, the count of the bound, in six launches:
//   1. rows in, 32 rows a block, one warp a row: hin = bf16(LN(x)) (mlp_ln),
//      gbr = bf16(s * g), and the block's column sums of s * g (db2);
//   2. dual: h = hin k1 and da = gbr k2^T in two accumulators; the epilogue
//      writes bf16(dh), dh = da GELU'(h + b1), and bf16(GELU(h + b1)), and
//      each 128-row tile's column sums of the f32 dh (db1 partials);
//   3. dxin = bf16(dh) k1^T: f32 (mlp_ln) or the bf16 dx (mlp);
//   4. dk1 = hin^T bf16(dh) and dk2 = bf16(GELU(h))^T gbr in one launch,
//      R cut into S slices (a function of R, C, H chosen by the caller to
//      fill the card's SMs evenly), f32 partials a slice;
//   5. (mlp_ln) the LayerNorm backward, 32 rows a block, one warp a row:
//      dx, and the block's column sums of dxin xhat and dxin (dgamma,
//      dbeta);
//   6. one pass that sums every set of partials in a fixed order (dk1 and
//      dk2 then rounded to bf16, as the TPU kernels' callers round them).
// No atomics: every partial has one owner, so two calls give the same bits.
// The backward's 97 GFLOP at the flagship shape are bound by operations too.
//
// The engine: 256 threads, two warpgroups of 64 rows on a 128 x 128 output
// tile; 64-deep k tiles in a ring of three shared-memory stages fed by
// cp.async (16 bytes a thread a copy, in the 128-byte swizzle that the
// wgmma descriptors read; a stage's copies are issued while the products of
// the stage before run); m64n128k16 products with every operand majorness
// through the descriptors' transpose bits; the epilogue works on the
// accumulators in registers, and bf16 tiles leave through shared memory as
// 16-byte stores along rows (straight from the accumulators' layout a
// warp's store would cover eight rows with 16 bytes each, half of every
// 32-byte sector).
#include <cuda_bf16.h>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int NT = 256;    // threads a block of the row passes
constexpr int NW = NT / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ------------------------------------------------------------------ engine

constexpr int BM = 128, BN = 128, BK = 64;  // output tile, k tile
constexpr int BT = 256;                     // threads: two warpgroups of 64 rows
constexpr int RING = 3;                     // shared-memory stages of k tiles
constexpr int TRB = 32;                     // rows a block of the backward's row passes
constexpr int CW = 512;                     // columns of a row pass's partials at a time

// GELU at h, the forward's hidden: gelu_and_grad's a to the bit.
__device__ __forceinline__ float gelu(float h) {
  return h * (0.5f * (1.0f + erff(h * 0.70710678118654752f)));
}

// GELU and its derivative at h from one erff.
__device__ __forceinline__ void gelu_and_grad(float h, float& a, float& d) {
  const float cdf = 0.5f * (1.0f + erff(h * 0.70710678118654752f));
  a = h * cdf;  // = gelu(h) to the bit: halving is exact
  d = cdf + h * 0.3989422804014327f * expf(-0.5f * h * h);
}

// A row-major bf16 matrix: element (i, j) at p[i * ld + j].
struct Operand {
  const bf16* p;
  int ld;
};

// One product C (M, N) = A (M, K) B (K, N) of the engine. A K-major is
// stored (M, K), MN-major (K, M); B K-major (N, K), MN-major (K, N). The
// dual product adds C2 = A2 B2 with A2 (M, K) and B2 (N, K), both K-major.
// K runs over kt tiles of 64, cut into `slices` runs of kps tiles; block b
// takes slice b / tiles, output tile b % tiles (N fastest).
struct Problem {
  Operand a, b, a2, b2;
  int M, N, kt, tiles_n, tiles, slices, kps;
  void* out;                // f32 or bf16 (M, N), row stride ldo; a slice at out + s * slice_stride
  bf16* out2;               // dual: bf16(GELU(h + b1))
  float* part;              // dual: db1 partials (a row a tile of rows, N)
  const float* bias;        // dual, hidden: b1; out: b2
  const float* res;         // out (mlp_ln): the residual x (M, N), row stride ldo
  const float* rscale;      // out (mlp_ln): the per-row scale s (M) or null
  int ldo;
  long long slice_stride;
};

// The epilogues: the backward's dual (bf16(dh), bf16(GELU(h)), db1
// partials), f32 and bf16 stores; the forward's hidden (bf16(GELU(acc +
// b1))) and output (acc + b2; mlp_ln: times s, plus x).
enum Epi { BWD_DH, BWD_F32, BWD_BF16, FWD_GELU, FWD_OUT, FWD_OUT_LN };

// One product's configuration: operand majorness, the dual product, the
// epilogue; the shared-memory ring of RING stages of [A][B]([A2][B2]).
template <bool A_MN_, bool B_MN_, bool DUAL_, int EPI_>
struct Gemm {
  static constexpr bool A_MN = A_MN_, B_MN = B_MN_, DUAL = DUAL_;
  static constexpr int EPI = EPI_;
  static constexpr int OP = BM * BK * 2;  // bytes of one operand tile (BM = BN)
  static constexpr int STAGE = OP * (DUAL ? 4 : 2);
  static constexpr int RED = DUAL ? (BT / 32) * BN * 4 : 0;  // the dual epilogue's column sums
  static constexpr size_t SMEM = size_t(RING) * STAGE + RED + 1024;  // + slack to align to 1024
  static_assert(!DUAL || 2 * BM * (BN + 8) * 2 <= RING * STAGE, "the dual's staging fits the ring");
  static_assert(BM * (BN + 8) * 2 <= RING * STAGE, "the hidden's staging fits the ring");
};

using HiddenGemm = Gemm<false, true, false, FWD_GELU>;
template <bool LN>
using OutGemm = Gemm<false, true, false, LN ? FWD_OUT_LN : FWD_OUT>;
using DualGemm = Gemm<false, true, true, BWD_DH>;
using DxinGemm = Gemm<false, false, false, BWD_F32>;
using DxGemm = Gemm<false, false, false, BWD_BF16>;
using WeightGemm = Gemm<true, true, false, BWD_F32>;
template <bool A_MN, bool B_MN>
using CheckGemm = Gemm<A_MN, B_MN, false, BWD_F32>;

// A 128 (M or N) x 64 (k) operand tile into shared memory at dst in the
// 128-byte swizzle, rows at and past `rows` zero-filled: 1024 copies of 16
// bytes, four a thread.
template <bool MN>
__device__ __forceinline__ void load_operand(unsigned char* dst, Operand o, int r0, int rows,
                                             int k0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + BT * i;
    const int c = idx & 7;
    if constexpr (MN) {  // k row kr of column block cb: 64 columns of 128 bytes
      const int cb = (idx >> 3) & 1, kr = idx >> 4;
      const bool ok = r0 + cb * 64 < rows;
      const bf16* src = o.p + (ok ? size_t(k0 + kr) * o.ld + r0 + cb * 64 + c * 8 : 0);
      cp_async16(dst + cb * (BK * 128) + kr * 128 + ((c ^ (kr & 7)) << 4), src, ok);
    } else {             // row r: 64 k of 128 bytes
      const int r = idx >> 3;
      const bool ok = r0 + r < rows;
      const bf16* src = o.p + (ok ? size_t(r0 + r) * o.ld + k0 + c * 8 : 0);
      cp_async16(dst + r * 128 + ((c ^ (r & 7)) << 4), src, ok);
    }
  }
}

template <class G>
__device__ __forceinline__ void load_stage(unsigned char* st, const Problem& p, int m0, int n0,
                                           int k0) {
  load_operand<G::A_MN>(st, p.a, m0, p.M, k0);
  load_operand<G::B_MN>(st + G::OP, p.b, n0, p.N, k0);
  if constexpr (G::DUAL) {
    load_operand<false>(st + 2 * G::OP, p.a2, m0, p.M, k0);
    load_operand<false>(st + 3 * G::OP, p.b2, n0, p.N, k0);
  }
}

// Descriptor of a k16 step kk of an operand tile at shared address t: this
// warpgroup's 64 rows (A) or all 128 (B).
template <bool MN>
__device__ __forceinline__ uint64_t op_desc(uint32_t t, int kk) {
  return MN ? wgmma_desc(t + kk * 16 * 128, BK * 128, 1024) : wgmma_desc(t + kk * 32, 16, 1024);
}

// The k loop of one output tile over k tiles [kt0, kt1): acc (and acc2)
// hold this warpgroup's 64 x 128 of the tile when it returns.
template <class G>
__device__ __forceinline__ void mainloop(unsigned char* smem, const Problem& p, int m0, int n0,
                                         int kt0, int kt1, float (&acc)[64],
                                         float (&acc2)[G::DUAL ? 64 : 1]) {
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  if constexpr (G::DUAL) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc2[i] = 0.f;
  }
#pragma unroll
  for (int s = 0; s < RING - 1; ++s) {
    if (kt0 + s < kt1) load_stage<G>(smem + s * G::STAGE, p, m0, n0, (kt0 + s) * BK);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0;
    cp_async_wait<RING - 2>();
    fence_proxy_async();
    __syncthreads();  // tile i landed for all; every warpgroup is done with tile i - 1
    const uint32_t st = smem_addr(smem + (i % RING) * G::STAGE);
    const uint32_t a = st + wg * (BK * 128), b = st + G::OP;
    fence_acc(acc);
    if constexpr (G::DUAL) fence_acc(acc2);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_m64n128k16<G::A_MN, G::B_MN>(acc, op_desc<G::A_MN>(a, kk), op_desc<G::B_MN>(b, kk));
      if constexpr (G::DUAL)
        wgmma_m64n128k16<0, 0>(acc2, op_desc<false>(a + 2 * G::OP, kk),
                               op_desc<false>(b + 2 * G::OP, kk));
    }
    wgmma_commit();
    // tile i + RING - 1 into the stage that tile i - 1 left, while the
    // products run
    if (kt + RING - 1 < kt1)
      load_stage<G>(smem + ((i + RING - 1) % RING) * G::STAGE, p, m0, n0, (kt + RING - 1) * BK);
    cp_async_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if constexpr (G::DUAL) fence_acc(acc2);
  }
  cp_async_wait_all();
}

// One output tile (block b of the problem) through the k loop and its
// epilogue, from the accumulators in registers.
template <class G>
__device__ __forceinline__ void gemm_tile(unsigned char* smem_raw, const Problem& p, int b) {
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int s = b / p.tiles, t = b % p.tiles;
  const int m0 = (t / p.tiles_n) * BM, n0 = (t % p.tiles_n) * BN;
  const int kt0 = s * p.kps, kt1 = min(p.kt, kt0 + p.kps);
  float acc[64], acc2[G::DUAL ? 64 : 1];
  mainloop<G>(smem, p, m0, n0, kt0, kt1, acc, acc2);

  const int tid = threadIdx.x, lane = tid & 31;
  const int row0 = m0 + (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
  if constexpr (G::EPI == BWD_DH) {
    // bf16(dh) and bf16(GELU(h)) go through shared memory (the ring, free
    // once both warpgroups are past their products) to leave as 16-byte
    // stores along whole rows; rows padded by 16 bytes against bank conflicts
    constexpr int LDS = BN + 8;
    bf16* s_dh = reinterpret_cast<bf16*>(smem);
    bf16* s_a = s_dh + BM * LDS;
    __syncthreads();
    float cs[32];  // this thread's two rows' sums of dh, two columns of each n8 block
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j;
      const bool cok = col < p.N;
      const float bias0 = cok ? p.bias[col] : 0.f, bias1 = cok ? p.bias[col + 1] : 0.f;
      cs[2 * j] = cs[2 * j + 1] = 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + 8 * hf;
        float a0, a1, d0, d1;
        gelu_and_grad(acc[4 * j + 2 * hf] + bias0, a0, d0);
        gelu_and_grad(acc[4 * j + 2 * hf + 1] + bias1, a1, d1);
        const float dh0 = acc2[4 * j + 2 * hf] * d0, dh1 = acc2[4 * j + 2 * hf + 1] * d1;
        const int o = (row - m0) * LDS + col - n0;
        *reinterpret_cast<__nv_bfloat162*>(s_dh + o) = __floats2bfloat162_rn(dh0, dh1);
        *reinterpret_cast<__nv_bfloat162*>(s_a + o) = __floats2bfloat162_rn(a0, a1);
        if (cok && row < p.M) {
          cs[2 * j] += dh0;
          cs[2 * j + 1] += dh1;
        }
      }
    }
    // over the 8 row groups of the warp (lanes of equal lane % 4), then the
    // warps in order through shared memory: one owner a partial
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      float v = cs[k];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      cs[k] = v;
    }
    float* red = reinterpret_cast<float*>(smem + size_t(RING) * G::STAGE);
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        red[(tid >> 5) * BN + 8 * j + 2 * lane] = cs[2 * j];
        red[(tid >> 5) * BN + 8 * j + 2 * lane + 1] = cs[2 * j + 1];
      }
    }
    __syncthreads();
    for (int i = tid; i < 2 * BM * (BN / 8); i += BT) {
      const int r = (i / (BN / 8)) % BM, c = (i % (BN / 8)) * 8;
      const int row = m0 + r, col = n0 + c;
      if (row >= p.M || col >= p.N) continue;
      const bool second = i >= BM * (BN / 8);
      bf16* out = second ? p.out2 : static_cast<bf16*>(p.out);
      *reinterpret_cast<uint4*>(out + size_t(row) * p.ldo + col) =
          *reinterpret_cast<const uint4*>((second ? s_a : s_dh) + r * LDS + c);
    }
    if (tid < BN && n0 + tid < p.N) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < BT / 32; ++w) sum += red[w * BN + tid];
      p.part[size_t(m0 / BM) * p.N + n0 + tid] = sum;
    }
  } else if constexpr (G::EPI == FWD_GELU) {
    // bf16(GELU(h + b1)) through shared memory as in BWD_DH: one tile
    constexpr int LDS = BN + 8;
    bf16* s_h = reinterpret_cast<bf16*>(smem);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j;
      const bool cok = col < p.N;
      const float bias0 = cok ? p.bias[col] : 0.f, bias1 = cok ? p.bias[col + 1] : 0.f;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int o = (row0 + 8 * hf - m0) * LDS + col - n0;
        *reinterpret_cast<__nv_bfloat162*>(s_h + o) = __floats2bfloat162_rn(
            gelu(acc[4 * j + 2 * hf] + bias0), gelu(acc[4 * j + 2 * hf + 1] + bias1));
      }
    }
    __syncthreads();
    for (int i = tid; i < BM * (BN / 8); i += BT) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int row = m0 + r, col = n0 + c;
      if (row >= p.M || col >= p.N) continue;
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) + size_t(row) * p.ldo + col) =
          *reinterpret_cast<const uint4*>(s_h + r * LDS + c);
    }
  } else if constexpr (G::EPI == FWD_OUT || G::EPI == FWD_OUT_LN) {
    // y = acc + b2 (mlp_ln: times s, then plus x, rounded in that order)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j;
      if (col >= p.N) continue;
      const float bias0 = p.bias[col], bias1 = p.bias[col + 1];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + 8 * hf;
        if (row >= p.M) continue;
        const size_t o = size_t(row) * p.ldo + col;
        float v0 = acc[4 * j + 2 * hf] + bias0, v1 = acc[4 * j + 2 * hf + 1] + bias1;
        if constexpr (G::EPI == FWD_OUT_LN) {
          if (p.rscale != nullptr) {
            const float sr = p.rscale[row];
            v0 = __fmul_rn(v0, sr);
            v1 = __fmul_rn(v1, sr);
          }
          const float2 xr = *reinterpret_cast<const float2*>(p.res + o);
          v0 += xr.x;
          v1 += xr.y;
        }
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) = make_float2(v0, v1);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = row0 + 8 * hf;
        if (col >= p.N || row >= p.M) continue;
        const size_t o = size_t(s) * p.slice_stride + size_t(row) * p.ldo + col;
        const float v0 = acc[4 * j + 2 * hf], v1 = acc[4 * j + 2 * hf + 1];
        if constexpr (G::EPI == BWD_F32)
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + o) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// Each product its own kernel name, so that a profile splits both
// directions by launch (the forward's mlp_fwd_*, the backward's mlp_bwd_*).
__global__ void __launch_bounds__(BT, 2) mlp_fwd_hidden_kernel(const Problem p) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  gemm_tile<HiddenGemm>(dyn_smem, p, blockIdx.x);
}

template <bool LN>
__global__ void __launch_bounds__(BT, 2) mlp_fwd_out_kernel(const Problem p) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  gemm_tile<OutGemm<LN>>(dyn_smem, p, blockIdx.x);
}

__global__ void __launch_bounds__(BT, 1) mlp_bwd_dual_kernel(const Problem p) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  gemm_tile<DualGemm>(dyn_smem, p, blockIdx.x);
}

__global__ void __launch_bounds__(BT, 2) mlp_bwd_dxin_kernel(const Problem p) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  gemm_tile<DxinGemm>(dyn_smem, p, blockIdx.x);
}

__global__ void __launch_bounds__(BT, 2) mlp_bwd_dx_kernel(const Problem p) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  gemm_tile<DxGemm>(dyn_smem, p, blockIdx.x);
}

// dk1 partials (p0's blocks first), then dk2's.
__global__ void __launch_bounds__(BT, 2)
mlp_bwd_weights_kernel(const Problem p0, const Problem p1) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int n0 = p0.tiles * p0.slices;
  if (static_cast<int>(blockIdx.x) < n0)
    gemm_tile<WeightGemm>(dyn_smem, p0, blockIdx.x);
  else
    gemm_tile<WeightGemm>(dyn_smem, p1, blockIdx.x - n0);
}

// One engine product of each operand layout, f32 out (the card tests' check
// of the descriptors and the swizzle).
template <bool A_MN, bool B_MN>
__global__ void __launch_bounds__(BT, 2) mlp_bwd_check_kernel(const Problem p) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  gemm_tile<CheckGemm<A_MN, B_MN>>(dyn_smem, p, blockIdx.x);
}

Problem make_problem(Operand a, Operand b, int M, int N, int K, void* out, int ldo, int slices) {
  Problem p{};
  p.a = a;
  p.b = b;
  p.M = M;
  p.N = N;
  p.kt = K / BK;
  p.tiles_n = (N + BN - 1) / BN;
  p.tiles = ((M + BM - 1) / BM) * p.tiles_n;
  p.kps = (p.kt + slices - 1) / slices;
  p.slices = (p.kt + p.kps - 1) / p.kps;
  p.out = out;
  p.ldo = ldo;
  p.slice_stride = static_cast<long long>(M) * N;
  return p;
}

template <class G>
cudaError_t launch_gemm(void (*kernel)(Problem), cudaStream_t stream, const Problem& p) {
  cudaError_t err = set_smem(kernel, G::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<p.tiles * p.slices, BT, G::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// hin = bf16(LN(x)) of row r, by one warp (float4 columns).
__device__ __forceinline__ void ln_row(const float* __restrict__ x, const float* __restrict__ gm,
                                       const float* __restrict__ bt, bf16* __restrict__ hin,
                                       size_t r, int C, float eps) {
  const int lane = threadIdx.x & 31, C4 = C / 4;
  const float4* xr = reinterpret_cast<const float4*>(x + r * C);
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < C4; c += 32) {
    const float4 v = xr[c];
    s += v.x + v.y + v.z + v.w;
    s2 += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float mu = s / C, rs = rsqrtf(s2 / C - mu * mu + eps);
  for (int c = lane; c < C4; c += 32) {
    const float4 v = xr[c], w = reinterpret_cast<const float4*>(gm)[c],
                 b = reinterpret_cast<const float4*>(bt)[c];
    uint2 o;
    o.x = pack_bf16((v.x - mu) * rs * w.x + b.x, (v.y - mu) * rs * w.y + b.y);
    o.y = pack_bf16((v.z - mu) * rs * w.z + b.z, (v.w - mu) * rs * w.w + b.w);
    reinterpret_cast<uint2*>(hin + r * C)[c] = o;
  }
}

// The forward's LN rows: one warp a row, NW rows a block (R a multiple of NW).
__global__ void __launch_bounds__(NT)
mlp_fwd_ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ gm,
                       const float* __restrict__ bt, bf16* __restrict__ hin, int C, float eps) {
  ln_row(x, gm, bt, hin, size_t(blockIdx.x) * NW + (threadIdx.x >> 5), C, eps);
}

// The rows pass in, a block of 32 rows, one warp a row (float4 columns):
// (LN) hin = bf16(LN(x)); gbr = bf16(s * g) and the block's column sums of
// s * g (db2), each warp's rows in order, then the warps in order.
template <bool LN>
__global__ void __launch_bounds__(NT)
mlp_bwd_rows_in_kernel(const float* __restrict__ x, const float* __restrict__ gm,
                       const float* __restrict__ bt, const float* __restrict__ sc,
                       const float* __restrict__ g, bf16* __restrict__ hin,
                       bf16* __restrict__ gbr, float* __restrict__ part, int C, float eps) {
  __shared__ float4 s_part[NW][CW / 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t r0 = size_t(blockIdx.x) * TRB;
  const int C4 = C / 4;
  if constexpr (LN) {
    for (int rr = warp; rr < TRB; rr += NW) ln_row(x, gm, bt, hin, r0 + rr, C, eps);
  }
  for (int c0 = 0; c0 < C4; c0 += CW / 4) {
    const int cn = min(CW / 4, C4 - c0);
    for (int c = lane; c < cn; c += 32) s_part[warp][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int rr = warp; rr < TRB; rr += NW) {
      const float srow = LN && sc != nullptr ? sc[r0 + rr] : 1.f;
      const float4* gr = reinterpret_cast<const float4*>(g + (r0 + rr) * C) + c0;
      uint2* go = reinterpret_cast<uint2*>(gbr + (r0 + rr) * C) + c0;
      for (int c = lane; c < cn; c += 32) {
        float4 v = gr[c];
        if (LN) v = make_float4(v.x * srow, v.y * srow, v.z * srow, v.w * srow);
        go[c] = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
        float4& a = s_part[warp][c];
        a = make_float4(a.x + v.x, a.y + v.y, a.z + v.z, a.w + v.w);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 4 * cn; c += NT) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) sum += reinterpret_cast<const float*>(s_part[w])[c];
      part[size_t(blockIdx.x) * C + 4 * c0 + c] = sum;
    }
    __syncthreads();
  }
}

// The LayerNorm backward of 32 rows a block from dxin = bf16(dh) k1^T (f32),
// one warp a row (float4 columns): dx = g + rs (dxin gm - mean(dxin gm) -
// xhat mean(dxin gm xhat)), and the block's column sums of dxin xhat and
// dxin into part (R / 32, 2, C), each warp's rows in order, then the warps.
__global__ void __launch_bounds__(NT)
mlp_bwd_ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ gm,
                       const float* __restrict__ g, const float* __restrict__ dxin,
                       float* __restrict__ dx, float* __restrict__ part, int C, float eps) {
  __shared__ float4 s_part[NW][2][CW / 4];
  __shared__ float s_stat[TRB][4];  // mu, rs, m1, m2
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t r0 = size_t(blockIdx.x) * TRB;
  const int C4 = C / 4;
  const float4* gm4 = reinterpret_cast<const float4*>(gm);
  for (int rr = warp; rr < TRB; rr += NW) {
    const float4* xr = reinterpret_cast<const float4*>(x + (r0 + rr) * C);
    const float4* dr = reinterpret_cast<const float4*>(dxin + (r0 + rr) * C);
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < C4; c += 32) {
      const float4 v = xr[c];
      s += v.x + v.y + v.z + v.w;
      s2 += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / C, rs = rsqrtf(s2 / C - mu * mu + eps);
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < C4; c += 32) {
      const float4 v = xr[c], d = dr[c], w = gm4[c];
      const float e0 = d.x * w.x, e1 = d.y * w.y, e2 = d.z * w.z, e3 = d.w * w.w;
      m1 += e0 + e1 + e2 + e3;
      m2 += e0 * ((v.x - mu) * rs) + e1 * ((v.y - mu) * rs) + e2 * ((v.z - mu) * rs) +
            e3 * ((v.w - mu) * rs);
    }
    m1 = warp_sum(m1);
    m2 = warp_sum(m2);
    if (lane == 0) {
      s_stat[rr][0] = mu;
      s_stat[rr][1] = rs;
      s_stat[rr][2] = m1 / C;
      s_stat[rr][3] = m2 / C;
    }
  }
  __syncwarp();
  for (int c0 = 0; c0 < C4; c0 += CW / 4) {
    const int cn = min(CW / 4, C4 - c0);
    for (int c = lane; c < cn; c += 32)
      s_part[warp][0][c] = s_part[warp][1][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int rr = warp; rr < TRB; rr += NW) {
      const float mu = s_stat[rr][0], rs = s_stat[rr][1], m1 = s_stat[rr][2],
                  m2 = s_stat[rr][3];
      const size_t o = (r0 + rr) * C;
      const float4* xr = reinterpret_cast<const float4*>(x + o) + c0;
      const float4* dr = reinterpret_cast<const float4*>(dxin + o) + c0;
      const float4* gr = reinterpret_cast<const float4*>(g + o) + c0;
      float4* out = reinterpret_cast<float4*>(dx + o) + c0;
      for (int c = lane; c < cn; c += 32) {
        const float4 v = xr[c], d = dr[c], gg = gr[c], w = gm4[c0 + c];
        const float h0 = (v.x - mu) * rs, h1 = (v.y - mu) * rs, h2 = (v.z - mu) * rs,
                    h3 = (v.w - mu) * rs;
        out[c] = make_float4(gg.x + rs * (d.x * w.x - m1 - h0 * m2),
                             gg.y + rs * (d.y * w.y - m1 - h1 * m2),
                             gg.z + rs * (d.z * w.z - m1 - h2 * m2),
                             gg.w + rs * (d.w * w.w - m1 - h3 * m2));
        float4& pg = s_part[warp][0][c];
        float4& pb = s_part[warp][1][c];
        pg = make_float4(pg.x + d.x * h0, pg.y + d.y * h1, pg.z + d.z * h2, pg.w + d.w * h3);
        pb = make_float4(pb.x + d.x, pb.y + d.y, pb.z + d.z, pb.w + d.w);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < 4 * cn; c += NT) {
      float pg = 0.f, pb = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        pg += reinterpret_cast<const float*>(s_part[w][0])[c];
        pb += reinterpret_cast<const float*>(s_part[w][1])[c];
      }
      part[size_t(blockIdx.x) * 2 * C + 4 * c0 + c] = pg;
      part[size_t(blockIdx.x) * 2 * C + C + 4 * c0 + c] = pb;
    }
    __syncthreads();
  }
}

// A set of partials: out[e] = the sum over p of in[p * pstride + e], e < n,
// to f32 or rounded to bf16. Up to 32 partials one lane an element sums
// them in order; past that one warp an element, lane l partials l, l + 32,
// ... in order, then a fixed shuffle tree.
struct SumSet {
  const float* in;
  long long n, pstride;
  int parts;
  float* f32;
  bf16* b16;
};

struct SumArgs {
  SumSet set[6];
  int count;
};

// Warp units of a set: 32 elements each, or one element each past 32 partials.
__device__ __forceinline__ long long sum_units(const SumSet& st) {
  return st.parts <= 32 ? (st.n + 31) / 32 : st.n;
}

// Every set's units in one index space, so that the small sets run beside
// the large ones.
__global__ void __launch_bounds__(NT) mlp_bwd_sums_kernel(const SumArgs a) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  long long units = 0;
  for (int k = 0; k < a.count; ++k) units += sum_units(a.set[k]);
  for (long long u = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
       u < units; u += nwarps) {
    long long v = u;
    int k = 0;
    while (v >= sum_units(a.set[k])) v -= sum_units(a.set[k++]);
    const SumSet& st = a.set[k];
    float s = 0.f;
    long long e = v;
    if (st.parts <= 32) {
      e = 32 * v + lane;
      if (e >= st.n) continue;
      for (int p = 0; p < st.parts; ++p) s += st.in[p * st.pstride + e];
    } else {
      for (int p = lane; p < st.parts; p += 32) s += st.in[p * st.pstride + e];
      s = warp_sum(s);
      if (lane != 0) continue;
    }
    if (st.b16 != nullptr)
      st.b16[e] = __float2bfloat16(s);
    else
      st.f32[e] = s;
  }
}

cudaError_t launch_sums(const SumArgs& a, cudaStream_t stream) {
  mlp_bwd_sums_kernel<<<132 * 8, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

bool shape_ok(int R, int C, int H) {
  return R > 0 && C > 0 && H > 0 && R % 64 == 0 && C % 64 == 0 && H % 64 == 0;
}

bool bwd_shape_ok(int R, int C, int H, int S) { return shape_ok(R, C, H) && S >= 1 && S <= R / BK; }

// The forward's two products: a = bf16(GELU(xin k1 + b1)), then y = a k2 +
// b2 (LN: times s, plus x). xin: hin (mlp_ln) or x (mlp), (R, C) bf16.
template <bool LN>
cudaError_t fwd_products(const bf16* xin, const bf16* k1, const float* b1, const bf16* k2,
                         const float* b2, const float* x, const float* sc, float* y, bf16* a,
                         int R, int C, int H, cudaStream_t stream) {
  Problem ph = make_problem({xin, C}, {k1, H}, R, H, C, a, H, 1);
  ph.bias = b1;
  cudaError_t err = launch_gemm<HiddenGemm>(mlp_fwd_hidden_kernel, stream, ph);
  if (err != cudaSuccess) return err;
  Problem po = make_problem({a, H}, {k2, C}, R, C, H, y, C, 1);
  po.bias = b2;
  po.res = x;
  po.rscale = sc;
  return launch_gemm<OutGemm<LN>>(mlp_fwd_out_kernel<LN>, stream, po);
}

// Launches 2-4 of both backwards: the dual product, dxin (or dx) and the
// weights' partials. xin: hin (mlp_ln) or x (mlp), (R, C) bf16.
cudaError_t bwd_products(const bf16* xin, const bf16* gbr, const bf16* k1, const float* b1,
                         const bf16* k2, bf16* dh, bf16* a, float* db1p, void* dxo, bool dx_bf16,
                         float* dk1p, float* dk2p, int R, int C, int H, int S,
                         cudaStream_t stream) {
  Problem pd = make_problem({xin, C}, {k1, H}, R, H, C, dh, H, 1);
  pd.a2 = {gbr, C};
  pd.b2 = {k2, C};
  pd.out2 = a;
  pd.part = db1p;
  pd.bias = b1;
  cudaError_t err = launch_gemm<DualGemm>(mlp_bwd_dual_kernel, stream, pd);
  if (err != cudaSuccess) return err;
  const Problem px = make_problem({dh, H}, {k1, H}, R, C, H, dxo, C, 1);
  err = dx_bf16 ? launch_gemm<DxGemm>(mlp_bwd_dx_kernel, stream, px)
                : launch_gemm<DxinGemm>(mlp_bwd_dxin_kernel, stream, px);
  if (err != cudaSuccess) return err;
  const Problem w1 = make_problem({xin, C}, {dh, H}, C, H, R, dk1p, H, S);
  const Problem w2 = make_problem({a, H}, {gbr, C}, H, C, R, dk2p, C, S);
  if ((err = set_smem(mlp_bwd_weights_kernel, WeightGemm::SMEM)) != cudaSuccess) return err;
  mlp_bwd_weights_kernel<<<w1.tiles * w1.slices + w2.tiles * w2.slices, BT, WeightGemm::SMEM,
                           stream>>>(w1, w2);
  return cudaGetLastError();
}

// The sets every backward sums: dk1, dk2 (S slices, to bf16), db1 (a
// partial a tile of the dual product's rows) and db2 (a partial a block of
// the rows pass in).
SumArgs weight_sums(const float* dk1p, const float* dk2p, const float* db1p, const float* db2p,
                    void* dk1, void* dk2, float* db1, float* db2, int R, int C, int H, int S) {
  SumArgs a{};
  const long long ch = static_cast<long long>(C) * H;
  a.set[0] = {dk1p, ch, ch, S, nullptr, static_cast<bf16*>(dk1)};
  a.set[1] = {dk2p, ch, ch, S, nullptr, static_cast<bf16*>(dk2)};
  a.set[2] = {db1p, H, H, (R + BM - 1) / BM, db1, nullptr};
  a.set[3] = {db2p, C, C, R / TRB, db2, nullptr};
  a.count = 4;
  return a;
}

}  // namespace

// y (R, C) f32 = x + s (GELU(LN(x) k1 + b1) k2 + b2), three launches; x
// f32, k1 (C, H), k2 (H, C) bf16, sc (R) or null. Scratch: hin (R, C) and
// a (R, H) bf16. x, gamma, beta, k1, k2 and the scratch 16-byte aligned.
PDAE_EXPORT int mlp_ln_fwd(const float* x, const float* gm, const float* bt, const void* k1,
                           const float* b1, const void* k2, const float* b2, const float* sc,
                           float* y, void* hin, void* a, int R, int C, int H, float eps,
                           void* stream) {
  if (!shape_ok(R, C, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* hs = static_cast<bf16*>(hin);
  mlp_fwd_ln_rows_kernel<<<R / NW, NT, 0, s>>>(x, gm, bt, hs, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(fwd_products<true>(hs, static_cast<const bf16*>(k1), b1,
                                             static_cast<const bf16*>(k2), b2, x, sc, y,
                                             static_cast<bf16*>(a), R, C, H, s));
}

// out (R, C) f32 = GELU(x k1 + b1) k2 + b2, two launches; x (R, C), k1, k2
// bf16. Scratch: a (R, H) bf16. x, k1, k2 and a 16-byte aligned.
PDAE_EXPORT int mlp_fwd(const void* x, const void* k1, const float* b1, const void* k2,
                        const float* b2, float* y, void* a, int R, int C, int H, void* stream) {
  if (!shape_ok(R, C, H)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fwd_products<false>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(k1), b1,
      static_cast<const bf16*>(k2), b2, nullptr, nullptr, y, static_cast<bf16*>(a), R, C, H,
      static_cast<cudaStream_t>(stream)));
}

// The backward of mlp_ln for cotangent g (R, C) f32, every R, C, H multiple
// of 64, six launches. Outputs: dx (R, C) f32; dk1 (C, H), dk2 (H, C) bf16;
// db1 (H) f32; dln (3, C) f32 = dgamma, dbeta, db2. Scratch: hin, gbr (R, C)
// and dh, a (R, H) bf16; dxin (R, C), part_ln (R / 32, 2, C), part_b2
// (R / 32, C), db1p (R / 128 rounded up, H), dk1p (S, C, H), dk2p (S, H, C) f32, S the
// weights' slices (1 <= S <= R / 64). x, g, gamma, beta, k1, k2 and every
// scratch buffer 16-byte aligned.
PDAE_EXPORT int mlp_ln_bwd(const float* x, const float* gm, const float* bt, const void* k1,
                           const float* b1, const void* k2, const float* sc, const float* g,
                           float* dx, void* dk1, void* dk2, float* db1, float* dln, void* hin,
                           void* gbr, void* dh, void* a, float* dxin, float* part_ln,
                           float* part_b2, float* db1p, float* dk1p, float* dk2p, int R, int C,
                           int H, int S, float eps, void* stream) {
  if (!bwd_shape_ok(R, C, H, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* hs = static_cast<bf16*>(hin);
  bf16* gs = static_cast<bf16*>(gbr);
  mlp_bwd_rows_in_kernel<true><<<R / TRB, NT, 0, s>>>(x, gm, bt, sc, g, hs, gs, part_b2, C, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = bwd_products(hs, gs, static_cast<const bf16*>(k1), b1, static_cast<const bf16*>(k2),
                     static_cast<bf16*>(dh), static_cast<bf16*>(a), db1p, dxin, false, dk1p,
                     dk2p, R, C, H, S, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_bwd_ln_rows_kernel<<<R / TRB, NT, 0, s>>>(x, gm, g, dxin, dx, part_ln, C, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  SumArgs sums = weight_sums(dk1p, dk2p, db1p, part_b2, dk1, dk2, db1, dln + 2 * C, R, C, H, S);
  sums.set[4] = {part_ln, C, 2LL * C, R / TRB, dln, nullptr};
  sums.set[5] = {part_ln + C, C, 2LL * C, R / TRB, dln + C, nullptr};
  sums.count = 6;
  return static_cast<int>(launch_sums(sums, s));
}

// The backward of mlp for cotangent g (R, C) f32, five launches. Outputs: dx
// (R, C), dk1 (C, H), dk2 (H, C) bf16; db1 (H), db2 (C) f32. Scratch: gbr
// (R, C) and dh, a (R, H) bf16; part_b2, db1p, dk1p, dk2p as for mlp_ln_bwd.
// x, g, k1, k2 and every scratch buffer 16-byte aligned.
PDAE_EXPORT int mlp_bwd(const void* x, const void* k1, const float* b1, const void* k2,
                        const float* g, void* dx, void* dk1, void* dk2, float* db1, float* db2,
                        void* gbr, void* dh, void* a, float* part_b2, float* db1p, float* dk1p,
                        float* dk2p, int R, int C, int H, int S, void* stream) {
  if (!bwd_shape_ok(R, C, H, S)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* gs = static_cast<bf16*>(gbr);
  mlp_bwd_rows_in_kernel<false><<<R / TRB, NT, 0, s>>>(nullptr, nullptr, nullptr, nullptr, g,
                                                       nullptr, gs, part_b2, C, 0.f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = bwd_products(static_cast<const bf16*>(x), gs, static_cast<const bf16*>(k1), b1,
                     static_cast<const bf16*>(k2), static_cast<bf16*>(dh), static_cast<bf16*>(a),
                     db1p, dx, true, dk1p, dk2p, R, C, H, S, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_sums(weight_sums(dk1p, dk2p, db1p, part_b2, dk1, dk2, db1, db2, R, C, H, S), s));
}

// One product of the backward's engine, out (M, N) f32 = A B, for the card
// tests: A K-major (M, K) or, with a_mn, MN-major (K, M); B K-major (N, K)
// or, with b_mn, MN-major (K, N); M, N, K multiples of 64.
PDAE_EXPORT int mlp_bwd_check(const void* a, const void* b, float* out, int a_mn, int b_mn, int M,
                              int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % 64 || N % 64 || K % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem p = make_problem({static_cast<const bf16*>(a), a_mn ? M : K},
                                 {static_cast<const bf16*>(b), b_mn ? N : K}, M, N, K, out, N, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a_mn && b_mn)
    err = launch_gemm<CheckGemm<true, true>>(mlp_bwd_check_kernel<true, true>, s, p);
  else if (a_mn)
    err = launch_gemm<CheckGemm<true, false>>(mlp_bwd_check_kernel<true, false>, s, p);
  else if (b_mn)
    err = launch_gemm<CheckGemm<false, true>>(mlp_bwd_check_kernel<false, true>, s, p);
  else
    err = launch_gemm<CheckGemm<false, false>>(mlp_bwd_check_kernel<false, false>, s, p);
  return static_cast<int>(err);
}
