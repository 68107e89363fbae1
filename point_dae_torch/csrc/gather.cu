// Small-C row gather: out[b, q, :] = x[b, idx[b, q], :] for C <= 8, f32,
// bit-exact, idx int32 or int64. Rows whose index falls outside [0, N) come
// out as zeros, as the TPU kernel's one-hot product gives them.
//
// Replaces point_dae_tpu/ops/pallas_scatter.py:gather_rows_small_c_pallas.
// The TPU kernel computed the gather as a one-hot matrix product only
// because its lane layout wastes 125 of 128 lanes on a 3-wide row; on
// Hopper it is an indexed copy.
//
// Bound on the H100: bytes (the index and the output once, each selected
// row once). Design: C is a template parameter, so a row's offsets need no
// runtime divide; a block owns 256 consecutive rows of one cloud
// (blockIdx.y), a thread one whole row, and reads its index once, int32 or
// int64 as given (no cast launch). The block stages its rows in shared
// memory and writes them out as 16-byte stores: a 3-wide row is 12 bytes,
// so one store a row would leave sectors partly filled.
//
// Second entry, gather_by_key_small_c: the rank-keyed select
// out[b, q, :] = x[b, n*, :] where keys[b, n*] == draw[b, q], zeros where no
// key matches. Replaces point_dae_tpu/ops/pallas_scatter.py:
// gather_by_key_small_c_pallas, whose one-hot compare and product do N * Q
// work a cloud. Here a block first inverts its cloud's keys into a table
// inv[key] = n in shared memory (N ints, filled with -1; the valid keys of
// a row are distinct ranks), then its threads copy x[b, inv[draw]] or
// zeros, one output element a thread: N + Q C work a block, exact. A cloud's
// Q rows are split over several blocks, each rebuilding the table. Bound:
// bytes (keys, draws and the output once, the selected rows once).
//
// Third entry, gather_rows_wide: out[b, q, :] = f32(x[b, idx[b, q], :]) for
// any C and x in f32, bf16 or f16, zeros where the index falls outside
// [0, N). Replaces point_dae_tpu/ops/pallas_scatter.py:gather_rows_pallas,
// a one-hot (tq, N) x (N, C) product at HIGHEST precision (exact, N C work
// a row). Bound: bytes, the output and the index once and each selected row
// once; the output is most of them. Design: a row gets C / V lanes (V
// elements a 16-byte vector: 4 f32, 8 bf16 or f16), rounded up to a power
// of two up to 32, so a warp copies 32 V / C rows at once (2 at C 64 f32);
// each row's index, int32 or int64 as given, is read once by its first lane
// and shared; a lane loads two rows' vectors before it stores either, and
// the f32 output goes out by streaming 16-byte stores. Nothing on the
// model's path calls it: the JAX package keeps XLA's gather forward
// (pallas_scatter.py:267-276).
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kGatherRows = 256;   // rows (and threads) a small-C gather block

template <int C, typename I>
__global__ void __launch_bounds__(kGatherRows)
gather_rows_kernel(const float* __restrict__ x, const I* __restrict__ idx,
                   float* __restrict__ out, int N, int Q) {
  // element e of the block's output sits at buf[e + (o0 & 3)], so the
  // block's first 16-byte boundary in out is a float4 of buf
  __shared__ float4 buf4[kGatherRows * C / 4 + 1];
  float* buf = reinterpret_cast<float*>(buf4);
  const int q0 = blockIdx.x * kGatherRows;
  const int n = min(kGatherRows, Q - q0);
  const size_t o0 = (size_t(blockIdx.y) * Q + q0) * C;
  const int shift = static_cast<int>(o0 & 3);
  const int r = threadIdx.x;
  if (r < n) {
    const long long i = static_cast<long long>(idx[size_t(blockIdx.y) * Q + q0 + r]);
    const float* src = x + (size_t(blockIdx.y) * N + (i >= 0 && i < N ? i : 0)) * C;
    const bool ok = i >= 0 && i < N;
#pragma unroll
    for (int c = 0; c < C; ++c) buf[shift + r * C + c] = ok ? src[c] : 0.0f;
  }
  __syncthreads();
  const int total = n * C;
  const int head = min((4 - shift) & 3, total);   // elements before the boundary
  float* ob = out + o0;
  if (r < head) ob[r] = buf[shift + r];
  const int nv = (total - head) / 4;
  const float4* bv = buf4 + (shift + head) / 4;
  for (int v = r; v < nv; v += kGatherRows)
    reinterpret_cast<float4*>(ob + head)[v] = bv[v];
  const int e = head + 4 * nv + r;
  if (e < total) ob[e] = buf[shift + e];
}

template <typename I>
cudaError_t launch_gather_rows(const float* x, const I* idx, float* out, int B, int N, int Q,
                               int C, cudaStream_t stream) {
  const dim3 grid((Q + kGatherRows - 1) / kGatherRows, B);
  switch (C) {
#define PDAE_GATHER_CASE(c)                                                              \
    case c:                                                                              \
      gather_rows_kernel<c, I><<<grid, kGatherRows, 0, stream>>>(x, idx, out, N, Q); \
      break;
    PDAE_GATHER_CASE(1)
    PDAE_GATHER_CASE(2)
    PDAE_GATHER_CASE(3)
    PDAE_GATHER_CASE(4)
    PDAE_GATHER_CASE(5)
    PDAE_GATHER_CASE(6)
    PDAE_GATHER_CASE(7)
    PDAE_GATHER_CASE(8)
#undef PDAE_GATHER_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

constexpr int kKeyRows = 256;   // draws a key-gather block

// 32-bit index arithmetic: the launcher checks that every offset fits.
__global__ void gather_by_key_kernel(const float* __restrict__ x,
                                     const int* __restrict__ keys,
                                     const int* __restrict__ draw,
                                     float* __restrict__ out, int N, int Q, int C,
                                     int q_blocks) {
  extern __shared__ int inv[];   // [N]
  const int b = blockIdx.x / q_blocks;
  const int q0 = (blockIdx.x % q_blocks) * kKeyRows;
  const int* kb = keys + static_cast<unsigned>(b) * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) inv[n] = -1;
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int key = kb[n];
    if (key >= 0 && key < N) inv[key] = n;
  }
  __syncthreads();
  const int rows = min(kKeyRows, Q - q0);
  const unsigned o = (static_cast<unsigned>(b) * Q + q0) * C;
  for (int e = threadIdx.x; e < rows * C; e += blockDim.x) {
    const int q = e / C, c = e - q * C;
    const int d = draw[static_cast<unsigned>(b) * Q + q0 + q];
    const int n = (d >= 0 && d < N) ? inv[d] : -1;
    out[o + e] = n >= 0 ? x[(static_cast<unsigned>(b) * N + n) * C + c] : 0.0f;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// One vector of a row: VEC (16 / sizeof(T), a 16-byte load) elements, or one
// element when VEC is 1; out gets them as f32 by streaming stores.
template <typename T, int VEC>
struct Vec {
  uint4 raw;
  float f;
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (VEC == 1)
      f = to_f32(*p);
    else
      raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() {
    raw = make_uint4(0u, 0u, 0u, 0u);
    f = 0.f;
  }
  __device__ __forceinline__ void store(float* o) const {
    if constexpr (VEC == 1) {
      __stcs(o, f);
    } else if constexpr (sizeof(T) == 4) {
      __stcs(reinterpret_cast<float4*>(o),
             make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                         __uint_as_float(raw.z), __uint_as_float(raw.w)));
    } else {
      const T* h = reinterpret_cast<const T*>(&raw);
      __stcs(reinterpret_cast<float4*>(o),
             make_float4(to_f32(h[0]), to_f32(h[1]), to_f32(h[2]), to_f32(h[3])));
      __stcs(reinterpret_cast<float4*>(o) + 1,
             make_float4(to_f32(h[4]), to_f32(h[5]), to_f32(h[6]), to_f32(h[7])));
    }
  }
};

// LPR lanes a row (a power of two up to 32), 32 / LPR rows a warp at once,
// UR rows a lane slot per step so that each lane keeps at least UR vectors
// in flight. A row's index is read once, by its first lane, and
// shared by a shuffle; int32 or int64 as given. 64-bit offsets.
constexpr int UR = 2;   // rows a lane slot loads before it stores

template <typename T, typename I, int VEC, int LPR>
__global__ void __launch_bounds__(256)
gather_rows_wide_kernel(const T* __restrict__ x, const I* __restrict__ idx,
                        float* __restrict__ out, int N, int Q, int C, long long rows) {
  constexpr int RPW = 32 / LPR;                      // rows a warp at once
  const int lane = threadIdx.x & 31, sub = lane / LPR, l = lane % LPR;
  const int nv = C / VEC;                            // vectors a row
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) / 32;
  const long long stride = static_cast<long long>(gridDim.x) * (blockDim.x / 32) * RPW;
  for (long long base = warp * RPW; base < rows; base += UR * stride) {
    long long row[UR];
    long long src[UR];
#pragma unroll
    for (int u = 0; u < UR; ++u) {
      row[u] = base + u * stride + sub;
      long long i = -1;
      if (l == 0 && row[u] < rows) i = static_cast<long long>(idx[row[u]]);
      i = __shfl_sync(0xffffffffu, i, sub * LPR);
      src[u] = (i >= 0 && i < N) ? (row[u] / Q * N + i) * C : -1;
    }
    for (int v0 = l; v0 < nv; v0 += LPR) {
      Vec<T, VEC> a[UR];
#pragma unroll
      for (int u = 0; u < UR; ++u) {
        if (src[u] >= 0)
          a[u].load(x + src[u] + static_cast<long long>(v0) * VEC);
        else
          a[u].zero();
      }
#pragma unroll
      for (int u = 0; u < UR; ++u)
        if (row[u] < rows) a[u].store(out + row[u] * C + static_cast<long long>(v0) * VEC);
    }
  }
}

template <typename T, typename I, int VEC>
cudaError_t launch_wide(const T* x, const I* idx, float* out, int N, int Q, int C,
                        long long rows, cudaStream_t stream) {
  const int nv = C / VEC;
  int lpr = 1;
  while (lpr < nv && lpr < 32) lpr *= 2;
  const long long per_block = 8LL * (32 / lpr) * UR;  // rows a block covers in one step
  const long long want = (rows + per_block - 1) / per_block;
  // a block a step's rows: a grid-stride loop only past 256 blocks an SM
  const int blocks = static_cast<int>(want < 132 * 256 ? want : 132 * 256);
  switch (lpr) {
#define PDAE_WIDE_CASE(L)                                                                \
    case L:                                                                              \
      gather_rows_wide_kernel<T, I, VEC, L><<<blocks, 256, 0, stream>>>(x, idx, out, N, Q, C, \
                                                                        rows);          \
      break;
    PDAE_WIDE_CASE(1)
    PDAE_WIDE_CASE(2)
    PDAE_WIDE_CASE(4)
    PDAE_WIDE_CASE(8)
    PDAE_WIDE_CASE(16)
    PDAE_WIDE_CASE(32)
#undef PDAE_WIDE_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide_t(const void* x, const void* idx, int idx64, float* out, int N, int Q,
                          int C, long long rows, int vec, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  constexpr int V = 16 / sizeof(T);
  if (idx64) {
    const long long* i = static_cast<const long long*>(idx);
    return vec ? launch_wide<T, long long, V>(xt, i, out, N, Q, C, rows, s)
               : launch_wide<T, long long, 1>(xt, i, out, N, Q, C, rows, s);
  }
  const int* i = static_cast<const int*>(idx);
  return vec ? launch_wide<T, int, V>(xt, i, out, N, Q, C, rows, s)
             : launch_wide<T, int, 1>(xt, i, out, N, Q, C, rows, s);
}

}  // namespace

// idx (B, Q): int64 when idx64, else int32; out (B, Q, C) f32, 16-byte aligned.
PDAE_EXPORT int gather_rows_small_c(const float* x, const void* idx, int idx64, float* out,
                                    int B, int N, int Q, int C, void* stream) {
  if (B < 0 || N < 1 || Q < 0 || C < 1 || C > 8 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Q == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      idx64 ? launch_gather_rows(x, static_cast<const long long*>(idx), out, B, N, Q, C, s)
            : launch_gather_rows(x, static_cast<const int*>(idx), out, B, N, Q, C, s);
  return static_cast<int>(err);
}

// keys (B, N) int32: distinct ranks, -1 for rows no draw may pick; draw
// (B, Q) int32 >= 0. N up to 12288 (the table in 48 KB of shared memory).
PDAE_EXPORT int gather_by_key_small_c(const float* x, const int* keys, const int* draw,
                                      float* out, int B, int N, int Q, int C,
                                      void* stream) {
  const long long total = static_cast<long long>(B) * Q * C;
  if (total == 0) return static_cast<int>(cudaSuccess);
  if (N < 1 || N > 12288 || total >= (1LL << 31) ||
      static_cast<long long>(B) * N * C >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int q_blocks = (Q + kKeyRows - 1) / kKeyRows;
  gather_by_key_kernel<<<B * q_blocks, 256, N * sizeof(int),
                         static_cast<cudaStream_t>(stream)>>>(x, keys, draw, out, N, Q, C,
                                                              q_blocks);
  return static_cast<int>(cudaGetLastError());
}

// x (B, N, C) of dtype 0 f32, 1 bf16, 2 f16; idx (B, Q) int64 when idx64,
// else int32; out (B, Q, C) f32. vec: 16-byte vectors (C a multiple of 16 /
// sizeof(x) and x 16-byte aligned), else one element a lane.
PDAE_EXPORT int gather_rows_wide(const void* x, int dtype, const void* idx, int idx64,
                                 float* out, int B, int N, int Q, int C, int vec,
                                 void* stream) {
  const long long rows = static_cast<long long>(B) * Q;
  if (rows == 0 || C == 0) return static_cast<int>(cudaSuccess);
  const int V = dtype == 0 ? 4 : 8;
  if (C < 0 || N < 1 || dtype < 0 || dtype > 2 || (vec != 0 && vec != 1) ||
      (vec && C % V != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_wide_t<float>(x, idx, idx64, out, N, Q, C, rows, vec, s); break;
    case 1: err = launch_wide_t<__nv_bfloat16>(x, idx, idx64, out, N, Q, C, rows, vec, s); break;
    default: err = launch_wide_t<__half>(x, idx, idx64, out, N, Q, C, rows, vec, s); break;
  }
  return static_cast<int>(err);
}
