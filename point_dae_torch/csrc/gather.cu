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
// a row); here a warp copies one row with vector loads (4 elements a lane
// where C and the pointers allow). Bound: bytes, the output and the index
// once and each selected row once. Nothing on the model's path calls it:
// the JAX package keeps XLA's gather forward (pallas_scatter.py:267-276).
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

// V elements of one row starting at c: V is 4 (one 16- or 8-byte load) or 1.
template <typename T, int V>
struct RowVec {
  static __device__ __forceinline__ float4 load(const T* p) {
    if constexpr (V == 4 && sizeof(T) == 4) {
      return *reinterpret_cast<const float4*>(p);
    } else if constexpr (V == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      const T* h = reinterpret_cast<const T*>(&u);
      return make_float4(to_f32(h[0]), to_f32(h[1]), to_f32(h[2]), to_f32(h[3]));
    } else {
      return make_float4(to_f32(p[0]), 0.f, 0.f, 0.f);
    }
  }
};

// One warp a row of the (B * Q) output rows; 64-bit offsets.
template <typename T, int V>
__global__ void gather_rows_wide_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                                        float* __restrict__ out, int N, int Q, int C,
                                        long long rows) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  for (long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
       row < rows; row += warps) {
    const int r = idx[row];
    float* o = out + row * C;
    if (r < 0 || r >= N) {
      for (int c = lane; c < C; c += 32) o[c] = 0.0f;
      continue;
    }
    const T* src = x + (row / Q * N + r) * static_cast<long long>(C);
    for (int c = lane * V; c < C; c += 32 * V) {
      const float4 v = RowVec<T, V>::load(src + c);
      if constexpr (V == 4)
        *reinterpret_cast<float4*>(o + c) = v;
      else
        o[c] = v.x;
    }
  }
}

template <typename T>
cudaError_t launch_wide(const void* x, const int* idx, float* out, int N, int Q, int C,
                        long long rows, int vec, cudaStream_t stream) {
  const int threads = 256;
  const long long want = (rows + threads / 32 - 1) / (threads / 32);
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  const T* xt = static_cast<const T*>(x);
  if (vec == 4)
    gather_rows_wide_kernel<T, 4><<<blocks, threads, 0, stream>>>(xt, idx, out, N, Q, C, rows);
  else
    gather_rows_wide_kernel<T, 1><<<blocks, threads, 0, stream>>>(xt, idx, out, N, Q, C, rows);
  return cudaGetLastError();
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

// x (B, N, C) of dtype 0 f32, 1 bf16, 2 f16; idx (B, Q) int32; out (B, Q, C)
// f32. vec 4 needs C % 4 == 0 and x and out aligned to 4 elements.
PDAE_EXPORT int gather_rows_wide(const void* x, int dtype, const int* idx, float* out, int B,
                                 int N, int Q, int C, int vec, void* stream) {
  const long long rows = static_cast<long long>(B) * Q;
  if (rows == 0 || C == 0) return static_cast<int>(cudaSuccess);
  if (C < 0 || N < 1 || dtype < 0 || dtype > 2 || (vec != 1 && vec != 4) ||
      (vec == 4 && C % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_wide<float>(x, idx, out, N, Q, C, rows, vec, s); break;
    case 1: err = launch_wide<__nv_bfloat16>(x, idx, out, N, Q, C, rows, vec, s); break;
    default: err = launch_wide<__half>(x, idx, out, N, Q, C, rows, vec, s); break;
  }
  return static_cast<int>(err);
}
