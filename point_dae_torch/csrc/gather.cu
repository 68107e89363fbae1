// Small-C row gather: out[b, q, :] = x[b, idx[b, q], :] for C <= 8, f32,
// bit-exact. Rows whose index falls outside [0, N) come out as zeros, as
// the TPU kernel's one-hot product gives them.
//
// Replaces point_dae_tpu/ops/pallas_scatter.py:gather_rows_small_c_pallas.
// The TPU kernel computed the gather as a one-hot matrix product only
// because its lane layout wastes 125 of 128 lanes on a 3-wide row; on
// Hopper it is a plain indexed copy.
//
// Bound on the H100: bytes. One thread writes one output element, so the
// writes are coalesced; the reads hit a (B, N, C) source of a few MB that
// stays in L2.
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

// 32-bit index arithmetic: the launcher checks that every offset fits.
__global__ void gather_rows_kernel(const float* __restrict__ x,
                                   const int* __restrict__ idx,
                                   float* __restrict__ out, int N, int Q, int C,
                                   unsigned total) {
  for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const unsigned bq = e / C;                  // b * Q + q
    const unsigned c = e - bq * C;
    const unsigned b = bq / Q;
    const int r = idx[bq];
    out[e] = (r >= 0 && r < N) ? x[(b * N + r) * C + c] : 0.0f;
  }
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

PDAE_EXPORT int gather_rows_small_c(const float* x, const int* idx, float* out,
                                    int B, int N, int Q, int C, void* stream) {
  const long long total = static_cast<long long>(B) * Q * C;
  if (total == 0) return static_cast<int>(cudaSuccess);
  if (total >= (1LL << 31) || static_cast<long long>(B) * N * C >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  gather_rows_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, idx, out, N, Q, C, static_cast<unsigned>(total));
  return static_cast<int>(cudaGetLastError());
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
