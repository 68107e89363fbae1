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
