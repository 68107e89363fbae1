// The previous design of csrc/gather.cu's gather_by_key_small_c (kept
// unchanged as the yardstick of tools/key_gather_ablation.py): a block a
// (cloud, 256 draws) rebuilds its cloud's table inv[key] = n in shared
// memory (N ints, filled with -1), then writes one output element a thread.
// keys and draws are int32, so the caller casts int64 ones first.
#include "common.cuh"

namespace {

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
