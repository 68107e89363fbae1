// Furthest point sampling: (B, N, 3) f32 -> (B, n) i32.
//
// Replaces point_dae_tpu/ops/pallas_fps.py:fps_pallas_batched (and
// fps_pallas, the same function in the per-row TPU layout).
//
// Conventions of both versions: the first pick is index 0; a point with
// (x*x + y*y) + z*z <= 1e-3 is never picked; each iteration moves
// min_d = min(min_d, (dx*dx + dy*dy) + dz*dz) and picks the argmax of min_d
// over the selectable points (the others count as -1), ties to the lowest
// index, as jnp.argmax and torch.argmax resolve them. Every product and sum
// uses a round-to-nearest intrinsic in that order (no FMA), so the picks
// equal the plain PyTorch version's bit for bit: FPS is chaotic, and one
// different pick changes every later one.
//
// Design: one block of 1024 threads per cloud. Each thread keeps PPT points
// (n = tid + j * 1024) and their running min-distance in registers; the
// coordinates also sit in shared memory (SoA, 12 B a point) so that every
// thread reads the last pick's coordinates from there. An iteration is the
// distance update, a warp-shuffle argmax, one barrier, and a redundant
// merge of the 32 warp results by every warp (double-buffered, so one
// barrier an iteration suffices).
//
// Bound on the H100: about 8 f32 operations a point an iteration (tens of
// microseconds at the recipes' shapes); what sets the time is the n serial
// iterations, each ending in a barrier and a shuffle reduction, and only B
// of the 132 SMs busy.
#include <cfloat>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPPT = 8;  // N <= 8192

// larger value wins, equal values go to the lower index
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    argmax_merge(v, i, ov, oi);
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ pts, int N, int n_samples,
           int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sx = reinterpret_cast<float*>(smem);
  float* sy = sx + N;
  float* sz = sy + N;
  __shared__ float warp_v[2][kWarps];
  __shared__ int warp_i[2][kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* cloud = pts + static_cast<size_t>(b) * N * 3;
  int* picks = out + static_cast<size_t>(b) * n_samples;

  float x[PPT], y[PPT], z[PPT], min_d[PPT];
  unsigned sel = 0;  // bit j: point j of this thread exists and is selectable
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int n = tid + j * kThreads;
    x[j] = y[j] = z[j] = 0.0f;
    min_d[j] = 1e10f;
    if (n < N) {
      x[j] = cloud[3 * n];
      y[j] = cloud[3 * n + 1];
      z[j] = cloud[3 * n + 2];
      sx[n] = x[j];
      sy[n] = y[j];
      sz[n] = z[j];
      const float mag = __fadd_rn(__fadd_rn(__fmul_rn(x[j], x[j]), __fmul_rn(y[j], y[j])),
                                  __fmul_rn(z[j], z[j]));
      if (mag > 1e-3f) sel |= 1u << j;
    }
  }
  __syncthreads();

  int last = 0;  // first pick is index 0
  for (int it = 0; it < n_samples; ++it) {
    if (tid == 0) picks[it] = last;
    const float px = sx[last], py = sy[last], pz = sz[last];
    float best_v = -FLT_MAX;
    int best_i = INT_MAX;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int n = tid + j * kThreads;
      if (n < N) {
        const float d = sq_dist3(x[j], y[j], z[j], px, py, pz);
        min_d[j] = fminf(min_d[j], d);
        const float cand = (sel >> j) & 1u ? min_d[j] : -1.0f;
        if (cand > best_v) {  // n rises with j: ties keep the lower index
          best_v = cand;
          best_i = n;
        }
      }
    }
    warp_argmax(best_v, best_i);
    const int buf = it & 1;
    if (lane == 0) {
      warp_v[buf][warp] = best_v;
      warp_i[buf][warp] = best_i;
    }
    __syncthreads();
    // every warp merges the 32 warp results itself: no second barrier. The
    // buffer written in iteration it + 2 is this one, and no warp gets
    // there before every warp has passed the barrier of iteration it + 1.
    float v = warp_v[buf][lane];
    int i = warp_i[buf][lane];
    warp_argmax(v, i);
    last = i;
  }
}

template <int PPT>
cudaError_t launch(const float* pts, int B, int N, int n_samples, int* out,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(N) * 3 * sizeof(float);
  cudaError_t err = set_smem(fps_kernel<PPT>, smem);
  if (err != cudaSuccess) return err;
  fps_kernel<PPT><<<B, kThreads, smem, stream>>>(pts, N, n_samples, out);
  return cudaGetLastError();
}

}  // namespace

PDAE_EXPORT int fps(const float* pts, int B, int N, int n_samples, int* out,
                    void* stream) {
  if (N < 1 || N > kThreads * kMaxPPT || n_samples < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ppt = (N + kThreads - 1) / kThreads;
  cudaError_t err;
  if (ppt <= 1) err = launch<1>(pts, B, N, n_samples, out, s);
  else if (ppt <= 2) err = launch<2>(pts, B, N, n_samples, out, s);
  else if (ppt <= 4) err = launch<4>(pts, B, N, n_samples, out, s);
  else err = launch<8>(pts, B, N, n_samples, out, s);
  return static_cast<int>(err);
}
