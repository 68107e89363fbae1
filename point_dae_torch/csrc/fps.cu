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
// Design: one block of 1024 threads per cloud. Up to kRegPoints points
// (N <= 8192), each thread keeps PPT points (n = tid + j * 1024) and their
// running min-distance in registers; the coordinates also sit in shared
// memory (SoA, 12 B a point) so that every thread reads the last pick's
// coordinates from there. Above that (no upper limit) the streamed form
// keeps each point as one float4 (x, y, z, min_d) in a scratch buffer the
// caller allocates, min_d = -1 marking a point that is never picked, and
// each iteration streams the cloud's buffer (16 B a point: 256 KB at 16384
// points, which stays in L2) and reads the last pick from the input. An
// iteration is the distance update, a warp-shuffle argmax, one barrier, and
// a redundant merge of the 32 warp results by every warp (double-buffered,
// so one barrier an iteration suffices).
//
// Bound on the H100: about 8 f32 operations a point an iteration (tens of
// microseconds at the recipes' shapes); what sets the time is the n serial
// iterations, each ending in a barrier and a shuffle reduction, and only B
// of the 132 SMs busy; the streamed form adds the buffer's pass through L2.
#include <cfloat>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPPT = 8;
constexpr int kRegPoints = kThreads * kMaxPPT;  // 8192: above, the streamed form
constexpr int kStreamBatch = 4;                  // points a thread loads at once, streamed

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

// The block's argmax of each thread's (v, i). Every warp merges the 32 warp
// results itself: no second barrier. The caller alternates between two
// buffers: the one written in iteration it + 2 is this one, and no warp gets
// there before every warp has passed the barrier of iteration it + 1.
__device__ __forceinline__ int block_argmax(float v, int i, float* wv, int* wi) {
  const int lane = threadIdx.x & 31;
  warp_argmax(v, i);
  if (lane == 0) {
    wv[threadIdx.x >> 5] = v;
    wi[threadIdx.x >> 5] = i;
  }
  __syncthreads();
  v = wv[lane];
  i = wi[lane];
  warp_argmax(v, i);
  return i;
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
    last = block_argmax(best_v, best_i, warp_v[it & 1], warp_i[it & 1]);
  }
}

// Streamed form, any N: point n is buf[n] = (x, y, z, min_d), min_d = -1
// for a point that is never picked; the loop over a thread's points runs
// in ascending n, so ties keep the lower index.
__global__ void __launch_bounds__(kThreads)
fps_stream_kernel(const float* __restrict__ pts, int N, int n_samples,
                  float4* __restrict__ buf_all, int* __restrict__ out) {
  __shared__ float warp_v[2][kWarps];
  __shared__ int warp_i[2][kWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* cloud = pts + static_cast<size_t>(b) * N * 3;
  float4* buf = buf_all + static_cast<size_t>(b) * N;
  int* picks = out + static_cast<size_t>(b) * n_samples;

  for (int n = tid; n < N; n += kThreads) {
    const float x = cloud[3 * n], y = cloud[3 * n + 1], z = cloud[3 * n + 2];
    const float mag = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
    buf[n] = make_float4(x, y, z, mag > 1e-3f ? 1e10f : -1.0f);
  }
  // each thread reads back only what it wrote: no barrier before the loop
  int last = 0;
  for (int it = 0; it < n_samples; ++it) {
    if (tid == 0) picks[it] = last;
    const float px = cloud[3 * last], py = cloud[3 * last + 1], pz = cloud[3 * last + 2];
    float best_v = -FLT_MAX;
    int best_i = INT_MAX;
    for (int n0 = tid; n0 < N; n0 += kStreamBatch * kThreads) {
      float4 p[kStreamBatch];   // loaded together, then taken in ascending n
#pragma unroll
      for (int u = 0; u < kStreamBatch; ++u) {
        const int n = n0 + u * kThreads;
        p[u] = n < N ? buf[n] : make_float4(0.f, 0.f, 0.f, -1.f);
      }
#pragma unroll
      for (int u = 0; u < kStreamBatch; ++u) {
        const int n = n0 + u * kThreads;
        float cand = p[u].w;
        if (p[u].w >= 0.0f) {
          cand = fminf(p[u].w, sq_dist3(p[u].x, p[u].y, p[u].z, px, py, pz));
          buf[n].w = cand;
        }
        if (n < N && cand > best_v) {
          best_v = cand;
          best_i = n;
        }
      }
    }
    last = block_argmax(best_v, best_i, warp_v[it & 1], warp_i[it & 1]);
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

// buf (B, N) float4 is scratch for N > 8192 and may be null below.
PDAE_EXPORT int fps(const float* pts, int B, int N, int n_samples, void* buf, int* out,
                    void* stream) {
  if (N < 1 || n_samples < 1 || B < 1 || (N > kRegPoints && buf == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ppt = (N + kThreads - 1) / kThreads;
  cudaError_t err;
  if (ppt <= 1) err = launch<1>(pts, B, N, n_samples, out, s);
  else if (ppt <= 2) err = launch<2>(pts, B, N, n_samples, out, s);
  else if (ppt <= 4) err = launch<4>(pts, B, N, n_samples, out, s);
  else if (ppt <= kMaxPPT) err = launch<kMaxPPT>(pts, B, N, n_samples, out, s);
  else {
    fps_stream_kernel<<<B, kThreads, 0, s>>>(pts, N, n_samples, static_cast<float4*>(buf), out);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
