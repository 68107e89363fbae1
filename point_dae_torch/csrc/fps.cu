// Furthest point sampling: (B, N, 3) f32 -> (B, n) i32.
//
// Replaces point_dae_tpu/ops/pallas_fps.py:fps_pallas_batched (and
// fps_pallas, the same function in the per-row TPU layout).
//
// The loop, its conventions, its bound and its design are those of
// csrc/fps_loop.cuh. The caller passes the plan (ops/fps.py:plan): the
// register form over clusters of `cluster` blocks of `threads` threads with
// `ppt` points a thread (cluster 1: one block a cloud), or with ppt 0 the
// streamed form over the float4 scratch buffer `buf`.
#include "fps_loop.cuh"

namespace {

using fps_loop::State;

template <int PPT, int C>
__global__ void __launch_bounds__(fps_loop::kThreads)
fps_kernel(const float* __restrict__ pts, int N, int n_samples, int* __restrict__ out) {
  extern __shared__ float4 spts[];
  __shared__ State<C> st;
  const int b = blockIdx.x / C;
  fps_loop::run<PPT, C>(pts + static_cast<size_t>(b) * N * 3, N, n_samples,
                        out + static_cast<size_t>(b) * n_samples, spts, st);
}

__global__ void __launch_bounds__(fps_loop::kStreamThreads)
fps_stream_kernel(const float* __restrict__ pts, int N, int n_samples,
                  float4* __restrict__ buf, int* __restrict__ out) {
  __shared__ State<1> st;
  const int b = blockIdx.x;
  fps_loop::run_stream(pts + static_cast<size_t>(b) * N * 3, N, n_samples,
                       out + static_cast<size_t>(b) * n_samples,
                       buf + static_cast<size_t>(b) * N, st);
}

template <int PPT, int C>
struct Launch {
  static cudaError_t run(const float* pts, int B, int N, int n_samples, int threads, int* out,
                         cudaStream_t s) {
    return fps_loop::launch(fps_kernel<PPT, C>, C, B * C, threads,
                            fps_loop::smem_bytes(threads, PPT), s, pts, N, n_samples, out);
  }
};

template <int PPT, int C>
struct ClusterSlots {
  static cudaError_t run(int threads, int* n) {
    *n = fps_loop::cluster_slots(fps_kernel<PPT, C>, C, threads,
                                 fps_loop::smem_bytes(threads, PPT));
    return cudaSuccess;
  }
};

}  // namespace

// ppt 0: the streamed form (buf (B, N) float4 scratch); else the register
// form's plan, which must hold N points.
PDAE_EXPORT int fps(const float* pts, int B, int N, int n_samples, int cluster, int threads,
                    int ppt, void* buf, int* out, void* stream) {
  if (N < 1 || n_samples < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ppt == 0) {
    if (buf == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    fps_stream_kernel<<<B, fps_loop::kStreamThreads, 0, s>>>(
        pts, N, n_samples, static_cast<float4*>(buf), out);
    return static_cast<int>(cudaGetLastError());
  }
  if (!fps_loop::plan_ok(N, cluster, threads, ppt)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      fps_loop::by_plan<Launch>(ppt, cluster, pts, B, N, n_samples, threads, out, s));
}

// The clusters of `cluster` blocks of a plan's kernel that the card holds at
// once (cudaOccupancyMaxActiveClusters), -1 if the query fails.
PDAE_EXPORT int fps_cluster_slots(int cluster, int threads, int ppt) {
  int n = -1;
  if (cluster < 2 || fps_loop::by_plan<ClusterSlots>(ppt, cluster, threads, &n) != cudaSuccess)
    return -1;
  return n;
}
