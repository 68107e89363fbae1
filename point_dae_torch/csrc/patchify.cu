// Fused FPS + kNN patchify: (B, N, 3) f32 -> fps_idx (B, G) i32 and
// knn_idx (B, G, S) i32, ascending by distance, lowest index first on ties.
//
// Replaces point_dae_tpu/ops/pallas_patchify.py:fused_patchify_pallas.
//
// Design: two launches that meet in fps_idx.
//  - patchify_fps_sample_kernel: the G iterations of the FPS loop of
//    csrc/fps_loop.cuh in its register form (a row takes at most
//    patchify_max_points(), below the streamed form's 65536), so fps_idx
//    equals the fps kernel's picks by construction; the caller passes the
//    plan of ops/fps.py:plan, so a few large clouds spread over thread-block
//    clusters as fps does.
//  - patchify_knn_rows_kernel: the B*G kNN rows over the whole card, a warp
//    a row, eight rows of one cloud a block with the cloud staged in shared
//    memory (SoA). A lane computes the distances of its points n = lane +
//    32 t once, into registers (VPL = N / 32 <= 64 of them), as the bits of
//    the float (distances are >= +0, so the unsigned order is the float
//    order), and keeps the minimum of each group of eight registers. Then S
//    rounds each take the least (distance, index): a minimum over the
//    lane's group minima (the lower register on a tie), one redux.sync
//    minimum of the distance and one of the index over the lanes holding
//    it, and the winner's register masked and its group rescanned (the same
//    group for the whole warp). That is the TPU kernel's argmin-then-mask
//    extraction (pallas_patchify.py:103-114): equal distances go lowest
//    index first.
//  - above 2048 points a row, patchify_knn_scan_kernel: S rounds of "least
//    (distance, index) after the previous one", each recomputing the row's
//    distances from the staged cloud (the previous design's kNN phase).
// The TPU kernel kept every FPS distance row as the (G, N) kNN matrix in
// VMEM; here each row's distances are computed again from its centre, nine
// operations a point, which costs less than storing and reloading them.
//
// Bound on the H100: neither bytes (12 B a point, 4 B an index out) nor
// operations (G*N*9 for the rows); the FPS phase's serial iterations (see
// fps_loop.cuh) and, for the rows, the S dependent rounds of two warp
// reductions each. All distances use round-to-nearest intrinsics in the
// plain version's order, so both outputs equal it bit for bit.
#include "fps_loop.cuh"

namespace {

using fps_loop::kFull;
using fps_loop::State;

constexpr unsigned kNone = 0xffffffffu;   // an index no point has

template <int PPT, int C>
__global__ void __launch_bounds__(fps_loop::kThreads)
patchify_fps_sample_kernel(const float* __restrict__ pts, int N, int G,
                           int* __restrict__ fps_out) {
  extern __shared__ float4 spts[];
  __shared__ State<C> st;
  const int b = blockIdx.x / C;
  fps_loop::run<PPT, C>(pts + static_cast<size_t>(b) * N * 3, N, G,
                        fps_out + static_cast<size_t>(b) * G, spts, st);
}

template <int PPT, int C>
struct FpsLaunch {
  static cudaError_t run(const float* pts, int B, int N, int G, int threads, int* fps_out,
                         cudaStream_t s) {
    return fps_loop::launch(patchify_fps_sample_kernel<PPT, C>, C, B * C, threads,
                            fps_loop::smem_bytes(threads, PPT), s, pts, N, G, fps_out);
  }
};

constexpr int kRowWarps = 8;         // kNN rows a block, all of one cloud
constexpr int kRowThreads = kRowWarps * 32;
constexpr int kGroup = 8;            // distance registers a group
constexpr int kMaxVPL = 64;          // registers a lane: rows of up to 2048 points
constexpr unsigned kMasked = 0xffffffffu;   // above every distance's bits

// Stage cloud b (N points) into shared memory as x, y, z arrays.
__device__ __forceinline__ void stage_cloud(const float* __restrict__ cloud, int N, float* sx,
                                            float* sy, float* sz) {
  for (int n = threadIdx.x; n < N; n += kRowThreads) {
    sx[n] = cloud[3 * n];
    sy[n] = cloud[3 * n + 1];
    sz[n] = cloud[3 * n + 2];
  }
  __syncthreads();
}

// Minimum of group Q of a lane's distances and its register, the lower
// register on a tie.
template <int Q, int VPL>
__device__ __forceinline__ void group_min(const unsigned (&d)[VPL], unsigned& best, int& bt) {
  best = d[Q * kGroup];
  bt = Q * kGroup;
#pragma unroll
  for (int t = Q * kGroup + 1; t < (Q + 1) * kGroup; ++t)
    if (d[t] < best) {
      best = d[t];
      bt = t;
    }
}

// Mask register tl of the lane with `mine` in group Q when the round's winner
// sits there (q == tl / kGroup is the same for the whole warp), then find
// the group's minimum again.
template <int Q, int VPL>
__device__ __forceinline__ void take(unsigned (&d)[VPL], bool mine, int tl,
                                     unsigned (&gk)[VPL / kGroup], int (&gt)[VPL / kGroup]) {
  if constexpr (Q < VPL / kGroup) {
    if (Q == tl / kGroup) {
#pragma unroll
      for (int t = Q * kGroup; t < (Q + 1) * kGroup; ++t)
        if (mine && t == tl) d[t] = kMasked;
      group_min<Q>(d, gk[Q], gt[Q]);
    } else {
      take<Q + 1>(d, mine, tl, gk, gt);
    }
  }
}

template <int Q, int VPL>
__device__ __forceinline__ void all_group_mins(const unsigned (&d)[VPL],
                                               unsigned (&gk)[VPL / kGroup],
                                               int (&gt)[VPL / kGroup]) {
  if constexpr (Q < VPL / kGroup) {
    group_min<Q>(d, gk[Q], gt[Q]);
    all_group_mins<Q + 1>(d, gk, gt);
  }
}

template <int VPL>
__global__ void __launch_bounds__(kRowThreads)
patchify_knn_rows_kernel(const float* __restrict__ pts, const int* __restrict__ fps_idx, int N,
                         int G, int S, int* __restrict__ knn_out) {
  __shared__ float sx[VPL * 32], sy[VPL * 32], sz[VPL * 32];
  const int lane = threadIdx.x & 31;
  const int per_cloud = (G + kRowWarps - 1) / kRowWarps;
  const int b = blockIdx.x / per_cloud;
  const int g = (blockIdx.x % per_cloud) * kRowWarps + (threadIdx.x >> 5);
  stage_cloud(pts + static_cast<size_t>(b) * N * 3, N, sx, sy, sz);
  if (g >= G) return;   // whole warp
  const int c = fps_idx[static_cast<size_t>(b) * G + g];
  const float px = sx[c], py = sy[c], pz = sz[c];

  unsigned d[VPL];
#pragma unroll
  for (int t = 0; t < VPL; ++t) {
    const int n = 32 * t + lane;
    d[t] = n < N ? __float_as_uint(sq_dist3(sx[n], sy[n], sz[n], px, py, pz)) : kMasked;
  }
  unsigned gk[VPL / kGroup];
  int gt[VPL / kGroup];
  all_group_mins<0>(d, gk, gt);

  int* out = knn_out + (static_cast<size_t>(b) * G + g) * S;
  for (int r = 0; r < S; ++r) {
    unsigned bk = gk[0];
    int bt = gt[0];
#pragma unroll
    for (int q = 1; q < VPL / kGroup; ++q)
      if (gk[q] < bk) {   // strict: the lower register stays on a tie
        bk = gk[q];
        bt = gt[q];
      }
    const unsigned kmin = __reduce_min_sync(kFull, bk);
    const unsigned n =
        __reduce_min_sync(kFull, bk == kmin ? static_cast<unsigned>(32 * bt + lane) : kNone);
    if (lane == 0) out[r] = static_cast<int>(n);
    take<0>(d, lane == static_cast<int>(n & 31), static_cast<int>(n >> 5), gk, gt);
  }
}

// Rows of more than kMaxVPL * 32 points: S rounds over the staged cloud, each
// the least (distance, index) strictly after the previous round's.
__global__ void __launch_bounds__(kRowThreads)
patchify_knn_scan_kernel(const float* __restrict__ pts, const int* __restrict__ fps_idx, int N,
                         int G, int S, int* __restrict__ knn_out) {
  extern __shared__ float scloud[];
  float* sx = scloud;
  float* sy = sx + N;
  float* sz = sy + N;
  const int lane = threadIdx.x & 31;
  const int per_cloud = (G + kRowWarps - 1) / kRowWarps;
  const int b = blockIdx.x / per_cloud;
  const int g = (blockIdx.x % per_cloud) * kRowWarps + (threadIdx.x >> 5);
  stage_cloud(pts + static_cast<size_t>(b) * N * 3, N, sx, sy, sz);
  if (g >= G) return;   // whole warp
  const int c = fps_idx[static_cast<size_t>(b) * G + g];
  const float px = sx[c], py = sy[c], pz = sz[c];
  int* out = knn_out + (static_cast<size_t>(b) * G + g) * S;
  unsigned prev_k = 0;
  int prev_i = -1;
  for (int r = 0; r < S; ++r) {
    unsigned bk = kMasked;
    unsigned bi = kNone;
    for (int n = lane; n < N; n += 32) {   // n rises: the first of equal keys stays
      const unsigned k = __float_as_uint(sq_dist3(sx[n], sy[n], sz[n], px, py, pz));
      if ((k > prev_k || (k == prev_k && n > prev_i)) && k < bk) {
        bk = k;
        bi = static_cast<unsigned>(n);
      }
    }
    const unsigned kmin = __reduce_min_sync(kFull, bk);
    const unsigned n = __reduce_min_sync(kFull, bk == kmin ? bi : kNone);
    if (lane == 0) out[r] = static_cast<int>(n);
    prev_k = kmin;
    prev_i = static_cast<int>(n);
  }
}

template <int VPL>
cudaError_t launch_rows(const float* pts, const int* fps_idx, int B, int N, int G, int S,
                        int* knn_out, cudaStream_t s) {
  const int blocks = B * ((G + kRowWarps - 1) / kRowWarps);
  patchify_knn_rows_kernel<VPL><<<blocks, kRowThreads, 0, s>>>(pts, fps_idx, N, G, S, knn_out);
  return cudaGetLastError();
}

}  // namespace

// The largest cloud a kNN row takes: the scan kernel stages 12 B a point.
PDAE_EXPORT int patchify_max_points() { return 232448 / 12; }

// The FPS phase's plan (ops/fps.py:plan, register form) is the caller's.
// Two launches: FPS, then the rows.
PDAE_EXPORT int patchify(const float* pts, int B, int N, int G, int S, int cluster, int threads,
                         int ppt, int* fps_out, int* knn_out, void* stream) {
  if (B < 1 || N < 1 || G < 1 || S < 1 || S > N || N > patchify_max_points() ||
      !fps_loop::plan_ok(N, cluster, threads, ppt))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = fps_loop::by_plan<FpsLaunch>(ppt, cluster, pts, B, N, G, threads, fps_out, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N <= 512) return static_cast<int>(launch_rows<16>(pts, fps_out, B, N, G, S, knn_out, s));
  if (N <= 1024) return static_cast<int>(launch_rows<32>(pts, fps_out, B, N, G, S, knn_out, s));
  if (N <= kMaxVPL * 32)
    return static_cast<int>(launch_rows<kMaxVPL>(pts, fps_out, B, N, G, S, knn_out, s));
  const size_t smem = static_cast<size_t>(N) * 12;
  err = set_smem(patchify_knn_scan_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  patchify_knn_scan_kernel<<<B * ((G + kRowWarps - 1) / kRowWarps), kRowThreads, smem, s>>>(
      pts, fps_out, N, G, S, knn_out);
  return static_cast<int>(cudaGetLastError());
}
