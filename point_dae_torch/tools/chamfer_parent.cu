// The two chamfer halves in their previous design, kept unchanged as the
// yardstick of point_dae_torch/tools/chamfer_ablation.py and of
// chip_smoke.py: a warp a patch for the patch half, a thread a row over
// 1024-point tiles for the tiled half, one launch a direction. The current
// design, in csrc/chamfer.cu, must give the same bits. Built with
// -I point_dae_torch/csrc; nothing on a path launches it.
//
// The two chamfer halves of the port: the patch kernel for many tiny sets
// and, further down, the tiled kernel for large sets.
//
// Patch chamfer half: for every point of x (P, N, 3) its nearest point in
// y (P, M, 3): squared distance, index (first index on ties: a strict `<`
// update in index order) and the nearest point's coordinates, which the
// backward pass reuses.
//
// Replaces point_dae_tpu/losses/chamfer.py:_nn_half_small_pallas.
//
// Design: one warp per patch; the patch's M <= 64 targets sit in shared
// memory and each lane scans them for its query points (N <= 64, so at
// most two a lane). The TPU kernel put the batch on the 128 lanes for the
// same reason: the sets are tiny and a matrix unit would idle on K=3.
//
// Bound on the H100: f32 arithmetic, P*N*M*8 operations (about 0.1 GFLOP
// at the flagship's 13056 patches of 36 x 32), against some 10 MB moved.
// Distances use round-to-nearest intrinsics, summed left to right as the
// plain PyTorch version sums them, so index ties resolve identically.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxPts = 64;

__global__ void __launch_bounds__(kWarps * 32)
nn_half_small_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     int P, int N, int M, float* __restrict__ dist,
                     int* __restrict__ idx, float* __restrict__ near) {
  __shared__ float sy[kWarps][kMaxPts * 3];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= P) return;  // whole warp leaves together; no block barrier below

  const float* yp = y + static_cast<size_t>(p) * M * 3;
  for (int e = lane; e < M * 3; e += 32) sy[warp][e] = yp[e];
  __syncwarp();

  for (int q = lane; q < N; q += 32) {
    const float* xq = x + (static_cast<size_t>(p) * N + q) * 3;
    const float ax = xq[0], ay = xq[1], az = xq[2];
    float md = 1e30f;
    int mi = 0;
    float nx = 0.f, ny = 0.f, nz = 0.f;
    for (int j = 0; j < M; ++j) {
      const float bx = sy[warp][3 * j], by = sy[warp][3 * j + 1],
                  bz = sy[warp][3 * j + 2];
      const float d = sq_dist3(ax, ay, az, bx, by, bz);
      if (d < md) {
        md = d;
        mi = j;
        nx = bx;
        ny = by;
        nz = bz;
      }
    }
    const size_t o = static_cast<size_t>(p) * N + q;
    dist[o] = md;
    idx[o] = mi;
    near[3 * o] = nx;
    near[3 * o + 1] = ny;
    near[3 * o + 2] = nz;
  }
}

// Tiled chamfer half for large sets: for every point of x (B, N, 3) its
// nearest point in y (B, M, 3) over the *expansion* distance
// (xx - 2 x.y) + yy, as the TPU kernel forms it (the coordinate-wise form
// above rounds differently near zero). First index on ties; the distance is
// clamped at zero on output only.
//
// Replaces point_dae_tpu/losses/chamfer.py:_nn_half_pallas.
//
// Design: one thread per x row, a block of kTiledThreads rows of one cloud;
// y streams through shared memory in tiles of kTiledTile points stored as
// (y0, y1, y2, yy), which every thread scans in index order with a strict
// `<`, so a later tile wins only when it is strictly nearer. Every product
// and sum is a round-to-nearest intrinsic in the plain version's order, so
// distances and indices agree with it bit for bit.
//
// Bound on the H100: B*N*M*9 f32 operations (1.2 GFLOP at 128 x 1024 x
// 1024) against B*(N+M)*12 + B*N*8 bytes (4 MB): operations.
constexpr int kTiledThreads = 128;
constexpr int kTiledTile = 1024;

__global__ void __launch_bounds__(kTiledThreads)
nn_half_tiled_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     int N, int M, int rows_blocks, float* __restrict__ dist,
                     int* __restrict__ idx) {
  __shared__ float4 sy[kTiledTile];
  const int b = blockIdx.x / rows_blocks;
  const int i = (blockIdx.x % rows_blocks) * kTiledThreads + threadIdx.x;
  const bool live = i < N;
  const float* xp = x + (static_cast<size_t>(b) * N + (live ? i : N - 1)) * 3;
  const float x0 = xp[0], x1 = xp[1], x2 = xp[2];
  const float xx = __fadd_rn(__fadd_rn(__fmul_rn(x0, x0), __fmul_rn(x1, x1)),
                             __fmul_rn(x2, x2));
  float best = 1e30f;
  int besti = 0;
  const float* yb = y + static_cast<size_t>(b) * M * 3;
  for (int j0 = 0; j0 < M; j0 += kTiledTile) {
    const int lim = min(kTiledTile, M - j0);
    __syncthreads();
    for (int j = threadIdx.x; j < lim; j += kTiledThreads) {
      const float* yp = yb + static_cast<size_t>(j0 + j) * 3;
      const float y0 = yp[0], y1 = yp[1], y2 = yp[2];
      sy[j] = make_float4(y0, y1, y2,
                          __fadd_rn(__fadd_rn(__fmul_rn(y0, y0), __fmul_rn(y1, y1)),
                                    __fmul_rn(y2, y2)));
    }
    __syncthreads();
    for (int j = 0; j < lim; ++j) {
      const float4 p = sy[j];
      const float xy = __fadd_rn(__fadd_rn(__fmul_rn(x0, p.x), __fmul_rn(x1, p.y)),
                                 __fmul_rn(x2, p.z));
      const float d = __fadd_rn(__fsub_rn(xx, __fmul_rn(2.0f, xy)), p.w);
      if (d < best) {
        best = d;
        besti = j0 + j;
      }
    }
  }
  if (live) {
    const size_t o = static_cast<size_t>(b) * N + i;
    dist[o] = fmaxf(best, 0.0f);
    idx[o] = besti;
  }
}

}  // namespace

PDAE_EXPORT int nn_half_tiled(const float* x, const float* y, int B, int N, int M,
                              float* dist, int* idx, void* stream) {
  if (B == 0 || N == 0) return static_cast<int>(cudaSuccess);
  if (M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_blocks = (N + kTiledThreads - 1) / kTiledThreads;
  nn_half_tiled_kernel<<<B * rows_blocks, kTiledThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, y, N, M, rows_blocks,
                                                              dist, idx);
  return static_cast<int>(cudaGetLastError());
}

PDAE_EXPORT int nn_half_small(const float* x, const float* y, int P, int N, int M,
                              float* dist, int* idx, float* near, void* stream) {
  if (N > kMaxPts || M > kMaxPts) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (P + kWarps - 1) / kWarps;
  nn_half_small_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, P, N, M, dist, idx, near);
  return static_cast<int>(cudaGetLastError());
}
