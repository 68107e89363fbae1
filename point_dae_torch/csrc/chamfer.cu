// The two chamfer halves of the port, each one launch for both directions
// of an nn_distance call: the patch kernel for many tiny sets and, further
// down, the tiled kernel for large sets. The launch plans are
// losses/chamfer.py:patch_plan and tiled_plan.
//
// Patch chamfer half: for every point of x (P, N, 3) its nearest point in
// y (P, M, 3), and for every point of y its nearest in x: squared distance
// (sq_dist3, coordinate-wise), index (first index on ties) and the nearest
// point's coordinates, which the backward pass reuses.
//
// Replaces point_dae_tpu/losses/chamfer.py:_nn_half_small_pallas.
//
// Design: a block copies its K patches' x and y (contiguous in memory) into
// shared memory once, flat with eight loads in flight a thread, each patch
// at a stride of an odd number of 16-byte words, so that lanes reading
// different patches hit different banks. The block's threads then take its
// (patch, direction, group of three queries) tasks, the plan sizing a
// block to one round of them. A thread scans its three queries together,
// four targets at a time, so three 16-byte shared loads serve twelve pairs
// (on an H100 80GB HBM3 at 700 W, tools/chamfer_ablation.py: one query a
// thread, the first form of this kernel, took 0.0242 ms under its best
// plan, four 0.0217, three 0.0202). It keeps each minimum with fminf and
// its index with a strict `<`, and reads the nearest point once, after the
// scan. The TPU kernel put the batch on the 128 lanes for the same reason:
// the sets are tiny and a matrix unit would idle on K=3.
//
// Bound on the H100, both directions at the flagship's 13056 patches of 36
// and 32 points: 28.4 MB read once and written (0.0085 ms) against 30.1 M
// pairs of eleven lane instructions (0.010 ms of issue at 1.98 GHz).
// Distances use round-to-nearest intrinsics, summed left to right as the
// plain PyTorch version sums them, so index ties resolve identically.
#include "common.cuh"

namespace {

constexpr int kMaxPts = 64;
constexpr int kMaxPatchThreads = 256;
constexpr int kQueries = 3;  // queries a thread scans together
constexpr int kStage = 8;    // loads in flight a thread while a block copies its patches
constexpr float kFar = 1e30f;  // a running minimum's start: no distance this far is taken

// Floats a patch of n points takes in shared memory: 3 n rounded up to
// whole 16-byte words, made an odd number of words.
__host__ __device__ inline int patch_stride(int n) {
  int words = (3 * n + 3) / 4;
  words += 1 - (words & 1);
  return 4 * words;
}

// One target of a query's scan: fminf keeps the distance, a strict `<`
// against the minimum before it the first index.
__device__ __forceinline__ void patch_step(float ax, float ay, float az, float bx, float by,
                                           float bz, int j, float& md, int& mi) {
  const float d = sq_dist3(ax, ay, az, bx, by, bz);
  mi = d < md ? j : mi;
  md = fminf(md, d);
}

__global__ void __launch_bounds__(kMaxPatchThreads)
nn_half_small_kernel(const float* __restrict__ x, const float* __restrict__ y, int P, int N,
                     int M, int K, float* __restrict__ d1, int* __restrict__ i1,
                     float* __restrict__ n1, float* __restrict__ d2, int* __restrict__ i2,
                     float* __restrict__ n2) {
  extern __shared__ float4 smem4[];
  float* const xs = reinterpret_cast<float*>(smem4);
  const int sx = patch_stride(N), sy = patch_stride(M);
  float* const ys = xs + K * sx;
  const int p0 = blockIdx.x * K;
  const int kc = min(K, P - p0);
  // The block's x and y are contiguous: copy them flat, kStage loads in
  // flight a thread, each float to its patch's padded row. (e + 0.5) / n3
  // in f32 is at least 0.5 / n3 from an integer and off by far less, so
  // its truncation is the patch.
  const int nx3 = N * 3, ny3 = M * 3;
  const int nx = kc * nx3, total = nx + kc * ny3;
  const float* xb = x + static_cast<size_t>(p0) * nx3;
  const float* yb = y + static_cast<size_t>(p0) * ny3;
  const float inv_x = 1.0f / nx3, inv_y = 1.0f / ny3;
  for (int base = threadIdx.x; base < total; base += kStage * blockDim.x) {
    float v[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = base + u * blockDim.x;
      v[u] = e < nx ? xb[e] : e < total ? yb[e - nx] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int e = base + u * blockDim.x;
      if (e < nx) {
        const int k = static_cast<int>((e + 0.5f) * inv_x);
        xs[k * sx + e - k * nx3] = v[u];
      } else if (e < total) {
        const int f = e - nx, k = static_cast<int>((f + 0.5f) * inv_y);
        ys[k * sy + f - k * ny3] = v[u];
      }
    }
  }
  __syncthreads();
  // A task is kQueries queries g, g + ng, ... of one (patch, direction),
  // ng = ceil(nq / kQueries) tasks a patch and direction: one shared load of
  // a target serves kQueries pairs. Queries past nq repeat the last one and
  // store nothing.
  const int gx = (N + kQueries - 1) / kQueries, gy = (M + kQueries - 1) / kQueries;
  const int first = kc * gx;  // tasks of the first direction (x against y)
  const int tasks = d2 ? kc * (gx + gy) : first;
  const float inv_gx = 1.0f / gx, inv_gy = 1.0f / gy;
  for (int e = threadIdx.x; e < tasks; e += blockDim.x) {
    const bool second = e >= first;
    const int f = second ? e - first : e;
    const int ng = second ? gy : gx;
    const int nq = second ? M : N, nt = second ? N : M;
    const int k = static_cast<int>((f + 0.5f) * (second ? inv_gy : inv_gx)), g = f - k * ng;
    const float* qs = second ? ys + k * sy : xs + k * sx;
    const float* ts = second ? xs + k * sx : ys + k * sy;
    float ax[kQueries], ay[kQueries], az[kQueries], md[kQueries];
    int mi[kQueries];
#pragma unroll
    for (int i = 0; i < kQueries; ++i) {
      const int q = min(g + i * ng, nq - 1);
      ax[i] = qs[3 * q];
      ay[i] = qs[3 * q + 1];
      az[i] = qs[3 * q + 2];
      md[i] = kFar;
      mi[i] = 0;
    }
    int j = 0;
    for (; j + 4 <= nt; j += 4) {
      const float4 a = *reinterpret_cast<const float4*>(ts + 3 * j);
      const float4 b = *reinterpret_cast<const float4*>(ts + 3 * j + 4);
      const float4 c = *reinterpret_cast<const float4*>(ts + 3 * j + 8);
#pragma unroll
      for (int i = 0; i < kQueries; ++i) {
        patch_step(ax[i], ay[i], az[i], a.x, a.y, a.z, j, md[i], mi[i]);
        patch_step(ax[i], ay[i], az[i], a.w, b.x, b.y, j + 1, md[i], mi[i]);
        patch_step(ax[i], ay[i], az[i], b.z, b.w, c.x, j + 2, md[i], mi[i]);
        patch_step(ax[i], ay[i], az[i], c.y, c.z, c.w, j + 3, md[i], mi[i]);
      }
    }
    for (; j < nt; ++j) {
      const float bx = ts[3 * j], by = ts[3 * j + 1], bz = ts[3 * j + 2];
#pragma unroll
      for (int i = 0; i < kQueries; ++i)
        patch_step(ax[i], ay[i], az[i], bx, by, bz, j, md[i], mi[i]);
    }
    float* const dist = second ? d2 : d1;
    int* const idx = second ? i2 : i1;
    float* const near = second ? n2 : n1;
#pragma unroll
    for (int i = 0; i < kQueries; ++i) {
      const int q = g + i * ng;
      if (q < nq) {
        const bool hit = md[i] < kFar;  // no target nearer than kFar: index 0, coordinates 0
        const size_t o = static_cast<size_t>(p0 + k) * nq + q;
        dist[o] = md[i];
        idx[o] = mi[i];
        near[3 * o] = hit ? ts[3 * mi[i]] : 0.f;
        near[3 * o + 1] = hit ? ts[3 * mi[i] + 1] : 0.f;
        near[3 * o + 2] = hit ? ts[3 * mi[i] + 2] : 0.f;
      }
    }
  }
}

// Tiled chamfer half for large sets: for every point of x (B, N, 3) its
// nearest point in y (B, M, 3), and for every point of y its nearest in x,
// over the *expansion* distance (xx - 2 x.y) + yy, as the TPU kernel forms
// it (the coordinate-wise form above rounds differently near zero). First
// index on ties; the distance is clamped at zero on output only.
//
// Replaces point_dae_tpu/losses/chamfer.py:_nn_half_pallas.
//
// Design: the first blocks take x's rows against y, the rest y's rows
// against x. A block's threads form S column groups of whole warps; a
// thread holds R rows, so one broadcast 16-byte shared load of a target
// (y0, y1, y2, yy) serves R pairs. Group g scans the contiguous column range
// [g span, (g + 1) span), staged in pieces. A pair costs eight issued
// instructions: x.y as three rounded products summed left to right, then
// fma(-2, x.y, xx) (2 x.y is exact, so this one rounding equals the plain
// version's xx - 2 x.y), + yy, and fminf into the chunk's minimum. The index
// is found after the loop: a chunk of kChunk columns whose minimum is
// strictly below the row's best is recorded, and at the end of each piece
// the recorded chunk is scanned again, with the same operations, for its
// first column at the best distance. The groups' (best, index) then merge
// in shared memory in group order with a strict `<`, so the earlier range,
// the smaller index, wins a tie. Every product and sum rounds as the plain
// version's, so distances and indices agree with it bit for bit (barring
// x.y past 1.7e38, where the plain version's 2 x.y overflows).
//
// Bound on the H100, both directions at 128 x 1024 x 1024: 268 M pairs of
// nine f32 operations (0.0361 ms at the FMA rate) against 4 MB; the
// rounding rule's eight issued instructions a pair take 0.064-0.072 ms at
// 128 lanes a clock an SM (1.98-1.755 GHz).
constexpr int kChunk = 16;
constexpr int kMaxTiledThreads = 256;

struct TiledDir {  // one direction: rows of q against targets of t
  const float* q;
  const float* t;
  int nq, nt, row_blocks;
  float* dist;
  int* idx;
};

__device__ __forceinline__ float sq_norm3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
}

// (xx - 2 x.y) + yy in the plain version's rounding
__device__ __forceinline__ float expansion(float x0, float x1, float x2, float xx, float4 p) {
  const float xy = __fadd_rn(__fadd_rn(__fmul_rn(x0, p.x), __fmul_rn(x1, p.y)),
                             __fmul_rn(x2, p.z));
  return __fadd_rn(__fmaf_rn(-2.0f, xy, xx), p.w);
}

template <int R>
__global__ void __launch_bounds__(kMaxTiledThreads)
nn_half_tiled_kernel(TiledDir d0, TiledDir d1, int blocks0, int S, int piece) {
  extern __shared__ float4 sy[];  // S pieces of `piece` targets, then the merge
  const bool second = blockIdx.x >= blocks0;
  const TiledDir dir = second ? d1 : d0;
  const int blk = second ? blockIdx.x - blocks0 : blockIdx.x;
  const int b = blk / dir.row_blocks;
  const int gthreads = blockDim.x / S;
  const int g = threadIdx.x / gthreads, t = threadIdx.x - g * gthreads;
  const int rows = gthreads * R;
  const int row0 = (blk - b * dir.row_blocks) * rows;
  const float* qb = dir.q + static_cast<size_t>(b) * dir.nq * 3;
  const float* tb = dir.t + static_cast<size_t>(b) * dir.nt * 3;

  float x0[R], x1[R], x2[R], xx[R], best[R];
  int bi[R], bc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = min(row0 + t + r * gthreads, dir.nq - 1);
    x0[r] = qb[3 * i];
    x1[r] = qb[3 * i + 1];
    x2[r] = qb[3 * i + 2];
    xx[r] = sq_norm3(x0[r], x1[r], x2[r]);
    best[r] = kFar;
    bi[r] = 0;
  }
  const int span = (dir.nt + S - 1) / S;
  const int c0 = min(g * span, dir.nt), c1 = min(c0 + span, dir.nt);
  const float4* ys = sy + g * piece;
  for (int p0 = 0; p0 < span; p0 += piece) {
    __syncthreads();
    for (int e = threadIdx.x; e < S * piece; e += blockDim.x) {
      const int gg = e / piece;
      const int col = gg * span + p0 + (e - gg * piece);
      if (col < min((gg + 1) * span, dir.nt)) {
        const float* yp = tb + static_cast<size_t>(col) * 3;
        const float a = yp[0], bb = yp[1], c = yp[2];
        sy[e] = make_float4(a, bb, c, sq_norm3(a, bb, c));
      }
    }
    __syncthreads();
    const int n = max(0, min(piece, c1 - c0 - p0));
#pragma unroll
    for (int r = 0; r < R; ++r) bc[r] = -1;
    for (int j0 = 0; j0 < n; j0 += kChunk) {
      float cm[R];
#pragma unroll
      for (int r = 0; r < R; ++r) cm[r] = __int_as_float(0x7f800000);  // +inf
      if (j0 + kChunk <= n) {
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float4 p = ys[j0 + jj];
#pragma unroll
          for (int r = 0; r < R; ++r)
            cm[r] = fminf(cm[r], expansion(x0[r], x1[r], x2[r], xx[r], p));
        }
      } else {
        for (int jj = j0; jj < n; ++jj) {
          const float4 p = ys[jj];
#pragma unroll
          for (int r = 0; r < R; ++r)
            cm[r] = fminf(cm[r], expansion(x0[r], x1[r], x2[r], xx[r], p));
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (cm[r] < best[r]) {
          best[r] = cm[r];
          bc[r] = j0;
        }
      }
    }
    // the recorded chunk's first column at the best distance
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (bc[r] >= 0) {
        const int end = min(bc[r] + kChunk, n);
        for (int jj = bc[r]; jj < end; ++jj) {
          if (expansion(x0[r], x1[r], x2[r], xx[r], ys[jj]) == best[r]) {
            bi[r] = c0 + p0 + jj;
            break;
          }
        }
      }
    }
  }

  float* const dist = dir.dist + static_cast<size_t>(b) * dir.nq;
  int* const idx = dir.idx + static_cast<size_t>(b) * dir.nq;
  if (S == 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = row0 + t + r * gthreads;
      if (i < dir.nq) {
        dist[i] = fmaxf(best[r], 0.0f);
        idx[i] = bi[r];
      }
    }
    return;
  }
  __syncthreads();  // every group is done with the staged targets
  float* const md = reinterpret_cast<float*>(sy);
  int* const mi = reinterpret_cast<int*>(md + S * rows);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    md[g * rows + t + r * gthreads] = best[r];
    mi[g * rows + t + r * gthreads] = bi[r];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows && row0 + e < dir.nq; e += blockDim.x) {
    float bd = md[e];
    int bx = mi[e];
    for (int gg = 1; gg < S; ++gg) {
      if (md[gg * rows + e] < bd) {
        bd = md[gg * rows + e];
        bx = mi[gg * rows + e];
      }
    }
    dist[row0 + e] = fmaxf(bd, 0.0f);
    idx[row0 + e] = bx;
  }
}

template <int R>
cudaError_t launch_tiled(const TiledDir& d0, const TiledDir& d1, int blocks0, int blocks,
                         int threads, int S, int piece, size_t smem, cudaStream_t stream) {
  const cudaError_t err = set_smem(nn_half_tiled_kernel<R>, smem);
  if (err != cudaSuccess) return err;
  nn_half_tiled_kernel<R><<<blocks, threads, smem, stream>>>(d0, d1, blocks0, S, piece);
  return cudaGetLastError();
}

}  // namespace

// Both directions of the tiled half in one launch (d2 == nullptr: x against
// y alone). Plan: R rows a thread (1, 2, 4 or 8), `warps` warps a block in S
// column groups of whole warps, `piece` targets of a group staged at once.
PDAE_EXPORT int nn_half_tiled_pair(const float* x, const float* y, int B, int N, int M, int R,
                                   int warps, int S, int piece, float* d1, int* i1, float* d2,
                                   int* i2, void* stream) {
  const int threads = warps * 32;
  if (threads > kMaxTiledThreads || warps < 1 || S < 1 || warps % S != 0 || piece < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  if ((N > 0 && M <= 0) || (d2 && M > 0 && N <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = threads / S * R;
  TiledDir a{x, y, N, M, (N + rows - 1) / rows, d1, i1};
  TiledDir c{y, x, M, N, d2 ? (M + rows - 1) / rows : 0, d2, i2};
  const int blocks0 = B * a.row_blocks, blocks = blocks0 + B * c.row_blocks;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  const size_t stage = static_cast<size_t>(S) * piece * sizeof(float4);
  const size_t merge = S > 1 ? static_cast<size_t>(S) * rows * 8 : 0;
  const size_t smem = stage > merge ? stage : merge;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (R) {
    case 1: err = launch_tiled<1>(a, c, blocks0, blocks, threads, S, piece, smem, s); break;
    case 2: err = launch_tiled<2>(a, c, blocks0, blocks, threads, S, piece, smem, s); break;
    case 4: err = launch_tiled<4>(a, c, blocks0, blocks, threads, S, piece, smem, s); break;
    case 8: err = launch_tiled<8>(a, c, blocks0, blocks, threads, S, piece, smem, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Both directions of the patch half in one launch (d2 == nullptr: x against
// y alone). Plan: K patches a block of `threads` threads.
PDAE_EXPORT int nn_half_small_pair(const float* x, const float* y, int P, int N, int M, int K,
                                   int threads, float* d1, int* i1, float* n1, float* d2,
                                   int* i2, float* n2, void* stream) {
  if (N > kMaxPts || M > kMaxPts || N < 1 || M < 1 || K < 1 || threads < 32 ||
      threads > kMaxPatchThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(K) * (patch_stride(N) + patch_stride(M)) * 4;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem(nn_half_small_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  nn_half_small_kernel<<<(P + K - 1) / K, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, P, N, M, K, d1, i1, n1, d2, i2, n2);
  return static_cast<int>(cudaGetLastError());
}
