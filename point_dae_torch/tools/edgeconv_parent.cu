// The EdgeConv kernels in their previous design, kept unchanged as the yardstick
// of point_dae_torch/tools/edgeconv_ablation.py and of chip_smoke.py: its
// backward finds each target row's contributors by scanning the cloud's whole
// idx list (N^2 k work), and its selection keeps kR = 2 query rows a warp. The
// current design, in csrc/edgeconv.cu, must give the same bits. Built with
// -I point_dae_torch/csrc; nothing in the package loads it.
//
// Fused EdgeConv neighbour aggregate: kNN selection fused with the four
// per-point aggregates of U over each point's k nearest neighbours, and the
// two backward passes that scatter the cotangents back onto U.
//
// Replaces point_dae_tpu/ops/pallas_edgeconv.py:knn_aggregate: _fwd_kernel
// (forward), _bwd_kernel_first (grad_mode 'first') and _bwd_kernel
// (grad_mode 'split'); pallas_edgeconv.py:aggregate_from_idx (its forward,
// _fwd_idx_kernel, is the aggregate launch alone: entry edgeconv_aggregate;
// its backwards are the two above); and point_dae_tpu/ops/pallas_knn.py:
// knn_pallas (the selection with a query set apart from the database, the
// distances written too: entry knn_select).
//
// Forward. For cloud b and point i, over xf (B, N, Cf) f32:
//   d[i, j] = (sq[i] - 2 dot(xf[i], xf[j])) + sq[j],  not clamped at zero,
// k rounds each take the first minimal column (lower index on ties), and
// over the selected rows of U (B, N, C) in that order: M = max, m = min,
// S1 = sum, S2 = sum of squares, and (grad_mode 'first') rM / rm = the round
// that first attains the max / min (strict > / <), one byte each.
//
// Design. The TPU kernel held a cloud's whole xf and U in VMEM; a Hopper
// block has 227 KB, so the forward is two launches that meet in idx:
//  - select: a block is kSelWarps warps, kR query rows a warp. xf streams
//    through shared memory in (kTileCols columns x kTileCh channels) tiles
//    shared by the block's rows, the next tile's global loads in flight
//    while the current one is used. A lane keeps the distances of columns
//    lane + 32 t of its kR rows in registers (32 * kNT = 1024 columns at
//    once) and reads four channels of a column at a time. A round is a
//    minimum over the lane's four cached group minima, a warp argmin by
//    shuffles over (distance, column), and a masking of the winner with a
//    rescan of its group of eight registers; the warp's rows go through it
//    side by side. Above 1024 columns (N <= 4096) the columns stream in
//    chunks of 1024 and each chunk's rounds merge with the row's running
//    top-k, kept per warp in shared memory, by (distance, column), the
//    TPU kernel's multi-tile merge (pallas_knn.py:80-95) done in place.
//  - aggregate: a warp a row reads the selected rows of U straight from L2
//    (an exact f32 row read stands where the TPU used a one-hot matrix
//    product), four channels a lane.
// Products and sums whose rounding decides a neighbour or an output bit are
// round-to-nearest intrinsics in the plain version's order (channel order
// for the distance, round order for the sums), so the forward agrees with
// it bit for bit.
//
// Backward. du[j] = sum over the pairs (i, r) with idx[i, r] = j of
//   first: (rM[i] == r) gM[i] + (rm[i] == r) gm[i] + gs1[i] + 2 U[j] gs2[i]
//   split: (U[j] == M[i]) gM[i] / cM[i] + (U[j] == m[i]) gm[i] / cm[i]
//          + gs1[i] + 2 U[j] gs2[i],  cM / cm = the number of the row's
//          neighbours whose value equals M / m.
// The TPU summed du over a sequential grid axis with transposed one-hot
// products. Here the warp that owns target row j finds its contributors
// itself: the cloud's idx streams through shared memory, the warp scans it
// for j and keeps the matches in (i, r) order (ballot + popcount) in a
// list of max(N, 1024) entries (a kNN names a row at most once a source,
// so nothing is dropped; above N 3376 a block has fewer warps), then sums
// their cotangent rows in that order, four channels a lane: the (gM, gm)
// terms, gs1 and gs2 each in their own sum, du = (acc + s1) + (2 U) s2.
// No atomics: the result repeats bit for bit. 'split' first runs a pass
// over source rows that turns (gM, gm) into (gM / cM, gm / cm).
//
// Bounds on the H100 (f32 outside the tensor cores): the forward's distance
// phase does B*N*N*Cf multiply-adds as two rounded operations each (69
// GFLOP at B 128, N 1024, Cf 128), against B*N*(Cf + 4.5 C + k)*4 bytes:
// operations. The backward moves about B*N*C*4*6 bytes and sums B*N*k*C*4
// terms: bytes.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = 1e30f;

constexpr int kSelWarps = 16;
constexpr int kR = 2;                       // query rows a warp
constexpr int kSelRows = kSelWarps * kR;    // query rows a block
constexpr int kSelThreads = kSelWarps * 32;
constexpr int kNT = 32;                     // distance registers a lane and row
constexpr int kMaxN = 32 * kNT;             // 1024
constexpr int kTileCols = 128;
constexpr int kTileCh = 32;
constexpr int kTileStride = kTileCh + 4;    // floats a column: float4 reads without conflicts
constexpr int kTileRegs = kTileCols * kTileCh / kSelThreads;   // 8 floats a thread
constexpr int kMaxK = 64;

// sq[row] = sum_c x[row, c]^2, products rounded, summed in channel order.
__global__ void row_sqnorm_kernel(const float* __restrict__ x, int rows, int C,
                                  float* __restrict__ sq) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* p = x + static_cast<size_t>(r) * C;
  float s = 0.f;
  for (int c = 0; c < C; ++c) s = __fadd_rn(s, __fmul_rn(p[c], p[c]));
  sq[r] = s;
}

// Round r's neighbour, held by lane r & 31 in i0 (r < 32) or i1.
__device__ __forceinline__ int round_idx(int i0, int i1, int r) {
  return __shfl_sync(kFull, r < 32 ? i0 : i1, r & 31);
}

__device__ __forceinline__ float mac_rn(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// One tile of xf, columns col0.. and channels cc.., a thread's share in
// registers: element s of thread t is tile float4 (or float) t + s * threads.
struct TileRegs {
  float v[kTileRegs];
};

template <bool kVec>
__device__ __forceinline__ void tile_load(TileRegs& r, const float* __restrict__ xb,
                                          int N, int Cf, int col0, int cc, int nch,
                                          int nchp) {
  if constexpr (kVec) {   // Cf % 4 == 0: one float4 is four channels of one column
    const int per_col = nchp >> 2;
#pragma unroll
    for (int s = 0; s < kTileRegs / 4; ++s) {
      const int e = threadIdx.x + s * kSelThreads;
      const int j = e / per_col, c4 = e - j * per_col;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < kTileCols && col0 + j < N)
        val = *reinterpret_cast<const float4*>(
            xb + static_cast<size_t>(col0 + j) * Cf + cc + 4 * c4);
      r.v[4 * s] = val.x; r.v[4 * s + 1] = val.y;
      r.v[4 * s + 2] = val.z; r.v[4 * s + 3] = val.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < kTileRegs; ++s) {
      const int e = threadIdx.x + s * kSelThreads;
      const int j = e / nchp, c = e - j * nchp;
      r.v[s] = (j < kTileCols && col0 + j < N && c < nch)
                   ? xb[static_cast<size_t>(col0 + j) * Cf + cc + c] : 0.f;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void tile_store(const TileRegs& r, float* __restrict__ ys,
                                           int nchp) {
  if constexpr (kVec) {
    const int per_col = nchp >> 2;
#pragma unroll
    for (int s = 0; s < kTileRegs / 4; ++s) {
      const int e = threadIdx.x + s * kSelThreads;
      const int j = e / per_col, c4 = e - j * per_col;
      if (j < kTileCols)
        *reinterpret_cast<float4*>(ys + j * kTileStride + 4 * c4) =
            make_float4(r.v[4 * s], r.v[4 * s + 1], r.v[4 * s + 2], r.v[4 * s + 3]);
    }
  } else {
#pragma unroll
    for (int s = 0; s < kTileRegs; ++s) {
      const int e = threadIdx.x + s * kSelThreads;
      const int j = e / nchp, c = e - j * nchp;
      if (j < kTileCols) ys[j * kTileStride + c] = r.v[s];
    }
  }
}

constexpr int kGroup = 8;   // distance registers a group; kNT / kGroup == 4 groups
static_assert(kNT == 4 * kGroup, "the selection handles four groups");

// Minimum of group G of a lane's distances and its register, the lower
// register (column) on a tie.
template <int G>
__device__ __forceinline__ void group_min(const float (&d)[kNT], float& best, int& bt) {
  best = d[G * kGroup];
  bt = G * kGroup;
#pragma unroll
  for (int t = G * kGroup + 1; t < (G + 1) * kGroup; ++t)
    if (d[t] < best) {
      best = d[t];
      bt = t;
    }
}

// Remove the round's winner, register tl of the lane with `mine`, from
// group G and find the group's minimum again.
template <int G>
__device__ __forceinline__ void take(float (&d)[kNT], bool mine, int tl, float& best,
                                     int& bt) {
#pragma unroll
  for (int t = G * kGroup; t < (G + 1) * kGroup; ++t)
    if (mine && t == tl) d[t] = kInf;
  group_min<G>(d, best, bt);
}

// kNN selection of query rows against a database's columns: idx (B, Nq, k)
// and, with kDists, the distances, ascending, lower column on ties. The
// EdgeConv forward passes one cloud as both. Up to kMaxN columns a row's
// distances sit in the lanes' registers at once. kStream handles more: the
// columns go by in chunks of kMaxN, each chunk's k rounds drawing from the
// chunk's registers and from the head of the row's running top-k (kept per
// warp in shared memory), so the merge orders by (distance, column) as one
// pass over all columns would.
template <bool kVec, bool kStream, bool kDists>
__global__ void __launch_bounds__(kSelThreads)
knn_select_kernel(const float* __restrict__ qx, const float* __restrict__ sqq,
                  const float* __restrict__ yx, const float* __restrict__ sqy, int Nq,
                  int Ndb, int Cf, int k, int row_blocks, int* __restrict__ idx,
                  float* __restrict__ dists) {
  extern __shared__ __align__(16) float smem[];
  const int Cfp = (Cf + 3) & ~3;               // q rows padded with zeros
  float* qs = smem;                            // [kSelRows][Cfp]
  float* ys = smem + kSelRows * Cfp;           // [kTileCols][kTileStride]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / row_blocks;
  const int row0 = (blockIdx.x % row_blocks) * kSelRows;
  const float* qb = qx + static_cast<size_t>(b) * Nq * Cf;
  const float* yb = yx + static_cast<size_t>(b) * Ndb * Cf;
  const float* sqqb = sqq + static_cast<size_t>(b) * Nq;
  const float* sqyb = sqy + static_cast<size_t>(b) * Ndb;
  // kStream: a warp's running lists, [buffer][row][kMaxK] values then columns
  float* lv = ys + kTileCols * kTileStride + warp * (4 * kR * kMaxK);
  int* li = reinterpret_cast<int*>(lv + 2 * kR * kMaxK);

  for (int e = threadIdx.x; e < kSelRows * Cfp; e += kSelThreads) {
    const int r = e / Cfp, c = e - r * Cfp;
    qs[e] = c < Cf ? qb[static_cast<size_t>(min(row0 + r, Nq - 1)) * Cf + c] : 0.f;
  }

  int i0[kR], i1[kR];        // !kStream: round r's column (and distance) in
  float v0[kR], v1[kR];      // lane r & 31, r < 32 in i0 / v0, else i1 / v1
  int cur = 0;               // kStream: the buffer holding the running lists
  TileRegs regs;
  tile_load<kVec>(regs, yb, Ndb, Cf, 0, 0, min(kTileCh, Cf), (min(kTileCh, Cf) + 3) & ~3);
  for (int base = 0; base < Ndb; base += kMaxN) {   // one chunk unless kStream
    const int ncols = min(kMaxN, Ndb - base);
    // ---- distances: d[a][t] is row kR * warp + a against column base + 32 t + lane
    float d[kR][kNT];
#pragma unroll
    for (int a = 0; a < kR; ++a)
#pragma unroll
      for (int t = 0; t < kNT; ++t) d[a][t] = 0.f;

    for (int cc = 0; cc < Cf; cc += kTileCh) {
      const int nch = min(kTileCh, Cf - cc);
      const int nchp = (nch + 3) & ~3;
#pragma unroll
      for (int tc = 0; tc < kNT / 4; ++tc) {
        const int col0 = tc * kTileCols;
        if (col0 < ncols) {   // the same for the whole block
          __syncthreads();   // the tile before is used up (and qs is written)
          tile_store<kVec>(regs, ys, nchp);
          __syncthreads();
          {   // the next tile's loads fly while this one is used
            int ncol = col0 + kTileCols, ncc = cc, nbase = base;
            if (ncol >= ncols) { ncol = 0; ncc = cc + kTileCh; }
            if (ncc >= Cf) { ncc = 0; nbase = base + kMaxN; }
            if (nbase < Ndb) {
              const int nn = min(kTileCh, Cf - ncc);
              tile_load<kVec>(regs, yb, Ndb, Cf, nbase + ncol, ncc, nn, (nn + 3) & ~3);
            }
          }
          const float* q = qs + (kR * warp) * Cfp + cc;
          for (int c = 0; c < nchp; c += 4) {
            float4 qv[kR];
#pragma unroll
            for (int a = 0; a < kR; ++a)
              qv[a] = *reinterpret_cast<const float4*>(q + a * Cfp + c);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float4 y =
                  *reinterpret_cast<const float4*>(ys + (lane + 32 * u) * kTileStride + c);
#pragma unroll
              for (int a = 0; a < kR; ++a) {
                float acc = d[a][tc * 4 + u];
                acc = mac_rn(acc, qv[a].x, y.x);
                acc = mac_rn(acc, qv[a].y, y.y);
                acc = mac_rn(acc, qv[a].z, y.z);
                acc = mac_rn(acc, qv[a].w, y.w);
                d[a][tc * 4 + u] = acc;
              }
            }
          }
        }
      }
    }
    // no block barrier below, up to the next chunk's tiles
#pragma unroll
    for (int a = 0; a < kR; ++a) {
      const int i = min(row0 + kR * warp + a, Nq - 1);
      const float qq = sqqb[i];
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const int j = 32 * t + lane;
        d[a][t] = j < ncols
                      ? __fadd_rn(__fsub_rn(qq, __fmul_rn(2.0f, d[a][t])), sqyb[base + j])
                      : kInf;
      }
      if (!kStream) {
        i0[a] = 0;
        i1[a] = 0;
        v0[a] = 0.f;
        v1[a] = 0.f;
      }
    }

    // ---- k rounds of first-argmin extraction, the warp's rows side by side.
    // A lane keeps the minimum of each group of kGroup registers, so a round
    // rescans only the group the winner sat in (the same group for the whole
    // warp) instead of all kNT registers.
    float gb[kR][kNT / kGroup];
    int gt[kR][kNT / kGroup];
#pragma unroll
    for (int a = 0; a < kR; ++a) {
      group_min<0>(d[a], gb[a][0], gt[a][0]);
      group_min<1>(d[a], gb[a][1], gt[a][1]);
      group_min<2>(d[a], gb[a][2], gt[a][2]);
      group_min<3>(d[a], gb[a][3], gt[a][3]);
    }
    int head[kR];   // kStream: the next entry of each row's running list
#pragma unroll
    for (int a = 0; a < kR; ++a) head[a] = 0;
    for (int r = 0; r < k; ++r) {
      float best[kR];
      int bj[kR];
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        best[a] = gb[a][0];
        int bt = gt[a][0];
#pragma unroll
        for (int g = 1; g < kNT / kGroup; ++g)
          if (gb[a][g] < best[a]) {   // strict: the lower column stays on a tie
            best[a] = gb[a][g];
            bt = gt[a][g];
          }
        bj[a] = base + 32 * bt + lane;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int a = 0; a < kR; ++a) {
          const float ov = __shfl_xor_sync(kFull, best[a], off);
          const int oj = __shfl_xor_sync(kFull, bj[a], off);
          if (ov < best[a] || (ov == best[a] && oj < bj[a])) {
            best[a] = ov;
            bj[a] = oj;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        bool from_list = false;   // the same for the whole warp
        if constexpr (kStream) {
          float v = best[a];
          int j = bj[a];
          if (base > 0) {   // the list's columns all precede this chunk's
            const float hv = lv[(cur * kR + a) * kMaxK + head[a]];
            const int hj = li[(cur * kR + a) * kMaxK + head[a]];
            from_list = hv < v || (hv == v && hj < j);
            if (from_list) {
              v = hv;
              j = hj;
              ++head[a];
            }
          }
          if (lane == 0) {
            lv[((cur ^ 1) * kR + a) * kMaxK + r] = v;
            li[((cur ^ 1) * kR + a) * kMaxK + r] = j;
          }
        } else if (lane == (r & 31)) {
          if (r < 32) {
            i0[a] = bj[a];
            v0[a] = best[a];
          } else {
            i1[a] = bj[a];
            v1[a] = best[a];
          }
        }
        if (!from_list) {
          const int tl = (bj[a] - base) >> 5;
          const bool mine = lane == (bj[a] & 31);
          switch (tl / kGroup) {   // the same for the whole warp
            case 0: take<0>(d[a], mine, tl, gb[a][0], gt[a][0]); break;
            case 1: take<1>(d[a], mine, tl, gb[a][1], gt[a][1]); break;
            case 2: take<2>(d[a], mine, tl, gb[a][2], gt[a][2]); break;
            default: take<3>(d[a], mine, tl, gb[a][3], gt[a][3]); break;
          }
        }
      }
    }
    if constexpr (kStream) {
      cur ^= 1;
      __syncwarp();
    }
  }
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int i = row0 + kR * warp + a;
    if (i < Nq) {
      const size_t o = (static_cast<size_t>(b) * Nq + i) * k;
      for (int r = lane; r < k; r += 32) {
        if constexpr (kStream) {
          idx[o + r] = li[(cur * kR + a) * kMaxK + r];
          if constexpr (kDists) dists[o + r] = lv[(cur * kR + a) * kMaxK + r];
        } else {
          idx[o + r] = r < 32 ? i0[a] : i1[a];
          if constexpr (kDists) dists[o + r] = r < 32 ? v0[a] : v1[a];
        }
      }
    }
  }
}

// A lane's kV consecutive channels.
template <int kV>
struct Vec {
  float v[kV];
};

template <int kV>
__device__ __forceinline__ Vec<kV> ld(const float* p) {
  Vec<kV> out;
  if constexpr (kV == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out.v[0] = t.x; out.v[1] = t.y; out.v[2] = t.z; out.v[3] = t.w;
  } else {
    out.v[0] = *p;
  }
  return out;
}

template <int kV>
__device__ __forceinline__ void st(float* p, const Vec<kV>& x) {
  if constexpr (kV == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  else
    *p = x.v[0];
}

template <int kV>
__device__ __forceinline__ void st_bytes(uint8_t* p, const int (&x)[kV]) {
  if constexpr (kV == 4)
    *reinterpret_cast<uchar4*>(p) = make_uchar4(x[0], x[1], x[2], x[3]);
  else
    *p = static_cast<uint8_t>(x[0]);
}

constexpr int kAggWarps = 8;

// Aggregates over the rows idx selects, in round order; a warp a row, kV
// channels a lane (kV == 4 needs C % 4 == 0).
template <int kV, bool kTrack>
__global__ void __launch_bounds__(kAggWarps * 32)
edgeconv_aggregate_kernel(const float* __restrict__ U, const int* __restrict__ idx,
                          int rows, int N, int C, int k, float* __restrict__ M,
                          float* __restrict__ m, float* __restrict__ S1,
                          float* __restrict__ S2, uint8_t* __restrict__ rM,
                          uint8_t* __restrict__ rm) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kAggWarps + (threadIdx.x >> 5);
  if (row >= rows) return;   // whole warp
  const int* ir = idx + static_cast<size_t>(row) * k;
  const int i0 = lane < k ? ir[lane] : 0;
  const int i1 = lane + 32 < k ? ir[lane + 32] : 0;
  const float* Ub = U + static_cast<size_t>(row / N) * N * C;
  for (int c0 = 0; c0 < C; c0 += 32 * kV) {
    const int c = c0 + lane * kV;
    const bool live = c < C;
    float vM[kV], vm[kV], s1[kV], s2[kV];
    int irM[kV], irm[kV];
#pragma unroll
    for (int x = 0; x < kV; ++x) {
      vM[x] = -kInf; vm[x] = kInf; s1[x] = 0.f; s2[x] = 0.f; irM[x] = 0; irm[x] = 0;
    }
#pragma unroll 4
    for (int r = 0; r < k; ++r) {
      const int j = round_idx(i0, i1, r);
      if (live) {
        const Vec<kV> u = ld<kV>(Ub + static_cast<size_t>(j) * C + c);
#pragma unroll
        for (int x = 0; x < kV; ++x) {
          const float v = u.v[x];
          if (v > vM[x]) irM[x] = r;
          if (v < vm[x]) irm[x] = r;
          vM[x] = fmaxf(vM[x], v);
          vm[x] = fminf(vm[x], v);
          s1[x] = __fadd_rn(s1[x], v);
          s2[x] = __fadd_rn(s2[x], __fmul_rn(v, v));
        }
      }
    }
    if (live) {
      const size_t o = static_cast<size_t>(row) * C + c;
      Vec<kV> t;
#pragma unroll
      for (int x = 0; x < kV; ++x) t.v[x] = vM[x];
      st<kV>(M + o, t);
#pragma unroll
      for (int x = 0; x < kV; ++x) t.v[x] = vm[x];
      st<kV>(m + o, t);
#pragma unroll
      for (int x = 0; x < kV; ++x) t.v[x] = s1[x];
      st<kV>(S1 + o, t);
#pragma unroll
      for (int x = 0; x < kV; ++x) t.v[x] = s2[x];
      st<kV>(S2 + o, t);
      if constexpr (kTrack) {
        st_bytes<kV>(rM + o, irM);
        st_bytes<kV>(rm + o, irm);
      }
    }
  }
}

// 'split' pass over source rows: wM = gM / max(cM, 1), wm = gm / max(cm, 1).
template <int kV>
__global__ void __launch_bounds__(kAggWarps * 32)
edgeconv_tie_weights_kernel(const float* __restrict__ U, const int* __restrict__ idx,
                            const float* __restrict__ Mv, const float* __restrict__ mv,
                            const float* __restrict__ gM, const float* __restrict__ gm,
                            int rows, int N, int C, int k, float* __restrict__ wM,
                            float* __restrict__ wm) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kAggWarps + (threadIdx.x >> 5);
  if (row >= rows) return;   // whole warp
  const int* ir = idx + static_cast<size_t>(row) * k;
  const int i0 = lane < k ? ir[lane] : 0;
  const int i1 = lane + 32 < k ? ir[lane + 32] : 0;
  const float* Ub = U + static_cast<size_t>(row / N) * N * C;
  for (int c0 = 0; c0 < C; c0 += 32 * kV) {
    const int c = c0 + lane * kV;
    const bool live = c < C;
    const size_t o = static_cast<size_t>(row) * C + (live ? c : 0);
    const Vec<kV> vM = ld<kV>(Mv + o), vm = ld<kV>(mv + o);
    float cM[kV], cm[kV];
#pragma unroll
    for (int x = 0; x < kV; ++x) { cM[x] = 0.f; cm[x] = 0.f; }
#pragma unroll 4
    for (int r = 0; r < k; ++r) {
      const int j = round_idx(i0, i1, r);
      if (live) {
        const Vec<kV> u = ld<kV>(Ub + static_cast<size_t>(j) * C + c);
#pragma unroll
        for (int x = 0; x < kV; ++x) {
          cM[x] += u.v[x] == vM.v[x] ? 1.f : 0.f;
          cm[x] += u.v[x] == vm.v[x] ? 1.f : 0.f;
        }
      }
    }
    if (live) {
      Vec<kV> a = ld<kV>(gM + o), c2 = ld<kV>(gm + o);
#pragma unroll
      for (int x = 0; x < kV; ++x) {
        a.v[x] = a.v[x] / fmaxf(cM[x], 1.f);
        c2.v[x] = c2.v[x] / fmaxf(cm[x], 1.f);
      }
      st<kV>(wM + o, a);
      st<kV>(wm + o, c2);
    }
  }
}

constexpr int kBwdWarps = 16;   // target rows a backward block, at most
constexpr int kChunk = 4096;    // idx entries staged a pass
// A kNN row names a column at most once, so a target row has at most N
// contributors: a warp's list holds max(N, kMaxN) entries, and above
// N = 3376 fewer warps a block keep the lists inside kMaxSmem.
constexpr int kMaxSmem = 232448;

template <int kV>
__device__ __forceinline__ void ld_rounds(const uint8_t* p, int (&out)[kV]) {
  if constexpr (kV == 4) {
    const uchar4 t = *reinterpret_cast<const uchar4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
    out[0] = *p;
  }
}

// kSplit == false: a = rM, c = rm (bytes), gA = gM, gB = gm.
// kSplit == true:  a = M,  c = m (float),  gA = wM, gB = wm.
template <bool kSplit, int kV>
__global__ void __launch_bounds__(kBwdWarps * 32)
edgeconv_bwd_kernel(const float* __restrict__ U, const int* __restrict__ idx,
                    const void* __restrict__ a_, const void* __restrict__ c_,
                    const float* __restrict__ gA, const float* __restrict__ gB,
                    const float* __restrict__ gs1, const float* __restrict__ gs2,
                    int N, int C, int k, int row_blocks, int list_cap,
                    float* __restrict__ du) {
  extern __shared__ __align__(16) int ism[];
  int* chunk = ism;                                   // [kChunk]
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* list = ism + kChunk + warp * list_cap;         // matches e = i * k + r
  const int b = blockIdx.x / row_blocks;
  const int j = (blockIdx.x % row_blocks) * warps + warp;
  const int E = N * k;
  const int* ib = idx + static_cast<size_t>(b) * E;

  // ---- this row's contributors, in (i, r) order
  int n = 0;
  for (int e0 = 0; e0 < E; e0 += kChunk) {
    const int lim = min(kChunk, E - e0);
    __syncthreads();
    for (int e = threadIdx.x; e < lim; e += blockDim.x) chunk[e] = ib[e0 + e];
    __syncthreads();
    if (j < N) {
      for (int base = 0; base < lim; base += 128) {
        // a lane takes four neighbouring entries
        const int e = base + 4 * lane;
        int4 v = make_int4(-1, -1, -1, -1);
        if (e + 3 < lim) {
          v = *reinterpret_cast<const int4*>(chunk + e);
        } else {
          if (e < lim) v.x = chunk[e];
          if (e + 1 < lim) v.y = chunk[e + 1];
          if (e + 2 < lim) v.z = chunk[e + 2];
        }
        const bool h0 = v.x == j, h1 = v.y == j, h2 = v.z == j, h3 = v.w == j;
        const unsigned any = __ballot_sync(kFull, h0 || h1 || h2 || h3);
        if (any == 0u) continue;   // the same for the whole warp
        const int mine = h0 + h1 + h2 + h3;
        // entries before this lane's: an inclusive scan over the lanes
        int incl = mine;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int t = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += t;
        }
        int pos = n + incl - mine;
        if (h0) { if (pos < list_cap) list[pos] = e0 + e; ++pos; }
        if (h1) { if (pos < list_cap) list[pos] = e0 + e + 1; ++pos; }
        if (h2) { if (pos < list_cap) list[pos] = e0 + e + 2; ++pos; }
        if (h3) { if (pos < list_cap) list[pos] = e0 + e + 3; ++pos; }
        n += __shfl_sync(kFull, incl, 31);
      }
    }
  }
  if (j >= N) return;
  n = min(n, list_cap);   // n <= N <= list_cap when idx rows are a kNN's
  __syncwarp();

  // ---- their cotangent rows, summed in that order
  const size_t cloud = static_cast<size_t>(b) * N;
  for (int c0 = 0; c0 < C; c0 += 32 * kV) {
    const int c = c0 + lane * kV;
    if (c >= C) continue;   // no warp-wide operation below
    const Vec<kV> u = ld<kV>(U + (cloud + j) * C + c);
    float acc[kV], s1[kV], s2[kV];
#pragma unroll
    for (int x = 0; x < kV; ++x) { acc[x] = 0.f; s1[x] = 0.f; s2[x] = 0.f; }
#pragma unroll 4
    for (int q = 0; q < n; ++q) {
      const int e = list[q];
      const int i = e / k, r = e - i * k;
      const size_t o = (cloud + i) * C + c;
      const Vec<kV> a = ld<kV>(gA + o), bb = ld<kV>(gB + o);
      const Vec<kV> t1 = ld<kV>(gs1 + o), t2 = ld<kV>(gs2 + o);
      if constexpr (kSplit) {
        const Vec<kV> vM = ld<kV>(static_cast<const float*>(a_) + o);
        const Vec<kV> vm = ld<kV>(static_cast<const float*>(c_) + o);
#pragma unroll
        for (int x = 0; x < kV; ++x)
          acc[x] += (u.v[x] == vM.v[x] ? a.v[x] : 0.f) + (u.v[x] == vm.v[x] ? bb.v[x] : 0.f);
      } else {
        int qM[kV], qm[kV];
        ld_rounds<kV>(static_cast<const uint8_t*>(a_) + o, qM);
        ld_rounds<kV>(static_cast<const uint8_t*>(c_) + o, qm);
#pragma unroll
        for (int x = 0; x < kV; ++x)
          acc[x] += (qM[x] == r ? a.v[x] : 0.f) + (qm[x] == r ? bb.v[x] : 0.f);
      }
#pragma unroll
      for (int x = 0; x < kV; ++x) {
        s1[x] += t1.v[x];
        s2[x] += t2.v[x];
      }
    }
    Vec<kV> out;
#pragma unroll
    for (int x = 0; x < kV; ++x)   // (acc + s1) + (2 u) s2, no fused multiply-add
      out.v[x] = __fadd_rn(__fadd_rn(acc[x], s1[x]),
                           __fmul_rn(__fmul_rn(2.0f, u.v[x]), s2[x]));
    st<kV>(du + (cloud + j) * C + c, out);
  }
}

template <bool kSplit, int kV>
int launch_bwd(const float* U, const int* idx, const void* a, const void* c,
               const float* gA, const float* gB, const float* gs1, const float* gs2,
               int B, int N, int C, int k, float* du, cudaStream_t stream) {
  const int list_cap = N > kMaxN ? N : kMaxN;
  const int fit = static_cast<int>((kMaxSmem - kChunk * sizeof(int)) / (list_cap * sizeof(int)));
  const int warps = fit < kBwdWarps ? fit : kBwdWarps;
  const size_t smem = (kChunk + static_cast<size_t>(warps) * list_cap) * sizeof(int);
  cudaError_t err = set_smem(edgeconv_bwd_kernel<kSplit, kV>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (N + warps - 1) / warps;
  edgeconv_bwd_kernel<kSplit, kV><<<B * row_blocks, warps * 32, smem, stream>>>(
      U, idx, a, c, gA, gB, gs1, gs2, N, C, k, row_blocks, list_cap, du);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec, bool kStream, bool kDists>
int launch_select3(const float* q, const float* sqq, const float* y, const float* sqy,
                   int B, int Nq, int Ndb, int Cf, int k, int* idx, float* dists,
                   cudaStream_t stream) {
  const int Cfp = (Cf + 3) & ~3;
  const size_t smem =
      (static_cast<size_t>(kSelRows) * Cfp + kTileCols * kTileStride +
       (kStream ? kSelWarps * 4 * kR * kMaxK : 0)) * sizeof(float);
  cudaError_t err = set_smem(knn_select_kernel<kVec, kStream, kDists>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (Nq + kSelRows - 1) / kSelRows;
  knn_select_kernel<kVec, kStream, kDists><<<B * row_blocks, kSelThreads, smem, stream>>>(
      q, sqq, y, sqy, Nq, Ndb, Cf, k, row_blocks, idx, dists);
  return static_cast<int>(cudaGetLastError());
}

// Picks the instance: float4 reads when Cf % 4 == 0, streamed columns above kMaxN.
template <bool kDists>
int launch_select(const float* q, const float* sqq, const float* y, const float* sqy,
                  int B, int Nq, int Ndb, int Cf, int k, int* idx, float* dists,
                  cudaStream_t stream) {
  const bool vec = Cf % 4 == 0, streamed = Ndb > kMaxN;
  if (vec)
    return streamed
               ? launch_select3<true, true, kDists>(q, sqq, y, sqy, B, Nq, Ndb, Cf, k, idx,
                                                    dists, stream)
               : launch_select3<true, false, kDists>(q, sqq, y, sqy, B, Nq, Ndb, Cf, k, idx,
                                                     dists, stream);
  return streamed
             ? launch_select3<false, true, kDists>(q, sqq, y, sqy, B, Nq, Ndb, Cf, k, idx,
                                                   dists, stream)
             : launch_select3<false, false, kDists>(q, sqq, y, sqy, B, Nq, Ndb, Cf, k, idx,
                                                    dists, stream);
}

int launch_sqnorm(const float* x, int rows, int C, float* sq, cudaStream_t stream) {
  if (rows == 0) return static_cast<int>(cudaSuccess);
  row_sqnorm_kernel<<<(rows + 255) / 256, 256, 0, stream>>>(x, rows, C, sq);
  return static_cast<int>(cudaGetLastError());
}

template <int kV>
int launch_aggregate(const float* U, const int* idx, int B, int N, int C, int k,
                     int track, float* M, float* m, float* S1, float* S2, uint8_t* rM,
                     uint8_t* rm, cudaStream_t stream) {
  const int rows = B * N;
  const int blocks = (rows + kAggWarps - 1) / kAggWarps;
  if (track)
    edgeconv_aggregate_kernel<kV, true><<<blocks, kAggWarps * 32, 0, stream>>>(
        U, idx, rows, N, C, k, M, m, S1, S2, rM, rm);
  else
    edgeconv_aggregate_kernel<kV, false><<<blocks, kAggWarps * 32, 0, stream>>>(
        U, idx, rows, N, C, k, M, m, S1, S2, rM, rm);
  return static_cast<int>(cudaGetLastError());
}

// N up to kMaxStreamN: the selection streams its columns, the backward's
// lists fit shared memory.
constexpr int kMaxStreamN = 4096;

bool bad_shape(int N, int k) {
  return N < 1 || N > kMaxStreamN || k < 1 || k > kMaxK || k > N;
}

int launch_aggregate_any(const float* U, const int* idx, int B, int N, int C, int k,
                         int track, float* M, float* m, float* S1, float* S2, uint8_t* rM,
                         uint8_t* rm, cudaStream_t stream) {
  return C % 4 == 0
             ? launch_aggregate<4>(U, idx, B, N, C, k, track, M, m, S1, S2, rM, rm, stream)
             : launch_aggregate<1>(U, idx, B, N, C, k, track, M, m, S1, S2, rM, rm, stream);
}

}  // namespace

// sq (B, N) is scratch. rM / rm (bytes) may be null when track == 0.
PDAE_EXPORT int edgeconv_fwd(const float* xf, const float* U, float* sq, int B, int N,
                             int Cf, int C, int k, int track, float* M, float* m,
                             float* S1, float* S2, int* idx, uint8_t* rM, uint8_t* rm,
                             void* stream_) {
  if (bad_shape(N, k) || Cf < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  int err = launch_sqnorm(xf, B * N, Cf, sq, stream);
  if (err != 0) return err;
  err = launch_select<false>(xf, sq, xf, sq, B, N, N, Cf, k, idx, nullptr, stream);
  if (err != 0) return err;
  return launch_aggregate_any(U, idx, B, N, C, k, track, M, m, S1, S2, rM, rm, stream);
}

// aggregate_from_idx: the forward's aggregate launch over a given
// distance-ordered idx (B, N, k). rM / rm may be null when track == 0.
PDAE_EXPORT int edgeconv_aggregate(const float* U, const int* idx, int B, int N, int C,
                                   int k, int track, float* M, float* m, float* S1,
                                   float* S2, uint8_t* rM, uint8_t* rm, void* stream_) {
  if (N < 1 || k < 1 || k > kMaxK || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  return launch_aggregate_any(U, idx, B, N, C, k, track, M, m, S1, S2, rM, rm,
                              static_cast<cudaStream_t>(stream_));
}

// knn_pallas: the k nearest of Ndb database rows y (B, Ndb, C) for each of Nq
// query rows q (B, Nq, C): dists and idx (B, Nq, k), ascending, lower index
// on ties. sqq (B, Nq) and sqy (B, Ndb) are scratch.
PDAE_EXPORT int knn_select(const float* q, const float* y, float* sqq, float* sqy, int B,
                           int Nq, int Ndb, int C, int k, float* dists, int* idx,
                           void* stream_) {
  if (bad_shape(Ndb, k) || Nq < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  int err = launch_sqnorm(q, B * Nq, C, sqq, stream);
  if (err != 0) return err;
  err = launch_sqnorm(y, B * Ndb, C, sqy, stream);
  if (err != 0) return err;
  return launch_select<true>(q, sqq, y, sqy, B, Nq, Ndb, C, k, idx, dists, stream);
}

PDAE_EXPORT int edgeconv_bwd_first(const float* U, const int* idx, const uint8_t* rM,
                                   const uint8_t* rm, const float* gM, const float* gm,
                                   const float* gs1, const float* gs2, int B, int N,
                                   int C, int k, float* du, void* stream_) {
  if (bad_shape(N, k) || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  return C % 4 == 0
             ? launch_bwd<false, 4>(U, idx, rM, rm, gM, gm, gs1, gs2, B, N, C, k, du, stream)
             : launch_bwd<false, 1>(U, idx, rM, rm, gM, gm, gs1, gs2, B, N, C, k, du, stream);
}

// wM, wm (B, N, C) are scratch.
PDAE_EXPORT int edgeconv_bwd_split(const float* U, const int* idx, const float* M,
                                   const float* m, const float* gM, const float* gm,
                                   const float* gs1, const float* gs2, float* wM,
                                   float* wm, int B, int N, int C, int k, float* du,
                                   void* stream_) {
  if (bad_shape(N, k) || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int rows = B * N;
  const int blocks = (rows + kAggWarps - 1) / kAggWarps;
  if (C % 4 == 0)
    edgeconv_tie_weights_kernel<4><<<blocks, kAggWarps * 32, 0, stream>>>(
        U, idx, M, m, gM, gm, rows, N, C, k, wM, wm);
  else
    edgeconv_tie_weights_kernel<1><<<blocks, kAggWarps * 32, 0, stream>>>(
        U, idx, M, m, gM, gm, rows, N, C, k, wM, wm);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return C % 4 == 0
             ? launch_bwd<true, 4>(U, idx, M, m, wM, wm, gs1, gs2, B, N, C, k, du, stream)
             : launch_bwd<true, 1>(U, idx, M, m, wM, wm, gs1, gs2, B, N, C, k, du, stream);
}
