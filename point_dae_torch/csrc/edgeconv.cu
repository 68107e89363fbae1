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
//  - select: a block takes 32 query rows and the columns in chunks of
//    1024. First the block computes the chunk's 32 x 1024 distances into
//    shared memory: xf streams through a three-stage cp.async ring of (512
//    columns x 8 channels) tiles, one barrier a tile, two tiles in flight
//    while one is used, and a thread holds a 4-row x 8-column tile of
//    sums, so each staged value feeds four or eight multiply-adds. Then
//    each warp takes two rows, a lane the distances of columns lane + 32 t
//    in registers, for k rounds: a minimum over the lane's four cached
//    group minima, a warp argmin over (distance, column) in two redux.sync
//    minima, and a masking of the winner with a rescan of its group of
//    eight registers. Above 1024 columns (N <= 4096) each chunk's rounds
//    merge with the row's running top-k, kept per warp in shared memory,
//    by (distance, column), the TPU kernel's multi-tile merge
//    (pallas_knn.py:80-95) done in place.
//  - aggregate: a block takes one cloud, one channel slice of W = 4, 8, 16
//    or 32 channels and a chunk of its rows, and first copies the cloud's
//    whole slice of U (N x W f32) into shared memory with 16-byte cp.async
//    (an exact f32 row read stands where the TPU used a one-hot matrix
//    product). Then W / 4 lanes take a row, a float4 each, and walk its k
//    rounds in shared memory; the outputs go out as whole float4 (uchar4)
//    slices. Each U element leaves L2 once a block instead of k times.
//    The plan (ops/edgeconv.py:aggregate_plan) picks the slice, the row
//    chunks and the block's warps. Where not even a 4-channel slice fits a
//    block's 227 KB (N above 14528) the L2 form stays: a warp a row reads
//    the rows from L2, four channels a lane.
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
// products. Here a stable counting sort of each cloud's idx by target
// builds every target row's list of contributors in (i, r) order (a kNN
// row names a target once, so source order is (i, r) order; no float and
// no order-dependent atomics), then a group of lanes a (target row,
// channel slice) sums their cotangent rows in list order: the (gM, gm)
// terms, gs1 and gs2 each in their own sum, du = (acc + s1) + (2 U) s2.
// The work is linear in N k; the result repeats bit for bit. 'split' first
// runs a pass over source rows that turns (gM, gm) into (gM / cM, gm / cm).
//
// Bounds on the H100 (f32 outside the tensor cores): the forward's distance
// phase does B*N*N*Cf multiply-adds, against B*N*(Cf + 4.5 C + k)*4 bytes:
// operations. Counted at the FMA rate that is 67 TFLOP/s; kept as two
// rounded operations each (no FMA, so the neighbours stay the plain
// version's), the floor is one instruction each at 128 lanes a clock an SM,
// twice that. The aggregate alone moves B*N*(4.5 C + k)*4 bytes (with
// track): bytes; it issues about nine lane operations an element and round
// (two compares and selects for the rounds, max, min, a sum, a product and
// a sum) and, staged, a shared-memory load a round for four channels. The
// backward moves about B*N*C*4*6 bytes and sums B*N*k*C*4 terms: bytes;
// each source row is read once for each of its k targets, mostly from L2,
// which sets its pace.
#include "common.cuh"
#include "mma.cuh"

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = 1e30f;

constexpr int kSelWarps = 16;
constexpr int kR = 2;                       // query rows a warp in the rounds
constexpr int kSelRows = kSelWarps * kR;    // query rows a block
constexpr int kSelThreads = kSelWarps * 32;
constexpr int kNT = 32;                     // distance registers a lane and row
constexpr int kMaxN = 32 * kNT;             // 1024 columns a chunk
constexpr int kTileCols = 512;              // columns a distance tile
constexpr int kDistCh = 8;                  // channels a distance tile
constexpr int kRT = 4;                      // rows of a thread's distance tile
constexpr int kCT = 8;                      // columns of a thread's distance tile
constexpr int kMaxK = 64;
static_assert(kSelRows == 8 * kRT && kTileCols == 2 * 32 * kCT && kTileCols == kSelThreads,
              "16 warps: 8 row groups of 4 x 2 column halves of 256; a thread a column");

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

// Distance tiles in order: chunk of kMaxN columns, then its column tiles
// of kTileCols, then channel slices of kDistCh.
struct TileGrid {
  int Ndb, Cf, ncc;
  __device__ int count() const {
    const int full = Ndb / kMaxN, rest = Ndb - full * kMaxN;
    return (full * 2 + (rest + kTileCols - 1) / kTileCols) * ncc;
  }
  // (chunk base, column tile, channel slice) of tile T
  __device__ void at(int T, int& base, int& ct, int& cs) const {
    const int chunk = T / (2 * ncc), w = T - chunk * 2 * ncc;
    base = chunk * kMaxN;
    ct = w / ncc;
    cs = w - ct * ncc;
  }
};

// A distance tile in shared memory: ys[column][8] (the column's channels
// cc.. in two groups of four, group g of column j at 4 (g ^ (j >> 2 & 1)),
// so that eight neighbouring lanes' float4 reads of one group fall in
// distinct banks) and qs[row][8] for the block's query rows. Channels past
// Cf, columns past Ndb and rows past Nq arrive as zeros (a zero product
// adds nothing: the sums are never -0).
constexpr int kStages = 3;                           // tiles in flight
constexpr int kStageFloats = kTileCols * kDistCh + kSelRows * kDistCh;

__device__ __forceinline__ int swz(int j, int g) { return 4 * (g ^ ((j >> 2) & 1)); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// The threads copy the tile's columns (a thread a column, or two a column
// when Cf % 4 == 0) and, t < 2 kSelRows (vector) or < kDistCh kSelRows,
// the query rows' channels.
template <bool kVec>
__device__ __forceinline__ void tile_issue(float* __restrict__ stage, const TileGrid& tg,
                                           int T, const float* __restrict__ qb,
                                           const float* __restrict__ yb, int Nq, int row0) {
  int base, ct, cs;
  tg.at(T, base, ct, cs);
  const int cc = cs * kDistCh, nch = min(kDistCh, tg.Cf - cc);
  const int t = threadIdx.x;
  float* ys = stage;
  float* qs = stage + kTileCols * kDistCh;
  if constexpr (kVec) {   // Cf % 4 == 0: nch is 4 or 8, a group is 16 bytes
    // two neighbouring threads copy one column's two groups: a warp's
    // copy reads 16 whole 32-byte sectors
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int jt = h * (kTileCols / 2) + (t >> 1), g = t & 1;
      const int jj = base + ct * kTileCols + jt;
      const bool ok = jj < tg.Ndb && 4 * g < nch;
      cp_async16(ys + jt * kDistCh + swz(jt, g),
                 yb + static_cast<size_t>(ok ? jj : 0) * tg.Cf + cc + 4 * g, ok);
    }
    if (t < 2 * kSelRows) {
      const int r = t >> 1, g = t & 1;
      const float* pq = qb + static_cast<size_t>(min(row0 + r, Nq - 1)) * tg.Cf + cc + 4 * g;
      cp_async16(qs + r * kDistCh + 4 * g, pq, 4 * g < nch);
    }
  } else {
    const int j = base + ct * kTileCols + t;
    const bool col_ok = j < tg.Ndb;
    const float* py = yb + static_cast<size_t>(col_ok ? j : 0) * tg.Cf + cc;
#pragma unroll
    for (int c = 0; c < kDistCh; ++c)
      cp_async4(ys + t * kDistCh + swz(t, c >> 2) + (c & 3), py + (c < nch ? c : 0),
                col_ok && c < nch);
    if (t < kDistCh * kSelRows) {
      const int r = t / kDistCh, c = t % kDistCh;
      const float* pq = qb + static_cast<size_t>(min(row0 + r, Nq - 1)) * tg.Cf + cc;
      cp_async4(qs + r * kDistCh + c, pq + (c < nch ? c : 0), c < nch);
    }
  }
}

// The tile's channels for a thread's rows rg * 4 .. + 3 and columns
// half * 256 + lane + 32 t (t < 8): per group of four channels, four
// broadcast float4 of the rows and eight float4 of the columns feed 128
// rounded multiply-adds, a channel at a time, so each sum takes its
// channels in order.
__device__ __forceinline__ void tile_macs(float (&acc)[kRT][kCT], const float* __restrict__ stage,
                                          int rg, int half, int lane, int groups) {
  const float* ys = stage + (half * 256 + lane) * kDistCh;
  const float* qs = stage + kTileCols * kDistCh + rg * kRT * kDistCh;
  for (int g = 0; g < groups; ++g) {   // the same for the whole block
    float4 q[kRT];
#pragma unroll
    for (int a = 0; a < kRT; ++a) q[a] = *reinterpret_cast<const float4*>(qs + a * kDistCh + 4 * g);
    float4 y[kCT];
#pragma unroll
    for (int t = 0; t < kCT; ++t)
      y[t] = *reinterpret_cast<const float4*>(ys + t * 32 * kDistCh + swz(lane, g));
    // a channel at a time over all 32 sums: 32 independent chains
#pragma unroll
    for (int a = 0; a < kRT; ++a)
#pragma unroll
      for (int t = 0; t < kCT; ++t) acc[a][t] = mac_rn(acc[a][t], q[a].x, y[t].x);
#pragma unroll
    for (int a = 0; a < kRT; ++a)
#pragma unroll
      for (int t = 0; t < kCT; ++t) acc[a][t] = mac_rn(acc[a][t], q[a].y, y[t].y);
#pragma unroll
    for (int a = 0; a < kRT; ++a)
#pragma unroll
      for (int t = 0; t < kCT; ++t) acc[a][t] = mac_rn(acc[a][t], q[a].z, y[t].z);
#pragma unroll
    for (int a = 0; a < kRT; ++a)
#pragma unroll
      for (int t = 0; t < kCT; ++t) acc[a][t] = mac_rn(acc[a][t], q[a].w, y[t].w);
  }
}

// An unsigned key in the order of the float (distances are never -0 or NaN:
// sums of squares and their differences round to +0), for the warp-wide
// minimum in one instruction.
__device__ __forceinline__ unsigned float_key(float f) {
  const unsigned u = __float_as_uint(f);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned key) {
  return __uint_as_float(key ^ ((key >> 31) ? 0x80000000u : 0xffffffffu));
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
// EdgeConv forward passes one cloud as both. A block takes kSelRows query
// rows and the columns in chunks of kMaxN, in two phases a chunk:
//  - distances: the block's (kSelRows x kMaxN) distances into shared
//    memory, as tiles of kTileCols columns x kDistCh channels staged
//    through a kStages-deep cp.async ring (one barrier a tile; the copies
//    need no registers, so they fly on through the rounds). With the
//    tile after next loaded through registers the loop waited on those
//    loads: on the H100, at Cf 128, it took 2.60 ms a call, and 1.89 with
//    no multiply-add at all.
//    A thread holds a 4-row x 8-column tile of sums (tile_macs).
//  - rounds: a warp takes kR rows, a lane the distances of columns
//    lane + 32 t in registers, and runs k rounds of first-argmin
//    extraction; kStream (more than kMaxN columns) merges each chunk's
//    rounds with the row's running top-k, kept per warp in shared memory,
//    by (distance, column), so the result is that of one pass over all
//    columns.
template <bool kVec, bool kStream, bool kDists>
__global__ void __launch_bounds__(kSelThreads)
knn_select_kernel(const float* __restrict__ qx, const float* __restrict__ sqq,
                  const float* __restrict__ yx, const float* __restrict__ sqy, int Nq,
                  int Ndb, int Cf, int k, int row_blocks, int* __restrict__ idx,
                  float* __restrict__ dists) {
  extern __shared__ __align__(16) float smem[];
  float* dist = smem;                                   // [kSelRows][kMaxN]
  float* stages = dist + kSelRows * kMaxN;              // [kStages][kStageFloats]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / row_blocks;
  const int row0 = (blockIdx.x % row_blocks) * kSelRows;
  const float* qb = qx + static_cast<size_t>(b) * Nq * Cf;
  const float* yb = yx + static_cast<size_t>(b) * Ndb * Cf;
  const float* sqqb = sqq + static_cast<size_t>(b) * Nq;
  const float* sqyb = sqy + static_cast<size_t>(b) * Ndb;
  // kStream: a warp's running lists, [buffer][row][k] values then columns
  float* lv = stages + kStages * kStageFloats + warp * (4 * kR * k);
  int* li = reinterpret_cast<int*>(lv + 2 * kR * k);
  // the distance phase's thread tile: rows rg * 4 .. + 3, columns
  // half * 256 + lane + 32 t of the column tile (t < 8)
  const int rg = warp >> 1, half = warp & 1;

  int i0[kR], i1[kR];        // !kStream: round r's column (and distance) in
  float v0[kR], v1[kR];      // lane r & 31, r < 32 in i0 / v0, else i1 / v1
  int cur = 0;               // kStream: the buffer holding the running lists

  const TileGrid tg{Ndb, Cf, (Cf + kDistCh - 1) / kDistCh};
  const int ntiles = tg.count();
  // tile T goes to stage T % kStages; each issue is one commit group
  for (int T = 0; T < kStages - 1; ++T) {
    if (T < ntiles) tile_issue<kVec>(stages + T * kStageFloats, tg, T, qb, yb, Nq, row0);
    cp_async_commit();
  }
  int T = 0;   // the tile computed next
  for (int base = 0; base < Ndb; base += kMaxN) {
    const int ncols = min(kMaxN, Ndb - base);
    for (int ct = 0; ct * kTileCols < ncols; ++ct) {
      float acc[kRT][kCT];
#pragma unroll
      for (int a = 0; a < kRT; ++a)
#pragma unroll
        for (int v = 0; v < kCT; ++v) acc[a][v] = 0.f;
      for (int cs = 0; cs < tg.ncc; ++cs, ++T) {
        cp_async_wait<kStages - 2>();   // tile T has landed
        __syncthreads();                // for every thread; stage T - 1 is free
        const int next = T + kStages - 1;
        if (next < ntiles)
          tile_issue<kVec>(stages + (next % kStages) * kStageFloats, tg, next, qb, yb, Nq, row0);
        cp_async_commit();
        const int nch = min(kDistCh, Cf - cs * kDistCh);
        tile_macs(acc, stages + (T % kStages) * kStageFloats, rg, half, lane, nch > 4 ? 2 : 1);
      }

      // ---- the column tile's distances into shared memory
#pragma unroll
      for (int a = 0; a < kRT; ++a) {
        const int row = rg * kRT + a;
        const float qq = sqqb[min(row0 + row, Nq - 1)];
#pragma unroll
        for (int t = 0; t < kCT; ++t) {
          const int col = ct * kTileCols + half * 256 + lane + 32 * t;
          dist[row * kMaxN + col] =
              col < ncols ? __fadd_rn(__fsub_rn(qq, __fmul_rn(2.0f, acc[a][t])), sqyb[base + col])
                          : kInf;
        }
      }
    }
    __syncthreads();

    // ---- k rounds of first-argmin extraction over the chunk, the warp's
    // rows side by side. A lane keeps the minimum of each group of kGroup
    // registers, so a round rescans only the group the winner sat in (the
    // same group for the whole warp) instead of all kNT registers.
    float d[kR][kNT];
#pragma unroll
    for (int a = 0; a < kR; ++a) {
#pragma unroll
      for (int t = 0; t < kNT; ++t)   // columns past the chunk were never written
        d[a][t] = 32 * t + lane < ncols ? dist[(kR * warp + a) * kMaxN + 32 * t + lane] : kInf;
      if (!kStream) {
        i0[a] = 0;
        i1[a] = 0;
        v0[a] = 0.f;
        v1[a] = 0.f;
      }
    }
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
      for (int a = 0; a < kR; ++a) {   // the warp's least (distance, column)
        const unsigned key = float_key(best[a]);
        const unsigned kmin = __reduce_min_sync(kFull, key);
        bj[a] = static_cast<int>(
            __reduce_min_sync(kFull, key == kmin ? static_cast<unsigned>(bj[a]) : 0xffffffffu));
        best[a] = key_float(kmin);
      }
#pragma unroll
      for (int a = 0; a < kR; ++a) {
        bool from_list = false;   // the same for the whole warp
        if constexpr (kStream) {
          float v = best[a];
          int j = bj[a];
          if (base > 0) {   // the list's columns all precede this chunk's
            const float hv = lv[(cur * kR + a) * k + head[a]];
            const int hj = li[(cur * kR + a) * k + head[a]];
            from_list = hv < v || (hv == v && hj < j);
            if (from_list) {
              v = hv;
              j = hj;
              ++head[a];
            }
          }
          if (lane == 0) {
            lv[((cur ^ 1) * kR + a) * k + r] = v;
            li[((cur ^ 1) * kR + a) * k + r] = j;
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
  cp_async_wait<0>();
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int i = row0 + kR * warp + a;
    if (i < Nq) {
      const size_t o = (static_cast<size_t>(b) * Nq + i) * k;
      for (int r = lane; r < k; r += 32) {
        if constexpr (kStream) {
          idx[o + r] = li[(cur * kR + a) * k + r];
          if constexpr (kDists) dists[o + r] = lv[(cur * kR + a) * k + r];
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
  } else if constexpr (kV == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out.v[0] = t.x; out.v[1] = t.y;
  } else {
    out.v[0] = *p;
  }
  return out;
}

template <int kV>
__device__ __forceinline__ void st(float* p, const Vec<kV>& x) {
  if constexpr (kV == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  else if constexpr (kV == 2)
    *reinterpret_cast<float2*>(p) = make_float2(x.v[0], x.v[1]);
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

// The staged form: a block of kWarps warps a (cloud, channel slice of W =
// 4 kL channels, chunk of chunk_rows rows). The slice of the whole cloud,
// su[N][W], is copied in first (16 bytes at a time where C % 4 == 0, else a
// channel at a time; channels past C arrive as zeros and are never stored).
// Then kL lanes take a row, a float4 of the slice each, and walk the row's
// k rounds in round order: the row's lanes read its indices together from
// idx, four rounds in one 16-byte load where the rows are 16-byte aligned
// (k % 4 == 0), and each round's float4 from shared memory. Blocks are
// ordered slice fastest, so that the slices of a row's output lines are
// written together.
template <int kL, bool kTrack, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
edgeconv_aggregate_staged_kernel(const float* __restrict__ U, const int* __restrict__ idx,
                                 int N, int C, int k, int slices, int chunks, int chunk_rows,
                                 int vec, int idx4, float* __restrict__ M,
                                 float* __restrict__ m, float* __restrict__ S1,
                                 float* __restrict__ S2, uint8_t* __restrict__ rM,
                                 uint8_t* __restrict__ rm) {
  constexpr int W = 4 * kL;
  constexpr int kRows = 32 / kL;              // rows a warp takes at once
  constexpr int kThreads = kWarps * 32;
  extern __shared__ __align__(16) float su[];  // [N][W]
  const int s = blockIdx.x % slices;
  const int rest = blockIdx.x / slices;
  const int chunk = rest % chunks, b = rest / chunks;
  const int c0 = s * W;
  const float* Ub = U + static_cast<size_t>(b) * N * C;
  if (vec) {
    for (int e = threadIdx.x; e < N * kL; e += kThreads) {
      const int j = e / kL, c = c0 + 4 * (e % kL);
      cp_async16(su + 4 * e, Ub + static_cast<size_t>(j) * C + (c < C ? c : 0), c < C);
    }
  } else {
    for (int e = threadIdx.x; e < N * W; e += kThreads) {
      const int j = e / W, c = c0 + e % W;
      cp_async4(su + e, Ub + static_cast<size_t>(j) * C + (c < C ? c : 0), c < C);
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane % kL;
  const int c = c0 + 4 * t;
  const int r0 = chunk * chunk_rows, r1 = min(N, r0 + chunk_rows);
  const float* sl = su + 4 * t;
  for (int row = r0 + warp * kRows + lane / kL; row < r1; row += kWarps * kRows) {
    const int* ir = idx + (static_cast<size_t>(b) * N + row) * k;
    float vM[4], vm[4], s1[4], s2[4];
    int irM[4], irm[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      vM[x] = -kInf; vm[x] = kInf; s1[x] = 0.f; s2[x] = 0.f; irM[x] = 0; irm[x] = 0;
    }
    auto round = [&](int j, int r) {
      const float4 u4 = *reinterpret_cast<const float4*>(sl + j * W);
      const float u[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float v = u[x];
        if constexpr (kTrack) {
          if (v > vM[x]) irM[x] = r;
          if (v < vm[x]) irm[x] = r;
        }
        vM[x] = fmaxf(vM[x], v);
        vm[x] = fminf(vm[x], v);
        s1[x] = __fadd_rn(s1[x], v);
        s2[x] = __fadd_rn(s2[x], __fmul_rn(v, v));
      }
    };
    if (idx4) {
      for (int r = 0; r < k; r += 4) {
        const int4 j = *reinterpret_cast<const int4*>(ir + r);
        round(j.x, r);
        round(j.y, r + 1);
        round(j.z, r + 2);
        round(j.w, r + 3);
      }
    } else {
#pragma unroll 4
      for (int r = 0; r < k; ++r) round(ir[r], r);
    }
    if (c >= C) continue;
    const size_t o = (static_cast<size_t>(b) * N + row) * C + c;
    if (vec) {
      *reinterpret_cast<float4*>(M + o) = make_float4(vM[0], vM[1], vM[2], vM[3]);
      *reinterpret_cast<float4*>(m + o) = make_float4(vm[0], vm[1], vm[2], vm[3]);
      *reinterpret_cast<float4*>(S1 + o) = make_float4(s1[0], s1[1], s1[2], s1[3]);
      *reinterpret_cast<float4*>(S2 + o) = make_float4(s2[0], s2[1], s2[2], s2[3]);
      if constexpr (kTrack) {
        *reinterpret_cast<uchar4*>(rM + o) = make_uchar4(irM[0], irM[1], irM[2], irM[3]);
        *reinterpret_cast<uchar4*>(rm + o) = make_uchar4(irm[0], irm[1], irm[2], irm[3]);
      }
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if (c + x < C) {
          M[o + x] = vM[x];
          m[o + x] = vm[x];
          S1[o + x] = s1[x];
          S2[o + x] = s2[x];
          if constexpr (kTrack) {
            rM[o + x] = static_cast<uint8_t>(irM[x]);
            rm[o + x] = static_cast<uint8_t>(irm[x]);
          }
        }
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

// ---- backward: contributor lists by a stable counting sort of idx by
// target, then one ordered gather-sum a (target row, channel slice).
//
// A cloud's source rows are cut into at most kMaxSegs segments of seg rows
// (seg >= kMinSeg). count: a block a (cloud, segment) counts its entries
// by target in shared memory (integer atomics: a count does not depend on
// their order) and writes the N counts. scan: a block a cloud turns them
// into each segment's first slot in each target's list, and each target's
// list start. place: a block a (cloud, segment) walks its rows in order,
// one warp, a lane an entry: the k targets of a row are distinct (a kNN
// names a column once), so no two lanes of a row share a cursor, and rows
// in ascending i give each list in ascending (i, r).
constexpr int kMaxSegs = 16;
constexpr int kMinSeg = 64;
constexpr int kSortThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kSumWarps = 2;

int segment_rows(int N) {
  const int seg = (N + kMaxSegs - 1) / kMaxSegs;
  return seg > kMinSeg ? seg : kMinSeg;
}

// Scratch of the backward, in ints: counts (B, kMaxSegs, N), list starts
// (B, N + 1), lists (B, N k).
struct Lists {
  int* counts;
  int* start;
  int* list;
};

Lists carve(int* work, int B, int N, int k) {
  Lists l;
  l.counts = work;
  l.start = work + static_cast<size_t>(B) * kMaxSegs * N;
  l.list = l.start + static_cast<size_t>(B) * (N + 1);
  return l;
}

__global__ void __launch_bounds__(kSortThreads)
contrib_count_kernel(const int* __restrict__ idx, int N, int k, int seg, int S,
                     int* __restrict__ counts) {
  extern __shared__ int hist[];   // [N]
  const int b = blockIdx.x / S, s = blockIdx.x % S;
  for (int j = threadIdx.x; j < N; j += kSortThreads) hist[j] = 0;
  __syncthreads();
  const int i0 = s * seg, i1 = min(N, i0 + seg);
  const int* ib = idx + (static_cast<size_t>(b) * N + i0) * k;
  for (int e = threadIdx.x; e < (i1 - i0) * k; e += kSortThreads) {
    const int j = ib[e];
    if (j >= 0 && j < N) atomicAdd(&hist[j], 1);
  }
  __syncthreads();
  int* out = counts + (static_cast<size_t>(b) * kMaxSegs + s) * N;
  for (int j = threadIdx.x; j < N; j += kSortThreads) out[j] = hist[j];
}

// A thread owns jpt <= 4 consecutive targets (N <= 4096): their counts
// become exclusive sums over the segments, in place, and their totals an
// exclusive sum over the targets.
__global__ void __launch_bounds__(kScanThreads)
contrib_scan_kernel(int* __restrict__ counts, int N, int S, int* __restrict__ start) {
  __shared__ int warp_tot[kScanThreads / 32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int jpt = (N + kScanThreads - 1) / kScanThreads;
  const int j0 = threadIdx.x * jpt;
  int* cb = counts + static_cast<size_t>(b) * kMaxSegs * N;
  int tot[4] = {0, 0, 0, 0};
  int mine = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int j = j0 + t;
    if (t < jpt && j < N) {
      int run = 0;
      for (int s = 0; s < S; ++s) {
        const int c = cb[s * N + j];
        cb[s * N + j] = run;
        run += c;
      }
      tot[t] = run;
      mine += run;
    }
  }
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = warp_tot[lane];
    int w = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += t;
    }
    warp_tot[lane] = w - v;
  }
  __syncthreads();
  int run = warp_tot[warp] + incl - mine;
  int* sb = start + static_cast<size_t>(b) * (N + 1);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int j = j0 + t;
    if (t < jpt && j < N) {
      sb[j] = run;
      run += tot[t];
    }
  }
  if (threadIdx.x == kScanThreads - 1) sb[N] = run;
}

// The segment's idx rows are staged in shared memory first, so the walk
// waits on shared memory only.
__global__ void __launch_bounds__(kSortThreads)
contrib_place_kernel(const int* __restrict__ idx, const int* __restrict__ counts,
                     const int* __restrict__ start, int N, int k, int seg, int S,
                     int* __restrict__ list) {
  extern __shared__ int sm[];
  int* cur = sm;                  // [N] the next slot of each target's list
  int* rows = sm + N;             // [seg * k]
  const int b = blockIdx.x / S, s = blockIdx.x % S;
  const int i0 = s * seg, i1 = min(N, i0 + seg);
  const int* cb = counts + (static_cast<size_t>(b) * kMaxSegs + s) * N;
  const int* sb = start + static_cast<size_t>(b) * (N + 1);
  for (int j = threadIdx.x; j < N; j += kSortThreads) cur[j] = sb[j] + cb[j];
  const int* ib = idx + (static_cast<size_t>(b) * N + i0) * k;
  for (int e = threadIdx.x; e < (i1 - i0) * k; e += kSortThreads) rows[e] = ib[e];
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int* lb = list + static_cast<size_t>(b) * N * k;
  for (int i = i0; i < i1; ++i) {
    for (int r = lane; r < k; r += 32) {
      const int j = rows[(i - i0) * k + r];
      if (j >= 0 && j < N) {
        const int pos = cur[j];
        cur[j] = pos + 1;
        lb[pos] = i * k + r;
      }
    }
    __syncwarp();
  }
}

template <int kV>
__device__ __forceinline__ void ld_rounds(const uint8_t* p, int (&out)[kV]) {
  if constexpr (kV == 4) {
    const uchar4 t = *reinterpret_cast<const uchar4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (kV == 2) {
    const uchar2 t = *reinterpret_cast<const uchar2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
    out[0] = *p;
  }
}


// Sum pass: a warp a (target row j, channel slice), kV channels a lane. It
// walks j's list in order and sums, per channel, the (gA, gB) terms, gs1
// and gs2 each in its own sum; du = (acc + s1) + (2 U) s2, no fused
// multiply-add. A gA (gB) row is loaded only where one of the lane's
// channels takes it: the term is zero elsewhere, so the bits are those of
// loading it always. A batch of entries' loads is in flight at once (a
// hub's long list is walked by one warp), and blocks of two warps let a
// hub's warp hold little beside it.
// kSplit == false: a = rM, c = rm (bytes), gA = gM, gB = gm.
// kSplit == true:  a = M,  c = m (float),  gA = wM, gB = wm.
constexpr int kSumMinBlocks = 10;   // 102 registers a thread at most

template <bool kSplit, int kV>
__global__ void __launch_bounds__(kSumWarps * 32, kSumMinBlocks)
edgeconv_bwd_kernel(const float* __restrict__ U, const int* __restrict__ start,
                    const int* __restrict__ list, const void* __restrict__ a_,
                    const void* __restrict__ c_, const float* __restrict__ gA_,
                    const float* __restrict__ gB_, const float* __restrict__ gs1_,
                    const float* __restrict__ gs2_, int N, int C, int k, int slices,
                    long long groups, float* __restrict__ du) {
  constexpr int kBatch = 4;   // list entries whose rows are loaded together
  const int lane = threadIdx.x & 31;
  const long long grp = static_cast<long long>(blockIdx.x) * kSumWarps + (threadIdx.x >> 5);
  if (grp >= groups) return;   // whole warp
  const int slice = static_cast<int>(grp % slices);
  const int j = static_cast<int>(grp / slices % N);
  const int b = static_cast<int>(grp / slices / N);
  const int* sb = start + static_cast<size_t>(b) * (N + 1);
  const int beg = sb[j];
  const int n = sb[j + 1] - beg;
  const int c = (slice * 32 + lane) * kV;
  const bool active = c < C;
  const int* lb = list + static_cast<size_t>(b) * N * k + beg;
  const size_t cloud = static_cast<size_t>(b) * N;
  const int cc = active ? c : 0;
  const Vec<kV> u = ld<kV>(U + (cloud + j) * C + cc);
  // the cloud's rows; a source row's offset i C + cc fits an int (N <= 4096)
  const size_t cb = cloud * C;
  const float *gA = gA_ + cb, *gB = gB_ + cb, *gs1 = gs1_ + cb, *gs2 = gs2_ + cb;
  const float* fa = kSplit ? static_cast<const float*>(a_) + cb : nullptr;
  const float* fc = kSplit ? static_cast<const float*>(c_) + cb : nullptr;
  const uint8_t* ba = kSplit ? nullptr : static_cast<const uint8_t*>(a_) + cb;
  const uint8_t* bc = kSplit ? nullptr : static_cast<const uint8_t*>(c_) + cb;
  float acc[kV], s1[kV], s2[kV];
#pragma unroll
  for (int x = 0; x < kV; ++x) { acc[x] = 0.f; s1[x] = 0.f; s2[x] = 0.f; }

  for (int q0 = 0; q0 < n; q0 += 32) {
    const int my_e = q0 + lane < n ? lb[q0 + lane] : 0;
    const int cnt = min(32, n - q0);   // the same for the whole warp
    for (int t0 = 0; t0 < cnt; t0 += kBatch) {
      int rr[kBatch];
      bool on[kBatch];
      int o[kBatch];
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        const int e = __shfl_sync(kFull, my_e, (t0 + t) & 31);
        on[t] = active && t0 + t < cnt;
        const int i = e / k;
        rr[t] = e - i * k;
        o[t] = i * C + cc;
      }
      // the batch's rows: gs1, gs2 and the tie tests first (s1, s2 taken
      // at once, in list order), then the (gA, gB) rows the tests select
      bool tA[kBatch][kV], tB[kBatch][kV], anyA[kBatch], anyB[kBatch];
      {
        Vec<kV> t1[kBatch], t2[kBatch];
#pragma unroll
        for (int t = 0; t < kBatch; ++t) {
          anyA[t] = anyB[t] = false;
          if (on[t]) {
            t1[t] = ld<kV>(gs1 + o[t]);
            t2[t] = ld<kV>(gs2 + o[t]);
            if constexpr (kSplit) {
              const Vec<kV> vM = ld<kV>(fa + o[t]);
              const Vec<kV> vm = ld<kV>(fc + o[t]);
#pragma unroll
              for (int x = 0; x < kV; ++x) {
                tA[t][x] = u.v[x] == vM.v[x];
                tB[t][x] = u.v[x] == vm.v[x];
              }
            } else {
              int qM[kV], qm[kV];
              ld_rounds<kV>(ba + o[t], qM);
              ld_rounds<kV>(bc + o[t], qm);
#pragma unroll
              for (int x = 0; x < kV; ++x) {
                tA[t][x] = qM[x] == rr[t];
                tB[t][x] = qm[x] == rr[t];
              }
            }
#pragma unroll
            for (int x = 0; x < kV; ++x) {
              anyA[t] |= tA[t][x];
              anyB[t] |= tB[t][x];
            }
          }
        }
#pragma unroll
        for (int t = 0; t < kBatch; ++t) {
          if (on[t]) {
#pragma unroll
            for (int x = 0; x < kV; ++x) {
              s1[x] += t1[t].v[x];
              s2[x] += t2[t].v[x];
            }
          }
        }
      }
      Vec<kV> ga[kBatch], gb[kBatch];
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
#pragma unroll
        for (int x = 0; x < kV; ++x) { ga[t].v[x] = 0.f; gb[t].v[x] = 0.f; }
        if (anyA[t]) ga[t] = ld<kV>(gA + o[t]);
        if (anyB[t]) gb[t] = ld<kV>(gB + o[t]);
      }
#pragma unroll
      for (int t = 0; t < kBatch; ++t) {
        if (on[t]) {
#pragma unroll
          for (int x = 0; x < kV; ++x)
            acc[x] += (tA[t][x] ? ga[t].v[x] : 0.f) + (tB[t][x] ? gb[t].v[x] : 0.f);
        }
      }
    }
  }
  if (active) {
    Vec<kV> out;
#pragma unroll
    for (int x = 0; x < kV; ++x)   // (acc + s1) + (2 u) s2, no fused multiply-add
      out.v[x] = __fadd_rn(__fadd_rn(acc[x], s1[x]),
                           __fmul_rn(__fmul_rn(2.0f, u.v[x]), s2[x]));
    st<kV>(du + (cloud + j) * C + c, out);
  }
}

int launch_lists(const int* idx, int B, int N, int k, const Lists& l, cudaStream_t stream) {
  const int seg = segment_rows(N);
  const int S = (N + seg - 1) / seg;
  size_t smem = static_cast<size_t>(N) * sizeof(int);
  cudaError_t err = set_smem(contrib_count_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  contrib_count_kernel<<<B * S, kSortThreads, smem, stream>>>(idx, N, k, seg, S, l.counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  contrib_scan_kernel<<<B, kScanThreads, 0, stream>>>(l.counts, N, S, l.start);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  smem = (static_cast<size_t>(N) + static_cast<size_t>(seg) * k) * sizeof(int);
  err = set_smem(contrib_place_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  contrib_place_kernel<<<B * S, kSortThreads, smem, stream>>>(idx, l.counts, l.start, N, k,
                                                               seg, S, l.list);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSplit, int kV>
int launch_sum(const float* U, const Lists& l, const void* a, const void* c, const float* gA,
               const float* gB, const float* gs1, const float* gs2, int B, int N, int C,
               int k, float* du, cudaStream_t stream) {
  const int slices = (C + 32 * kV - 1) / (32 * kV);
  const long long groups = static_cast<long long>(B) * N * slices;
  const long long blocks = (groups + kSumWarps - 1) / kSumWarps;
  edgeconv_bwd_kernel<kSplit, kV><<<static_cast<unsigned>(blocks), kSumWarps * 32, 0, stream>>>(
      U, l.start, l.list, a, c, gA, gB, gs1, gs2, N, C, k, slices, groups, du);
  return static_cast<int>(cudaGetLastError());
}

// The lists, then the sums: float4 channels a lane for C above 64, float2
// for an even C, else one.
template <bool kSplit>
int launch_bwd(const float* U, const int* idx, const void* a, const void* c, const float* gA,
               const float* gB, const float* gs1, const float* gs2, int* work, int B, int N,
               int C, int k, float* du, cudaStream_t stream) {
  const Lists l = carve(work, B, N, k);
  const int err = launch_lists(idx, B, N, k, l, stream);
  if (err != 0) return err;
  const int vec = C % 4 == 0 && C > 64 ? 4 : C % 2 == 0 ? 2 : 1;   // channels a lane
  if (vec == 4)
    return launch_sum<kSplit, 4>(U, l, a, c, gA, gB, gs1, gs2, B, N, C, k, du, stream);
  if (vec == 2)
    return launch_sum<kSplit, 2>(U, l, a, c, gA, gB, gs1, gs2, B, N, C, k, du, stream);
  return launch_sum<kSplit, 1>(U, l, a, c, gA, gB, gs1, gs2, B, N, C, k, du, stream);
}

template <bool kVec, bool kStream, bool kDists>
int launch_select3(const float* q, const float* sqq, const float* y, const float* sqy,
                   int B, int Nq, int Ndb, int Cf, int k, int* idx, float* dists,
                   cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kSelRows) * kMaxN + kStages * kStageFloats +
       (kStream ? static_cast<size_t>(kSelWarps) * 4 * kR * k : 0)) * sizeof(float);
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

template <int kL, bool kTrack, int kWarps>
int launch_staged(const float* U, const int* idx, int B, int N, int C, int k, int chunks,
                  float* M, float* m, float* S1, float* S2, uint8_t* rM, uint8_t* rm,
                  cudaStream_t stream) {
  constexpr int W = 4 * kL;
  const auto kernel = edgeconv_aggregate_staged_kernel<kL, kTrack, kWarps>;
  const int slices = (C + W - 1) / W;
  const int chunk_rows = (N + chunks - 1) / chunks;
  const size_t smem = static_cast<size_t>(N) * W * sizeof(float);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(B) * chunks * slices;
  const int idx4 = k % 4 == 0 && reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      U, idx, N, C, k, slices, chunks, chunk_rows, C % 4 == 0, idx4, M, m, S1, S2, rM, rm);
  return static_cast<int>(cudaGetLastError());
}

template <int kL, int kWarps>
int launch_staged_t(const float* U, const int* idx, int B, int N, int C, int k, int track,
                    int chunks, float* M, float* m, float* S1, float* S2, uint8_t* rM,
                    uint8_t* rm, cudaStream_t stream) {
  return track ? launch_staged<kL, true, kWarps>(U, idx, B, N, C, k, chunks, M, m, S1, S2,
                                                 rM, rm, stream)
               : launch_staged<kL, false, kWarps>(U, idx, B, N, C, k, chunks, M, m, S1, S2,
                                                  rM, rm, stream);
}

template <int kWarps>
int launch_staged_w(const float* U, const int* idx, int B, int N, int C, int k, int track,
                    int lanes, int chunks, float* M, float* m, float* S1, float* S2,
                    uint8_t* rM, uint8_t* rm, cudaStream_t stream) {
  switch (lanes) {
    case 1:
      return launch_staged_t<1, kWarps>(U, idx, B, N, C, k, track, chunks, M, m, S1, S2, rM,
                                        rm, stream);
    case 2:
      return launch_staged_t<2, kWarps>(U, idx, B, N, C, k, track, chunks, M, m, S1, S2, rM,
                                        rm, stream);
    case 4:
      return launch_staged_t<4, kWarps>(U, idx, B, N, C, k, track, chunks, M, m, S1, S2, rM,
                                        rm, stream);
    case 8:
      return launch_staged_t<8, kWarps>(U, idx, B, N, C, k, track, chunks, M, m, S1, S2, rM,
                                        rm, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The aggregate under the caller's plan (ops/edgeconv.py:aggregate_plan):
// lanes 1, 2, 4 or 8 a row (slices of 4 lanes channels) in chunks row
// chunks a cloud, blocks of 8, 16 or 32 warps: the staged form; lanes 0,
// the L2 form.
int launch_aggregate_any(const float* U, const int* idx, int B, int N, int C, int k,
                         int track, int lanes, int chunks, int warps, float* M, float* m,
                         float* S1, float* S2, uint8_t* rM, uint8_t* rm, cudaStream_t stream) {
  if (chunks < 1 || chunks > N) return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0)
    return C % 4 == 0
               ? launch_aggregate<4>(U, idx, B, N, C, k, track, M, m, S1, S2, rM, rm, stream)
               : launch_aggregate<1>(U, idx, B, N, C, k, track, M, m, S1, S2, rM, rm, stream);
  switch (warps) {
    case 8:
      return launch_staged_w<8>(U, idx, B, N, C, k, track, lanes, chunks, M, m, S1, S2, rM, rm,
                                stream);
    case 16:
      return launch_staged_w<16>(U, idx, B, N, C, k, track, lanes, chunks, M, m, S1, S2, rM,
                                 rm, stream);
    case 32:
      return launch_staged_w<32>(U, idx, B, N, C, k, track, lanes, chunks, M, m, S1, S2, rM,
                                 rm, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// sq (B, N) is scratch. rM / rm (bytes) may be null when track == 0. The
// aggregate runs under the plan (lanes, chunks, warps) of ops/edgeconv.py.
PDAE_EXPORT int edgeconv_fwd(const float* xf, const float* U, float* sq, int B, int N,
                             int Cf, int C, int k, int track, int lanes, int chunks,
                             int warps, float* M, float* m, float* S1, float* S2, int* idx,
                             uint8_t* rM, uint8_t* rm, void* stream_) {
  if (bad_shape(N, k) || Cf < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  int err = launch_sqnorm(xf, B * N, Cf, sq, stream);
  if (err != 0) return err;
  err = launch_select<false>(xf, sq, xf, sq, B, N, N, Cf, k, idx, nullptr, stream);
  if (err != 0) return err;
  return launch_aggregate_any(U, idx, B, N, C, k, track, lanes, chunks, warps, M, m, S1, S2,
                              rM, rm, stream);
}

// aggregate_from_idx: the forward's aggregate launch over a given
// distance-ordered idx (B, N, k), under the plan (lanes, chunks, warps).
// rM / rm may be null when track == 0.
PDAE_EXPORT int edgeconv_aggregate(const float* U, const int* idx, int B, int N, int C,
                                   int k, int track, int lanes, int chunks, int warps,
                                   float* M, float* m, float* S1, float* S2, uint8_t* rM,
                                   uint8_t* rm, void* stream_) {
  if (N < 1 || k < 1 || k > kMaxK || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  return launch_aggregate_any(U, idx, B, N, C, k, track, lanes, chunks, warps, M, m, S1, S2,
                              rM, rm, static_cast<cudaStream_t>(stream_));
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

// work: B (kMaxSegs N + N + 1 + N k) ints of scratch (struct Lists).
PDAE_EXPORT int edgeconv_bwd_first(const float* U, const int* idx, const uint8_t* rM,
                                   const uint8_t* rm, const float* gM, const float* gm,
                                   const float* gs1, const float* gs2, int* work, int B,
                                   int N, int C, int k, float* du, void* stream_) {
  if (bad_shape(N, k) || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  return launch_bwd<false>(U, idx, rM, rm, gM, gm, gs1, gs2, work, B, N, C, k, du,
                           static_cast<cudaStream_t>(stream_));
}

// wM, wm (B, N, C) are scratch.
PDAE_EXPORT int edgeconv_bwd_split(const float* U, const int* idx, const float* M,
                                   const float* m, const float* gM, const float* gm,
                                   const float* gs1, const float* gs2, float* wM,
                                   float* wm, int* work, int B, int N, int C, int k,
                                   float* du, void* stream_) {
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
  return launch_bwd<true>(U, idx, M, m, wM, wm, gs1, gs2, work, B, N, C, k, du, stream);
}

// The backward's contributor lists alone, for checks, into work laid out as
// the backward's: B kMaxSegs N ints of counts, then the list starts
// (B, N + 1), then the lists (B, N k) of entries i k + r.
PDAE_EXPORT int edgeconv_contributor_lists(const int* idx, int* work, int B, int N, int k,
                                           void* stream_) {
  if (bad_shape(N, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  return launch_lists(idx, B, N, k, carve(work, B, N, k), static_cast<cudaStream_t>(stream_));
}
