// Row scatter-add, the backward of a row gather:
//   out[b, m, :] = sum over q with idx[b, q] == m of g[b, q, :]
// idx (B, Q) int32, g (B, Q, C) f32 or bf16, out (B, N, C) f32; rows that no
// q names come out as zeros, and entries of idx outside [0, N) add nothing.
//
// Replaces point_dae_tpu/ops/pallas_scatter.py:scatter_rows_add_pallas. The
// TPU kernel builds a one-hot (tq, N) tile and contracts it with g on the
// MXU: it stands in for a scatter because the matrix unit is there. On
// Hopper the work is reading g once, so the bound is bytes, and the one-hot
// product (N times the work) is not carried over.
//
// No float atomics: each output element is the sum of its contributors in
// ascending q, left to right, with no fused multiply-add, so the result has
// the same bits from run to run and the same bits as scatter_add_ on the CPU
// (which adds each element's contributors in ascending q).
//
// A stable counting sort of each cloud's idx by row builds every row's list
// of contributors in ascending q, its placing spread over the card: each
// cloud's q range is cut into S segments (ops/gather.py:scatter_plan).
//  - count: a block a (cloud, segment) counts its entries by row in shared
//    memory (integer atomics: a count does not depend on their order) and
//    writes the N counts to counts (B, S, N);
//  - place: a block a (cloud, segment) reads its cloud's S N counts and
//    scans them (the rows' totals, an exclusive sum over the rows, give
//    each row's list start, which segment 0's block writes to start (B, N +
//    1); the counts of the segments before its own, each row's first slot
//    for its entries); stages its segment's entries in shared memory (8192
//    at a time), cuts them among its 16 warps, counts each warp's part in a
//    histogram of its own, turns the segment's slots into each warp's, and
//    walks its part 32 entries at a time: __match_any_sync groups equal
//    rows inside the 32, and a lane's rank is the number of lanes below it
//    in its group.
// Then the sums: G lanes take a row (32 / G rows a warp) and V channels a
// lane, G V channels a slice (ops/gather.py:scatter_plan picks V and G from
// C, the type and the alignment of g: 16-byte loads where they can be), and
// walk the row's list with kBatch loads in flight a lane, summing in list
// order; a warp's rows walk together to the longest list, each lane's loads
// and sums masked past its own. Each g element is read once.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRows = 2048;
constexpr int kMaxSegs = 16;
constexpr int kCountThreads = 256;
constexpr int kPlaceWarps = 16;
constexpr int kPlaceThreads = kPlaceWarps * 32;
constexpr int kRowsAThread = kMaxRows / kPlaceThreads;
constexpr int kWindow = 8192;   // entries of a segment the place pass stages at once
constexpr int kSumWarps = 8;
constexpr int kBatch = 8;     // list entries whose g rows a lane loads at once

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

// Scratch, in ints: counts (B, S, N), list starts (B, N + 1), lists (B, Q).
struct Lists {
  int* counts;
  int* start;
  int* order;
};

Lists carve(int* work, int B, int Q, int N, int S) {
  Lists l;
  l.counts = work;
  l.start = work + static_cast<size_t>(B) * S * N;
  l.order = l.start + static_cast<size_t>(B) * (N + 1);
  return l;
}

__global__ void __launch_bounds__(kCountThreads)
scatter_count_kernel(const int* __restrict__ idx, int Q, int N, int S, int seg,
                     int* __restrict__ counts) {
  extern __shared__ int hist[];   // [N]
  const int b = blockIdx.x / S, s = blockIdx.x % S;
  for (int r = threadIdx.x; r < N; r += kCountThreads) hist[r] = 0;
  __syncthreads();
  const int q0 = min(Q, s * seg), q1 = min(Q, q0 + seg);
  const int* ib = idx + static_cast<size_t>(b) * Q;
#pragma unroll 8
  for (int q = q0 + threadIdx.x; q < q1; q += kCountThreads) {
    const int r = ib[q];
    if (r >= 0 && r < N) atomicAdd(&hist[r], 1);
  }
  __syncthreads();
  int* out = counts + (static_cast<size_t>(b) * S + s) * N;
  for (int r = threadIdx.x; r < N; r += kCountThreads) out[r] = hist[r];
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// The segment in windows of at most kWindow entries, each staged in shared
// memory first; cur[] (a thread's rows, in registers) carries each row's
// next slot from window to window.
__global__ void __launch_bounds__(kPlaceThreads)
scatter_place_kernel(const int* __restrict__ idx, const int* __restrict__ counts, int Q,
                     int N, int S, int seg, int* __restrict__ start, int* __restrict__ order) {
  extern __shared__ __align__(16) int sm[];
  int* cnt = sm;                            // [kPlaceWarps][N]
  int* rows = sm + kPlaceWarps * N;         // [kWindow] the window's idx
  int* first = rows + kWindow;              // [N] the rows' totals, then list starts
  __shared__ int warp_tot[kPlaceWarps];
  const int b = blockIdx.x / S, s = blockIdx.x % S;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int q0 = min(Q, s * seg), q1 = min(Q, q0 + seg);
  const int* ib = idx + static_cast<size_t>(b) * Q;
  // rows threadIdx.x + t kPlaceThreads: the counts before segment s in
  // before[t], the totals over the segments in first[] (coalesced reads);
  // then the thread's kRowsAThread consecutive rows' totals, an exclusive
  // sum over the block's rows, turn first[] into each row's list start
  int* sb = start + static_cast<size_t>(b) * (N + 1);
  int cur[kRowsAThread];
#pragma unroll
  for (int t = 0; t < kRowsAThread; ++t) {
    const int r = threadIdx.x + t * kPlaceThreads;
    int tot = 0, before = 0;
    if (r < N) {
      const int* cb = counts + static_cast<size_t>(b) * S * N + r;
#pragma unroll 4
      for (int z = 0; z < S; ++z) {
        const int c = cb[z * N];
        tot += c;
        before += z < s ? c : 0;
      }
      first[r] = tot;
    }
    cur[t] = before;
  }
  __syncthreads();
  {
    const int r0 = threadIdx.x * kRowsAThread;
    int tot[kRowsAThread];
    int mine_tot = 0;
#pragma unroll
    for (int t = 0; t < kRowsAThread; ++t) {
      tot[t] = r0 + t < N ? first[r0 + t] : 0;
      mine_tot += tot[t];
    }
    const int incl = warp_incl_scan(mine_tot, lane);
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    int run = incl - mine_tot;
    for (int w = 0; w < warp; ++w) run += warp_tot[w];
#pragma unroll
    for (int t = 0; t < kRowsAThread; ++t) {
      if (r0 + t < N) first[r0 + t] = run;
      run += tot[t];
    }
    if (s == 0 && threadIdx.x == kPlaceThreads - 1) sb[N] = run;
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < kRowsAThread; ++t) {
    const int r = threadIdx.x + t * kPlaceThreads;
    if (r < N) {
      if (s == 0) sb[r] = first[r];
      cur[t] += first[r];                   // the segment's first slot in row r
    }
  }
  int* mine = cnt + warp * N;
  int* ob = order + static_cast<size_t>(b) * Q;
  for (int x0 = q0; x0 < q1; x0 += kWindow) {
    const int x1 = min(q1, x0 + kWindow);
    for (int i = threadIdx.x; i < x1 - x0; i += kPlaceThreads) cp_async4(rows + i, ib + x0 + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int i = threadIdx.x; i < kPlaceWarps * N / 4; i += kPlaceThreads)
      reinterpret_cast<int4*>(cnt)[i] = make_int4(0, 0, 0, 0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const int part = (x1 - x0 + kPlaceWarps - 1) / kPlaceWarps;
    const int w0 = min(x1, x0 + warp * part), w1 = min(x1, w0 + part);
    for (int q = w0 + lane; q < w1; q += 32) {
      const int r = rows[q - x0];
      if (r >= 0 && r < N) atomicAdd(&mine[r], 1);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kRowsAThread; ++t) {
      const int r = threadIdx.x + t * kPlaceThreads;
      if (r < N) {
#pragma unroll
        for (int w = 0; w < kPlaceWarps; ++w) {
          const int c = cnt[w * N + r];
          cnt[w * N + r] = cur[t];           // warp w's next slot in row r
          cur[t] += c;
        }
      }
    }
    __syncthreads();
    for (int base = w0; base < w1; base += 32) {
      const int q = base + lane;
      const int r = q < w1 ? rows[q - x0] : -1;
      const bool ok = r >= 0 && r < N;
      const unsigned peers = __match_any_sync(kFull, ok ? r : N + lane);
      const int pos = ok ? mine[r] + __popc(peers & below) : 0;
      __syncwarp();
      if (ok && (peers & below) == 0) mine[r] += __popc(peers);
      if (ok) ob[pos] = q;
      __syncwarp();
    }
    __syncthreads();
  }
}

// A lane's V elements of a g row: loaded raw (the packed type, so that a
// batch of bf16 loads holds half the registers) and added in order, widened
// to f32, into the lane's sums.
template <typename T, int V> struct Vec;
template <> struct Vec<float, 4> {
  using Raw = float4;
  __device__ static void add(float* acc, const Raw& t) {
    acc[0] = __fadd_rn(acc[0], t.x); acc[1] = __fadd_rn(acc[1], t.y);
    acc[2] = __fadd_rn(acc[2], t.z); acc[3] = __fadd_rn(acc[3], t.w);
  }
};
template <> struct Vec<float, 2> {
  using Raw = float2;
  __device__ static void add(float* acc, const Raw& t) {
    acc[0] = __fadd_rn(acc[0], t.x); acc[1] = __fadd_rn(acc[1], t.y);
  }
};
template <> struct Vec<float, 1> {
  using Raw = float;
  __device__ static void add(float* acc, const Raw& t) { acc[0] = __fadd_rn(acc[0], t); }
};
__device__ __forceinline__ void add_bf16x2(float* acc, unsigned w) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&w);
  acc[0] = __fadd_rn(acc[0], __low2float(a));
  acc[1] = __fadd_rn(acc[1], __high2float(a));
}
template <> struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static void add(float* acc, const Raw& t) {
    add_bf16x2(acc, t.x); add_bf16x2(acc + 2, t.y);
    add_bf16x2(acc + 4, t.z); add_bf16x2(acc + 6, t.w);
  }
};
template <> struct Vec<__nv_bfloat16, 4> {
  using Raw = uint2;
  __device__ static void add(float* acc, const Raw& t) {
    add_bf16x2(acc, t.x); add_bf16x2(acc + 2, t.y);
  }
};
template <> struct Vec<__nv_bfloat16, 2> {
  using Raw = unsigned;
  __device__ static void add(float* acc, const Raw& t) { add_bf16x2(acc, t); }
};
template <> struct Vec<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  __device__ static void add(float* acc, const Raw& t) {
    acc[0] = __fadd_rn(acc[0], __bfloat162float(t));
  }
};

// A warp a (cloud, group of 32 / G rows, channel slice), slices fastest: the
// warps that read one g row's slices run side by side.
template <typename T, int V, int G>
__global__ void __launch_bounds__(kSumWarps * 32)
scatter_sum_kernel(const T* __restrict__ g, const int* __restrict__ start,
                   const int* __restrict__ order, float* __restrict__ out, int Q, int N,
                   int C, int slices, int row_groups, int n_warps) {
  using Raw = typename Vec<T, V>::Raw;
  constexpr int kRows = 32 / G;
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  if (gw >= n_warps) return;   // whole warp
  const int slice = gw % slices;
  const int rest = gw / slices;
  const int b = rest / row_groups;
  const int grp = lane / G, gl = lane % G;
  const int row = (rest % row_groups) * kRows + grp;
  const int c = (slice * G + gl) * V;
  const bool active = row < N && c < C;
  const int* sb = start + static_cast<size_t>(b) * (N + 1);
  const int beg = row < N ? sb[row] : 0;
  const int n = row < N ? sb[row + 1] - beg : 0;
  const int longest = __reduce_max_sync(kFull, n);
  const int* ob = order + static_cast<size_t>(b) * Q + beg;
  const T* gb = g + static_cast<size_t>(b) * Q * C + c;

  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.0f;
  for (int j0 = 0; j0 < longest; j0 += G) {
    const int my_q = j0 + gl < n ? ob[j0 + gl] : -1;
    const int cnt = min(G, longest - j0);   // the same for the whole warp
    for (int t0 = 0; t0 < cnt; t0 += kBatch) {
      Raw v[kBatch];
      bool on[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int q = __shfl_sync(kFull, my_q, grp * G + ((t0 + u) & (G - 1)));
        on[u] = active && t0 + u < cnt && q >= 0;
        if (on[u]) v[u] = *reinterpret_cast<const Raw*>(gb + static_cast<size_t>(q) * C);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (on[u]) Vec<T, V>::add(acc, v[u]);
    }
  }
  if (active) {
    float* o = out + (static_cast<size_t>(b) * N + row) * C + c;
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(o + e) = make_float4(acc[e], acc[e + 1], acc[e + 2],
                                                        acc[e + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = acc[e];
    }
  }
}

template <typename T, int V, int G>
cudaError_t launch_sum(const void* g, const Lists& l, float* out, int B, int Q, int N, int C,
                       cudaStream_t s) {
  const int slices = (C + G * V - 1) / (G * V);
  const int row_groups = (N + 32 / G - 1) / (32 / G);
  const long long n_warps = static_cast<long long>(B) * row_groups * slices;
  if (n_warps >= (1LL << 31)) return cudaErrorInvalidValue;
  const long long blocks = (n_warps + kSumWarps - 1) / kSumWarps;
  scatter_sum_kernel<T, V, G><<<static_cast<unsigned>(blocks), kSumWarps * 32, 0, s>>>(
      static_cast<const T*>(g), l.start, l.order, out, Q, N, C, slices, row_groups,
      static_cast<int>(n_warps));
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_sum_g(int lanes, const void* g, const Lists& l, float* out, int B, int Q,
                         int N, int C, cudaStream_t s) {
  switch (lanes) {
    case 32: return launch_sum<T, V, 32>(g, l, out, B, Q, N, C, s);
    case 16: return launch_sum<T, V, 16>(g, l, out, B, Q, N, C, s);
    case 8: return launch_sum<T, V, 8>(g, l, out, B, Q, N, C, s);
    case 4: return launch_sum<T, V, 4>(g, l, out, B, Q, N, C, s);
    case 2: return launch_sum<T, V, 2>(g, l, out, B, Q, N, C, s);
    case 1: return launch_sum<T, V, 1>(g, l, out, B, Q, N, C, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_lists(const int* idx, int B, int Q, int N, int S, const Lists& l,
                         cudaStream_t s) {
  const int seg = (Q + S - 1) / S;
  scatter_count_kernel<<<B * S, kCountThreads, N * sizeof(int), s>>>(idx, Q, N, S, seg,
                                                                     l.counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = (static_cast<size_t>(kPlaceWarps + 1) * N + kWindow) * sizeof(int);
  if ((err = set_smem(scatter_place_kernel, smem)) != cudaSuccess) return err;
  scatter_place_kernel<<<B * S, kPlaceThreads, smem, s>>>(idx, l.counts, Q, N, S, seg, l.start,
                                                          l.order);
  return cudaGetLastError();
}

bool bad_lists(int B, int Q, int N, int S) {
  return B <= 0 || N <= 0 || Q < 0 || N > kMaxRows || S < 1 || S > kMaxSegs ||
         static_cast<long long>(B) * Q >= (1LL << 31) ||
         static_cast<long long>(B) * S * N >= (1LL << 31);
}

}  // namespace

// g: (B, Q, C) f32 (g_bf16 == 0) or bf16; idx (B, Q) int32; the plan of
// ops/gather.py:scatter_plan: segs in [1, 16] segments a cloud; vec in {1,
// 2, 4} (and 8 for bf16) elements a lane, dividing C and the alignment of
// g; lanes in {1, 2, ..., 32} a row. work: B (segs N + N + 1 + Q) ints of
// scratch the caller allocates (struct Lists); out (B, N, C) f32.
PDAE_EXPORT int scatter_rows_add(const void* g, int g_bf16, const int* idx, int B, int Q,
                                 int N, int C, int segs, int vec, int lanes, int* work,
                                 float* out, void* stream) {
  if (bad_lists(B, Q, N, segs) || C <= 0 || C % vec != 0 || (vec == 8 && !g_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Lists l = carve(work, B, Q, N, segs);
  cudaError_t err = launch_lists(idx, B, Q, N, segs, l, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g_bf16) {
    switch (vec) {
      case 8: err = launch_sum_g<__nv_bfloat16, 8>(lanes, g, l, out, B, Q, N, C, s); break;
      case 4: err = launch_sum_g<__nv_bfloat16, 4>(lanes, g, l, out, B, Q, N, C, s); break;
      case 2: err = launch_sum_g<__nv_bfloat16, 2>(lanes, g, l, out, B, Q, N, C, s); break;
      case 1: err = launch_sum_g<__nv_bfloat16, 1>(lanes, g, l, out, B, Q, N, C, s); break;
      default: err = cudaErrorInvalidValue;
    }
  } else {
    switch (vec) {
      case 4: err = launch_sum_g<float, 4>(lanes, g, l, out, B, Q, N, C, s); break;
      case 2: err = launch_sum_g<float, 2>(lanes, g, l, out, B, Q, N, C, s); break;
      case 1: err = launch_sum_g<float, 1>(lanes, g, l, out, B, Q, N, C, s); break;
      default: err = cudaErrorInvalidValue;
    }
  }
  return static_cast<int>(err);
}

// The counting sort alone, for checks: work laid out as scatter_rows_add's
// (the counts (B, segs, N), the list starts (B, N + 1), the lists (B, Q)).
PDAE_EXPORT int scatter_lists(const int* idx, int B, int Q, int N, int segs, int* work,
                              void* stream) {
  if (bad_lists(B, Q, N, segs)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_lists(idx, B, Q, N, segs, carve(work, B, Q, N, segs),
                                       static_cast<cudaStream_t>(stream)));
}
