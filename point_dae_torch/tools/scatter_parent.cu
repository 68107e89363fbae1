// The row scatter-add in its previous design, kept unchanged as the yardstick
// of point_dae_torch/tools/rowreduce_ablation.py and of chip_smoke.py: one
// block of 16 warps a cloud runs the whole counting sort, then a warp a
// (cloud, row, channel slice) sums the row's list with four loads in flight.
// The current design, in csrc/scatter.cu, must give the same bits. Built
// with -I point_dae_torch/csrc; nothing in the package loads it.
//
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
// Pass 1, one block a cloud: a stable counting sort of idx[b, :] by row.
// Each of the block's 16 warps owns a contiguous segment of q and a row
// histogram of its own in shared memory (16 x N ints, so N <= 2048 fits),
// counted with integer atomics (a count does not depend on their order).
// An exclusive scan over (row, warp) gives each warp its write offsets, and
// a second walk, 32 entries at a time, writes every q into its row's list
// in ascending q: __match_any_sync groups equal rows inside the 32, and a
// lane's rank is the number of lanes below it in its group. The match is
// the pass's main cost, which is why the counts do without it.
// Pass 2: one warp a (cloud, row, channel slice) walks its row's list and
// sums the g rows with vector loads (4, 2 or 1 elements a lane), four loads
// in flight, and writes the output slice once. Each g element is read once.
#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSortWarps = 16;
constexpr int kSortThreads = kSortWarps * 32;
constexpr int kMaxRows = 2048;
constexpr int kSumWarps = 8;

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

__global__ void __launch_bounds__(kSortThreads)
sort_rows_kernel(const int* __restrict__ idx, int Q, int N,
                 int* __restrict__ row_ptr, int* __restrict__ order) {
  extern __shared__ int smem[];
  int* cnt = smem;                           // [kSortWarps][N]
  int* warp_tot = smem + kSortWarps * N;     // [kSortWarps]
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int* ib = idx + static_cast<size_t>(b) * Q;
  int* ob = order + static_cast<size_t>(b) * Q;

  for (int i = threadIdx.x; i < kSortWarps * N; i += kSortThreads) cnt[i] = 0;
  __syncthreads();

  const int seg = (Q + kSortWarps - 1) / kSortWarps;
  const int q0 = min(Q, warp * seg), q1 = min(Q, q0 + seg);
  int* mine = cnt + warp * N;

  // A: the warp's histogram of its segment (integer atomics: the counts do
  // not depend on their order)
  for (int q = q0 + lane; q < q1; q += 32) {
    const int r = ib[q];
    if (r >= 0 && r < N) atomicAdd(&mine[r], 1);
  }
  __syncthreads();

  // B: exclusive scan in (row, warp) order; each thread owns rpt rows
  const int rpt = (N + kSortThreads - 1) / kSortThreads;
  const int r0 = threadIdx.x * rpt, r1 = min(N, r0 + rpt);
  int local = 0;
  for (int r = r0; r < r1; ++r)
    for (int w = 0; w < kSortWarps; ++w) local += cnt[w * N + r];
  const int incl = warp_incl_scan(local, lane);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kSortWarps ? warp_tot[lane] : 0;
    const int s = warp_incl_scan(v, lane);
    __syncwarp();
    if (lane < kSortWarps) warp_tot[lane] = s - v;
  }
  __syncthreads();
  int run = warp_tot[warp] + incl - local;
  int* rp = row_ptr + static_cast<size_t>(b) * (N + 1);
  for (int r = r0; r < r1; ++r) {
    rp[r] = run;
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = cnt[w * N + r];
      cnt[w * N + r] = run;                  // warp w's next slot in row r
      run += c;
    }
  }
  if (threadIdx.x == kSortThreads - 1) rp[N] = run;
  __syncthreads();

  // C: the warp's segment again, each q into its row's list in q order
  for (int base = q0; base < q1; base += 32) {
    const int q = base + lane;
    const int r = q < q1 ? ib[q] : -1;
    const bool ok = r >= 0 && r < N;
    const unsigned peers = __match_any_sync(kFull, ok ? r : N + lane);
    const int pos = ok ? mine[r] + __popc(peers & below) : 0;
    __syncwarp();
    if (ok && (peers & below) == 0) mine[r] += __popc(peers);
    if (ok) ob[pos] = q;
    __syncwarp();
  }
}

template <typename T, int V> struct Vec;
template <> struct Vec<float, 4> {
  __device__ static void load(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
};
template <> struct Vec<float, 2> {
  __device__ static void load(const float* p, float* v) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
};
template <> struct Vec<float, 1> {
  __device__ static void load(const float* p, float* v) { v[0] = *p; }
};
template <> struct Vec<__nv_bfloat16, 4> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
    const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(c); v[3] = __high2float(c);
  }
};
template <> struct Vec<__nv_bfloat16, 2> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = __low2float(a); v[1] = __high2float(a);
  }
};
template <> struct Vec<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* v) { v[0] = __bfloat162float(*p); }
};

template <typename T, int V>
__global__ void __launch_bounds__(kSumWarps * 32)
sum_rows_kernel(const T* __restrict__ g, const int* __restrict__ row_ptr,
                const int* __restrict__ order, float* __restrict__ out, int Q, int N,
                int C, int slices, long long n_warps) {
  const int lane = threadIdx.x & 31;
  const long long gw = static_cast<long long>(blockIdx.x) * kSumWarps + (threadIdx.x >> 5);
  if (gw >= n_warps) return;
  const int slice = static_cast<int>(gw % slices);
  const long long rest = gw / slices;
  const int row = static_cast<int>(rest % N);
  const int b = static_cast<int>(rest / N);
  const int c = slice * 32 * V + lane * V;
  const bool active = c < C;
  const int* rp = row_ptr + static_cast<size_t>(b) * (N + 1);
  const int beg = rp[row], end = rp[row + 1];
  const T* gb = g + static_cast<size_t>(b) * Q * C + c;
  const int* ob = order + static_cast<size_t>(b) * Q;

  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.0f;
  for (int j0 = beg; j0 < end; j0 += 32) {
    const int n = min(32, end - j0);
    const int my_q = lane < n ? ob[j0 + lane] : 0;
    for (int t = 0; t < n; t += 4) {
      float v[4][V];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = __shfl_sync(kFull, my_q, (t + u) & 31);
        if (active && t + u < n) {
          Vec<T, V>::load(gb + static_cast<size_t>(q) * C, v[u]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) v[u][e] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (t + u < n) {
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], v[u][e]);
        }
      }
    }
  }
  if (active) {
    float* o = out + (static_cast<size_t>(b) * N + row) * C + c;
#pragma unroll
    for (int e = 0; e < V; ++e) o[e] = acc[e];
  }
}

template <typename T, int V>
cudaError_t launch_sum(const void* g, const int* row_ptr, const int* order, float* out,
                       int B, int Q, int N, int C, cudaStream_t s) {
  const int slices = (C + 32 * V - 1) / (32 * V);
  const long long n_warps = static_cast<long long>(B) * N * slices;
  const long long blocks = (n_warps + kSumWarps - 1) / kSumWarps;
  sum_rows_kernel<T, V><<<static_cast<unsigned>(blocks), kSumWarps * 32, 0, s>>>(
      static_cast<const T*>(g), row_ptr, order, out, Q, N, C, slices, n_warps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sum_v(int vec, const void* g, const int* row_ptr, const int* order,
                         float* out, int B, int Q, int N, int C, cudaStream_t s) {
  if (vec == 4) return launch_sum<T, 4>(g, row_ptr, order, out, B, Q, N, C, s);
  if (vec == 2) return launch_sum<T, 2>(g, row_ptr, order, out, B, Q, N, C, s);
  return launch_sum<T, 1>(g, row_ptr, order, out, B, Q, N, C, s);
}

}  // namespace

// g: (B, Q, C) f32 (g_bf16 == 0) or bf16; idx (B, Q) int32; vec in {1, 2, 4}
// divides C and the alignment of g (the wrapper picks it); row_ptr (B, N + 1)
// and order (B, Q) int32 are scratch the caller allocates; out (B, N, C) f32.
PDAE_EXPORT int scatter_rows_add(const void* g, int g_bf16, const int* idx, int B, int Q,
                                 int N, int C, int vec, int* row_ptr, int* order,
                                 float* out, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || Q < 0 || N > kMaxRows || C % vec != 0 ||
      (vec != 1 && vec != 2 && vec != 4) ||
      static_cast<long long>(B) * Q >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (static_cast<size_t>(kSortWarps) * N + kSortWarps) * sizeof(int);
  cudaError_t err = set_smem(sort_rows_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sort_rows_kernel<<<B, kSortThreads, smem, s>>>(idx, Q, N, row_ptr, order);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = g_bf16 ? launch_sum_v<__nv_bfloat16>(vec, g, row_ptr, order, out, B, Q, N, C, s)
               : launch_sum_v<float>(vec, g, row_ptr, order, out, B, Q, N, C, s);
  return static_cast<int>(err);
}
