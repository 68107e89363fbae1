// Small-C row gather: out[b, q, :] = x[b, idx[b, q], :] for C <= 8, f32,
// bit-exact, idx int32 or int64. Rows whose index falls outside [0, N) come
// out as zeros, as the TPU kernel's one-hot product gives them.
//
// Replaces point_dae_tpu/ops/pallas_scatter.py:gather_rows_small_c_pallas.
// The TPU kernel computed the gather as a one-hot matrix product only
// because its lane layout wastes 125 of 128 lanes on a 3-wide row; on
// Hopper it is an indexed copy.
//
// Bound on the H100: bytes (the index and the output once, each selected
// row once). Design: C is a template parameter, so a row's offsets need no
// runtime divide; a block owns 256 consecutive rows of one cloud
// (blockIdx.y), a thread one whole row, and reads its index once, int32 or
// int64 as given (no cast launch). The block stages its rows in shared
// memory and writes them out as 16-byte stores: a 3-wide row is 12 bytes,
// so one store a row would leave sectors partly filled.
//
// Second entry, gather_by_key_small_c: the rank-keyed select
// out[b, q, :] = x[b, n*, :] where key[b, n*] == draw[b, q], zeros where no
// key matches. Replaces point_dae_tpu/ops/pallas_scatter.py:
// gather_by_key_small_c_pallas, whose one-hot compare and product do N * Q
// work a cloud, and the key building of its caller
// (point_dae_tpu/ops/geometry.py:326-331: rank = cumsum(mask) - 1, keys =
// where(mask, rank, -1), draws below the cloud's valid count). Two key
// sources: keys as given (int32 or int64, distinct where >= 0), or a bool
// mask (B, N), whose key at a valid point is its rank, the number of valid
// points before it. Draws int32 or int64 ranks, or with a mask f32
// uniforms, which become min(trunc(u * float(max(cnt, 1))), max(cnt, 1) - 1)
// for the cloud's valid count cnt: the rounding of the plain chain
// (draws * cnt).long().clamp_max(cnt - 1), whose f32-by-int64 product
// multiplies in f32. Bound: bytes (the mask or keys, the draws and the
// output once, each selected row once).
//
// Design: one block of up to 1024 threads a cloud (ops/gather.py:
// key_gather_threads), a thread a draw. From a mask, the cloud's ranks are
// found once, without a table: a warp's ballot over 32 mask bytes is one
// 32-bit slice of the row in shared memory, every warp sums the slices'
// popcounts into a prefix across its lanes, and the point of rank d is the
// lane whose prefix passes d (a binary search by shuffles), then the slice
// in that lane's share, then the bit in the slice. From keys, a table
// inv[key] = n in shared memory. A 3-wide row (12 bytes) moves in an
// 8-byte and a 4-byte access, each aligned, in and out; other widths are
// staged in shared memory and written out as 16-byte stores. Keys and
// draws are read as given, so int64 ones need no cast launch.
// tools/key_gather_ablation.py times the variants.
//
// Third entry, gather_rows_wide: out[b, q, :] = f32(x[b, idx[b, q], :]) for
// any C and x in f32, bf16 or f16, zeros where the index falls outside
// [0, N). Replaces point_dae_tpu/ops/pallas_scatter.py:gather_rows_pallas,
// a one-hot (tq, N) x (N, C) product at HIGHEST precision (exact, N C work
// a row). Bound: bytes, the output and the index once and each selected row
// once; the output is most of them. Design: a row gets C / V lanes (V
// elements a 16-byte vector: 4 f32, 8 bf16 or f16), rounded up to a power
// of two up to 32, so a warp copies 32 V / C rows at once (2 at C 64 f32);
// each row's index, int32 or int64 as given, is read once by its first lane
// and shared; a lane loads two rows' vectors before it stores either, and
// the f32 output goes out by streaming 16-byte stores. Nothing on the
// model's path calls it: the JAX package keeps XLA's gather forward
// (pallas_scatter.py:267-276).
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kGatherRows = 256;   // rows (and threads) a small-C gather block

template <int C, typename I>
__global__ void __launch_bounds__(kGatherRows)
gather_rows_kernel(const float* __restrict__ x, const I* __restrict__ idx,
                   float* __restrict__ out, int N, int Q) {
  // element e of the block's output sits at buf[e + (o0 & 3)], so the
  // block's first 16-byte boundary in out is a float4 of buf
  __shared__ float4 buf4[kGatherRows * C / 4 + 1];
  float* buf = reinterpret_cast<float*>(buf4);
  const int q0 = blockIdx.x * kGatherRows;
  const int n = min(kGatherRows, Q - q0);
  const size_t o0 = (size_t(blockIdx.y) * Q + q0) * C;
  const int shift = static_cast<int>(o0 & 3);
  const int r = threadIdx.x;
  if (r < n) {
    const long long i = static_cast<long long>(idx[size_t(blockIdx.y) * Q + q0 + r]);
    const float* src = x + (size_t(blockIdx.y) * N + (i >= 0 && i < N ? i : 0)) * C;
    const bool ok = i >= 0 && i < N;
#pragma unroll
    for (int c = 0; c < C; ++c) buf[shift + r * C + c] = ok ? src[c] : 0.0f;
  }
  __syncthreads();
  const int total = n * C;
  const int head = min((4 - shift) & 3, total);   // elements before the boundary
  float* ob = out + o0;
  if (r < head) ob[r] = buf[shift + r];
  const int nv = (total - head) / 4;
  const float4* bv = buf4 + (shift + head) / 4;
  for (int v = r; v < nv; v += kGatherRows)
    reinterpret_cast<float4*>(ob + head)[v] = bv[v];
  const int e = head + 4 * nv + r;
  if (e < total) ob[e] = buf[shift + e];
}

template <typename I>
cudaError_t launch_gather_rows(const float* x, const I* idx, float* out, int B, int N, int Q,
                               int C, cudaStream_t stream) {
  const dim3 grid((Q + kGatherRows - 1) / kGatherRows, B);
  switch (C) {
#define PDAE_GATHER_CASE(c)                                                              \
    case c:                                                                              \
      gather_rows_kernel<c, I><<<grid, kGatherRows, 0, stream>>>(x, idx, out, N, Q); \
      break;
    PDAE_GATHER_CASE(1)
    PDAE_GATHER_CASE(2)
    PDAE_GATHER_CASE(3)
    PDAE_GATHER_CASE(4)
    PDAE_GATHER_CASE(5)
    PDAE_GATHER_CASE(6)
    PDAE_GATHER_CASE(7)
    PDAE_GATHER_CASE(8)
#undef PDAE_GATHER_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

constexpr int kKeyMaxN = 12288;     // table entries a block holds: 48 KB
constexpr int kKeyMaxThreads = 1024;

__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// A draw's rank: integers as given; an f32 uniform u becomes
// min(trunc(u * float(max(cnt, 1))), max(cnt, 1) - 1).
__device__ __forceinline__ long long draw_rank(int d, int) { return d; }
__device__ __forceinline__ long long draw_rank(long long d, int) { return d; }
__device__ __forceinline__ long long draw_rank(float u, int cnt) {
  const int c = max(cnt, 1);
  const long long d = static_cast<long long>(__fmul_rn(u, static_cast<float>(c)));
  return d < c - 1 ? d : c - 1;
}

// A 3-wide row (12 bytes, 4-byte aligned) in two loads or stores: 8 bytes
// where they are 8-byte aligned and the other 4.
__device__ __forceinline__ float3 load_row3(const float* row) {
  const bool even = (reinterpret_cast<uintptr_t>(row) & 7) == 0;
  const float2 a = __ldg(reinterpret_cast<const float2*>(row + (even ? 0 : 1)));
  const float c = __ldg(row + (even ? 2 : 0));
  return even ? make_float3(a.x, a.y, c) : make_float3(c, a.x, a.y);
}

__device__ __forceinline__ void store_row3(float* row, float3 v) {
  const bool even = (reinterpret_cast<uintptr_t>(row) & 7) == 0;
  *reinterpret_cast<float2*>(row + (even ? 0 : 1)) =
      even ? make_float2(v.x, v.y) : make_float2(v.y, v.z);
  row[even ? 2 : 0] = even ? v.z : v.x;
}

// The position of the k-th (from 0) set bit of w, which has more than k.
__device__ __forceinline__ int select_bit(unsigned w, int k) {
  int pos = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    const int c = __popc((w >> pos) & ((1u << step) - 1));
    if (k >= c) {
      k -= c;
      pos += step;
    }
  }
  return pos;
}

// K: bool (a mask) or int / long long (keys); D: int, long long or float.
// One block a cloud. From a mask: warp w's ballot over 32 elements in a
// round is the row's slice n / 32, and every warp sums the slices'
// popcounts, lane l the slices [l sp, (l + 1) sp), into a prefix across its
// lanes; the point of rank d is then found without a table: the lane whose
// prefix passes d (a binary search by shuffles), the slice within that
// lane's, and the bit within the slice. From keys: a table inv[key] = n,
// filled with -1 first. 32-bit offsets: the launcher checks that every one
// fits.
template <typename K, typename D>
__global__ void __launch_bounds__(kKeyMaxThreads)
gather_by_key_kernel(const float* __restrict__ x, const K* __restrict__ keys,
                     const D* __restrict__ draw, float* __restrict__ out, int N, int Q,
                     int C) {
  constexpr bool kMask = std::is_same<K, bool>::value;
  extern __shared__ float4 smem4[];
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31;
  float4* stage4 = smem4;                              // [T C / 4 + 1]
  float* stage = reinterpret_cast<float*>(smem4);
  int* inv = reinterpret_cast<int*>(smem4 + T * C / 4 + 1);   // keys: [N]
  unsigned* ballots = reinterpret_cast<unsigned*>(inv);        // mask: [N / 32]
  const unsigned b = blockIdx.x;
  const float* xb = x + b * static_cast<unsigned>(N) * C;
  const D* db = draw + b * static_cast<unsigned>(Q);

  const int S = (N + 31) / 32, sp = (S + 31) / 32;    // slices, a lane's slices
  int incl = 0, lane_sum = 0, cnt = 0;                 // mask: the prefix over lanes, the count
  if constexpr (kMask) {
    const unsigned char* mb = reinterpret_cast<const unsigned char*>(keys) + b * N;
    for (int n = t; n - lane < N; n += T) {
      const unsigned bal = __ballot_sync(0xffffffffu, n < N && mb[n] != 0);
      if (lane == 0) ballots[n / 32] = bal;
    }
  } else {
    const K* kb = keys + b * N;
    for (int n = t; n < N; n += T) inv[n] = -1;
    __syncthreads();
    for (int n = t; n < N; n += T) {
      const long long key = static_cast<long long>(kb[n]);
      if (key >= 0 && key < N) inv[key] = n;
    }
  }
  __syncthreads();
  if constexpr (kMask) {
    for (int s = lane * sp; s < min(S, (lane + 1) * sp); ++s) lane_sum += __popc(ballots[s]);
    incl = warp_inclusive_sum(lane_sum);
    cnt = __shfl_sync(0xffffffffu, incl, 31);
  }

  for (int p0 = 0; p0 < Q; p0 += T) {
    const int rows = min(T, Q - p0);
    const unsigned o0 = (b * static_cast<unsigned>(Q) + p0) * C;
    const int shift = static_cast<int>(o0 & 3);
    long long d = -1;
    if (t < rows) d = draw_rank(db[p0 + t], cnt);
    int n = -1;
    if constexpr (kMask) {
      // the first lane whose prefix passes d; every lane takes part
      int L = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (__shfl_sync(0xffffffffu, incl, L + step - 1) <= d) L += step;
      const int before = __shfl_sync(0xffffffffu, incl - lane_sum, min(L, 31));
      if (d >= 0 && d < cnt) {
        int rem = static_cast<int>(d) - before, sl = L * sp;
        for (int c = __popc(ballots[sl]); rem >= c; c = __popc(ballots[sl])) {
          rem -= c;
          ++sl;
        }
        n = sl * 32 + select_bit(ballots[sl], rem);
      }
    } else {
      if (d >= 0 && d < N) n = inv[d];
    }
    if (C == 3) {   // a 3-wide row in two loads and two stores, each aligned; no staging
      if (t < rows) {
        float3 v = load_row3(xb + max(n, 0) * 3);
        if (n < 0) v = make_float3(0.0f, 0.0f, 0.0f);
        store_row3(out + o0 + 3 * t, v);
      }
      continue;
    }
    if (t < rows) {
      const float* src = xb + max(n, 0) * C;
      for (int c = 0; c < C; ++c) stage[shift + t * C + c] = n >= 0 ? __ldg(src + c) : 0.0f;
    }
    __syncthreads();
    const int total = rows * C;
    const int head = min((4 - shift) & 3, total);   // elements before the 16-byte boundary
    float* ob = out + o0;
    if (t < head) ob[t] = stage[shift + t];
    const int nv = (total - head) / 4;
    const float4* bv = stage4 + (shift + head) / 4;
    for (int v = t; v < nv; v += T) reinterpret_cast<float4*>(ob + head)[v] = bv[v];
    const int e = head + 4 * nv + t;
    if (e < total) ob[e] = stage[shift + e];
    __syncthreads();
  }
}

template <typename K, typename D>
cudaError_t launch_key(const float* x, const void* keys, const void* draw, float* out, int B,
                       int N, int Q, int C, int threads, cudaStream_t s) {
  auto kernel = gather_by_key_kernel<K, D>;
  constexpr bool kMask = std::is_same<K, bool>::value;
  const size_t smem = (threads * C / 4 + 1) * sizeof(float4) +
                      (kMask ? (N + 31) / 32 : N) * sizeof(int);
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, threads, smem, s>>>(x, static_cast<const K*>(keys), static_cast<const D*>(draw),
                                  out, N, Q, C);
  return cudaGetLastError();
}

template <typename K>
cudaError_t launch_key_draw(int draw_type, const float* x, const void* keys, const void* draw,
                            float* out, int B, int N, int Q, int C, int threads,
                            cudaStream_t s) {
  switch (draw_type) {
    case 0: return launch_key<K, int>(x, keys, draw, out, B, N, Q, C, threads, s);
    case 1: return launch_key<K, long long>(x, keys, draw, out, B, N, Q, C, threads, s);
    case 2:
      if constexpr (std::is_same<K, bool>::value)
        return launch_key<K, float>(x, keys, draw, out, B, N, Q, C, threads, s);
      else
        return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// One vector of a row: VEC (16 / sizeof(T), a 16-byte load) elements, or one
// element when VEC is 1; out gets them as f32 by streaming stores.
template <typename T, int VEC>
struct Vec {
  uint4 raw;
  float f;
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (VEC == 1)
      f = to_f32(*p);
    else
      raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() {
    raw = make_uint4(0u, 0u, 0u, 0u);
    f = 0.f;
  }
  __device__ __forceinline__ void store(float* o) const {
    if constexpr (VEC == 1) {
      __stcs(o, f);
    } else if constexpr (sizeof(T) == 4) {
      __stcs(reinterpret_cast<float4*>(o),
             make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                         __uint_as_float(raw.z), __uint_as_float(raw.w)));
    } else {
      const T* h = reinterpret_cast<const T*>(&raw);
      __stcs(reinterpret_cast<float4*>(o),
             make_float4(to_f32(h[0]), to_f32(h[1]), to_f32(h[2]), to_f32(h[3])));
      __stcs(reinterpret_cast<float4*>(o) + 1,
             make_float4(to_f32(h[4]), to_f32(h[5]), to_f32(h[6]), to_f32(h[7])));
    }
  }
};

// LPR lanes a row (a power of two up to 32), 32 / LPR rows a warp at once,
// UR rows a lane slot per step so that each lane keeps at least UR vectors
// in flight. A row's index is read once, by its first lane, and
// shared by a shuffle; int32 or int64 as given. 64-bit offsets.
constexpr int UR = 2;   // rows a lane slot loads before it stores

template <typename T, typename I, int VEC, int LPR>
__global__ void __launch_bounds__(256)
gather_rows_wide_kernel(const T* __restrict__ x, const I* __restrict__ idx,
                        float* __restrict__ out, int N, int Q, int C, long long rows) {
  constexpr int RPW = 32 / LPR;                      // rows a warp at once
  const int lane = threadIdx.x & 31, sub = lane / LPR, l = lane % LPR;
  const int nv = C / VEC;                            // vectors a row
  const long long warp = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) / 32;
  const long long stride = static_cast<long long>(gridDim.x) * (blockDim.x / 32) * RPW;
  for (long long base = warp * RPW; base < rows; base += UR * stride) {
    long long row[UR];
    long long src[UR];
#pragma unroll
    for (int u = 0; u < UR; ++u) {
      row[u] = base + u * stride + sub;
      long long i = -1;
      if (l == 0 && row[u] < rows) i = static_cast<long long>(idx[row[u]]);
      i = __shfl_sync(0xffffffffu, i, sub * LPR);
      src[u] = (i >= 0 && i < N) ? (row[u] / Q * N + i) * C : -1;
    }
    for (int v0 = l; v0 < nv; v0 += LPR) {
      Vec<T, VEC> a[UR];
#pragma unroll
      for (int u = 0; u < UR; ++u) {
        if (src[u] >= 0)
          a[u].load(x + src[u] + static_cast<long long>(v0) * VEC);
        else
          a[u].zero();
      }
#pragma unroll
      for (int u = 0; u < UR; ++u)
        if (row[u] < rows) a[u].store(out + row[u] * C + static_cast<long long>(v0) * VEC);
    }
  }
}

template <typename T, typename I, int VEC>
cudaError_t launch_wide(const T* x, const I* idx, float* out, int N, int Q, int C,
                        long long rows, cudaStream_t stream) {
  const int nv = C / VEC;
  int lpr = 1;
  while (lpr < nv && lpr < 32) lpr *= 2;
  const long long per_block = 8LL * (32 / lpr) * UR;  // rows a block covers in one step
  const long long want = (rows + per_block - 1) / per_block;
  // a block a step's rows: a grid-stride loop only past 256 blocks an SM
  const int blocks = static_cast<int>(want < 132 * 256 ? want : 132 * 256);
  switch (lpr) {
#define PDAE_WIDE_CASE(L)                                                                \
    case L:                                                                              \
      gather_rows_wide_kernel<T, I, VEC, L><<<blocks, 256, 0, stream>>>(x, idx, out, N, Q, C, \
                                                                        rows);          \
      break;
    PDAE_WIDE_CASE(1)
    PDAE_WIDE_CASE(2)
    PDAE_WIDE_CASE(4)
    PDAE_WIDE_CASE(8)
    PDAE_WIDE_CASE(16)
    PDAE_WIDE_CASE(32)
#undef PDAE_WIDE_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide_t(const void* x, const void* idx, int idx64, float* out, int N, int Q,
                          int C, long long rows, int vec, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  constexpr int V = 16 / sizeof(T);
  if (idx64) {
    const long long* i = static_cast<const long long*>(idx);
    return vec ? launch_wide<T, long long, V>(xt, i, out, N, Q, C, rows, s)
               : launch_wide<T, long long, 1>(xt, i, out, N, Q, C, rows, s);
  }
  const int* i = static_cast<const int*>(idx);
  return vec ? launch_wide<T, int, V>(xt, i, out, N, Q, C, rows, s)
             : launch_wide<T, int, 1>(xt, i, out, N, Q, C, rows, s);
}

}  // namespace

// idx (B, Q): int64 when idx64, else int32; out (B, Q, C) f32, 16-byte aligned.
PDAE_EXPORT int gather_rows_small_c(const float* x, const void* idx, int idx64, float* out,
                                    int B, int N, int Q, int C, void* stream) {
  if (B < 0 || N < 1 || Q < 0 || C < 1 || C > 8 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Q == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      idx64 ? launch_gather_rows(x, static_cast<const long long*>(idx), out, B, N, Q, C, s)
            : launch_gather_rows(x, static_cast<const int*>(idx), out, B, N, Q, C, s);
  return static_cast<int>(err);
}

// x (B, N, C <= 8) f32; keys (B, N): key_type 0 a bool mask, 1 int32 keys,
// 2 int64 keys (distinct where >= 0); draw (B, Q): draw_type 0 int32 ranks,
// 1 int64 ranks, 2 f32 uniforms (with a mask only); out (B, Q, C) f32,
// 16-byte aligned. N up to 12288 (the keys' table in 48 KB of shared
// memory); a block of `threads` (a multiple of 32 up to 1024) a cloud.
PDAE_EXPORT int gather_by_key_small_c(const float* x, const void* keys, int key_type,
                                      const void* draw, int draw_type, float* out, int B,
                                      int N, int Q, int C, int threads, void* stream) {
  const long long total = static_cast<long long>(B) * Q * C;
  if (B < 0 || Q < 0 || N < 1 || N > kKeyMaxN || C < 1 || C > 8 ||
      total >= (1LL << 31) || static_cast<long long>(B) * N * C >= (1LL << 31) ||
      threads < 32 || threads > kKeyMaxThreads || threads % 32 != 0 || key_type < 0 ||
      key_type > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (key_type == 0)
    err = launch_key_draw<bool>(draw_type, x, keys, draw, out, B, N, Q, C, threads, s);
  else if (key_type == 1)
    err = launch_key_draw<int>(draw_type, x, keys, draw, out, B, N, Q, C, threads, s);
  else
    err = launch_key_draw<long long>(draw_type, x, keys, draw, out, B, N, Q, C, threads, s);
  return static_cast<int>(err);
}

// x (B, N, C) of dtype 0 f32, 1 bf16, 2 f16; idx (B, Q) int64 when idx64,
// else int32; out (B, Q, C) f32. vec: 16-byte vectors (C a multiple of 16 /
// sizeof(x) and x 16-byte aligned), else one element a lane.
PDAE_EXPORT int gather_rows_wide(const void* x, int dtype, const void* idx, int idx64,
                                 float* out, int B, int N, int Q, int C, int vec,
                                 void* stream) {
  const long long rows = static_cast<long long>(B) * Q;
  if (rows == 0 || C == 0) return static_cast<int>(cudaSuccess);
  const int V = dtype == 0 ? 4 : 8;
  if (C < 0 || N < 1 || dtype < 0 || dtype > 2 || (vec != 0 && vec != 1) ||
      (vec && C % V != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_wide_t<float>(x, idx, idx64, out, N, Q, C, rows, vec, s); break;
    case 1: err = launch_wide_t<__nv_bfloat16>(x, idx, idx64, out, N, Q, C, rows, vec, s); break;
    default: err = launch_wide_t<__half>(x, idx, idx64, out, N, Q, C, rows, vec, s); break;
  }
  return static_cast<int>(err);
}
