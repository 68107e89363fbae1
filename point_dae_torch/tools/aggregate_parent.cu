// The EdgeConv aggregate in its previous design, kept unchanged as the
// yardstick of point_dae_torch/tools/rowreduce_ablation.py and of
// chip_smoke.py: a warp a row reads the row's k selected rows of U straight
// from L2, four channels a lane, and writes M, m, S1, S2 (and with track the
// rounds rM, rm). The current design, csrc/edgeconv.cu's staged aggregate,
// must give the same bits. Built with -I point_dae_torch/csrc; nothing in
// the package loads it.
#include "common.cuh"

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = 1e30f;
constexpr int kMaxK = 64;

// Round r's neighbour, held by lane r & 31 in i0 (r < 32) or i1.
__device__ __forceinline__ int round_idx(int i0, int i1, int r) {
  return __shfl_sync(kFull, r < 32 ? i0 : i1, r & 31);
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

}  // namespace

// The entry of csrc/edgeconv.cu as it was: aggregates over a given idx
// (B, N, k); rM / rm may be null when track == 0.
PDAE_EXPORT int edgeconv_aggregate(const float* U, const int* idx, int B, int N, int C,
                                   int k, int track, float* M, float* m, float* S1,
                                   float* S2, uint8_t* rM, uint8_t* rm, void* stream_) {
  if (N < 1 || k < 1 || k > kMaxK || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  return C % 4 == 0
             ? launch_aggregate<4>(U, idx, B, N, C, k, track, M, m, S1, S2, rM, rm, stream)
             : launch_aggregate<1>(U, idx, B, N, C, k, track, M, m, S1, S2, rM, rm, stream);
}
