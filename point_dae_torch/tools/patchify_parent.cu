// The fused patchify kernel in its previous design, kept unchanged as the
// yardstick of point_dae_torch/tools/fps_ablation.py and of chip_smoke.py:
// one block of 256 threads a cloud, FPS with two barriers and a serial merge
// an iteration, then each kNN row as S rounds of "smallest (distance, index)
// after the previous one" over all N points. The current design, in
// csrc/patchify.cu, must give the same fps_idx and knn_idx. Built with
// -I point_dae_torch/csrc; nothing in the package loads it.
//
// Fused FPS + kNN patchify: (B, N, 3) f32 -> fps_idx (B, G) i32 and
// knn_idx (B, G, S) i32, ascending by distance, lowest index first on ties.
//
// Replaces point_dae_tpu/ops/pallas_patchify.py:fused_patchify_pallas.
//
// Design: one block per cloud. The cloud's coordinates (SoA), the running
// min-distance and the selectable flags live in shared memory (17 B a
// point). FPS runs its G iterations with a block argmax (lowest index on
// equal values, as jnp.argmax). The TPU kernel kept every FPS distance row
// as the (G, N) kNN matrix in VMEM; 64 rows of 1024 points would take
// 256 KB here, more than a block's 227 KB, so each kNN row is recomputed
// instead (3 coordinates a point): one warp owns a centre and extracts its
// S nearest as successive minima of the (distance, index) order, which is
// exactly the argmin-then-mask extraction of the TPU kernel.
//
// Bound on the H100: neither bytes (12 KB a cloud) nor FLOPs (G*N*8); the
// G serial FPS iterations, each ending in a block-wide argmax and two
// barriers, set the time. All distances use round-to-nearest intrinsics so
// they equal the plain PyTorch version bit for bit (FPS is chaotic: one
// different pick changes every later pick).
#include <cfloat>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (value, index) pair order used for the FPS argmax: larger value wins,
// equal values go to the lower index.
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Strict (distance, index) order used by the kNN extraction.
__device__ __forceinline__ bool lex_less(float a, int ai, float b, int bi) {
  return a < b || (a == b && ai < bi);
}

__global__ void __launch_bounds__(kThreads)
patchify_kernel(const float* __restrict__ pts, int N, int G, int S,
                int* __restrict__ fps_out, int* __restrict__ knn_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sx = reinterpret_cast<float*>(smem);
  float* sy = sx + N;
  float* sz = sy + N;
  float* min_d = sz + N;
  unsigned char* selectable = reinterpret_cast<unsigned char*>(min_d + N);
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ int picks[1024];  // G <= 1024, checked by the launcher
  __shared__ int last_pick;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* cloud = pts + static_cast<size_t>(b) * N * 3;

  for (int n = tid; n < N; n += kThreads) {
    const float x = cloud[3 * n], y = cloud[3 * n + 1], z = cloud[3 * n + 2];
    sx[n] = x;
    sy[n] = y;
    sz[n] = z;
    min_d[n] = 1e10f;
    const float mag = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                __fmul_rn(z, z));
    selectable[n] = mag > 1e-3f;
  }
  if (tid == 0) last_pick = 0;  // first pick is index 0
  __syncthreads();

  // ---- phase 1: furthest point sampling
  for (int it = 0; it < G; ++it) {
    const int last = last_pick;
    if (tid == 0) picks[it] = last;
    const float px = sx[last], py = sy[last], pz = sz[last];
    float best_v = -FLT_MAX;
    int best_i = INT_MAX;
    for (int n = tid; n < N; n += kThreads) {
      const float d = sq_dist3(sx[n], sy[n], sz[n], px, py, pz);
      const float m = fminf(min_d[n], d);
      min_d[n] = m;
      const float cand = selectable[n] ? m : -1.0f;
      if (cand > best_v) {  // n rises within a thread: ties keep the lower
        best_v = cand;
        best_i = n;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best_v, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      argmax_merge(best_v, best_i, ov, oi);
    }
    if (lane == 0) {
      warp_v[warp] = best_v;
      warp_i[warp] = best_i;
    }
    __syncthreads();
    if (tid == 0) {
      float v = warp_v[0];
      int i = warp_i[0];
      for (int w = 1; w < kWarps; ++w) argmax_merge(v, i, warp_v[w], warp_i[w]);
      last_pick = i;
    }
    __syncthreads();
  }
  for (int g = tid; g < G; g += kThreads) fps_out[b * G + g] = picks[g];

  // ---- phase 2: kNN rows, one warp per centre
  for (int g = warp; g < G; g += kWarps) {
    const int c = picks[g];
    const float px = sx[c], py = sy[c], pz = sz[c];
    float prev_d = -FLT_MAX;
    int prev_i = -1;
    int* out = knn_out + (static_cast<size_t>(b) * G + g) * S;
    for (int j = 0; j < S; ++j) {
      // smallest (distance, index) strictly after the previous pick
      float bd = FLT_MAX;
      int bi = INT_MAX;
      for (int n = lane; n < N; n += 32) {
        const float d = sq_dist3(sx[n], sy[n], sz[n], px, py, pz);
        if (lex_less(prev_d, prev_i, d, n) && lex_less(d, n, bd, bi)) {
          bd = d;
          bi = n;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, bd, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (lex_less(od, oi, bd, bi)) {
          bd = od;
          bi = oi;
        }
      }
      if (lane == 0) out[j] = bi;
      prev_d = bd;
      prev_i = bi;
    }
  }
}

}  // namespace

PDAE_EXPORT int patchify_smem_bytes(int N) { return 17 * N; }

PDAE_EXPORT int patchify(const float* pts, int B, int N, int G, int S,
                         int* fps_out, int* knn_out, void* stream) {
  if (G > 1024 || S > N || G > N) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(patchify_smem_bytes(N));
  cudaError_t err = set_smem(patchify_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  patchify_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pts, N, G, S, fps_out, knn_out);
  return static_cast<int>(cudaGetLastError());
}
