// The furthest point sampling loop, shared by csrc/fps.cu (the FPS kernel)
// and csrc/patchify.cu (the FPS phase of the fused patchify).
//
// Replaces the FPS loops of point_dae_tpu/ops/pallas_fps.py:fps_pallas_batched
// and fps_pallas, and phase 1 of pallas_patchify.py:fused_patchify_pallas.
//
// Conventions of every version: the first pick is index 0; a point with
// (x*x + y*y) + z*z <= 1e-3 is never picked; each iteration moves
// min_d = min(min_d, (dx*dx + dy*dy) + dz*dz) and picks the argmax of min_d
// over the selectable points (the others count as -1), ties to the lowest
// index, as jnp.argmax and torch.argmax resolve them. Every product and sum
// is a round-to-nearest intrinsic in that order (no FMA), so the picks equal
// the plain PyTorch version's bit for bit: FPS is chaotic, and one different
// pick changes every later one.
//
// What bounds it on the H100: not bytes (12 B a point, once) and not
// operations (about 9 f32 operations a point an iteration), but the chain of
// n serial iterations: each ends in a reduction over the whole cloud and a
// barrier, and the next one needs its winner. Two things set an iteration's
// time: the issue cost of the update (about 12 warp instructions for every
// 32 points on one SM) and the latency of the reduction. The design cuts both:
//  - the key: a selectable point's min_d >= 0 is compared as the signed int
//    of its bits (the float order), an unselectable one holds min_d = -1.0f,
//    a negative int below every selectable key; a point past N holds -1.0f
//    too and loses every tie on its index. (key, index) pack into one u64,
//    the key's bits with the sign flipped above the index's complement, so
//    that the larger u64 is the larger key, then the lower index;
//  - a thread's candidate: the larger key of its points in a tree of
//    depth log2(PPT) (the lower j, so the lower index, on a tie), not a chain
//    of PPT dependent compares;
//  - a block's winner: one redux.sync max of the key a warp; the lane
//    holding it (the lowest index among the lanes holding it, by one more
//    redux.sync, at a tie) writes its packed u64 into the warp's slot; after
//    one barrier every thread reads the eight slots (four 16-byte loads) and
//    takes the largest in a tree of three compares, then the winner's
//    coordinates from the block's copy of its points. The slots are
//    double-buffered, so that one barrier an iteration suffices: a warp
//    writes a buffer again two iterations later, after the barrier that
//    follows every read of it. (A shared-memory atomicMax of the u64 would
//    need no slots, but on the H100 it is a compare-and-swap loop, slow when
//    eight warps contend for one word);
//  - a cloud over the C blocks of a thread-block cluster (C = 2, 4 or 8),
//    where the update's issue cost outweighs the exchange: each block keeps
//    its share of the points in registers and finds its winner as above;
//    the thread owning it sends (packed u64, coordinates) into every block's
//    candidate slots with st.async, which signals the receiving block's
//    mbarrier (complete_tx); each block waits on its own mbarrier and takes
//    the largest of the C candidates. Slots and mbarriers are double-
//    buffered: a block sends iteration it + 2 only after it received every
//    block's iteration it + 1, which each block sends after it has read its
//    slots of iteration it; and the block re-arms its mbarrier (one arrival
//    with the expected bytes) before it sends its own next candidate;
//  - at most 256 threads a block, with up to 32 points a thread.
// A block holds at most 8192 points (256 threads x 32), a cluster of 8 at
// most 65536; above, the streamed form keeps each point as one float4
// (x, y, z, min_d) in a scratch buffer and streams it every iteration.
#pragma once

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace fps_loop {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;                   // most threads a block (register form)
constexpr int kWarps = kThreads / 32;
constexpr int kStreamThreads = kThreads;        // the streamed form's one block
constexpr int kStreamBatch = 16;                // points a thread loads at once, streamed
constexpr unsigned kCandBytes = 8 + 16;         // a candidate: packed u64 and a float4

// The larger key, then the lower index, is the larger value.
__device__ __forceinline__ unsigned long long pack(int key, unsigned idx) {
  return static_cast<unsigned long long>(static_cast<unsigned>(key) ^ 0x80000000u) << 32 | ~idx;
}

__device__ __forceinline__ unsigned index_of(unsigned long long v) {
  return ~static_cast<unsigned>(v);
}

// A block's shared state: the warps' double-buffered slots and, in a
// cluster, the double-buffered candidate slots and their mbarriers.
template <int C>
struct State {
  alignas(16) unsigned long long slot[2][kWarps];
  float4 cand_pt[2][C];
  unsigned long long cand[2][C];
  unsigned long long full[2];   // mbarriers
};

__device__ __forceinline__ unsigned long long umax64(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

// The largest key among a thread's points and its j, the lower j on a tie.
template <int PPT>
__device__ __forceinline__ void thread_best(const float (&md)[PPT], int& best, int& jb) {
  int k[PPT], jj[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    k[j] = __float_as_int(md[j]);
    jj[j] = j;
  }
#pragma unroll
  for (int s = 1; s < PPT; s *= 2)
#pragma unroll
    for (int j = 0; j + s < PPT; j += 2 * s)
      if (k[j + s] > k[j]) {   // strict: the lower j stays on a tie
        k[j] = k[j + s];
        jj[j] = jj[j + s];
      }
  best = k[0];
  jb = jj[0];
}

// The warp's candidate into its slot: the largest key, then the lowest index.
__device__ __forceinline__ void warp_slot(unsigned long long* slot, int key, unsigned idx) {
  const int wkey = __reduce_max_sync(kFull, key);
  const unsigned tied = __ballot_sync(kFull, key == wkey);
  bool writes = (threadIdx.x & 31) == __ffs(tied) - 1;
  if (tied & (tied - 1))   // two lanes hold the key (the same for the whole warp)
    writes = idx == __reduce_min_sync(kFull, key == wkey ? idx : 0xffffffffu);
  if (writes) *slot = pack(key, idx);
}

// After the barrier: the largest of the kWarps slots (a slot no warp writes
// holds 0, below every candidate).
__device__ __forceinline__ unsigned long long block_best(const unsigned long long* slot) {
  const ulonglong2* s2 = reinterpret_cast<const ulonglong2*>(slot);
  const ulonglong2 a = s2[0], b = s2[1], c = s2[2], d = s2[3];
  static_assert(kWarps == 8, "block_best reads eight slots");
  return umax64(umax64(umax64(a.x, a.y), umax64(b.x, b.y)),
                umax64(umax64(c.x, c.y), umax64(d.x, d.y)));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n\tbarrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t in_rank(uint32_t local, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// One arrival on the local mbarrier, with the bytes its phase waits for.
__device__ __forceinline__ void arm(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n}"
      :: "r"(smem(bar)), "r"(parity) : "memory");
}

// Send a block's candidate into slot `rank` of buffer `b` of every block of
// the cluster, completing the bytes each receiving block's mbarrier waits for.
template <int C>
__device__ __forceinline__ void send(State<C>& st, int b, unsigned rank, unsigned long long v,
                                     float4 p) {
  const uint32_t cand = smem(&st.cand[b][rank]);
  const uint32_t pt = smem(&st.cand_pt[b][rank]);
  const uint32_t bar = smem(&st.full[b]);
#pragma unroll
  for (unsigned r = 0; r < C; ++r) {
    const uint32_t rbar = in_rank(bar, r);
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
                 :: "r"(in_rank(cand, r)), "l"(v), "r"(rbar) : "memory");
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
        "[%5];"
        :: "r"(in_rank(pt, r)), "r"(__float_as_uint(p.x)), "r"(__float_as_uint(p.y)),
           "r"(__float_as_uint(p.z)), "r"(__float_as_uint(p.w)), "r"(rbar) : "memory");
  }
}

__device__ __forceinline__ float initial_min_d(float x, float y, float z) {
  const float mag = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
  return mag > 1e-3f ? 1e10f : -1.0f;
}

// Register form: the FPS of one cloud over the C blocks of a cluster (C == 1:
// one block). Thread t of block r holds the points n = r * nt + t + j * C * nt,
// j < PPT (nt = blockDim.x <= kThreads), and its block keeps their
// coordinates in spts[j * nt + t] (PPT * nt float4 of dynamic shared
// memory; with C == 1 that is spts[n]). Block 0 writes the picks.
template <int PPT, int C>
__device__ __forceinline__ void run(const float* __restrict__ cloud, int N, int n_samples,
                                    int* __restrict__ picks, float4* __restrict__ spts,
                                    State<C>& st) {
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const unsigned rank = C > 1 ? cluster_rank() : 0u;
  const int stride = C * nt;
  const int first = static_cast<int>(rank) * nt + tid;
  const bool writer = rank == 0 && tid == 0;

  float x[PPT], y[PPT], z[PPT], md[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int n = first + j * stride;
    x[j] = y[j] = z[j] = 0.0f;
    md[j] = -1.0f;   // never picked; a point past N also loses every tie (its index)
    if (n < N) {
      x[j] = cloud[3 * n];
      y[j] = cloud[3 * n + 1];
      z[j] = cloud[3 * n + 2];
      spts[j * nt + tid] = make_float4(x[j], y[j], z[j], 0.0f);
      md[j] = initial_min_d(x[j], y[j], z[j]);
    }
  }
  if (tid < 2 * kWarps) st.slot[tid / kWarps][tid % kWarps] = 0ull;
  if (tid == 0) {
    if constexpr (C > 1) {
      for (int b = 0; b < 2; ++b) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem(&st.full[b]))
                     : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      arm(&st.full[0], C * kCandBytes);
      arm(&st.full[1], C * kCandBytes);
    }
  }
  // every block's slots and mbarriers are ready before anyone uses them
  if constexpr (C > 1) cluster_sync();
  else __syncthreads();

  float px = cloud[0], py = cloud[1], pz = cloud[2];   // the first pick, index 0
  if (writer) picks[0] = 0;
  unsigned parity = 0;   // bit b: the phase of mbarrier b to wait for
  for (int it = 1; it < n_samples; ++it) {
#pragma unroll
    for (int j = 0; j < PPT; ++j)
      md[j] = fminf(md[j], sq_dist3(x[j], y[j], z[j], px, py, pz));
    int best, jb;
    thread_best(md, best, jb);
    const unsigned mine = static_cast<unsigned>(first + jb * stride);
    const int b = it & 1;
    warp_slot(&st.slot[b][tid >> 5], best, mine);
    __syncthreads();
    const unsigned long long v = block_best(st.slot[b]);
    unsigned w = index_of(v);
    float4 p;
    if constexpr (C == 1) {
      p = spts[w];
    } else {
      if (mine == w) send<C>(st, b, rank, v, spts[jb * nt + tid]);
      wait(&st.full[b], (parity >> b) & 1u);
      parity ^= 1u << b;
      if (tid == 0) arm(&st.full[b], C * kCandBytes);   // for iteration it + 2
      unsigned long long m = st.cand[b][0];
      int src = 0;
#pragma unroll
      for (int r = 1; r < C; ++r) {
        const unsigned long long c = st.cand[b][r];
        if (c > m) {
          m = c;
          src = r;
        }
      }
      w = index_of(m);
      p = st.cand_pt[b][src];
    }
    px = p.x;
    py = p.y;
    pz = p.z;
    if (writer) picks[it] = static_cast<int>(w);
  }
  // no block leaves while another may still send into its slots
  if constexpr (C > 1) cluster_sync();
}

// Streamed form, one block of kStreamThreads, any N: point n is buf[n] =
// (x, y, z, min_d), min_d = -1 for a point that is never picked; a thread
// takes its points in ascending n, so ties keep the lower index.
__device__ __forceinline__ void run_stream(const float* __restrict__ cloud, int N, int n_samples,
                                           int* __restrict__ picks, float4* __restrict__ buf,
                                           State<1>& st) {
  const int tid = threadIdx.x;
  for (int n = tid; n < N; n += kStreamThreads) {
    const float x = cloud[3 * n], y = cloud[3 * n + 1], z = cloud[3 * n + 2];
    buf[n] = make_float4(x, y, z, initial_min_d(x, y, z));
  }
  if (tid < 2 * kWarps) st.slot[tid / kWarps][tid % kWarps] = 0ull;
  __syncthreads();   // buf[w] below is any thread's point
  float px = cloud[0], py = cloud[1], pz = cloud[2];
  if (tid == 0) picks[0] = 0;
  for (int it = 1; it < n_samples; ++it) {
    int best = INT_MIN;   // a thread past N proposes nothing: INT_MIN packs below every point
    unsigned mine = 0;
    for (int n0 = tid; n0 < N; n0 += kStreamBatch * kStreamThreads) {
      float4 q[kStreamBatch];   // loaded together, then taken in ascending n
#pragma unroll
      for (int u = 0; u < kStreamBatch; ++u) {
        const int n = n0 + u * kStreamThreads;
        q[u] = n < N ? buf[n] : make_float4(0.f, 0.f, 0.f, -1.f);
      }
#pragma unroll
      for (int u = 0; u < kStreamBatch; ++u) {
        const int n = n0 + u * kStreamThreads;
        if (n < N) {
          if (q[u].w >= 0.0f) {
            q[u].w = fminf(q[u].w, sq_dist3(q[u].x, q[u].y, q[u].z, px, py, pz));
            buf[n].w = q[u].w;
          }
          const int key = __float_as_int(q[u].w);
          if (key > best) {
            best = key;
            mine = static_cast<unsigned>(n);
          }
        }
      }
    }
    const int b = it & 1;
    warp_slot(&st.slot[b][tid >> 5], best, mine);
    __syncthreads();
    const unsigned w = index_of(block_best(st.slot[b]));
    const float4 p = buf[w];   // its x, y, z were written before the first barrier
    px = p.x;
    py = p.y;
    pz = p.z;
    if (tid == 0) picks[it] = static_cast<int>(w);
  }
}

// Dynamic shared memory of the register form: each point's float4.
inline size_t smem_bytes(int threads, int ppt) {
  return static_cast<size_t>(threads) * ppt * sizeof(float4);
}

// Launch `kernel` over `blocks` blocks in clusters of C (C == 1: an ordinary
// launch). A refused launch returns its error: there is no fallback.
template <typename... Params, typename... Args>
inline cudaError_t launch(void (*kernel)(Params...), int C, int blocks, int threads, size_t smem,
                          cudaStream_t stream, Args... args) {
  // the static State counts against the 48 KB too
  if (smem > 40 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (C == 1) {
    kernel<<<blocks, threads, smem, stream>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The clusters of C blocks of `kernel` that the card can hold at once.
template <typename... Params>
inline int cluster_slots(void (*kernel)(Params...), int C, int threads, size_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * 256);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

// A plan's (points a thread, cluster size) as template arguments: Launch<PPT,
// C>::run(args...). The plans ops/fps.py:plan makes: PPT 4, 8, 16 or 32; C 1,
// 2, 4 or 8.
template <template <int, int> class Launch, int PPT, typename... Args>
inline cudaError_t by_cluster(int C, Args... args) {
  switch (C) {
    case 1: return Launch<PPT, 1>::run(args...);
    case 2: return Launch<PPT, 2>::run(args...);
    case 4: return Launch<PPT, 4>::run(args...);
    case 8: return Launch<PPT, 8>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <template <int, int> class Launch, typename... Args>
inline cudaError_t by_plan(int ppt, int C, Args... args) {
  switch (ppt) {
    case 4: return by_cluster<Launch, 4>(C, args...);
    case 8: return by_cluster<Launch, 8>(C, args...);
    case 16: return by_cluster<Launch, 16>(C, args...);
    case 32: return by_cluster<Launch, 32>(C, args...);
    default: return cudaErrorInvalidValue;
  }
}

// Whether a register-form plan holds N points and fits a block.
inline bool plan_ok(int N, int C, int threads, int ppt) {
  return threads >= 32 && threads <= kThreads && threads % 32 == 0 &&
         static_cast<long long>(C) * threads * ppt >= N;
}

}  // namespace fps_loop
