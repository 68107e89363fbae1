// Hopper warpgroup products (wgmma.mma_async, sm_90a) through inline PTX:
// m64n128k16, bf16 operands from shared memory, f32 accumulators in
// registers, both operands in the 128-byte swizzled layout.
//
// Operand layouts in shared memory (bf16; each layout is 1024-byte aligned):
//   K-major  (rows along M or N, 64 k a row): row r of the tile at r * 128
//     bytes, its 16-byte chunk c at chunk c ^ (r % 8). Descriptor: SBO 1024
//     (8 rows), LBO unused (16); a k16 step adds 32 bytes to the start.
//   MN-major (rows along k, 64 M or N a row): blocks of 64 columns, each
//     (k rows) x 128 bytes with the same chunk swizzle; descriptor SBO 1024
//     (8 k rows), LBO the block stride; a k16 step adds 16 rows (2048 bytes).
// The instruction's transpose bits select MN-major (1) or K-major (0) for A
// and for B.
//
// Accumulator of m64nNk16 (f32): in warp w of the warpgroup, lane l holds
// d[4j + i] at row 16 w + l / 4 + 8 (i / 2), column 8 j + 2 (l % 4) + i % 2.
#pragma once

#include <cstdint>

__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_byte_addr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (smem_byte_addr & 0x3FFFFu) >> 4;
  d |= uint64_t((lbo >> 4) & 0x3FFFu) << 16;
  d |= uint64_t((sbo >> 4) & 0x3FFFu) << 32;
  d |= uint64_t(1) << 62;  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Writes to shared memory by the threads (cp.async included) made visible
// to the wgmma unit, which reads through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous product (its wait is not tied to the registers).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A (64 x 16) B (16 x 128); TA / TB: 1 for an MN-major operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %66, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(1));
}
