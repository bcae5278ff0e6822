// Device helpers shared by the port's kernels (sm_90a): bf16 packing, warp
// and quad reductions, the bf16 mma.sync.m16n8k16 tile and the s8
// mma.sync.m16n8k32 tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ uint32_t ld_b32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A B for one 16 x 8 x 16 tile: bf16 operands, f32 accumulators.
// Fragments (g = lane / 4, t = lane % 4): a = A[g | g+8][2t.. | 2t+8..],
// b = B[2t.. | 2t+8..][g], c = C[g | g+8][2t, 2t+1].
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A B for one 16 x 8 x 32 tile: s8 operands, s32 accumulators. The
// fragments hold the same bytes as the bf16 tile's (4 int8 per register):
// a = A[g | g+8][4t.. | 4t+16..], b = B[4t.. | 4t+16..][g], c = C[g | g+8][2t, 2t+1].
__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace
