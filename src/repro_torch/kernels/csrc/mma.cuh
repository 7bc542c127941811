// PTX helpers of the bf16 tensor-core bodies (stream_stats.cu's
// stream_stats_mma and gram_mma.cu's gram_mma_partial).
#pragma once

#include "common.cuh"

namespace {

// C += A B, A 16 x 16 bf16 (row-major), B 16 x 8 bf16 (col-major), C f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A 16-byte load that leaves no line in L1.
__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

}  // namespace
