// PTX helpers of the bf16 tensor-core bodies (stream_stats.cu's
// stream_stats_mma, gram_mma.cu's gram_mma_partial, gram_block_mma.cu's
// gram_block_mma_partial, sketch_mma.cu's sketch_mma_partial and
// decode_attn_mma.cu's decode_mma_partial); gram_f32.cu's tile body uses
// the cp.async ones.
#pragma once

#include <type_traits>

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, L1 bypassed; `bytes` = 0 writes 16 zero bytes
// and reads nothing.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// Four 8 x 8 b16 matrices, each stored as 8 rows of 16 bytes, transposed
// on the way into the fragments: a [k][n] tile in shared memory becomes
// m16n8k16's col-major B operand.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// f(std::integral_constant<int, warp>) for this thread's warp, of a block of
// 8 warps: each warp runs its own compile-time instance of f.
template <typename F>
__device__ __forceinline__ void for_warp(int warp, F&& f) {
  switch (warp) {
    case 0: f(std::integral_constant<int, 0>{}); break;
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 3: f(std::integral_constant<int, 3>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 5: f(std::integral_constant<int, 5>{}); break;
    case 6: f(std::integral_constant<int, 6>{}); break;
    default: f(std::integral_constant<int, 7>{}); break;
  }
}

}  // namespace
