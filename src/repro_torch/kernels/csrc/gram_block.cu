// gram_block: G_ab = U_a U_bᵀ (Ka x Kb) and c_a = U_a g (Ka) in f32, one pass
// over the n columns.
//
// Replaces the Pallas TPU kernel repro/kernels/gram.py::gram_block_pallas
// (_gram_block_kernel), which pads Ka and Kb to 8 rows and n to a block_n
// multiple and carries (G_ab, c_a) across the sequential grid of one TPU
// core.  Here the body is the shared cross product of cross.cuh with
// A = U_a and B = [U_b; g]: any Ka and Kb, no pad, rows given by pointer and
// row stride (so U_a and U_b may be row blocks of one matrix), f32 or bf16
// each.  Two calls give bitwise-equal results (no float atomics).
//
// What bounds it on the H100: the bytes of U_a, U_b and g, read once —
// (Ka + Kb + 1)·n·s for s-byte entries — against 3.35 TB/s, beside
// Ka·(Kb + 1) FMAs per column at 67 TFLOP/s f32 on the CUDA cores.  At
// Ka = 64, Kb = 32 that is 1.94 ms of bytes for n = 2^24 in f32 against
// 1.04 ms of FMAs.  A slice stages Ka + Kb + 1 <= 128 rows in 64-column
// steps; shared memory (two 16-byte reads per 16 FMAs) is this design's own
// limit.

#include "cross.cuh"

namespace {

Problem block_problem(const void* Ua, long long lda, int a_bf16, int Ka,
                      const void* Ub, long long ldb, int b_bf16, int Kb,
                      const void* g, int g_bf16, long long n) {
  Problem p;
  p.a = rows_of(Ua, Ka, lda, a_bf16);
  p.b1 = rows_of(Ub, Kb, ldb, b_bf16);
  p.b2 = rows_of(g, 1, 0, g_bf16);
  p.sym = 0;
  p.n = n;
  return p;
}

}  // namespace

// Resident blocks per SM of the partial kernel and the number of slices for
// Ka and Kb rows.  Returns a CUDA error code.
extern "C" int gram_block_launch_config(int Ka, int Kb, int* blocks_per_sm,
                                        long long* slices) {
  if (Ka < 1 || Kb < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Problem p = block_problem(nullptr, 1, 0, Ka, nullptr, 1, 0, Kb,
                                  nullptr, 0, 1);
  return static_cast<int>(cross_launch_config(p, blocks_per_sm, slices));
}

// U_a (Ka, n) and U_b (Kb, n) with rows lda / ldb elements apart, g (n,),
// f32 or bf16 each; G (Ka, Kb) and c (Ka,) f32 contiguous.  partial holds
// slices * num_blocks * 4096 f32.  Returns cudaGetLastError() after the
// launches on `stream`.
extern "C" int gram_block_launch(const void* Ua, long long lda, int a_bf16,
                                 int Ka, const void* Ub, long long ldb,
                                 int b_bf16, int Kb, const void* g, int g_bf16,
                                 long long n, void* partial,
                                 long long partial_floats, int num_blocks,
                                 long long cols_per_block, void* G, void* c,
                                 void* stream) {
  const Problem p = block_problem(Ua, lda, a_bf16, Ka, Ub, ldb, b_bf16, Kb, g,
                                  g_bf16, n);
  return static_cast<int>(cross_run(
      p, static_cast<float*>(partial), partial_floats, num_blocks,
      cols_per_block, static_cast<float*>(G), Kb, static_cast<float*>(c), 1, 0,
      static_cast<cudaStream_t>(stream)));
}
