// sketch: S_U = U Rᵀ (K x m, f32) against an explicit sketch matrix R (m, n),
// one pass over the n columns.
//
// Replaces the Pallas TPU kernel repro/kernels/sketch.py::sketch_apply_pallas
// (_sketch_kernel), a split-K contraction over n that pads K and m to 8 rows
// and n to a block_n multiple and carries S_U across the sequential grid of
// one TPU core.  Here the body is the shared cross product of cross.cuh with
// A = U and B = R: any K and m, no pad, f32 or bf16 each.  R is cut into
// 64-row blocks, one grid slice each, and U is staged beside every block, so
// R is read once and U once per slice (from L2 after the first).  Two calls
// give bitwise-equal results (no float atomics).
//
// What bounds it on the H100: the bytes of R and U — (m + K)·n·s for s-byte
// entries — against 3.35 TB/s, beside K·m FMAs per column at 67 TFLOP/s f32
// on the CUDA cores.  At K = 8, m = 1024, n = 2^20 + 3 in f32 that is 1.29 ms
// of bytes against 0.26 ms of FMAs.  A slice stages K + 64 rows in 64-column
// steps, and at K = 8 each thread does 128 FMAs per step, so this simple
// design is bound by its loads and synchronisations, not by the bytes.

#include "cross.cuh"

namespace {

Problem sketch_problem(const void* U, long long ldu, int u_bf16, int K,
                       const void* R, long long ldr, int r_bf16, int m,
                       long long n) {
  Problem p;
  p.a = rows_of(U, K, ldu, u_bf16);
  p.b1 = rows_of(R, m, ldr, r_bf16);
  p.b2 = rows_of(nullptr, 0, 0, 0);
  p.sym = 0;
  p.n = n;
  return p;
}

}  // namespace

// Resident blocks per SM of the partial kernel and the number of slices for
// K rows of U and m of R.  Returns a CUDA error code.
extern "C" int sketch_apply_launch_config(int K, int m, int* blocks_per_sm,
                                          long long* slices) {
  if (K < 1 || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Problem p = sketch_problem(nullptr, 1, 0, K, nullptr, 1, 0, m, 1);
  return static_cast<int>(cross_launch_config(p, blocks_per_sm, slices));
}

// U (K, n) and R (m, n) with rows ldu / ldr elements apart, f32 or bf16
// each; S (K, m) f32 contiguous.  partial holds slices * num_blocks * 4096
// f32.  Returns cudaGetLastError() after the launches on `stream`.
extern "C" int sketch_apply_launch(const void* U, long long ldu, int u_bf16,
                                   int K, const void* R, long long ldr,
                                   int r_bf16, int m, long long n,
                                   void* partial, long long partial_floats,
                                   int num_blocks, long long cols_per_block,
                                   void* S, void* stream) {
  const Problem p = sketch_problem(U, ldu, u_bf16, K, R, ldr, r_bf16, m, n);
  return static_cast<int>(cross_run(
      p, static_cast<float*>(partial), partial_floats, num_blocks,
      cols_per_block, static_cast<float*>(S), m, nullptr, 0, 0,
      static_cast<cudaStream_t>(stream)));
}
