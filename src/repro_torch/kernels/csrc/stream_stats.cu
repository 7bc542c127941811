// stream_stats: G = D Dᵀ and C = D GMᵀ (P x P each, f32) in one pass over the
// n columns of a round's stacked updates D and gradient estimates GM.
//
// Replaces the Pallas TPU kernel repro/kernels/stream.py::stream_stats_pallas
// (_stream_stats_kernel), which walks (P, block_n) tiles of both streams
// through VMEM and carries (G, C) across the sequential grid of one TPU
// core, after padding P to 8 rows and n to a block_n multiple.  That pad is
// an O(P·n) copy of the inputs, which the streamed round engine exists to
// avoid, so the reference runs it only on aligned shapes.  Here the body is
// the shared cross product of cross.cuh with A = D, B = [D; GM] and `sym`:
// G's slices below the diagonal are left out and mirrored, D's rows of a
// diagonal slice are staged once, and each (P, width) slab goes in as it
// lies, a strided view of a stacked leaf, with no pad and no copy.  Two
// calls give bitwise-equal results (no float atomics); with `accumulate` the
// finish pass adds into G and C, so a round's slabs sum in slab order.
//
// What bounds it on the H100: the bytes of D and GM, read once — 2·P·n·s
// for s-byte entries — against 3.35 TB/s, and the product's FMAs:
// P(P+1)/2 for G's upper triangle and P² for C per column at 67 TFLOP/s f32
// on the CUDA cores.  At the transformer width (P = 16, bf16, n = 58.7 M)
// that is 1.12 ms of bytes against 0.69 ms of FMAs; at P = 16 a slice
// stages only 32 rows, so the kernel takes 256 columns per step to keep its
// FMAs per synchronisation up.  Shared memory (two 16-byte reads per 16
// FMAs) is this design's own limit; at the paper's P = 100 and n = 7 850 it
// is launch-bound.

#include "cross.cuh"

namespace {

Problem stream_problem(const void* D, long long ldd, int d_bf16,
                       const void* GM, long long ldg, int g_bf16, int P,
                       long long n) {
  Problem p;
  p.a = rows_of(D, P, ldd, d_bf16);
  p.b1 = p.a;
  p.b2 = rows_of(GM, P, ldg, g_bf16);
  p.sym = 1;
  p.n = n;
  return p;
}

}  // namespace

// Resident blocks per SM of the partial kernel and the number of slices for
// P rows.  Returns a CUDA error code.
extern "C" int stream_stats_launch_config(int P, int* blocks_per_sm,
                                          long long* slices) {
  const Problem p = stream_problem(nullptr, 1, 0, nullptr, 1, 0, P, 1);
  if (P < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cross_launch_config(p, blocks_per_sm, slices));
}

// D and GM (P, n), rows ldd / ldg elements apart, f32 or bf16 each; G and C
// (P, P) f32 contiguous, written (or added to, with accumulate).  partial
// holds slices * num_blocks * 4096 f32.  Returns cudaGetLastError() after
// the launches on `stream`.
extern "C" int stream_stats_launch(const void* D, long long ldd, int d_bf16,
                                   const void* GM, long long ldg, int g_bf16,
                                   int P, long long n, void* partial,
                                   long long partial_floats, int num_blocks,
                                   long long cols_per_block, void* G, void* C,
                                   int accumulate, void* stream) {
  const Problem p = stream_problem(D, ldd, d_bf16, GM, ldg, g_bf16, P, n);
  return static_cast<int>(cross_run(
      p, static_cast<float*>(partial), partial_floats, num_blocks,
      cols_per_block, static_cast<float*>(G), P, static_cast<float*>(C), P,
      accumulate, static_cast<cudaStream_t>(stream)));
}
