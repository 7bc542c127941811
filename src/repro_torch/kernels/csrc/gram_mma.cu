// gram_mma: G = U Uᵀ (K x K) and c = U g (K) in f32 on the bf16 tensor cores,
// one pass over the n columns, for the calls kernels/gram.py::_mma_eligible
// accepts: U and g both bf16, 1 <= K <= 127, n % 8 == 0 and both pointers
// 16-byte aligned (so every row of the contiguous U starts 16-byte aligned).
// The other bf16 calls with K <= 127 (an odd n, n % 8 != 0, a view 2 bytes
// into its buffer) run the same loop on realigned tiles (gram_realign.cu;
// both instances in gram_mma.cuh); f32 calls run gram_f32.cu, mixed dtypes
// and bf16 K >= 128 gram.cu.
//
// Replaces the Pallas TPU kernel repro/kernels/gram.py::gram_pallas
// (_gram_kernel), as gram.cu does, with the same deterministic two-pass
// split reduction: the grid is one wave of blocks, each over one contiguous
// column range (gram.grid, whole 128-column granules), and a finish kernel
// sums the blocks' partials in block order.
//
// What bounds it on the H100: the bytes of U and g, read once —
// (K+1)·n·2 B at 3.35 TB/s, 651 µs at K = 64 and 1 012 µs at K = 100 for
// n = 2^24.  The product stays under that on the tensor cores: per 16
// columns the (16 x 8) tiles of E Eᵀ on or above the diagonal are
// MT(MT+1) mma.sync m16n8k16 (MT = Kp / 16), 56 at K = 100, which is
// 2.4e11 flops at n = 2^24, 0.24 ms at the 989 TFLOP/s bf16 peak.  gram.cu
// widens bf16 to f32 and multiplies on the CUDA cores out of shared memory,
// so it is bound by its FMAs there, not by the bytes.
//
// Operands.  E = [U; g] padded with zero rows to Kp = 16·ceil((K+1)/16)
// rows, instantiated for MT = Kp / 16 in 1..8 (padding to 128 rows would
// put the mma work past the byte bound at K = 64).  Row K of E is g, so c
// is column K of E Eᵀ, as in gram.cu's extended matrix.
//
// Reading.  A block stages (Kp x 128) bf16 tiles of E in shared memory
// with 16-byte cp.async copies (L1 bypassed) in a ring of 3 stages, the
// next two tiles in flight while one is multiplied.  The padding rows are
// zeroed once in every stage and never copied; the ragged last tile's
// chunks past n are zero-filled by cp.async (source size 0), with no global
// read.  So each byte of U and g is read from device memory once, for every
// K <= 127.  A staged row is 128 + 8 entries apart (272 bytes), so the
// eight 16-byte rows of each 8 x 8 matrix that ldmatrix reads fall in
// distinct banks.  At K = 100 one stage is 30 KB (two blocks an SM).
// 256 bytes of a row per stage read faster than 128, however many 64-column
// stages were in flight.
//
// Fragments.  A and B of E Eᵀ are both rows of E in the same [row][column]
// layout: m16n8k16's "row.col" case, so ldmatrix needs no .trans.  A tile
// (i, j) takes rows 16i..16i+15 as A (ldmatrix.x4: rows 0-7 and 8-15 of
// columns 0-7, then of columns 8-15, which are a0..a3) and rows 8j..8j+7 as
// B (ldmatrix.x2: columns 0-7 and 8-15, b0 and b1).  B of the two tiles that
// hold the diagonal (j = 2i, 2i + 1) is half of A's registers and is not
// loaded again.
//
// Work split.  The output is the MT(MT+1) tiles (i, j) of E Eᵀ with
// 8j + 7 >= 16i, c's column among them.  They are dealt to the block's 8
// warps in row-major order, ceil(MT(MT+1) / 8) consecutive tiles a warp
// (7 a warp at K = 100), so a warp's tiles share their A rows: per k-step a
// warp loads A once for each of its row tiles and B once for each tile.
// No two warps share a tile: there is no reduction across warps.  The deal
// is compile-time (each warp runs its own instance of the stage pass), so
// a warp's pass is straight-line code and all the fragment loads of a
// k-step issue before its mma; with the deal decided at run time, a branch
// per tile kept each mma waiting on its own ldmatrix, and the product, not
// the bytes, set the time.
//
// Accuracy and order.  Each step of 256 columns (2 stages) runs into zeroed
// accumulators, which a plain add then folds into f32 running sums, as
// stream_stats_mma does: no f32 chain runs over more than one step's
// columns.  Each block writes its (Kp x Kp) partial (its tiles only), and
// gram_mma_finish sums the partials in block order, mirrors G and writes c.
// No float atomics: two calls on one card are bitwise equal.
//
// No wgmma, TMA or clusters: cp.async + ldmatrix + mma.sync reach the bytes.

#include "gram_mma.cuh"

// Launch configuration of the partial kernel for this K (1 <= K <= 127): its
// dynamic shared memory per block and the blocks resident per SM (the grid
// is sized to fill the card in one wave).  Returns a CUDA error code.
extern "C" int gram_mma_launch_config(int K, int* blocks_per_sm,
                                      int* smem_bytes) {
  return tc_launch_config<false>(K, blocks_per_sm, smem_bytes);
}

// U (K, n) and g (n,) bf16, contiguous, both 16-byte aligned, 1 <= K <= 127,
// n % 8 == 0; partial holds partial_floats >= num_blocks·Kp² f32
// (Kp = 16·ceil((K+1)/16)); G (K, K) and c (K,) f32.  num_blocks column
// ranges of cols_per_block (a multiple of 128) cover n.  Anything else:
// cudaErrorInvalidValue.  Returns cudaGetLastError() after the launches on
// `stream`.
extern "C" int gram_mma_launch(const void* U, const void* g, void* partial,
                               long long partial_floats, void* G, void* c,
                               int K, long long n, int num_blocks,
                               long long cols_per_block, void* stream) {
  if (n % 8 != 0 || reinterpret_cast<uintptr_t>(U) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return tc_launch<false>(U, g, partial, partial_floats, G, c, K, n,
                          num_blocks, cols_per_block, stream);
}
