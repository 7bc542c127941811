// sketch_mma: S_U = U Rᵀ (K x m, f32) against an explicit sketch matrix R
// (m, n) on the bf16 tensor cores, one pass over the n columns, for the
// calls kernels/sketch.py::_mma_eligible accepts: U and R both bf16,
// 1 <= K <= 64, any m >= 1, n % 8 == 0, both pointers 16-byte aligned and
// both row strides multiples of 8 entries (so every row starts 16-byte
// aligned).  The other bf16 calls with K <= 64 (ragged n, unaligned views)
// run the same loop on realigned tiles (sketch_realign.cu), f32 calls
// cross_f32.cu, and mixed calls and K > 64 sketch.cu.  The body's code is
// in sketch_mma.cuh, which both tensor-core sources include.
//
// Replaces the Pallas TPU kernel repro/kernels/sketch.py::sketch_apply_pallas
// (_sketch_kernel), a split-K contraction over n that pads K and m to 8 rows,
// widens both operands to f32 before the MXU dot and carries S_U across the
// sequential grid of one TPU core.  Here, as in gram_block_mma.cu, the grid
// is one wave of blocks and a finish kernel sums the blocks' partials in
// block order: blocks run in parallel and carry nothing between them.
//
// What bounds it on the H100: the bytes of R and U, read once —
// (m + K)·n·2 B at 3.35 TB/s — beside 2·K·m·n flops at the 989 TFLOP/s
// bf16 peak.  K = 8, m = 1024, n = 2^20: 2.164 GB, 646 µs, against 17 µs of
// tensor work; K = 64, m = 256, n = 2^22: 2.684 GB, 801 µs, against 139 µs.
// sketch.cu runs cross.cuh's body, which widens bf16 to f32 and multiplies
// on the CUDA cores out of shared memory, so it is bound there (3.3 ms at
// K = 8, m = 1024, n = 2^20 + 3, in bf16 as in f32), not by the bytes.
//
// Roles.  m is large and K small (m = 1024, K = 8 at the model shape), so
// R takes the A side of m16n8k16, in 16-row tiles along m, and U the B
// side, zero-padded to 8·NB rows (NB = ceil(K/8), 1..8: one instance per
// NB, eight in all).  Each warp produces (16 x 8) tiles of S_Uᵀ; the finish
// writes them transposed.
//
// Grid.  Slices of kSliceRows = 128 rows of R (the last one short when
// m % 128 != 0) times column blocks: ceil(m / 128) slices of num_blocks
// blocks, each over a contiguous range of whole 128-column tiles, one
// resident wave in all (kernels/gram.py::grid), in a 1-D grid so that m
// has no cap.  U is staged beside every slice, so it is read once per
// slice; the slices' blocks over one column range run side by side, and
// after the first the reads of U come from L2.  At K = 8, m = 1024 that is
// 8 reads of U's 16.8 MB, 6 % on top of R's 2.15 GB, and at K = 64,
// m = 256 two reads of 537 MB.
//
// Why 128 rows a slice: one 16-row tile of R for each of the 8 warps, so a
// warp loads its A fragment once per k-step and reuses it for all NB tiles
// of U.  A stage is (128 + 8·NB) staged rows of 272 bytes, 37 KB at NB = 1
// (two blocks an SM in 108 KB each, three stages) and 52 KB at NB = 8 (one
// block an SM, still two stages, 104 KB, in flight); at NB = 8 a thread
// keeps 64 f32 accumulators, under the 128 registers of two blocks an SM
// (ptxas: 56 registers at NB = 1 up to 124 at NB = 8, no spills).  A
// 256-row slice would halve the reads of U but, at 71-87 KB a stage, leave
// a single block of two stages an SM at every NB; a 64-row slice would
// leave half the warps without a tile of R.  A ring of four stages was no
// faster at either model shape on an H100, so it stays at three.
//
// Reading.  A block stages (128 + 8·NB) x 128 bf16 tiles, R's rows then
// U's, in shared memory with 16-byte cp.async copies (L1 bypassed) in a
// ring of 3 stages, the next two tiles in flight while one is multiplied.
// The padding rows (R's past the slice's last row, U's past K) are zeroed
// once in every stage and never copied; the ragged last tile's chunks past
// n are zero-filled by cp.async (source size 0), with no global read.  A
// staged row is 128 + 8 entries apart (272 bytes), so the eight 16-byte rows
// of each 8 x 8 matrix that ldmatrix reads fall in distinct banks.
//
// Fragments and work split.  R and U are both [row][column] rows:
// m16n8k16's "row.col" case, so ldmatrix needs no .trans.  Warp w owns the
// row tile w of the slice (R rows 16w..16w+15, ldmatrix.x4: a0..a3) and all
// NB tiles of U (rows 8j..8j+7, ldmatrix.x2: b0 and b1).  The deal is fixed
// at compile time: every warp runs the same straight-line pass, NB unrolled,
// with its row tile folded into its ldmatrix address, so all the fragment
// loads of a k-step issue before its mma (a deal decided at run time left
// each mma waiting on its own ldmatrix in gram_mma: 2.9x slower).  A warp
// whose row tile lies wholly past m (the last slice) skips the mma.
//
// Accuracy and order.  Each step of 256 columns (2 stages) runs into zeroed
// accumulators, which a plain add then folds into f32 running sums: no f32
// chain runs over more than one step's columns.  Each block writes its
// (128 x 8·NB) partial, and sketch_mma_finish sums a slice's partials in
// block order in f64 and rounds once to f32.  No float atomics: two calls
// on one card are bitwise equal.

#include "sketch_mma.cuh"

// Resident blocks per SM of the partial kernel for K rows of U (1 <= K <=
// 64) and the number of 128-row slices of R's m rows (the grid is sized to
// fill the card in one wave).  Returns a CUDA error code.
extern "C" int sketch_mma_launch_config(int K, int m, int* blocks_per_sm,
                                        long long* slices) {
  return tc_launch_config<false>(K, m, blocks_per_sm, slices);
}

// U (K, n) and R (m, n) bf16 with rows ldu / ldr entries apart (both
// multiples of 8), both 16-byte aligned, 1 <= K <= 64, n % 8 == 0; partial
// holds partial_floats >= ceil(m/128)·num_blocks·128·8·ceil(K/8) f32; S
// (K, m) f32 contiguous.  num_blocks column ranges of cols_per_block (a
// multiple of 128) cover n.  Anything else: cudaErrorInvalidValue.
// Returns cudaGetLastError() after the launches on `stream`.
extern "C" int sketch_mma_launch(const void* U, long long ldu, int K,
                                 const void* R, long long ldr, int m,
                                 long long n, void* partial,
                                 long long partial_floats, int num_blocks,
                                 long long cols_per_block, void* S,
                                 void* stream) {
  if (n % 8 != 0 || ldu % 8 != 0 || ldr % 8 != 0 ||
      reinterpret_cast<uintptr_t>(U) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(R) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return tc_launch<false>(U, ldu, K, R, ldr, m, n, partial, partial_floats,
                          num_blocks, cols_per_block, S, stream);
}
