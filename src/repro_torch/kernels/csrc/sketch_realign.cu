// sketch_realign: S_U = U Rᵀ (K x m, f32) on the bf16 tensor cores for the
// bf16 calls whose rows start only 2-byte aligned: U and R both bf16,
// 1 <= K <= 64, any m >= 1 and n >= 1, any row strides and pointers
// (kernels/sketch.py::_body: "realign" where _mma_eligible fails on
// alignment or n % 8 — an odd n, n % 8 != 0, a view 2 bytes into its
// buffer, a row stride that is no multiple of 8).  Before this body those
// calls ran cross.cuh's CUDA-core loop (sketch.cu), 3.3 ms at K = 8,
// m = 1024, n = 2^20 + 3.
//
// Replaces, for these calls, the Pallas TPU kernel
// repro/kernels/sketch.py:39 sketch_apply_pallas (_sketch_kernel), as
// sketch_mma.cu does for the aligned ones.  What bounds it on the H100 is
// the same: the bytes of R and U read once, (m + K)·n·2 B at 3.35 TB/s
// (K = 8, m = 1024, n = 2^20 + 3: 646 µs; K = 64, m = 256, n = 2^22 + 3:
// 801 µs), against 17 and 139 µs of tensor work.
//
// The hard part is the staging.  cp.async and TMA copy only from 4/8/16-byte
// aligned sources (TMA also wants 16-byte row strides), and ldmatrix reads
// 16-byte aligned rows of shared memory, so a row that starts 2 bytes past a
// 16-byte boundary cannot be copied as it lies.  Each row r has its own
// shift s_r = (address of its first entry / 2) mod 8, fixed for the call
// (a tile starts a multiple of 128 entries in); a thread finds the shifts
// of its rows once and keeps them, 4 bits a row, in one register.  The body
// keeps sketch_mma.cu's grid, fragments, k-step order and finish
// (sketch_mma.cuh, kRealign) and changes only how a tile reaches its slot:
//
//   1. Land.  For each staged row, cp.async the aligned-down 16-byte chunks
//      that cover the tile's 128 columns: entries base - s .. base - s + 135
//      of the row, 17 chunks where s != 0 and 16 where s = 0, into the same
//      272-byte staged row (the 17th chunk fills its 16-byte pad, which
//      ldmatrix never reads).  A chunk is read only if it starts before the
//      block's last column col1 (so no read starts past the row's last
//      entry); else cp.async zero-fills it.  The first chunk of a row
//      starts up to 14 bytes before the row, inside the 16-byte granule
//      that holds its first entry.
//   2. Realign, in place: the 16 threads of a row are a half-warp; lane l
//      reads chunks l and l + 1 of two rows, the warp syncs, lane l writes
//      chunk l of each: words q = s / 2 on picked by a tree of selects on
//      the bits of s, a funnel shift by half a word for an odd s, and on the
//      last tile of a range the entries at or past col1 masked to zero (the
//      bytes of other rows or past the tensor in a row's first and last
//      granules fall outside the shifted window or past col1).  Rows with
//      s = 0 whose tile ends inside the range are left as they landed.
//   3. Padding rows are zeroed once, as sketch_mma.cu does; columns past n
//      are zero by the mask (n % 8 != 0) or by the zero-fill.
//
// At NB = 1 (K <= 8, two blocks an SM) a tile lands, every warp realigns
// its rows, a barrier, then the mma, in sketch_mma.cu's ring of 3.  At
// NB >= 2 shared memory holds one block an SM whatever the ring, so these
// instances take a ring of 4, realign tile tt + 1 right after the mma of
// tile tt (one barrier a tile, two tiles in flight) and run 16 warps: two
// to each row tile of R, each over half of U's row groups, so the landing
// and the pass are spread over twice the warps.  Every output tile meets
// the same mma sequence in every instance.
//
// So wherever n % 8 == 0 every staged tile holds what sketch_mma.cu stages
// from an aligned copy of the same values, the loop and the finish are the
// same, and so are the bits (tests/test_torch_cuda.py holds them equal on
// views 2·s bytes into their buffers).
//
// Tried on the H100 in exploratory builds and not kept (µs a call by CUDA
// events at K = 8, m = 1024 / K = 64, m = 256, n = 2^20 + 3 / 2^22 + 3
// beside the kept build's ancestors in the same call, NVIDIA H100 80GB
// HBM3, 700 W):
//   - a pass a half-warp a row with its shift recomputed from the row's
//     pointer, one row at a time (1 132 / 2 670 against 839 / 1 140 with
//     the pass left out): a latency-bound loop even over rows it skips;
//   - the word picked by a chain of selects on s / 2 (~60 instructions a
//     chunk; 1 013 against 850 with the tree and no mask on full tiles);
//   - rows paired 8 apart (one shift a warp) with a switch on s: 920-961
//     against 847-851 with the tree;
//   - a second barrier after the pass at NB >= 2 (1 620-1 685 against
//     1 472 realigned ahead by 16 warps);
//   - the neighbour's chunk by four shuffles instead of a second 16-byte
//     shared load (933 / 1 597 against 876 / 1 485), and no __syncwarp at
//     all (a timing build only: 872 / 1 468, no gain).
//   - A register path (an aligned 16-byte ld.global a lane, the next lane's
//     chunk by a shuffle) was not built: it holds its next stage's loads in
//     registers beside the 64 accumulators of NB = 8, where the cp.async
//     ring holds none.
//
// What is left at NB = 8 (K = 64: ~1.5x sketch_mma.cu's aligned twin; the
// landing alone, the pass left out, costs ~9 %: 1 124-1 134 against
// 1 023-1 033) is shared memory's rate.  A tile of 192 staged rows
// moves ~400 KB through it on an SM (the landing 52 KB, the pass 147 KB:
// two 16-byte reads and a write a chunk, the 16 warps' ldmatrix ~200 KB),
// ~3 100 clocks at 128 bytes a clock, about the 1.9 µs its 49 KB take
// from HBM.  At NB = 1 the pass moves 105 KB of a tile's ~190 KB and two
// blocks an SM overlap it with the other's copies (~1.15x the aligned
// twin, 849-876 against 730-769, the landing ~4 % of it).

#include "sketch_mma.cuh"

// Resident blocks per SM of the realigning partial kernel for K rows of U
// (1 <= K <= 64) and the number of 128-row slices of R's m rows.  Returns a
// CUDA error code.
extern "C" int sketch_realign_launch_config(int K, int m, int* blocks_per_sm,
                                            long long* slices) {
  return tc_launch_config<true>(K, m, blocks_per_sm, slices);
}

// U (K, n) and R (m, n) bf16 with rows ldu / ldr entries apart (any), each
// row starting at least 2-byte aligned, 1 <= K <= 64, n >= 1; partial holds
// partial_floats >= ceil(m/128)·num_blocks·128·8·ceil(K/8) f32; S (K, m)
// f32 contiguous.  num_blocks column ranges of cols_per_block (a multiple of
// 128) cover n.  Anything else: cudaErrorInvalidValue.  Returns
// cudaGetLastError() after the launches on `stream`.
extern "C" int sketch_realign_launch(const void* U, long long ldu, int K,
                                     const void* R, long long ldr, int m,
                                     long long n, void* partial,
                                     long long partial_floats, int num_blocks,
                                     long long cols_per_block, void* S,
                                     void* stream) {
  if (reinterpret_cast<uintptr_t>(U) % 2 != 0 ||
      reinterpret_cast<uintptr_t>(R) % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return tc_launch<true>(U, ldu, K, R, ldr, m, n, partial, partial_floats,
                         num_blocks, cols_per_block, S, stream);
}
