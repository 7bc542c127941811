// gram_realign: G = U Uᵀ (K x K) and c = U g (K) in f32 on the bf16 tensor
// cores for the bf16 calls whose rows start only 2-byte aligned: U and g
// both bf16, 1 <= K <= 127, any n >= 1 and any pointers
// (kernels/gram.py::_body: "realign" where _mma_eligible fails on n % 8 or
// on alignment — an odd n, a view 2 bytes into its buffer).  Before this
// body those calls ran gram.cu's CUDA-core loop, which widens bf16 to f32
// and is bound by its FMAs, its global loads scalar (343.9 µs at K = 64,
// n = 2^20 + 3, against torch.matmul's 193.8).
//
// Replaces, for these calls, the Pallas TPU kernel
// repro/kernels/gram.py:104 gram_pallas (_gram_kernel), as gram_mma.cu does
// for the aligned ones.  What bounds it on the H100 is the same: the bytes
// of U and g read once, (K+1)·n·2 B at 3.35 TB/s (K = 64, n = 2^20 + 3:
// 40.7 µs; K = 10: 6.9 µs).
//
// It keeps gram_mma.cu's grid, fragments, deal, k-step order, accuracy
// steps and finish (gram_mma.cuh, kRealign) and changes only how a tile
// reaches its slot (realign.cuh): row r of E = [U; g] (U + r·n for r < K,
// g for r = K) has its own shift s_r = (address / 2) mod 8, found once a
// thread and kept 4 bits a row in one register; each tile lands the
// aligned-down 16-byte chunks of each row (17 where s_r != 0, the 17th in
// the staged row's pad), none that starts at or past the block's last
// column col1 (the last row of U and g end at their allocation), then
// every warp shifts its rows into place in shared memory and masks the
// entries at or past col1 on the last tile.  The padding rows K+1 .. Kp-1
// are zeroed once, as in gram_mma.cu.
//
// The ring.  At MT <= 4 and MT >= 7 a tile lands, every warp realigns it, a
// barrier, then the mma, in gram_mma.cu's ring of 3.  At MT = 5, 6 the ring
// holds 4 tiles and tile tt + 1 is realigned right after the mma of tile
// tt (one barrier a tile, two tiles in flight); two blocks an SM still fit
// (4 x 96 x 272 B = 104 KB at MT = 6; at MT = 7 a block would need 122 KB).
// Timed both ways by benchmarks/torch_gram_realign.py (a build with the
// ring of 4 at every MT <= 6 beside one with the ring of 3 at every MT, µs
// a call by CUDA events, the best of four rounds taken in turn at
// n = 2^24 + 3, NVIDIA H100 80GB HBM3, 700.00 W): ring of 4 / ring of 3 =
// 1.037 (K = 1), 0.984 (10), 0.999 (16), 1.033 (31), 1.034 (32), 1.042
// (47), 1.047 (48), 1.035 (63), 0.951 (64: 1 108.0 against 1 165.6),
// 0.949 (79), 0.962 (80), 0.970 (95).  Where the pass is short beside the
// copies (MT <= 4, three or four blocks an SM) the other blocks' copies
// hide it and waiting for two landed tiles costs more; at MT = 5, 6 (two
// blocks an SM) realigning in the previous tile's shadow pays.
//
// Same grid, same bits: the wrapper sizes the grid from the aligned
// instance's occupancy (gram.grid with gram_mma_launch_config's blocks an
// SM), and this instance is built for the same residency
// (realign_blocks_of: ptxas gives it 51-56 registers at MT <= 2, 70-76 at
// MT = 3, 4, where the aligned one has 64 and 72-80), so wherever
// n % 8 == 0 every staged tile holds what gram_mma.cu stages from an
// aligned copy of the same values, the loop and the finish are the same,
// and so are the bits (tests/test_torch_cuda.py holds them equal on views
// 2·s bytes into their buffers).
//
// What is left (the same runs): the shipped build takes 1.17-1.49x the
// aligned twin's time at n = 2^24 (1.479x at K = 64), as the pass moves
// every shifted row's chunks through shared memory once more (two 16-byte
// reads and a write a chunk, ~44 KB a tile at K = 64 beside the landing's
// 18 KB and the fragments' ~115 KB); on rows that need no shift it costs
// 3-8 % of device time at n = 2^20 (chip_smoke.py: the realigning body
// forced on the aligned twins).  A register path (aligned 16-byte global
// loads, the neighbour's chunk by a shuffle, one shared store) would drop
// the pass's reads but hold a tile's loads in registers beside up to 128
// accumulator registers; it was not built.

#include "gram_mma.cuh"

// Dynamic shared memory per block and resident blocks per SM of the
// realigning partial kernel for this K (1 <= K <= 127); the grid is the
// aligned instance's (gram_mma_launch_config), which this one matches.
// Returns a CUDA error code.
extern "C" int gram_realign_launch_config(int K, int* blocks_per_sm,
                                          int* smem_bytes) {
  return tc_launch_config<true>(K, blocks_per_sm, smem_bytes);
}

// U (K, n) and g (n,) bf16, contiguous, each starting at least 2-byte
// aligned, 1 <= K <= 127, n >= 1; partial holds partial_floats >=
// num_blocks·Kp² f32 (Kp = 16·ceil((K+1)/16)); G (K, K) and c (K,) f32.
// num_blocks column ranges of cols_per_block (a multiple of 128) cover n.
// Anything else: cudaErrorInvalidValue.  Returns cudaGetLastError() after
// the launches on `stream`.
extern "C" int gram_realign_launch(const void* U, const void* g,
                                   void* partial, long long partial_floats,
                                   void* G, void* c, int K, long long n,
                                   int num_blocks, long long cols_per_block,
                                   void* stream) {
  if (reinterpret_cast<uintptr_t>(U) % 2 != 0 ||
      reinterpret_cast<uintptr_t>(g) % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return tc_launch<true>(U, g, partial, partial_floats, G, c, K, n,
                         num_blocks, cols_per_block, stream);
}
