// sketch_mma: S_U = U Rᵀ (K x m, f32) against an explicit sketch matrix R
// (m, n) on the bf16 tensor cores, one pass over the n columns, for the
// calls kernels/sketch.py::_mma_eligible accepts: U and R both bf16,
// 1 <= K <= 64, any m >= 1, n % 8 == 0, both pointers 16-byte aligned and
// both row strides multiples of 8 entries (so every row starts 16-byte
// aligned).  Every other call (f32 or mixed inputs, K > 64, ragged n,
// unaligned views) runs sketch.cu.
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

#include <atomic>
#include <utility>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSliceRows = 16 * kWarps;  // rows of R a block: a tile a warp
constexpr int kMaxNB = 8;           // 8·NB <= 64 rows of U: K <= 64
constexpr int kCols = 128;          // columns of one stage: 256 bytes a row
constexpr int kStride = kCols + 8;  // staged row stride in entries (272 bytes)
constexpr int kStages = 3;          // ring of staged tiles
constexpr int kChunks = kCols / 8;  // 16-byte chunks of a staged row
constexpr int kStepStages = 256 / kCols;  // stages of one accuracy step
constexpr int kFinishThreads = 128;

constexpr int nb_of(int K) { return (K + 7) / 8; }
constexpr int smem_bytes_of(int NB) {
  return kStages * (kSliceRows + 8 * NB) * kStride * (int)sizeof(__nv_bfloat16);
}

// One staged tile through a warp's NB tiles: per 16-column k-step the A
// fragment of its row tile of R, the B fragments of U's NB row groups, then
// one mma a tile into `step`.  a_addr and b_addr are the lane's ldmatrix
// addresses in the stage for k-step 0.
template <int NB>
__device__ __forceinline__ void warp_stage(unsigned a_addr, unsigned b_addr,
                                           float (&step)[NB][4]) {
#pragma unroll
  for (int ks = 0; ks < kCols / 16; ++ks) {
    unsigned a[4], b[NB][2];
    ldmatrix_x4(a, a_addr + 32 * ks);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      ldmatrix_x2(b[j], b_addr + 8 * j * kStride * 2 + 32 * ks);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      mma_bf16(step[j], a[0], a[1], a[2], a[3], b[j][0], b[j][1]);
  }
}

// Block s·num_blocks + b covers columns [b·cols_per_block, +cols_per_block)
// of rows 128s .. 128s+127 of R; its partial, S_Uᵀ of those rows as a
// (128 x 8·NB) f32 matrix, lies at partial + (s·num_blocks + b)·128·8·NB.
template <int NB>
__global__ void __launch_bounds__(kThreads, 2)
sketch_mma_partial(const __nv_bfloat16* __restrict__ U, long long ldu, int K,
                   const __nv_bfloat16* __restrict__ R, long long ldr, int m,
                   long long n, int num_blocks, long long cols_per_block,
                   float* __restrict__ partial) {
  constexpr int RB = 8 * NB;  // staged rows of U, after R's kSliceRows
  constexpr int kStageBytes =
      (kSliceRows + RB) * kStride * (int)sizeof(__nv_bfloat16);
  extern __shared__ uint4 smem[];
  const unsigned smem0 = smem_addr(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row0 = (long long)(blockIdx.x / num_blocks) * kSliceRows;
  const int rows = m - row0 < kSliceRows ? (int)(m - row0) : kSliceRows;
  const __nv_bfloat16* Rs = R + row0 * ldr;
  const long long col0 =
      (long long)(blockIdx.x % num_blocks) * cols_per_block;
  const long long col1 = col0 + cols_per_block < n ? col0 + cols_per_block : n;
  const int num_tiles =
      col1 > col0 ? (int)((col1 - col0 + kCols - 1) / kCols) : 0;

  // padding rows rows .. 127 of R and K .. RB-1 of U in every stage: zero,
  // once
  constexpr int kRowChunks = kStride * (int)sizeof(__nv_bfloat16) / 16;
  const int pad_r = kSliceRows - rows;
  const int pads = pad_r + RB - K;
  for (int c = tid; c < kStages * pads * kRowChunks; c += kThreads) {
    const int s = c / (pads * kRowChunks);
    const int p = c % (pads * kRowChunks) / kRowChunks;
    const int row = p < pad_r ? rows + p : kSliceRows + K + (p - pad_r);
    smem[(s * kStageBytes + row * kStride * 2) / 16 + c % kRowChunks] =
        make_uint4(0u, 0u, 0u, 0u);
  }

  // stage tile tt of the block's range into ring slot st: the slice's rows
  // of R and the K rows of U, kChunks 16-byte chunks a row, those past col1
  // zero-filled
  auto load_tile = [&](int tt, int st) {
    const long long base = col0 + (long long)tt * kCols;
    const unsigned dst = smem0 + st * kStageBytes;
    for (int c = tid; c < (rows + K) * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int part = c % kChunks;
      const long long col = base + 8 * part;
      const int ru = r - rows;
      const __nv_bfloat16* row = ru < 0 ? Rs + (long long)r * ldr
                                        : U + (long long)ru * ldu;
      const int srow = ru < 0 ? r : kSliceRows + ru;
      const bool in = col < col1;
      cp_async16(dst + (srow * kStride + 8 * part) * 2, row + (in ? col : 0),
                 in ? 16 : 0);
    }
  };

  // the lane's ldmatrix rows: for A (x4) row lane % 16 of the warp's row
  // tile, columns 8·(lane / 16) on; for B (x2) row lane % 8 of U's first
  // row group, columns 8·(lane / 8 % 2) on
  const unsigned a_off =
      ((16 * warp + (lane & 15)) * kStride + 8 * (lane >> 4)) * 2u;
  const unsigned b_off =
      ((kSliceRows + (lane & 7)) * kStride + 8 * ((lane >> 3) & 1)) * 2u;
  const bool has_rows = 16 * warp < rows;
  float run[NB][4], step[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) run[j][r] = step[j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < num_tiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int tt = 0; tt < num_tiles; ++tt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile tt has landed; every warp is done with tt - 1
    if (tt + kStages - 1 < num_tiles)
      load_tile(tt + kStages - 1, (tt + kStages - 1) % kStages);
    cp_async_commit();
    const unsigned stage = smem0 + (tt % kStages) * kStageBytes;
    if (has_rows) warp_stage<NB>(stage + a_off, stage + b_off, step);
    if (tt % kStepStages == kStepStages - 1 || tt == num_tiles - 1) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          run[j][r] += step[j][r];
          step[j][r] = 0.f;
        }
    }
  }
  cp_async_wait<0>();

  // entry r of tile (warp, j)'s fragment is row 16·warp + lane/4 + 8(r/2),
  // column 8j + 2(lane%4) + r%2 of the partial
  float* out = partial + (long long)blockIdx.x * kSliceRows * RB;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      out[(16 * warp + (lane >> 2) + 8 * (r >> 1)) * RB + 8 * j +
          2 * (lane & 3) + (r & 1)] = run[j][r];
}

// One thread per entry (k, j) of S (K x m), k fastest so that neighbouring
// threads read neighbouring partial entries: sums the num_blocks partials
// of row j's slice in block order in f64 and writes S[k][j] once.
__global__ void sketch_mma_finish(const float* __restrict__ partial,
                                  int num_blocks, int K, int m, int RB,
                                  float* __restrict__ S) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)K * m) return;
  const int j = (int)(idx / K);
  const int k = (int)(idx % K);
  const long long per_block = (long long)kSliceRows * RB;
  const float* p = partial +
                   (long long)(j / kSliceRows) * num_blocks * per_block +
                   (long long)(j % kSliceRows) * RB + k;
  double s = 0.0;
  for (int b = 0; b < num_blocks; ++b) s += p[b * per_block];
  S[(long long)k * m + j] = static_cast<float>(s);
}

using PartialKernel = void (*)(const __nv_bfloat16*, long long, int,
                               const __nv_bfloat16*, long long, int, long long,
                               int, long long, float*);

template <int... I>
PartialKernel partial_kernel_at(int idx, std::integer_sequence<int, I...>) {
  static const PartialKernel table[] = {sketch_mma_partial<I + 1>...};
  return table[idx];
}

PartialKernel partial_kernel(int NB) {
  return partial_kernel_at(NB - 1, std::make_integer_sequence<int, kMaxNB>{});
}

// Above 48 KB of dynamic shared memory a kernel must opt in; once per
// instance and device.
cudaError_t opt_in(int NB) {
  static std::atomic<unsigned long long> opted_in[kMaxNB];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  std::atomic<unsigned long long>& done = opted_in[NB - 1];
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(partial_kernel(NB),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes_of(NB));
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

long long slices_of(int m) { return (m + kSliceRows - 1) / kSliceRows; }

bool in_cap(int K, int m) { return K >= 1 && K <= 8 * kMaxNB && m >= 1; }

}  // namespace

// Resident blocks per SM of the partial kernel for K rows of U (1 <= K <=
// 64) and the number of 128-row slices of R's m rows (the grid is sized to
// fill the card in one wave).  Returns a CUDA error code.
extern "C" int sketch_mma_launch_config(int K, int m, int* blocks_per_sm,
                                        long long* slices) {
  if (!in_cap(K, m)) return static_cast<int>(cudaErrorInvalidValue);
  const int NB = nb_of(K);
  cudaError_t err = opt_in(NB);
  if (err != cudaSuccess) return static_cast<int>(err);
  *slices = slices_of(m);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, partial_kernel(NB), kThreads, smem_bytes_of(NB)));
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
  if (!in_cap(K, m)) return static_cast<int>(cudaErrorInvalidValue);
  const int NB = nb_of(K);
  const long long RB = 8LL * NB;
  const long long slices = slices_of(m);
  if (n < 1 || n % 8 != 0 || ldu % 8 != 0 || ldr % 8 != 0 ||
      reinterpret_cast<uintptr_t>(U) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(R) % 16 != 0 || num_blocks < 1 ||
      cols_per_block % kCols != 0 ||
      (long long)num_blocks * cols_per_block < n ||
      slices * num_blocks > 0x7fffffffLL ||
      partial_floats < slices * num_blocks * kSliceRows * RB)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in(NB);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  partial_kernel(NB)<<<(unsigned)(slices * num_blocks), kThreads,
                       smem_bytes_of(NB), st>>>(
      static_cast<const __nv_bfloat16*>(U), ldu, K,
      static_cast<const __nv_bfloat16*>(R), ldr, m, n, num_blocks,
      cols_per_block, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long entries = (long long)K * m;
  sketch_mma_finish<<<(unsigned)((entries + kFinishThreads - 1) /
                                 kFinishThreads),
                      kFinishThreads, 0, st>>>(p, num_blocks, K, m, (int)RB,
                                               static_cast<float*>(S));
  return static_cast<int>(cudaGetLastError());
}
