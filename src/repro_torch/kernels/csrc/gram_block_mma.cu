// gram_block_mma: G_ab = U_a U_bᵀ (Ka x Kb) and c_a = U_a g (Ka) in f32 on
// the bf16 tensor cores, one pass over the n columns, for the calls
// kernels/gram.py::_block_mma_eligible accepts: U_a, U_b and g all bf16,
// 1 <= Ka <= 64, 1 <= Kb <= 63, n % 8 == 0, the three pointers 16-byte
// aligned and both row strides multiples of 8 entries (so every row starts
// 16-byte aligned).  Every other call (f32 or mixed inputs, larger Ka or
// Kb, ragged n, unaligned views) runs gram_block.cu.
//
// Replaces the Pallas TPU kernel repro/kernels/gram.py::gram_block_pallas
// (_gram_block_kernel), as gram_block.cu does, with the same deterministic
// two-pass split reduction: the grid is one wave of blocks, each over one
// contiguous column range (gram.grid, whole 128-column granules), and a
// finish kernel sums the blocks' partials in block order.
//
// What bounds it on the H100: the bytes of U_a, U_b and g, read once —
// (Ka + Kb + 1)·n·2 B at 3.35 TB/s, 972 µs at Ka = 64, Kb = 32 for
// n = 2^24.  The product stays far under that on the tensor cores: per 16
// columns MA·NB mma.sync m16n8k16 (20 at Ka = 64, Kb = 32), 8.6e10 flops
// at n = 2^24, 0.09 ms at the 989 TFLOP/s bf16 peak.  gram_block.cu runs
// cross.cuh's body, which widens bf16 to f32 and multiplies on the CUDA
// cores out of shared memory (two 16-byte shared reads per 16 FMAs), so it
// is bound there, not by the bytes.
//
// Operands.  A = U_a padded with zero rows to 16·MA rows (MA = ceil(Ka/16),
// 1..4) and B = [U_b; g] padded to 8·NB rows (NB = ceil((Kb+1)/8), 1..8),
// each read from its own pointer and row stride, so U_a and U_b may be row
// blocks of one matrix.  Row Kb of B is g, so c_a is column Kb of A Bᵀ, as
// in gram_block.cu.  One instance per (MA, NB): 32 in all.
//
// Reading.  A block stages (16·MA + 8·NB) x 128 bf16 tiles, A's rows then
// B's, in shared memory with 16-byte cp.async copies (L1 bypassed) in a
// ring of 3 stages, the next two tiles in flight while one is multiplied.
// The padding rows are zeroed once in every stage and never copied; the
// ragged last tile's chunks past n are zero-filled by cp.async (source
// size 0), with no global read.  So each byte of U_a, U_b and g is read
// from device memory once.  A staged row is 128 + 8 entries apart (272
// bytes), so the eight 16-byte rows of each 8 x 8 matrix that ldmatrix
// reads fall in distinct banks.  At Ka = 64, Kb = 32 one stage is 28 KB
// (85 KB a block, two blocks an SM).
//
// Fragments.  A and B are both [row][column] rows: m16n8k16's "row.col"
// case, so ldmatrix needs no .trans.  Tile (i, j) takes A rows 16i..16i+15
// (ldmatrix.x4: rows 0-7 and 8-15 of columns 0-7, then of columns 8-15,
// which are a0..a3) and B rows 8j..8j+7 (ldmatrix.x2: columns 0-7 and 8-15,
// b0 and b1).
//
// Work split.  The output is all MA x NB (16 x 8) tiles of A Bᵀ (no
// triangle, unlike gram), dealt to the block's 8 warps in row-major order,
// ceil(MA·NB / 8) consecutive tiles a warp (4 at Ka = 64, Kb = 63), so a
// warp's tiles share their A rows: per k-step a warp loads A once for each
// of its row tiles and B once for each tile.  No two warps share a tile:
// there is no reduction across warps.  The deal is compile-time (each warp
// runs its own instance of the stage pass, mma.cuh's for_warp), so a
// warp's pass is straight-line code and all the fragment loads of a k-step
// issue before its mma (a deal decided at run time left each mma waiting
// on its own ldmatrix in gram_mma: 2.9x slower).
//
// Accuracy and order.  Each step of 256 columns (2 stages) runs into zeroed
// accumulators, which a plain add then folds into f32 running sums: no f32
// chain runs over more than one step's columns.  Each block writes its
// (16·MA x 8·NB) partial, and gram_block_mma_finish sums the partials in
// block order in f64 and rounds once to f32, so the sum over the blocks
// (264-527 at n = 2^24) adds no f32 rounding of its own.  No float
// atomics: two calls on one card are bitwise equal.

#include <atomic>
#include <utility>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxMA = 4;           // 16·MA <= 64 rows of A: Ka <= 64
constexpr int kMaxNB = 8;           // 8·NB <= 64 rows of B: Kb <= 63
constexpr int kCols = 128;          // columns of one stage: 256 bytes a row
constexpr int kStride = kCols + 8;  // staged row stride in entries (272 bytes)
constexpr int kStages = 3;          // ring of staged tiles
constexpr int kChunks = kCols / 8;  // 16-byte chunks of a staged row
constexpr int kStepStages = 256 / kCols;  // stages of one accuracy step
constexpr int kFinishThreads = 128;
static_assert(kWarps == 8, "for_warp deals to 8 warps");

constexpr int ma_of(int Ka) { return (Ka + 15) / 16; }
constexpr int nb_of(int Kb) { return (Kb + 1 + 7) / 8; }
constexpr int smem_bytes_of(int MA, int NB) {
  return kStages * (16 * MA + 8 * NB) * kStride * (int)sizeof(__nv_bfloat16);
}

// The deal of the MA x NB tiles (i, j) to the warps: row-major, TW
// consecutive tiles a warp.  All compile-time: a warp's pass over its
// tiles unrolls into straight-line code with no branch.
template <int MA, int NB>
struct Deal {
  static constexpr int NT = MA * NB;
  static constexpr int TW = (NT + kWarps - 1) / kWarps;
  __host__ __device__ static constexpr int row(int q) { return q / NB; }
  __host__ __device__ static constexpr int col(int q) { return q % NB; }
  __host__ __device__ static constexpr int count(int w) {  // tiles of warp w
    return NT - w * TW <= 0 ? 0 : NT - w * TW < TW ? NT - w * TW : TW;
  }
};

// A lane's ldmatrix row addresses, in bytes into a stage: for A (x4) row
// lane % 16 of a row tile, columns 8·(lane / 16) on; for B (x2) row lane % 8
// of a column group, columns 8·(lane / 8 % 2) on.
struct LaneOffsets {
  unsigned a, b;
};

template <int MA, int NB, int W, int T, int I0, int R>
__device__ __forceinline__ void tile_mma(float (&acc)[4],
                                         const unsigned (&a)[R][4],
                                         const unsigned (&b)[2]) {
  constexpr int i = Deal<MA, NB>::row(W * Deal<MA, NB>::TW + T) - I0;
  mma_bf16(acc, a[i][0], a[i][1], a[i][2], a[i][3], b[0], b[1]);
}

// One staged tile through warp W's tiles: per 16-column k-step the A
// fragments of the warp's R row tiles, the B fragments of its tiles, then
// one mma a tile into `step`.  B's rows start at row 16·MA of the stage.
template <int MA, int NB, int W, int... T>
__device__ __forceinline__ void warp_stage(
    unsigned stage, LaneOffsets lo, float (&step)[Deal<MA, NB>::TW][4],
    std::integer_sequence<int, T...>) {
  using D = Deal<MA, NB>;
  constexpr int I0 = D::row(W * D::TW);
  constexpr int R = D::row(W * D::TW + D::count(W) - 1) - I0 + 1;
#pragma unroll
  for (int ks = 0; ks < kCols / 16; ++ks) {
    unsigned a[R][4], b[sizeof...(T)][2];
#pragma unroll
    for (int r = 0; r < R; ++r)
      ldmatrix_x4(a[r], stage + lo.a + 16 * (I0 + r) * kStride * 2 + 32 * ks);
    (ldmatrix_x2(b[T], stage + lo.b +
                           (16 * MA + 8 * D::col(W * D::TW + T)) * kStride * 2 +
                           32 * ks),
     ...);
    (tile_mma<MA, NB, W, T, I0, R>(step[T], a, b[T]), ...);
  }
}

// Warp W's tiles into the block's (16·MA x 8·NB) partial: entry r of tile
// (i, j)'s fragment is row 16i + lane/4 + 8(r/2), column 8j + 2(lane%4) +
// r%2.
template <int MA, int NB, int W, int... T>
__device__ __forceinline__ void warp_write(
    float* out, int lane, const float (&run)[Deal<MA, NB>::TW][4],
    std::integer_sequence<int, T...>) {
  using D = Deal<MA, NB>;
  auto write = [&](int i, int j, const float (&acc)[4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      out[(16 * i + (lane >> 2) + 8 * (r >> 1)) * 8 * NB + 8 * j +
          2 * (lane & 3) + (r & 1)] = acc[r];
  };
  (write(D::row(W * D::TW + T), D::col(W * D::TW + T), run[T]), ...);
}

// One block per column range [col0, col1) of cols_per_block (a multiple of
// kCols); its partial at partial + blockIdx.x·(16·MA)·(8·NB).
template <int MA, int NB>
__global__ void __launch_bounds__(kThreads, 2)
gram_block_mma_partial(const __nv_bfloat16* __restrict__ Ua, long long lda,
                       int Ka, const __nv_bfloat16* __restrict__ Ub,
                       long long ldb, int Kb,
                       const __nv_bfloat16* __restrict__ g, long long n,
                       long long cols_per_block, float* __restrict__ partial) {
  using D = Deal<MA, NB>;
  constexpr int RA = 16 * MA;  // staged rows of A; B's follow
  constexpr int RB = 8 * NB;
  constexpr int TW = D::TW;
  constexpr int kStageBytes = (RA + RB) * kStride * (int)sizeof(__nv_bfloat16);
  extern __shared__ uint4 smem[];
  const unsigned smem0 = smem_addr(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long col0 = (long long)blockIdx.x * cols_per_block;
  const long long col1 = col0 + cols_per_block < n ? col0 + cols_per_block : n;
  const int num_tiles = col1 > col0 ? (int)((col1 - col0 + kCols - 1) / kCols) : 0;

  // padding rows Ka .. RA-1 of A and Kb+1 .. RB-1 of B in every stage:
  // zero, once
  constexpr int kRowChunks = kStride * (int)sizeof(__nv_bfloat16) / 16;
  const int pad_a = RA - Ka;
  const int pads = pad_a + RB - Kb - 1;
  for (int c = tid; c < kStages * pads * kRowChunks; c += kThreads) {
    const int s = c / (pads * kRowChunks);
    const int p = c % (pads * kRowChunks) / kRowChunks;
    const int row = p < pad_a ? Ka + p : RA + Kb + 1 + (p - pad_a);
    smem[(s * kStageBytes + row * kStride * 2) / 16 + c % kRowChunks] =
        make_uint4(0u, 0u, 0u, 0u);
  }

  // stage tile tt of the block's range into ring slot st: the Ka rows of A
  // and the Kb + 1 rows of B, kChunks 16-byte chunks a row, those past col1
  // zero-filled
  auto load_tile = [&](int tt, int st) {
    const long long base = col0 + (long long)tt * kCols;
    const unsigned dst = smem0 + st * kStageBytes;
    for (int c = tid; c < (Ka + Kb + 1) * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int part = c % kChunks;
      const long long col = base + 8 * part;
      const int rb = r - Ka;
      const __nv_bfloat16* row = rb < 0    ? Ua + (long long)r * lda
                                 : rb < Kb ? Ub + (long long)rb * ldb
                                           : g;
      const int srow = rb < 0 ? r : RA + rb;
      const bool in = col < col1;
      cp_async16(dst + (srow * kStride + 8 * part) * 2, row + (in ? col : 0),
                 in ? 16 : 0);
    }
  };

  const LaneOffsets lo = {
      ((lane & 15) * kStride + 8 * (lane >> 4)) * 2u,
      ((lane & 7) * kStride + 8 * ((lane >> 3) & 1)) * 2u};
  float run[TW][4], step[TW][4];
#pragma unroll
  for (int t = 0; t < TW; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) run[t][r] = step[t][r] = 0.f;

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
    for_warp(warp, [&](auto w) {
      constexpr int W = decltype(w)::value;
      if constexpr (D::count(W) > 0)
        warp_stage<MA, NB, W>(stage, lo, step,
                              std::make_integer_sequence<int, D::count(W)>{});
    });
    if (tt % kStepStages == kStepStages - 1 || tt == num_tiles - 1) {
#pragma unroll
      for (int t = 0; t < TW; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          run[t][r] += step[t][r];
          step[t][r] = 0.f;
        }
    }
  }
  cp_async_wait<0>();

  float* out = partial + (long long)blockIdx.x * RA * RB;
  for_warp(warp, [&](auto w) {
    constexpr int W = decltype(w)::value;
    if constexpr (D::count(W) > 0)
      warp_write<MA, NB, W>(out, lane, run,
                            std::make_integer_sequence<int, D::count(W)>{});
  });
}

// One thread per entry (i, j) of the Ka x (Kb+1) matrix [G_ab | c_a]: sums
// the blocks' (RA x RB) partials in block order in f64 and writes
// G_ab[i][j], or c_a[i] (j = Kb).
__global__ void gram_block_mma_finish(const float* __restrict__ partial,
                                      int num_blocks, int Ka, int Kb, int RA,
                                      int RB, float* __restrict__ G,
                                      float* __restrict__ c) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = idx / (Kb + 1);
  const int j = idx % (Kb + 1);
  if (i >= Ka) return;
  const float* p = partial + i * RB + j;
  const long long per_block = (long long)RA * RB;
  double s = 0.0;
  for (int b = 0; b < num_blocks; ++b) s += p[b * per_block];
  if (j == Kb)
    c[i] = static_cast<float>(s);
  else
    G[i * Kb + j] = static_cast<float>(s);
}

using PartialKernel = void (*)(const __nv_bfloat16*, long long, int,
                               const __nv_bfloat16*, long long, int,
                               const __nv_bfloat16*, long long, long long,
                               float*);

template <int... I>
PartialKernel partial_kernel_at(int idx, std::integer_sequence<int, I...>) {
  static const PartialKernel table[] = {
      gram_block_mma_partial<I / kMaxNB + 1, I % kMaxNB + 1>...};
  return table[idx];
}

PartialKernel partial_kernel(int MA, int NB) {
  return partial_kernel_at(
      (MA - 1) * kMaxNB + NB - 1,
      std::make_integer_sequence<int, kMaxMA * kMaxNB>{});
}

// Above 48 KB of dynamic shared memory a kernel must opt in; once per
// instance and device.
cudaError_t opt_in(int MA, int NB) {
  static std::atomic<unsigned long long> opted_in[kMaxMA * kMaxNB];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  std::atomic<unsigned long long>& done = opted_in[(MA - 1) * kMaxNB + NB - 1];
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(partial_kernel(MA, NB),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes_of(MA, NB));
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

bool in_cap(int Ka, int Kb) {
  return Ka >= 1 && Ka <= 16 * kMaxMA && Kb >= 1 && Kb <= 8 * kMaxNB - 1;
}

}  // namespace

// Launch configuration of the partial kernel for these Ka, Kb (1 <= Ka <=
// 64, 1 <= Kb <= 63): its dynamic shared memory per block and the blocks
// resident per SM (the grid is sized to fill the card in one wave).
// Returns a CUDA error code.
extern "C" int gram_block_mma_launch_config(int Ka, int Kb, int* blocks_per_sm,
                                            int* smem_bytes) {
  if (!in_cap(Ka, Kb)) return static_cast<int>(cudaErrorInvalidValue);
  const int MA = ma_of(Ka), NB = nb_of(Kb);
  cudaError_t err = opt_in(MA, NB);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = smem_bytes_of(MA, NB);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, partial_kernel(MA, NB), kThreads, *smem_bytes));
}

// U_a (Ka, n) and U_b (Kb, n) bf16 with rows lda / ldb entries apart (both
// multiples of 8), g (n,) bf16, the three 16-byte aligned, 1 <= Ka <= 64,
// 1 <= Kb <= 63, n % 8 == 0; partial holds partial_floats >=
// num_blocks·(16·MA)·(8·NB) f32; G (Ka, Kb) and c (Ka,) f32 contiguous.
// num_blocks column ranges of cols_per_block (a multiple of 128) cover n.
// Anything else: cudaErrorInvalidValue.  Returns cudaGetLastError() after
// the launches on `stream`.
extern "C" int gram_block_mma_launch(const void* Ua, long long lda, int Ka,
                                     const void* Ub, long long ldb, int Kb,
                                     const void* g, long long n, void* partial,
                                     long long partial_floats, int num_blocks,
                                     long long cols_per_block, void* G,
                                     void* c, void* stream) {
  if (!in_cap(Ka, Kb)) return static_cast<int>(cudaErrorInvalidValue);
  const int MA = ma_of(Ka), NB = nb_of(Kb);
  const long long RA = 16LL * MA, RB = 8LL * NB;
  if (n < 1 || n % 8 != 0 || lda % 8 != 0 || ldb % 8 != 0 ||
      reinterpret_cast<uintptr_t>(Ua) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(Ub) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0 || num_blocks < 1 ||
      cols_per_block % kCols != 0 ||
      (long long)num_blocks * cols_per_block < n ||
      partial_floats < num_blocks * RA * RB)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in(MA, NB);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  partial_kernel(MA, NB)<<<num_blocks, kThreads, smem_bytes_of(MA, NB), st>>>(
      static_cast<const __nv_bfloat16*>(Ua), lda, Ka,
      static_cast<const __nv_bfloat16*>(Ub), ldb, Kb,
      static_cast<const __nv_bfloat16*>(g), n, cols_per_block, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int entries = Ka * (Kb + 1);
  gram_block_mma_finish<<<(entries + kFinishThreads - 1) / kFinishThreads,
                          kFinishThreads, 0, st>>>(
      p, num_blocks, Ka, Kb, (int)RA, (int)RB, static_cast<float*>(G),
      static_cast<float*>(c));
  return static_cast<int>(cudaGetLastError());
}
