// gram_mma: G = U Uᵀ (K x K) and c = U g (K) in f32 on the bf16 tensor cores,
// one pass over the n columns, for the calls kernels/gram.py::_mma_eligible
// accepts: U and g both bf16, 1 <= K <= 127, n % 8 == 0 and both pointers
// 16-byte aligned (so every row of the contiguous U starts 16-byte aligned).
// Every other call (f32 or mixed inputs, K >= 128, ragged n, unaligned
// views) runs gram.cu.
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

#include <atomic>
#include <utility>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxMT = 8;           // Kp <= 128: K <= 127
constexpr int kCols = 128;          // columns of one stage: 256 bytes a row
constexpr int kStride = kCols + 8;  // staged row stride in entries (272 bytes)
constexpr int kStages = 3;          // ring of staged tiles
constexpr int kChunks = kCols / 8;  // 16-byte chunks of a staged row
constexpr int kStepStages = 256 / kCols;  // stages of one accuracy step
constexpr int kFinishThreads = 128;

constexpr int mt_of(int K) { return (K + 1 + 15) / 16; }
constexpr int smem_bytes_of(int MT) {
  return kStages * 16 * MT * kStride * (int)sizeof(__nv_bfloat16);
}

// The deal of the MT(MT+1) upper tiles (i, j), 8j + 7 >= 16i, to the warps:
// row-major (row tile i holds j = 2i .. 2MT-1), TW consecutive tiles a warp.
// It is all compile-time: a warp's pass over its tiles unrolls into
// straight-line code with no branch, so the fragment loads of a k-step all
// issue before its mma.
template <int MT>
struct Deal {
  static constexpr int NT = MT * (MT + 1);
  static constexpr int TW = (NT + kWarps - 1) / kWarps;
  __host__ __device__ static constexpr int row(int q) {
    int r = 0;
    while (q >= 2 * (MT - r)) {
      q -= 2 * (MT - r);
      ++r;
    }
    return r;
  }
  __host__ __device__ static constexpr int col(int q) {
    return q - first(row(q)) + 2 * row(q);
  }
  __host__ __device__ static constexpr int first(int i) {  // tile index of (i, 2i)
    return i * (2 * MT - i + 1);
  }
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

// B of warp W's T-th tile at k-step address offset `ks` (bytes): half of A's
// registers for the two tiles that hold the diagonal, else loaded.
template <int MT, int W, int T, int I0, int R>
__device__ __forceinline__ void fetch_b(unsigned (&b)[2],
                                        const unsigned (&a)[R][4],
                                        unsigned b_addr) {
  using D = Deal<MT>;
  constexpr int q = W * D::TW + T;
  constexpr int i = D::row(q) - I0;
  constexpr int j = D::col(q);
  if constexpr (j == 2 * D::row(q)) {
    b[0] = a[i][0];
    b[1] = a[i][2];
  } else if constexpr (j == 2 * D::row(q) + 1) {
    b[0] = a[i][1];
    b[1] = a[i][3];
  } else {
    ldmatrix_x2(b, b_addr + 8 * j * kStride * 2);
  }
}

template <int MT, int W, int T, int I0, int R>
__device__ __forceinline__ void tile_mma(float (&acc)[4],
                                         const unsigned (&a)[R][4],
                                         const unsigned (&b)[2]) {
  constexpr int i = Deal<MT>::row(W * Deal<MT>::TW + T) - I0;
  mma_bf16(acc, a[i][0], a[i][1], a[i][2], a[i][3], b[0], b[1]);
}

// One staged tile of E through warp W's tiles: per 16-column k-step the A
// fragments of the warp's R row tiles, the B fragments of its tiles, then
// one mma a tile into `step`.
template <int MT, int W, int... T>
__device__ __forceinline__ void warp_stage(unsigned stage, LaneOffsets lo,
                                           float (&step)[Deal<MT>::TW][4],
                                           std::integer_sequence<int, T...>) {
  using D = Deal<MT>;
  constexpr int I0 = D::row(W * D::TW);
  constexpr int R = D::row(W * D::TW + D::count(W) - 1) - I0 + 1;
#pragma unroll
  for (int ks = 0; ks < kCols / 16; ++ks) {
    unsigned a[R][4], b[sizeof...(T)][2];
#pragma unroll
    for (int r = 0; r < R; ++r)
      ldmatrix_x4(a[r], stage + lo.a + 16 * (I0 + r) * kStride * 2 + 32 * ks);
    (fetch_b<MT, W, T, I0, R>(b[T], a, stage + lo.b + 32 * ks), ...);
    (tile_mma<MT, W, T, I0, R>(step[T], a, b[T]), ...);
  }
}

// Warp W's tiles into the block's partial: entry r of tile (i, j)'s fragment
// is row 16i + lane/4 + 8(r/2), column 8j + 2(lane%4) + r%2.
template <int MT, int W, int... T>
__device__ __forceinline__ void warp_write(float* out, int lane,
                                           const float (&run)[Deal<MT>::TW][4],
                                           std::integer_sequence<int, T...>) {
  using D = Deal<MT>;
  auto write = [&](int i, int j, const float (&acc)[4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      out[(16 * i + (lane >> 2) + 8 * (r >> 1)) * 16 * MT + 8 * j +
          2 * (lane & 3) + (r & 1)] = acc[r];
  };
  (write(D::row(W * D::TW + T), D::col(W * D::TW + T), run[T]), ...);
}

static_assert(kWarps == 8, "for_warp deals to 8 warps");

// One block per column range [col0, col1) of cols_per_block (a multiple of
// kCols); its partial (Kp x Kp f32, row-major) at partial + blockIdx.x·Kp².
template <int MT>
__global__ void __launch_bounds__(kThreads, 2)
gram_mma_partial(const __nv_bfloat16* __restrict__ U,
                 const __nv_bfloat16* __restrict__ g, int K, long long n,
                 long long cols_per_block, float* __restrict__ partial) {
  using D = Deal<MT>;
  constexpr int Kp = 16 * MT;
  constexpr int TW = D::TW;
  constexpr int kStageBytes = Kp * kStride * (int)sizeof(__nv_bfloat16);
  extern __shared__ uint4 smem[];
  const unsigned smem0 = smem_addr(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long col0 = (long long)blockIdx.x * cols_per_block;
  const long long col1 = col0 + cols_per_block < n ? col0 + cols_per_block : n;
  const int num_tiles = col1 > col0 ? (int)((col1 - col0 + kCols - 1) / kCols) : 0;

  // padding rows K+1 .. Kp-1 of every stage: zero, once
  constexpr int kRowChunks = kStride * (int)sizeof(__nv_bfloat16) / 16;
  for (int c = tid; c < kStages * (Kp - K - 1) * kRowChunks; c += kThreads) {
    const int s = c / ((Kp - K - 1) * kRowChunks);
    const int rc = c % ((Kp - K - 1) * kRowChunks);
    smem[(s * kStageBytes + (K + 1 + rc / kRowChunks) * kStride * 2) / 16 +
         rc % kRowChunks] = make_uint4(0u, 0u, 0u, 0u);
  }

  // stage tile tt of the block's range into ring slot st: rows 0..K of E,
  // kChunks 16-byte chunks a row, those past col1 zero-filled
  auto load_tile = [&](int tt, int st) {
    const long long base = col0 + (long long)tt * kCols;
    const unsigned dst = smem0 + st * kStageBytes;
    for (int c = tid; c < (K + 1) * kChunks; c += kThreads) {
      const int r = c / kChunks;
      const int part = c % kChunks;
      const long long col = base + 8 * part;
      const __nv_bfloat16* row = r < K ? U + (long long)r * n : g;
      const bool in = col < col1;
      cp_async16(dst + (r * kStride + 8 * part) * 2, row + (in ? col : 0),
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
        warp_stage<MT, W>(stage, lo, step,
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

  float* out = partial + (long long)blockIdx.x * Kp * Kp;
  for_warp(warp, [&](auto w) {
    constexpr int W = decltype(w)::value;
    if constexpr (D::count(W) > 0)
      warp_write<MT, W>(out, lane, run,
                        std::make_integer_sequence<int, D::count(W)>{});
  });
}

// One thread per entry (i, j >= i) of the K x (K+1) matrix [G | c]: sums the
// blocks' partials in block order and writes G[i][j] and G[j][i], or c[i]
// (j = K).
__global__ void gram_mma_finish(const float* __restrict__ partial,
                                int num_blocks, int K, int Kp,
                                float* __restrict__ G, float* __restrict__ c) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = idx / (K + 1);
  const int j = idx % (K + 1);
  if (i >= K || j < i) return;
  const float* p = partial + i * Kp + j;
  const long long per_block = (long long)Kp * Kp;
  float s = 0.f;
  for (int b = 0; b < num_blocks; ++b) s += p[b * per_block];
  if (j == K) {
    c[i] = s;
  } else {
    G[i * K + j] = s;
    G[j * K + i] = s;
  }
}

using PartialKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, int,
                               long long, long long, float*);

PartialKernel partial_kernel(int MT) {
  switch (MT) {
    case 1: return gram_mma_partial<1>;
    case 2: return gram_mma_partial<2>;
    case 3: return gram_mma_partial<3>;
    case 4: return gram_mma_partial<4>;
    case 5: return gram_mma_partial<5>;
    case 6: return gram_mma_partial<6>;
    case 7: return gram_mma_partial<7>;
    default: return gram_mma_partial<8>;
  }
}

// Above 48 KB of dynamic shared memory a kernel must opt in (MT >= 4);
// once per instance and device.
cudaError_t opt_in(int MT) {
  static std::atomic<unsigned long long> opted_in[kMaxMT + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (opted_in[MT].load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(partial_kernel(MT),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes_of(MT));
  if (err == cudaSuccess) opted_in[MT].fetch_or(bit);
  return err;
}

}  // namespace

// Launch configuration of the partial kernel for this K (1 <= K <= 127): its
// dynamic shared memory per block and the blocks resident per SM (the grid
// is sized to fill the card in one wave).  Returns a CUDA error code.
extern "C" int gram_mma_launch_config(int K, int* blocks_per_sm,
                                      int* smem_bytes) {
  if (K < 1 || K > 16 * kMaxMT - 1) return static_cast<int>(cudaErrorInvalidValue);
  const int MT = mt_of(K);
  cudaError_t err = opt_in(MT);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = smem_bytes_of(MT);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, partial_kernel(MT), kThreads, *smem_bytes));
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
  const long long Kp = 16LL * mt_of(K);
  if (K < 1 || K > 16 * kMaxMT - 1 || n < 1 || n % 8 != 0 ||
      reinterpret_cast<uintptr_t>(U) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0 || num_blocks < 1 ||
      cols_per_block % kCols != 0 ||
      (long long)num_blocks * cols_per_block < n ||
      partial_floats < num_blocks * Kp * Kp)
    return static_cast<int>(cudaErrorInvalidValue);
  const int MT = mt_of(K);
  cudaError_t err = opt_in(MT);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  partial_kernel(MT)<<<num_blocks, kThreads, smem_bytes_of(MT), st>>>(
      static_cast<const __nv_bfloat16*>(U), static_cast<const __nv_bfloat16*>(g),
      K, n, cols_per_block, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int entries = K * (K + 1);
  gram_mma_finish<<<(entries + kFinishThreads - 1) / kFinishThreads,
                    kFinishThreads, 0, st>>>(p, num_blocks, K, (int)Kp,
                                             static_cast<float*>(G),
                                             static_cast<float*>(c));
  return static_cast<int>(cudaGetLastError());
}
