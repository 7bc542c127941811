// The tensor-core body of gram (G = U Uᵀ and c = U g on the bf16 tensor
// cores), shared by its two sources: gram_mma.cu takes U and g whose rows
// all start 16-byte aligned (kRealign false), gram_realign.cu those whose
// rows start only 2-byte aligned (kRealign true: an odd n, n % 8 != 0, or a
// view 2 bytes into its buffer).  gram_mma.cu's header gives the design:
// operands, stages, fragments, the deal, the order; gram_realign.cu's the
// realigned staging (realign.cuh).  The two instances share the grid, the
// ring, the fragments, the k-step order, the accuracy steps and the
// finish; they differ only in how a tile reaches its ring slot, so on the
// same values (n % 8 == 0) they stage the same tiles, meet the same mma
// sequence and give the same bits.

#pragma once

#include <atomic>
#include <utility>

#include "common.cuh"
#include "mma.cuh"
#include "realign.cuh"

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
static_assert(kCols == kRealignCols, "realign.cuh stages 128-column tiles");

constexpr int mt_of(int K) { return (K + 1 + 15) / 16; }
// The realigning instances at MT = 5, 6 realign each tile one ahead,
// beside the mma of the one before, in a ring of one more stage (two
// blocks an SM still fit the shared memory); elsewhere, and in the aligned
// instance, the ring stays at 3 (gram_realign.cu's header gives the times
// of both at every MT up to 6).
__host__ __device__ constexpr bool ahead_of(int MT, bool realign) {
  return realign && MT >= 5 && MT <= 6;
}
__host__ __device__ constexpr int ring_of(int MT, bool realign) {
  return ahead_of(MT, realign) ? kStages + 1 : kStages;
}
constexpr int smem_bytes_of(int MT, bool realign) {
  return ring_of(MT, realign) * 16 * MT * kStride * (int)sizeof(__nv_bfloat16);
}
// The blocks an SM the realigning instance is built for: the aligned
// instance's residency (ptxas gives it 64 registers at MT <= 2, four blocks
// an SM; 72-80 at MT = 3, 4, three; more above, two), so that the two
// share the grid gram.grid sizes from the aligned one and with it the bits.
__host__ __device__ constexpr int realign_blocks_of(int MT) {
  return MT <= 2 ? 4 : MT <= 4 ? 3 : 2;
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
// Row r of E = [U; g] is U + r·n for r < K and g for r = K.
template <int MT, bool kRealign>
__global__ void __launch_bounds__(kThreads,
                                  kRealign ? realign_blocks_of(MT) : 2)
gram_mma_partial(const __nv_bfloat16* __restrict__ U,
                 const __nv_bfloat16* __restrict__ g, int K, long long n,
                 long long cols_per_block, float* __restrict__ partial) {
  using D = Deal<MT>;
  constexpr int Kp = 16 * MT;
  constexpr int TW = D::TW;
  constexpr bool kAhead = ahead_of(MT, kRealign);
  constexpr int kRing = ring_of(MT, kRealign);
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
  for (int c = tid; c < kRing * (Kp - K - 1) * kRowChunks; c += kThreads) {
    const int s = c / ((Kp - K - 1) * kRowChunks);
    const int rc = c % ((Kp - K - 1) * kRowChunks);
    smem[(s * kStageBytes + (K + 1 + rc / kRowChunks) * kStride * 2) / 16 +
         rc % kRowChunks] = make_uint4(0u, 0u, 0u, 0u);
  }

  // Thread t stages chunk t % 16 of rows t / 16 + kRowStep·it (it < MT) of
  // every tile.  kRealign: each such row's shift, found once, 4 bits an it
  // (realign.cuh's codes: 8 | shift inside rows 0..K, 0 past them).
  constexpr int kRowStep = kThreads / kChunks;
  constexpr int kIters = Kp / kRowStep;
  const int part = tid % kChunks;
  auto row_of = [&](int i) { return i < K ? U + (long long)i * n : g; };
  unsigned shifts = 0;
  if constexpr (kRealign) {
    for (int it = 0, i = tid / kChunks; it < kIters && i < K + 1;
         ++it, i += kRowStep)
      shifts |= shift_code(row_of(i)) << (4 * it);
  }

  // stage tile tt of the block's range into ring slot st: rows 0..K of E,
  // kChunks 16-byte chunks a row, those past col1 zero-filled (kRealign:
  // the aligned-down chunks, 17 where a row's shift is not 0;
  // realign_tile then shifts them into place)
  auto load_tile = [&](int tt, int st) {
    const long long base = col0 + (long long)tt * kCols;
    const unsigned dst = smem0 + st * kStageBytes;
    if constexpr (kRealign) {
      for (int it = 0, i = tid / kChunks; i < K + 1; ++it, i += kRowStep)
        land_chunk<true>(dst + (i * kStride + 8 * part) * 2, row_of(i), base,
                         (int)(shifts >> (4 * it)) & 7, part, col1);
    } else {
      for (int c = tid; c < (K + 1) * kChunks; c += kThreads) {
        const int r = c / kChunks;
        const int part = c % kChunks;
        const long long col = base + 8 * part;
        const __nv_bfloat16* row = r < K ? U + (long long)r * n : g;
        const bool in = col < col1;
        cp_async16(dst + (r * kStride + 8 * part) * 2, row + (in ? col : 0),
                   in ? 16 : 0);
      }
    }
  };

  // kRealign: every staged row of slot st whose shift is not 0, or whose
  // tile ends past col1, rewritten in place, the entries past col1 zeroed
  auto realign_tile = [&](int tt, int st) {
    uint4* const slot = smem + st * Kp * kRowChunks + part;
    realign_rows<kIters>(shifts, col1 - (col0 + (long long)tt * kCols), part,
                         [&](int it) {
                           return slot + (tid / kChunks + kRowStep * it) *
                                             kRowChunks;
                         });
  };

  const LaneOffsets lo = {
      ((lane & 15) * kStride + 8 * (lane >> 4)) * 2u,
      ((lane & 7) * kStride + 8 * ((lane >> 3) & 1)) * 2u};
  float run[TW][4], step[TW][4];
#pragma unroll
  for (int t = 0; t < TW; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) run[t][r] = step[t][r] = 0.f;

  // Aligned, and realigning at MT <= 4 or >= 7: tile tt lands, then
  // (kRealign) every warp realigns its rows of it and a barrier, then the
  // mma.  Realigning at MT = 5, 6 (kAhead): tile tt + 1 is realigned right
  // after the mma of tile tt, in its shadow, and the barrier at the top of
  // the next step covers both; two tiles stay in flight in the ring of four.
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < num_tiles) load_tile(s, s);
    cp_async_commit();
  }
  if constexpr (kAhead) {
    if (num_tiles > 0) {
      cp_async_wait<kRing - 2>();
      __syncthreads();  // tile 0 has landed
      realign_tile(0, 0);
    }
  }
  for (int tt = 0; tt < num_tiles; ++tt) {
    cp_async_wait<kAhead ? kRing - 3 : kRing - 2>();
    __syncthreads();  // tile tt (kAhead: tt + 1) has landed; every warp is
                      // done with tt - 1 (kAhead: and has realigned tt)
    if (tt + kRing - 1 < num_tiles)
      load_tile(tt + kRing - 1, (tt + kRing - 1) % kRing);
    cp_async_commit();
    if constexpr (kRealign && !kAhead) {
      realign_tile(tt, tt % kRing);
      __syncthreads();  // every row of tile tt in place
    }
    const unsigned stage = smem0 + (tt % kRing) * kStageBytes;
    for_warp(warp, [&](auto w) {
      constexpr int W = decltype(w)::value;
      if constexpr (D::count(W) > 0)
        warp_stage<MT, W>(stage, lo, step,
                          std::make_integer_sequence<int, D::count(W)>{});
    });
    if constexpr (kAhead) {
      if (tt + 1 < num_tiles) realign_tile(tt + 1, (tt + 1) % kRing);
    }
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

template <bool kRealign, int... I>
PartialKernel partial_kernel_at(int idx, std::integer_sequence<int, I...>) {
  static const PartialKernel table[] = {gram_mma_partial<I + 1, kRealign>...};
  return table[idx];
}

template <bool kRealign>
PartialKernel partial_kernel(int MT) {
  return partial_kernel_at<kRealign>(
      MT - 1, std::make_integer_sequence<int, kMaxMT>{});
}

// Above 48 KB of dynamic shared memory a kernel must opt in (MT >= 4);
// once per instance and device.
template <bool kRealign>
cudaError_t opt_in(int MT) {
  static std::atomic<unsigned long long> opted_in[kMaxMT + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (opted_in[MT].load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(partial_kernel<kRealign>(MT),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes_of(MT, kRealign));
  if (err == cudaSuccess) opted_in[MT].fetch_or(bit);
  return err;
}

// Dynamic shared memory per block and resident blocks per SM of the partial
// kernel for this K (1 <= K <= 127).  Returns a CUDA error code.
template <bool kRealign>
int tc_launch_config(int K, int* blocks_per_sm, int* smem_bytes) {
  if (K < 1 || K > 16 * kMaxMT - 1) return static_cast<int>(cudaErrorInvalidValue);
  const int MT = mt_of(K);
  cudaError_t err = opt_in<kRealign>(MT);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = smem_bytes_of(MT, kRealign);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, partial_kernel<kRealign>(MT), kThreads, *smem_bytes));
}

// The partial kernel over num_blocks blocks, then the finish, on `stream`,
// after the checks both sources share (the caller checked the alignment
// and n its instance needs).  Returns cudaGetLastError().
template <bool kRealign>
int tc_launch(const void* U, const void* g, void* partial,
              long long partial_floats, void* G, void* c, int K, long long n,
              int num_blocks, long long cols_per_block, void* stream) {
  const long long Kp = 16LL * mt_of(K);
  if (K < 1 || K > 16 * kMaxMT - 1 || n < 1 || num_blocks < 1 ||
      cols_per_block % kCols != 0 ||
      (long long)num_blocks * cols_per_block < n ||
      partial_floats < num_blocks * Kp * Kp)
    return static_cast<int>(cudaErrorInvalidValue);
  const int MT = mt_of(K);
  cudaError_t err = opt_in<kRealign>(MT);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  partial_kernel<kRealign>(MT)<<<num_blocks, kThreads,
                                 smem_bytes_of(MT, kRealign), st>>>(
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

}  // namespace
