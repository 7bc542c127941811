// The tensor-core body of sketch (S_U = U Rᵀ on the bf16 tensor cores),
// shared by its two sources: sketch_mma.cu takes U and R whose rows all
// start 16-byte aligned (kRealign false), sketch_realign.cu those whose rows
// start only 2-byte aligned (kRealign true).  sketch_mma.cu's header gives
// the design: roles, grid, stages, fragments, order; sketch_realign.cu's
// the realigned staging.  The two instances share the grid, the fragments,
// the k-step order, the accuracy steps and the finish; they differ in how a
// tile reaches its ring slot (and, at NB >= 2, in the ring's depth and the
// warps that share a row tile), so on the same values (n % 8 == 0) they
// stage the same tiles, meet the same mma sequence and give the same bits.
// The realigned staging's device helpers (land_chunk, realign_rows) live in
// realign.cuh, shared with gram_mma.cuh.

#pragma once

#include <atomic>
#include <utility>

#include "common.cuh"
#include "mma.cuh"
#include "realign.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSliceRows = 16 * kWarps;  // rows of R a block: a tile a warp
constexpr int kMaxNB = 8;           // 8·NB <= 64 rows of U: K <= 64
constexpr int kCols = 128;          // columns of one stage: 256 bytes a row
constexpr int kStride = kCols + 8;  // staged row stride in entries (272 bytes)
constexpr int kStages = 3;          // ring of staged tiles
constexpr int kChunks = kCols / 8;  // 16-byte chunks of a staged row
constexpr int kRowChunks = kStride / 8;   // 16-byte chunks a staged row spans
constexpr int kStepStages = 256 / kCols;  // stages of one accuracy step
constexpr int kFinishThreads = 128;
static_assert(kCols == kRealignCols, "realign.cuh stages 128-column tiles");

constexpr int nb_of(int K) { return (K + 7) / 8; }
// The realigning instances at NB >= 2 realign each tile one ahead, beside
// the mma of the one before, in a ring of one more stage (shared memory
// allows one block an SM there whatever the ring, as for the aligned
// instance); at NB = 1 (two blocks an SM) the ring stays at 3.
__host__ __device__ constexpr bool ahead_of(int NB, bool realign) {
  return realign && NB > 1;
}
__host__ __device__ constexpr int ring_of(int NB, bool realign) {
  return ahead_of(NB, realign) ? kStages + 1 : kStages;
}
// ... and run 16 warps, two to a row tile of R, each over half of U's NB
// row groups (the first ceil(NB/2), the rest), so that the landing and the
// pass are spread over twice the warps; every output tile still meets the
// same mma sequence.
__host__ __device__ constexpr int threads_of(int NB, bool realign) {
  return ahead_of(NB, realign) ? 2 * kThreads : kThreads;
}
constexpr int smem_bytes_of(int NB, bool realign) {
  return ring_of(NB, realign) * (kSliceRows + 8 * NB) * kStride *
         (int)sizeof(__nv_bfloat16);
}

// One staged tile through NT of a warp's tiles: per 16-column k-step the A
// fragment of its row tile of R, the B fragments of NT of U's row groups,
// then one mma a tile into `step` (its first NT rows).  a_addr and b_addr
// are the lane's ldmatrix addresses in the stage for k-step 0 (b_addr at
// the warp's first row group).
template <int NT, int NA>
__device__ __forceinline__ void warp_stage(unsigned a_addr, unsigned b_addr,
                                           float (&step)[NA][4]) {
#pragma unroll
  for (int ks = 0; ks < kCols / 16; ++ks) {
    unsigned a[4], b[NT][2];
    ldmatrix_x4(a, a_addr + 32 * ks);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      ldmatrix_x2(b[j], b_addr + 8 * j * kStride * 2 + 32 * ks);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mma_bf16(step[j], a[0], a[1], a[2], a[3], b[j][0], b[j][1]);
  }
}

// Block s·num_blocks + b covers columns [b·cols_per_block, +cols_per_block)
// of rows 128s .. 128s+127 of R; its partial, S_Uᵀ of those rows as a
// (128 x 8·NB) f32 matrix, lies at partial + (s·num_blocks + b)·128·8·NB.
// Two blocks an SM fit the shared memory only at NB = 1; above it the
// realigning instances' 16 warps have the registers of one block an SM,
// which leaves the occupancy, and so the grid, that of the aligned
// instance.
template <int NB, bool kRealign>
__global__ void __launch_bounds__(threads_of(NB, kRealign),
                                  kRealign && NB > 1 ? 1 : 2)
sketch_mma_partial(const __nv_bfloat16* __restrict__ U, long long ldu, int K,
                   const __nv_bfloat16* __restrict__ R, long long ldr, int m,
                   long long n, int num_blocks, long long cols_per_block,
                   float* __restrict__ partial) {
  constexpr int RB = 8 * NB;  // staged rows of U, after R's kSliceRows
  constexpr bool kAhead = ahead_of(NB, kRealign);
  constexpr int kRing = ring_of(NB, kRealign);
  constexpr int kBlock = threads_of(NB, kRealign);
  // U's row groups of the warps of the first half (all of them where the
  // block has one half) and of the second
  constexpr int NB0 = kBlock == kThreads ? NB : (NB + 1) / 2;
  constexpr int NB1 = NB - NB0;
  constexpr int kStageBytes =
      (kSliceRows + RB) * kStride * (int)sizeof(__nv_bfloat16);
  extern __shared__ uint4 smem[];
  const unsigned smem0 = smem_addr(smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5 & (kWarps - 1);  // its row tile of R
  const bool second = tid >= kThreads;       // the second half's warps
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
  const int pad_r = kSliceRows - rows;
  const int pads = pad_r + RB - K;
  for (int c = tid; c < kRing * pads * kRowChunks; c += kBlock) {
    const int s = c / (pads * kRowChunks);
    const int p = c % (pads * kRowChunks) / kRowChunks;
    const int row = p < pad_r ? rows + p : kSliceRows + K + (p - pad_r);
    smem[(s * kStageBytes + row * kStride * 2) / 16 + c % kRowChunks] =
        make_uint4(0u, 0u, 0u, 0u);
  }

  // staged row i of the slice's rows + K (R's, then U's): its first entry
  // in global memory and its row in a stage
  auto row_of = [&](int i, int* srow) {
    const int ru = i - rows;
    *srow = ru < 0 ? i : kSliceRows + ru;
    return ru < 0 ? Rs + (long long)i * ldr : U + (long long)ru * ldu;
  };

  // Thread t stages chunk t % 16 of rows t / 16 + kRowStep·it (it <
  // kIters) of every tile.  kRealign: each such row's shift, found once, 4
  // bits an it (8 | shift for a row inside rows + K, 0 past it).
  constexpr int kRowStep = kBlock / kChunks;
  constexpr int kIters = (kSliceRows + RB + kRowStep - 1) / kRowStep;
  const int part = tid % kChunks;
  unsigned long long shifts = 0;
  if constexpr (kRealign) {
    for (int it = 0, i = tid / kChunks; it < kIters && i < rows + K;
         ++it, i += kRowStep) {
      int srow;
      shifts |= (unsigned long long)shift_code(row_of(i, &srow)) << (4 * it);
    }
  }

  // stage tile tt of the block's range into ring slot st: the slice's rows
  // of R and the K rows of U.  Aligned rows: kChunks 16-byte chunks a row,
  // those past col1 zero-filled.  kRealign: the aligned-down 16-byte chunks
  // that cover the tile's columns of the row (kChunks + 1 where its shift s
  // is not 0: the last thread of a row copies the 17th, into the row's
  // pad), each read only if it starts before col1 (else zero-filled), into
  // the same staged row; realign_tile then shifts them into place.
  auto load_tile = [&](int tt, int st) {
    const long long base = col0 + (long long)tt * kCols;
    const unsigned dst = smem0 + st * kStageBytes;
    for (int it = 0, i = tid / kChunks; i < rows + K; ++it, i += kRowStep) {
      int srow;
      const __nv_bfloat16* row = row_of(i, &srow);
      const int s = kRealign ? (int)(shifts >> (4 * it)) & 7 : 0;
      land_chunk<kRealign>(dst + (srow * kStride + 8 * part) * 2, row, base,
                           s, part, col1);
    }
  };

  // kRealign: every staged row of slot st whose shift is not 0, or whose
  // tile ends past col1, rewritten in place with its realigned chunks, the
  // entries past col1 zeroed.  The 16 threads of a row are a half-warp:
  // lane l reads the landed chunks l and l + 1 of kBatch rows, the warp
  // syncs, lane l writes chunk l of each.
  auto realign_tile = [&](int tt, int st) {
    uint4* const slot = smem + st * (kSliceRows + RB) * kRowChunks + part;
    realign_rows<kIters>(
        shifts, col1 - (col0 + (long long)tt * kCols), part, [&](int it) {
          const int i = tid / kChunks + kRowStep * it;
          return slot + (i < rows ? i : kSliceRows + (i - rows)) * kRowChunks;
        });
  };

  // the lane's ldmatrix rows: for A (x4) row lane % 16 of the warp's row
  // tile, columns 8·(lane / 16) on; for B (x2) row lane % 8 of U's first
  // row group, columns 8·(lane / 8 % 2) on
  const unsigned a_off =
      ((16 * warp + (lane & 15)) * kStride + 8 * (lane >> 4)) * 2u;
  const unsigned b_off =
      ((kSliceRows + (lane & 7)) * kStride + 8 * ((lane >> 3) & 1)) * 2u;
  const bool has_rows = 16 * warp < rows;
  float run[NB0][4], step[NB0][4];
#pragma unroll
  for (int j = 0; j < NB0; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) run[j][r] = step[j][r] = 0.f;

  // Aligned, and realigning at NB = 1: tile tt lands, then (kRealign) is
  // realigned by every warp, a barrier, then the mma.  Realigning at
  // NB >= 2 (kAhead): tile tt + 1 is realigned right after the mma of tile
  // tt, in its shadow, and the barrier at the top of the next step covers
  // both; two tiles stay in flight in the ring of four.
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
    if (has_rows) {
      if constexpr (NB1 > 0) {
        if (second)
          warp_stage<NB1, NB0>(stage + a_off,
                               stage + b_off + 8 * NB0 * kStride * 2, step);
        else
          warp_stage<NB0, NB0>(stage + a_off, stage + b_off, step);
      } else {
        warp_stage<NB0, NB0>(stage + a_off, stage + b_off, step);
      }
    }
    if constexpr (kAhead) {
      if (tt + 1 < num_tiles) realign_tile(tt + 1, (tt + 1) % kRing);
    }
    if (tt % kStepStages == kStepStages - 1 || tt == num_tiles - 1) {
#pragma unroll
      for (int j = 0; j < NB0; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          run[j][r] += step[j][r];
          step[j][r] = 0.f;
        }
    }
  }
  cp_async_wait<0>();

  // entry r of tile (warp, j)'s fragment is row 16·warp + lane/4 + 8(r/2),
  // column 8j + 2(lane%4) + r%2 of the partial (j from NB0 on in the
  // second half)
  float* out = partial + (long long)blockIdx.x * kSliceRows * RB;
  const int nt = second ? NB1 : NB0;
  const int j0 = second ? NB0 : 0;
#pragma unroll
  for (int j = 0; j < NB0; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (j < nt)
        out[(16 * warp + (lane >> 2) + 8 * (r >> 1)) * RB + 8 * (j0 + j) +
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

template <bool kRealign, int... I>
PartialKernel partial_kernel_at(int idx, std::integer_sequence<int, I...>) {
  static const PartialKernel table[] = {sketch_mma_partial<I + 1, kRealign>...};
  return table[idx];
}

template <bool kRealign>
PartialKernel partial_kernel(int NB) {
  return partial_kernel_at<kRealign>(
      NB - 1, std::make_integer_sequence<int, kMaxNB>{});
}

// Above 48 KB of dynamic shared memory a kernel must opt in; once per
// instance and device.
template <bool kRealign>
cudaError_t opt_in(int NB) {
  static std::atomic<unsigned long long> opted_in[kMaxNB];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  std::atomic<unsigned long long>& done = opted_in[NB - 1];
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(partial_kernel<kRealign>(NB),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes_of(NB, kRealign));
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

long long slices_of(int m) { return (m + kSliceRows - 1) / kSliceRows; }

bool in_cap(int K, int m) { return K >= 1 && K <= 8 * kMaxNB && m >= 1; }

// Resident blocks per SM of the partial kernel for K rows of U and the
// number of 128-row slices of R's m rows.  Returns a CUDA error code.
template <bool kRealign>
int tc_launch_config(int K, int m, int* blocks_per_sm, long long* slices) {
  if (!in_cap(K, m)) return static_cast<int>(cudaErrorInvalidValue);
  const int NB = nb_of(K);
  cudaError_t err = opt_in<kRealign>(NB);
  if (err != cudaSuccess) return static_cast<int>(err);
  *slices = slices_of(m);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, partial_kernel<kRealign>(NB),
      threads_of(NB, kRealign), smem_bytes_of(NB, kRealign)));
}

// The partial kernel over ceil(m/128)·num_blocks blocks, then the finish,
// on `stream`, after the checks both sources share (the caller checked the
// alignment its instance needs).  Returns cudaGetLastError().
template <bool kRealign>
int tc_launch(const void* U, long long ldu, int K, const void* R,
              long long ldr, int m, long long n, void* partial,
              long long partial_floats, int num_blocks,
              long long cols_per_block, void* S, void* stream) {
  if (!in_cap(K, m)) return static_cast<int>(cudaErrorInvalidValue);
  const int NB = nb_of(K);
  const long long RB = 8LL * NB;
  const long long slices = slices_of(m);
  if (n < 1 || num_blocks < 1 || cols_per_block % kCols != 0 ||
      (long long)num_blocks * cols_per_block < n ||
      slices * num_blocks > 0x7fffffffLL ||
      partial_floats < slices * num_blocks * kSliceRows * RB)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in<kRealign>(NB);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  partial_kernel<kRealign>(NB)<<<(unsigned)(slices * num_blocks),
                                 threads_of(NB, kRealign),
                                 smem_bytes_of(NB, kRealign), st>>>(
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

}  // namespace
