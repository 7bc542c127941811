// The realigned staging of the bf16 tensor-core bodies, shared by
// sketch_mma.cuh (sketch_realign.cu) and gram_mma.cuh (gram_realign.cu).
// A bf16 row that starts only 2-byte aligned cannot be copied as it lies:
// cp.async copies only from 4/8/16-byte aligned sources, and ldmatrix reads
// 16-byte aligned rows of shared memory.  So each row r has its own shift
// s_r = (address of its first entry / 2) mod 8, fixed for the call (a tile
// starts a multiple of 128 entries in), and a tile of 128 columns reaches
// its staged row in two steps:
//
//   1. Land (land_chunk): the aligned-down 16-byte chunks that cover the
//      tile's columns, entries base - s .. base - s + 135 of the row: 17
//      chunks where s != 0 and 16 where s = 0, into the same 272-byte
//      staged row (the 17th fills its 16-byte pad, which ldmatrix never
//      reads).  A chunk is read only if it starts before the block's last
//      column col1 (so no read starts past the row's last entry); else
//      cp.async zero-fills it.  The first chunk of a row starts up to 14
//      bytes before the row, inside the 16-byte granule that holds its
//      first entry.
//   2. Realign in place (realign_rows): the 16 threads of a staged row are
//      a half-warp; lane l reads chunks l and l + 1 of kBatch rows, the
//      warp syncs, lane l writes chunk l of each (realigned: the words
//      from s / 2 on, picked by a tree of selects on the bits of s, a
//      funnel shift by half a word for an odd s, and on the last tile of a
//      range the entries at or past col1 masked to zero).  A row with
//      s = 0 whose tile ends inside the range is left as it landed.
//
// A thread finds the shift of each of its rows once (shift_code) and keeps
// them, 4 bits a row (8 | s for a row inside the call's rows, 0 past them),
// in one register.  Wherever n % 8 == 0 a realigned tile holds what the
// aligned body stages from an aligned copy of the same values.

#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kRealignCols = 128;                 // columns of a staged tile
constexpr int kRealignChunks = kRealignCols / 8;  // its 16-byte chunks a row

// The element shift of a bf16 row starting at p: (address / 2) mod 8, the
// entries between the 16-byte boundary below it and its first entry.
__device__ __forceinline__ int shift_of(const __nv_bfloat16* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 1) & 7);
}

// A row's 4-bit code: 8 (inside the call's rows) | its shift.
__device__ __forceinline__ unsigned shift_code(const __nv_bfloat16* p) {
  return 8u | (unsigned)shift_of(p);
}

// Chunk j of a row realigned by `s` entries: entries s + 8j .. s + 8j + 7
// of the landed aligned-down chunks j (lo) and j + 1 (hi).  The words
// x[q .. q + 4] (q = s / 2) are picked by a tree of selects on the bits of
// q, then a funnel shift by half a word takes an odd shift; entries from
// `valid` on are zeroed (the columns past the block's range), which only
// the last tile of a range needs.
__device__ __forceinline__ uint4 realigned(uint4 lo, uint4 hi, int s,
                                           long long valid) {
  const unsigned x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  unsigned y[7], z[5], o[4];
#pragma unroll
  for (int k = 0; k < 7; ++k) y[k] = (s & 2) ? x[k + 1] : x[k];
#pragma unroll
  for (int k = 0; k < 5; ++k) z[k] = (s & 4) ? y[k + 2] : y[k];
  const unsigned sh = 16u * (s & 1);
#pragma unroll
  for (int w = 0; w < 4; ++w) o[w] = __funnelshift_r(z[w], z[w + 1], sh);
  if (valid < 8) {
    const int v = valid > 0 ? (int)valid : 0;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      o[w] &= (2 * w < v ? 0x0000ffffu : 0u) |
              (2 * w + 1 < v ? 0xffff0000u : 0u);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// Chunk `part` of a row's tile of columns [base, base + 128) into its
// staged row at shared address `to` (the chunk's own place): aligned rows
// (s = 0) copy it as it lies; kRealign, the aligned-down chunk (and, for the
// last part of a row with s != 0, the 17th into the row's pad).  A chunk
// that starts at or past col1 is zero-filled and not read.
template <bool kRealign>
__device__ __forceinline__ void land_chunk(unsigned to,
                                           const __nv_bfloat16* row,
                                           long long base, int s, int part,
                                           long long col1) {
  const long long col = base - s + 8 * part;
  const bool in = col < col1;
  cp_async16(to, row + (in ? col : -s), in ? 16 : 0);
  if (kRealign && part == kRealignChunks - 1 && s != 0) {
    const bool in2 = col + 8 < col1;
    cp_async16(to + 16, row + (in2 ? col + 8 : -s), in2 ? 16 : 0);
  }
}

// The realign pass over a thread's kIters staged rows of one slot: row_at(it)
// is chunk `part` of the it-th row in shared memory, `shifts` the rows'
// codes (4 bits an it), `lim` the tile's columns before col1.  Rows whose
// code says shift 0 and whose tile ends inside the range stand as landed.
// Every thread of the block calls it (it syncs its warp).
template <int kIters, typename Shifts, typename RowAt>
__device__ __forceinline__ void realign_rows(Shifts shifts, long long lim,
                                             int part, RowAt row_at) {
  constexpr int kBatch = 2;
#pragma unroll
  for (int b0 = 0; b0 < kIters; b0 += kBatch) {
    uint4 lo[kBatch], hi[kBatch];
    uint4* at[kBatch];
    int sh[kBatch];
    bool act[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const unsigned code =
          b0 + j < kIters ? (unsigned)(shifts >> (4 * (b0 + j))) & 15u : 0u;
      sh[j] = (int)(code & 7u);
      act[j] = (code & 8u) && (sh[j] != 0 || lim < kRealignCols);
      at[j] = row_at(b0 + j);
      if (act[j]) {
        lo[j] = at[j][0];
        hi[j] = at[j][1];
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (act[j]) *at[j] = realigned(lo[j], hi[j], sh[j], lim - 8 * part);
  }
}

}  // namespace
