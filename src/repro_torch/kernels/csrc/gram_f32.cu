// gram_f32: G = U Uᵀ (K x K) and c = U g (K) for f32 U and f32 g, on the f32
// CUDA cores, one pass over the n columns and one launch a call.  Every
// f32/f32 call takes this body (kernels/gram.py::_body); bf16 U and g that
// _mma_eligible accepts take gram_mma.cu, and the rest (mixed dtypes, bf16
// at odd n or unaligned) gram.cu, which `gram_cuda(..., body="cuda_core")`
// also reaches for f32, to compare the two.
//
// Replaces the Pallas TPU kernel repro/kernels/gram.py::gram_pallas
// (_gram_kernel), which carries a (K, K) accumulator across the sequential
// grid steps of one TPU core.  No TF32 and no tensor cores: no f32 operand is
// rounded to reach a tensor core.
//
// What bounds it on the H100: the bytes of U and g, read once — (K+1)·n·4 B
// at 3.35 TB/s — up to K ≈ 64, the FMAs above: K(K+1)/2 + K a column at
// 33.5 TFMA/s (67 TFLOP/s).  Two bodies, chosen by K:
//
// (a) K <= 8, a register-only stream (gram_f32_stream<K, kVec>).  Nothing
//     is staged in shared memory.  A thread reads one group of 4 columns of
//     every row of E = [U; g] with one 16-byte load a row where every row
//     starts 16-byte aligned (n % 4 == 0 and aligned pointers: kVec), else
//     one column at a time with 4-byte loads, several groups (columns) in
//     flight a thread: 12 / (K+1) groups (24 / (K+1) columns), so a resident
//     SM has tens of KB of loads in flight.  It keeps the K(K+1)/2 + K sums
//     (44 at K = 8) in registers, in the order (i, j >= i) row-major, then
//     c; each is reduced by a butterfly of warp shuffles, then across the
//     warps in warp order.  Bytes bound it: the train path's K = 1 and 4
//     scopes, the async flush's K = 5.
//
// (b) K >= 9, 8 x 8 register tiles over a cp.async ring
//     (gram_f32_tiles<kVec, kBudget>).
//     Rows.  Up to K = 127 one slice holds [U; g] (U read once).  Above it U
//     is cut into nb = ceil(K / 127) row blocks of floor or ceil(K / nb)
//     rows (block a starts at a·K/nb), and the grid has one slice
//     (blockIdx.y) per pair a <= b: a diagonal slice stages [U_a; g], rows
//     padded with zeros to Kp = 8·ceil((Ka+1)/8), and computes the upper
//     triangle of its product (U_a U_aᵀ and, in g's column, c_a); a cross
//     slice stages U_a and U_b, each padded to a multiple of 8, and computes
//     the rectangle U_a U_bᵀ.  K = 500 is 10 slices, K = 2 000 136.
//     Tiles.  The slice's product is cut into 8 x 8 tiles: T(T+1)/2 of the
//     upper triangle (T = Kp / 8; 91 at K = 100, 5 824 FMAs a column for
//     the 5 150 needed) or TA·TB, dealt row-major.  Thread t owns tile
//     t % tiles and column phase t / tiles; there are budget / tiles phases
//     and 32·ceil(tiles·phases / 32) threads.  The thread budget is 192
//     (two blocks an SM at 168 registers a thread) for one slice of 10 tiles
//     or more, 256 (128 registers) below that and when sliced (a cross slice
//     holds up to 256 tiles): on the H100 the 168-register instance ran
//     K = 32, 64 and 100 6-11 % faster; below 10 tiles 256 threads keep more
//     column phases at work.
//     Staging.  A stage holds `groups` groups of 4 columns of every staged
//     row, laid out [group][row] of float4 (a row's 4 columns of the group),
//     with one 16-byte pad slot after every 8 rows: row r at slot r + r/8.
//     cp.async fills it, 16-byte copies (L1 bypassed) where rows are 16-byte
//     aligned, four 4-byte copies otherwise (n = 7 850 is not aligned, and a
//     TMA tensor map would need it); padding rows are zeroed once.  A warp
//     copies 4 staged rows x 8 groups (128 bytes of a row) at a time and
//     each lane keeps its row while it walks the stage's groups by 8, so a
//     copy costs its cp.async and two adds (the copies still take a third
//     of K = 16's time).  The ring has 3 stages: the copies of stage s+2 are in flight
//     while stage s is multiplied.  `groups` is the phases times the most
//     groups that keep a stage within 32 KB (16 groups, 64 columns, at
//     K = 100: 87.8 KB of ring, 2 blocks an SM).
//     Products.  Per group a thread reads its tile's 8 A rows (eight float4)
//     and, one at a time, its 8 B rows, and makes 4 FMAs per (A row, B row),
//     in column order: 16 float4 loads from shared memory for 256 FMAs
//     (cuobjdump -sass: 16 LDS.128 and 256 FFMA a group; ptxas: no spills).
//     Banks: the lanes of a quarter warp hold consecutive tiles, mostly of
//     one tile row, so their A loads are a broadcast and their B rows 8j + k
//     sit at slots 9j + k, in distinct 16-byte bank groups (9 ≡ 1 mod 8)
//     except where a tile row ends inside the quarter.
//     What bounds it.  Not the FMAs alone (benchmarks/
//     torch_gram_f32_calibration.py measures each number here): on the
//     H100 a loop of 64 FFMA from registers issues at 88 % of the 33.45
//     TFMA/s peak, with 4 LDS.128 per 64 FFMA (this body's ratio) at 69 %
//     conflict-free and 50 % with 2-way conflicts.  This body issues its
//     deal's FMAs at 49 % at K = 100, 59 % with its copies skipped and 61 %
//     without the per-stage barrier too: each group's first FMAs wait on
//     its A loads, and the 32 registers of A leave no room to load the next
//     group early.  Slower on the card in exploratory builds (not kept):
//     staging [column][row] with 4-byte copies and the next column's
//     operands in registers (its copies issue a load/store instruction for
//     every 4 bytes), the next group's A in registers (one block an SM),
//     12 x 12 tiles (at the register limit), and a deal whose quarter
//     warps hold one window of 8 tile columns, free of bank conflicts on
//     paper (its quarters span up to 8 tile rows, so A loads lose their
//     broadcast).
//     Phases.  After the last stage each thread puts its 64 sums into shared
//     memory ([entry][thread]: a warp's stores are consecutive) and the
//     phase-0 thread of a tile adds phases 1, 2, ... to its own in order.
//
// (c) One launch a call.  Where the column split gives one block a slice
//     (n <= 128, as every fleet shape, n = 68, K up to 2 000), the block
//     writes G and c itself: (a) from its reduced sums; (b) through a copy
//     of the slice's product in shared memory ([row][col] at an odd stride),
//     so that G's rows and their mirrors are written by consecutive lanes
//     (a thread writing its own tile and its mirror would touch a separate
//     32-byte sector with each 4-byte store).  No scratch is used.
//     Otherwise each block writes its partial (its sums, entry-major: for (b)
//     entry (r, k) of tile q at (8r + k)·max_tiles + q, so a warp's stores
//     are consecutive) and the partials are summed in block order inside the
//     same launch: a cooperative launch (cudaLaunchCooperativeKernel) with
//     one grid barrier (cooperative_groups' grid sync), after which every
//     warp of the grid sums entries.  Why not a ticket counter whose last
//     block sums: that block would sum every partial alone (K = 100 at
//     n = 2^24: 264 partials of 5 824 entries), and its counter would have to
//     live zeroed between calls.  The grid is one resident wave
//     (kernels/gram.py::grid from the occupancy query), which a cooperative
//     launch needs.  The sum of an entry is taken by L lanes of a warp (the
//     least power of two with L·8 >= blocks, at most 32): lane l adds the
//     blocks l, l + L, ... in order, then a butterfly of shuffles adds the
//     L lanes.  G is written mirrored from one sum, so it is exactly
//     symmetric.
//
// No float atomics: every sum runs in an order fixed by the shape and the
// card (its SM count and the kernel's occupancy set the grid), so two calls
// on one card are bitwise equal.  Offsets are 64-bit: K·n passes 2^31 on the
// train scopes.

#include <cooperative_groups.h>

#include <atomic>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStreamMaxK = 8;       // body (a) takes K <= 8
constexpr int kStreamThreads = 256;
constexpr int kTileThreads = 256;    // body (b): threads of a block at most
constexpr int kNarrowThreads = 192;  // ... where a slice has 10 tiles or more
constexpr int kMaxRows = 128;        // staged rows of one side of a slice
constexpr int kStages = 3;
constexpr int kStageBytes = 32768;   // a stage's size, at most
constexpr int kGroup = 4;            // columns of a group: one float4 a row
constexpr int kMaxSlices = 65535;    // gridDim.y
constexpr int kMaxSmem = 128 * 1024; // opted in for the tile instances
constexpr int kWarpsPerStream = kStreamThreads / 32;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int round8(int x) { return (x + 7) / 8 * 8; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// ------------------------------------------------------------ loads, copies

__device__ __forceinline__ float4 ld_stream4(const float* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ float ld_stream1(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// 4 bytes global -> shared; `bytes` = 0 writes 4 zero bytes and reads nothing
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// ------------------------------------------------ the cross-block finish

// Sums every entry e of every slice s over the grid's blocks, in block order,
// and writes the sum where target(s, e, &p0, &p1) says (p0 null: no entry;
// p1: the mirror, or null).  Partials: [slice][block][entry], P entries a
// block.  Each entry is summed by L lanes of a warp (lane l: blocks l, l+L,
// ... in order), then a butterfly of shuffles over the L lanes.  Every lane
// of a warp runs the same trip count, so the shuffles are full-warp.
template <typename Target>
__device__ void finish(const float* __restrict__ partial, long long P,
                       Target target) {
  const int nblk = gridDim.x;
  int L = 1;
  while (L < 32 && L * 8 < nblk) L <<= 1;
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / L;
  const long long warps = (long long)gridDim.x * gridDim.y * (blockDim.x >> 5);
  const long long warp =
      ((long long)blockIdx.y * gridDim.x + blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  const long long items = (long long)gridDim.y * P;
  for (long long base = warp * per_warp; base < items;
       base += warps * per_warp) {
    const long long item = base + lane / L;
    float* p0 = nullptr;
    float* p1 = nullptr;
    long long s = 0, e = 0;
    if (item < items) {
      s = item / P;
      e = item - s * P;
      target(s, e, &p0, &p1);
    }
    float v = 0.f;
    if (p0 != nullptr) {
      const float* src = partial + s * nblk * P + e;
      for (int b = lane % L; b < nblk; b += L) v += src[(long long)b * P];
    }
    for (int off = L / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (p0 != nullptr && lane % L == 0) {
      *p0 = v;
      if (p1 != nullptr) *p1 = v;
    }
  }
}

// ------------------------------------------------- (a) the register stream

// the K(K+1)/2 + K sums of body (a): (i, j >= i) row-major, then c
template <int K>
struct Stream {
  static constexpr int R = K + 1;
  static constexpr int NS = K * (K + 1) / 2 + K;
};

template <int K>
__device__ __forceinline__ void accumulate(float (&acc)[Stream<K>::NS],
                                           const float (&e)[K + 1]) {
  int idx = 0;
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = i; j < K; ++j) {
      acc[idx] = fmaf(e[i], e[j], acc[idx]);
      ++idx;
    }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    acc[idx] = fmaf(e[i], e[K], acc[idx]);
    ++idx;
  }
}

// where sum e of body (a) goes: G[i][j] and its mirror, or c[i]
template <int K>
__device__ void stream_target(long long e, float* G, float* c, float** p0,
                              float** p1) {
  int idx = (int)e;
  for (int i = 0; i < K; ++i) {
    if (idx < K - i) {
      const int j = i + idx;
      *p0 = G + i * K + j;
      *p1 = i == j ? nullptr : G + j * K + i;
      return;
    }
    idx -= K - i;
  }
  *p0 = c + idx;
  *p1 = nullptr;
}

template <int K, bool kVec>
__global__ void __launch_bounds__(kStreamThreads, 2)
gram_f32_stream(const float* __restrict__ U, const float* __restrict__ g,
                float* __restrict__ partial, float* __restrict__ G,
                float* __restrict__ c, long long n,
                long long cols_per_block) {
  constexpr int R = Stream<K>::R;
  constexpr int NS = Stream<K>::NS;
  __shared__ float red[kWarpsPerStream][NS];
  const int tid = threadIdx.x;
  const long long col0 = (long long)blockIdx.x * cols_per_block;
  const long long col1 = col0 + cols_per_block < n ? col0 + cols_per_block : n;
  auto row = [&](int r) { return r < K ? U + (long long)r * n : g; };

  float acc[NS];
#pragma unroll
  for (int e = 0; e < NS; ++e) acc[e] = 0.f;

  if constexpr (kVec) {
    // groups of 4 columns: col0 and col1 are multiples of 4 here
    constexpr int kU = 12 / R > 1 ? 12 / R : 1;
    const long long q1 = col1 / kGroup;
    for (long long q = col0 / kGroup + tid; q < q1;
         q += (long long)kStreamThreads * kU) {
      float4 v[kU][R];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const long long qq = q + (long long)u * kStreamThreads;
#pragma unroll
        for (int r = 0; r < R; ++r)
          v[u][r] = qq < q1 ? ld_stream4(row(r) + kGroup * qq)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float e[R];
#pragma unroll
        for (int r = 0; r < R; ++r) e[r] = v[u][r].x;
        accumulate<K>(acc, e);
#pragma unroll
        for (int r = 0; r < R; ++r) e[r] = v[u][r].y;
        accumulate<K>(acc, e);
#pragma unroll
        for (int r = 0; r < R; ++r) e[r] = v[u][r].z;
        accumulate<K>(acc, e);
#pragma unroll
        for (int r = 0; r < R; ++r) e[r] = v[u][r].w;
        accumulate<K>(acc, e);
      }
    }
  } else {
    constexpr int kU = 24 / R > 1 ? 24 / R : 1;
    for (long long j = col0 + tid; j < col1;
         j += (long long)kStreamThreads * kU) {
      float v[kU][R];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const long long jj = j + (long long)u * kStreamThreads;
#pragma unroll
        for (int r = 0; r < R; ++r)
          v[u][r] = jj < col1 ? ld_stream1(row(r) + jj) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) accumulate<K>(acc, v[u]);
    }
  }

  // the warp's sums (a butterfly: every lane ends with the same bits), then
  // the block's, warps in order
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int e = 0; e < NS; ++e) {
    float v = acc[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][e] = v;
  }
  __syncthreads();
  float v = 0.f;
  if (tid < NS) {
#pragma unroll
    for (int w = 0; w < kWarpsPerStream; ++w) v += red[w][tid];
  }
  auto target = [&](long long, long long e, float** p0, float** p1) {
    stream_target<K>(e, G, c, p0, p1);
  };
  if (gridDim.x == 1) {
    if (tid < NS) {
      float *p0, *p1;
      target(0, tid, &p0, &p1);
      *p0 = v;
      if (p1 != nullptr) *p1 = v;
    }
    return;
  }
  if (tid < NS) partial[(long long)blockIdx.x * NS + tid] = v;
  __threadfence();
  cg::this_grid().sync();
  finish(partial, NS, target);
}

// ------------------------------------------------------ (b) the 8 x 8 tiles

// (i, j), i <= j, of the q-th cell of the upper triangle of a T x T grid in
// row-major order
__host__ __device__ inline void tile_of(int q, int T, int* i, int* j) {
  int r = 0;
  while (q >= T - r) {
    q -= T - r;
    ++r;
  }
  *i = r;
  *j = r + q;
}

// (a, b), a <= b, of slice s: the pairs of nb row blocks in row-major order
__host__ __device__ inline void pair_of(int s, int nb, int* a, int* b) {
  tile_of(s, nb, a, b);
}

__host__ __device__ inline int row_blocks(int K) {
  return K <= kMaxRows - 1 ? 1 : cdiv(K, kMaxRows - 1);
}

__host__ __device__ inline int row0_of(int a, int K, int nb) {
  return (int)((long long)a * K / nb);
}

// One slice of body (b): side A is U_a's rows, side B U_a's and g (diagonal)
// or U_b's (cross); staged rows [0, rows_a) are side A (on a diagonal slice
// also side B), [rows_a, rows) side B of a cross slice.
struct Slice {
  int a0, Ka, b0, Kb;
  bool diag;
  int rows_a;   // staged rows of side A, a multiple of 8
  int rows;     // staged rows in all
  int tb;       // tile columns (a diagonal slice: T = rows / 8)
  int tiles;
  int phases;   // column phases: the block's thread budget / tiles

  __host__ __device__ Slice(int s, int K, int nb, int budget) {
    int a = 0, b = 0;
    pair_of(s, nb, &a, &b);
    a0 = row0_of(a, K, nb);
    Ka = row0_of(a + 1, K, nb) - a0;
    b0 = row0_of(b, K, nb);
    Kb = row0_of(b + 1, K, nb) - b0;
    diag = a == b;
    if (diag) {
      rows_a = round8(Ka + 1);
      rows = rows_a;
      tb = rows / 8;
      tiles = tb * (tb + 1) / 2;
    } else {
      rows_a = round8(Ka);
      rows = rows_a + round8(Kb);
      tb = (rows - rows_a) / 8;
      tiles = rows_a / 8 * tb;
    }
    phases = budget / tiles;
  }

  __device__ int b_base() const { return diag ? 0 : rows_a; }
  __device__ void tile(int q, int* i, int* j) const {
    if (diag) {
      tile_of(q, tb, i, j);
    } else {
      *i = q / tb;
      *j = q % tb;
    }
  }
  // staged row x holds data (else padding): diag [U_a; g], cross U_a and
  // U_b, each from its side's first row
  __device__ bool real_row(int x) const {
    return diag ? x <= Ka : x < Ka || (x >= rows_a && x < rows_a + Kb);
  }
  __device__ const float* row_ptr(int x, const float* U, const float* g,
                                  long long n) const {
    if (x < Ka) return U + (long long)(a0 + x) * n;
    if (diag) return g;
    return U + (long long)(b0 + x - rows_a) * n;
  }
  // where entry (x, y) of the product goes (x: side A's staged row, y: side
  // B's, counted from side B's first row): G and its mirror, c, or nowhere
  __device__ void target(int x, int y, int K, float* G, float* c, float** p0,
                         float** p1) const {
    *p0 = *p1 = nullptr;
    if (x >= Ka) return;
    if (diag) {
      if (y < Ka && x <= y) {
        *p0 = G + (long long)(a0 + x) * K + a0 + y;
        if (x != y) *p1 = G + (long long)(a0 + y) * K + a0 + x;
      } else if (y == Ka) {
        *p0 = c + a0 + x;
      }
    } else if (y < Kb) {
      *p0 = G + (long long)(a0 + x) * K + b0 + y;
      *p1 = G + (long long)(b0 + y) * K + a0 + x;
    }
  }
};

// What a tile launch is, from K alone (kernels/gram.py::f32_tile_plan
// computes the same): the widest slices it can hold (the tallest row block,
// ceil(K / nb) rows, on every side) size the stage and the shared memory.
struct TilePlan {
  int nb, budget, threads, groups, slots, max_tiles, smem_bytes;
};

// The thread budget: 192 threads (168 registers a thread) for one slice of
// 10 tiles or more, 256 (128 registers) for fewer tiles and for the slices
// past K = 127, whose cross slices hold up to 256 tiles.
int budget_of(int K) {
  const int T = round8(K + 1) / 8;
  return row_blocks(K) == 1 && T >= 4 ? kNarrowThreads : kTileThreads;
}

TilePlan tile_plan(int K) {
  TilePlan p;
  p.nb = row_blocks(K);
  p.budget = budget_of(K);
  const int hi = cdiv(K, p.nb);
  const int d_rows = round8(hi + 1), d_t = d_rows / 8;
  const int d_tiles = d_t * (d_t + 1) / 2;
  int rows = d_rows, tiles = d_tiles, phases = p.budget / d_tiles;
  int out = d_rows * (d_rows + 1);
  if (p.nb > 1) {
    const int c_t = round8(hi) / 8;
    rows = imax(rows, 16 * c_t);
    tiles = imax(tiles, c_t * c_t);
    phases = imin(phases, kTileThreads / (c_t * c_t));
    out = imax(out, 8 * c_t * (8 * c_t + 1));
    p.threads = kTileThreads;
  } else {
    p.threads = cdiv(d_tiles * phases, 32) * 32;
  }
  p.slots = rows + rows / 8;
  const int m = imax(1, kStageBytes / (phases * p.slots * 16));
  p.groups = phases * m;
  p.max_tiles = tiles;
  const int ring = kStages * p.groups * p.slots * 16;
  const int red = p.threads * 64 * 4;
  p.smem_bytes = imax(ring, imax(red, out * 4));
  return p;
}

template <bool kVec, int kBudget>
__global__ void __launch_bounds__(kBudget, 2)
gram_f32_tiles(const float* __restrict__ U, const float* __restrict__ g,
               float* __restrict__ partial, float* __restrict__ G,
               float* __restrict__ c, int K, long long n,
               long long cols_per_block, int nb, int groups, int slots,
               int max_tiles) {
  extern __shared__ float4 smem[];
  const Slice sl(blockIdx.y, K, nb, kBudget);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const long long col0 = (long long)blockIdx.x * cols_per_block;
  const long long col1 = col0 + cols_per_block < n ? col0 + cols_per_block : n;
  const int stage_cols = kGroup * groups;
  const int stage_slots = groups * slots;
  const int num_stages =
      col1 > col0 ? (int)((col1 - col0 + stage_cols - 1) / stage_cols) : 0;
  auto groups_in = [&](int tt) {      // groups of stage tt inside [col0, col1)
    const long long left = col1 - col0 - (long long)tt * stage_cols;
    return (int)(left >= stage_cols ? groups : (left + kGroup - 1) / kGroup);
  };

  // the padding rows are never copied: zero the whole ring once
  for (int i = tid; i < kStages * stage_slots; i += nthreads)
    smem[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // Stage tt into ring slot `slot`: a warp copies quads of 4 staged rows
  // (lane / 8) x 8 groups (lane % 8: 128 bytes of a row); each lane keeps
  // its row and walks the stage's groups by 8.
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int rq = lane >> 3, cq = lane & 7;
  auto load_stage = [&](int tt, int slot) {
    const long long base = col0 + (long long)tt * stage_cols + kGroup * cq;
    const int gv = groups_in(tt);
    const unsigned st = smem_addr(smem + slot * stage_slots);
    for (int qd = warp; qd < sl.rows / 4; qd += nwarps) {
      const int x = 4 * qd + rq;
      if (!sl.real_row(x)) continue;
      const float* src = sl.row_ptr(x, U, g, n) + base;
      unsigned dst = st + (cq * slots + x + (x >> 3)) * 16u;
      for (int gi = cq; gi < gv; gi += 8) {
        if constexpr (kVec) {
          cp_async16(dst, src, 16);
        } else {
          const long long left = col1 - (base + kGroup * (gi - cq));
#pragma unroll
          for (int w = 0; w < kGroup; ++w)
            cp_async4(dst + 4 * w, src + (w < left ? w : 0), w < left ? 4 : 0);
        }
        src += 8 * kGroup;
        dst += 8u * slots * 16u;
      }
    }
  };

  const int q = tid % sl.tiles;
  const int p = tid / sl.tiles;
  const bool active = p < sl.phases;
  int ti = 0, tj = 0;
  sl.tile(q, &ti, &tj);
  const int aoff = 9 * ti;                          // slot of A row 8·ti
  const int boff = 9 * (sl.b_base() / 8 + tj);      // slot of B row 8·tj
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[r][k] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < num_stages) load_stage(s, s);
    cp_async_commit();
  }
  for (int tt = 0; tt < num_stages; ++tt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage tt has landed; every thread is done with tt - 1
    if (tt + kStages - 1 < num_stages)
      load_stage(tt + kStages - 1, (tt + kStages - 1) % kStages);
    cp_async_commit();
    if (active) {
      const float4* st = smem + (tt % kStages) * stage_slots;
      const int gv = groups_in(tt);
      for (int gi = p; gi < gv; gi += sl.phases) {
        const float4* grp = st + gi * slots;
        float4 a[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) a[r] = grp[aoff + r];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float4 b = grp[boff + k];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            float s = acc[r][k];
            s = fmaf(a[r].x, b.x, s);
            s = fmaf(a[r].y, b.y, s);
            s = fmaf(a[r].z, b.z, s);
            s = fmaf(a[r].w, b.w, s);
            acc[r][k] = s;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the phases of each tile, added in phase order onto phase 0's sums
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) red[(r * 8 + k) * nthreads + tid] = acc[r][k];
  __syncthreads();
  const bool lead = active && p == 0;
  if (lead) {
    for (int ph = 1; ph < sl.phases; ++ph)
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc[r][k] += red[(r * 8 + k) * nthreads + ph * sl.tiles + q];
  }
  __syncthreads();  // red is read; the product may overwrite it

  if (gridDim.x == 1) {
    // one block owns the slice: its product into shared memory, [x][y] at
    // an odd stride, then G's rows (and their mirrors) by consecutive lanes
    const int ldo = sl.rows - sl.b_base() + 1;
    float* S = red;
    if (lead) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k)
          S[(8 * ti + r) * ldo + 8 * tj + k] = acc[r][k];
    }
    __syncthreads();
    if (sl.diag) {
      for (int x = warp; x < sl.Ka; x += nwarps) {
        float* grow = G + (long long)(sl.a0 + x) * K + sl.a0;
        for (int y = lane; y < sl.Ka; y += 32)
          grow[y] = x <= y ? S[x * ldo + y] : S[y * ldo + x];
        if (lane == 0) c[sl.a0 + x] = S[x * ldo + sl.Ka];
      }
    } else {
      for (int x = warp; x < sl.Ka; x += nwarps) {
        float* grow = G + (long long)(sl.a0 + x) * K + sl.b0;
        for (int y = lane; y < sl.Kb; y += 32) grow[y] = S[x * ldo + y];
      }
      for (int y = warp; y < sl.Kb; y += nwarps) {
        float* grow = G + (long long)(sl.b0 + y) * K + sl.a0;
        for (int x = lane; x < sl.Ka; x += 32) grow[x] = S[x * ldo + y];
      }
    }
    return;
  }

  // the block's partial, entry-major, then every block's summed in order
  const long long P = 64LL * max_tiles;
  float* part = partial + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * P;
  if (lead) {
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int k = 0; k < 8; ++k) part[(r * 8 + k) * max_tiles + q] = acc[r][k];
  }
  __threadfence();
  cg::this_grid().sync();
  finish(partial, P, [&](long long s, long long e, float** p0, float** p1) {
    const Slice es((int)s, K, nb, kBudget);
    const int rk = (int)(e / max_tiles);
    const int qq = (int)(e - (long long)rk * max_tiles);
    *p0 = *p1 = nullptr;
    if (qq >= es.tiles) return;
    int i = 0, j = 0;
    es.tile(qq, &i, &j);
    es.target(8 * i + rk / 8, 8 * j + rk % 8, K, G, c, p0, p1);
  });
}

// ------------------------------------------------------------- host side

using StreamKernel = void (*)(const float*, const float*, float*, float*,
                              float*, long long, long long);
using TileKernel = void (*)(const float*, const float*, float*, float*,
                            float*, int, long long, long long, int, int, int,
                            int);

template <bool kVec>
StreamKernel stream_kernel_of(int K) {
  switch (K) {
    case 1: return gram_f32_stream<1, kVec>;
    case 2: return gram_f32_stream<2, kVec>;
    case 3: return gram_f32_stream<3, kVec>;
    case 4: return gram_f32_stream<4, kVec>;
    case 5: return gram_f32_stream<5, kVec>;
    case 6: return gram_f32_stream<6, kVec>;
    case 7: return gram_f32_stream<7, kVec>;
    default: return gram_f32_stream<8, kVec>;
  }
}

StreamKernel stream_kernel(int K, int vec) {
  return vec ? stream_kernel_of<true>(K) : stream_kernel_of<false>(K);
}

TileKernel tile_kernel(int vec, int budget) {
  if (budget == kNarrowThreads)
    return vec ? gram_f32_tiles<true, kNarrowThreads>
               : gram_f32_tiles<false, kNarrowThreads>;
  return vec ? gram_f32_tiles<true, kTileThreads>
             : gram_f32_tiles<false, kTileThreads>;
}

// Above 48 KB of dynamic shared memory a kernel must opt in: once per tile
// instance and device, to kMaxSmem (every plan stays under it).
cudaError_t opt_in(int vec, int budget) {
  static std::atomic<unsigned long long> opted_in[4];
  const int which = 2 * vec + (budget == kNarrowThreads);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (opted_in[which].load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(tile_kernel(vec, budget),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess) opted_in[which].fetch_or(bit);
  return err;
}

bool k_ok(int K) {
  if (K < 1) return false;
  const int nb = row_blocks(K);
  return (long long)nb * (nb + 1) / 2 <= kMaxSlices;
}

}  // namespace

// Launch configuration of the kernel a call with this K takes (vec: every
// row 16-byte aligned): the blocks resident per SM (the grid is one wave of
// them), its dynamic shared memory per block and its threads per block.
// Returns a CUDA error code.
extern "C" int gram_f32_launch_config(int K, int vec, int* blocks_per_sm,
                                      int* smem_bytes, int* threads) {
  if (!k_ok(K)) return static_cast<int>(cudaErrorInvalidValue);
  if (K <= kStreamMaxK) {
    *smem_bytes = 0;
    *threads = kStreamThreads;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, stream_kernel(K, vec), kStreamThreads, 0));
  }
  const TilePlan plan = tile_plan(K);
  cudaError_t err = opt_in(vec, plan.budget);
  if (err != cudaSuccess) return static_cast<int>(err);
  *smem_bytes = plan.smem_bytes;
  *threads = plan.threads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, tile_kernel(vec, plan.budget), plan.threads,
      plan.smem_bytes));
}

// U (K, n) and g (n,) f32, contiguous; vec: U and g 16-byte aligned and
// n % 4 == 0.  num_blocks column ranges of cols_per_block (a multiple of 128)
// cover n, for each of the nb(nb+1)/2 slices (1 for K <= 127), and the
// grid's blocks are one resident wave when num_blocks > 1; then partial
// holds partial_floats >= slices·num_blocks·P f32 (P = K(K+3)/2 for K <= 8,
// else 64 x the widest slice's tiles), else it is unused (may be null).
// G (K, K) and c (K,) f32.  Anything else: cudaErrorInvalidValue.  Returns
// cudaGetLastError() after the one launch on `stream`.
extern "C" int gram_f32_launch(const void* U, const void* g, void* partial,
                               long long partial_floats, void* G, void* c,
                               int K, long long n, int vec, int num_blocks,
                               long long cols_per_block, void* stream) {
  if (!k_ok(K) || n < 1 || num_blocks < 1 || cols_per_block % 128 != 0 ||
      (long long)num_blocks * cols_per_block < n ||
      (vec && (n % kGroup != 0 || reinterpret_cast<uintptr_t>(U) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(g) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* u = static_cast<const float*>(U);
  const float* gg = static_cast<const float*>(g);
  float* part = static_cast<float*>(partial);
  float* Gp = static_cast<float*>(G);
  float* cp = static_cast<float*>(c);
  long long nn = n, cols = cols_per_block;
  if (K <= kStreamMaxK) {
    const long long P = K * (K + 1) / 2 + K;
    if (num_blocks > 1 && (part == nullptr || partial_floats < num_blocks * P))
      return static_cast<int>(cudaErrorInvalidValue);
    const StreamKernel kernel = stream_kernel(K, vec);
    if (num_blocks == 1) {
      kernel<<<1, kStreamThreads, 0, st>>>(u, gg, part, Gp, cp, nn, cols);
      return static_cast<int>(cudaGetLastError());
    }
    void* args[] = {&u, &gg, &part, &Gp, &cp, &nn, &cols};
    cudaError_t err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(kernel), dim3(num_blocks),
        dim3(kStreamThreads), args, 0, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  const TilePlan plan = tile_plan(K);
  const int slices = plan.nb * (plan.nb + 1) / 2;
  const long long P = 64LL * plan.max_tiles;
  if (num_blocks > 1 &&
      (part == nullptr || partial_floats < (long long)slices * num_blocks * P))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in(vec, plan.budget);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TileKernel kernel = tile_kernel(vec, plan.budget);
  int KK = K, nb = plan.nb, groups = plan.groups, slots = plan.slots,
      max_tiles = plan.max_tiles;
  const dim3 grid(num_blocks, slices);
  if (num_blocks == 1) {
    kernel<<<grid, plan.threads, plan.smem_bytes, st>>>(
        u, gg, part, Gp, cp, KK, nn, cols, nb, groups, slots, max_tiles);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&u, &gg, &part, &Gp, &cp, &KK, &nn, &cols,
                  &nb, &groups, &slots, &max_tiles};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    grid, dim3(plan.threads), args,
                                    plan.smem_bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
