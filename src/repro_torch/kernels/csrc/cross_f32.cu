// cross_f32: out = A Bᵀ over n columns for f32 row sources, on the f32 CUDA
// cores, one launch a call — the f32 body of gram_block, stream_stats and
// sketch.  Every call whose row sources are all f32 takes it
// (kernels/gram.py::_block_body, kernels/stream.py::_body,
// kernels/sketch.py::_body); bf16 calls that the tensor-core bodies take
// stay there, and the rest (mixed dtypes, unaligned bf16 gram_block and
// stream_stats calls) on cross.cuh, which `body="cross"` also reaches for
// f32, to compare the two.
//
// Replaces, for these calls, the Pallas TPU kernels
// repro/kernels/gram.py:60 gram_block_pallas (_gram_block_kernel),
// repro/kernels/stream.py:102 stream_stats_pallas (_stream_stats_kernel)
// and repro/kernels/sketch.py:39 sketch_apply_pallas (_sketch_kernel),
// which pad the rows to 8 and n to a block multiple and carry the sums
// across the sequential grid of one TPU core.  No TF32 and no tensor cores:
// no f32 operand is rounded to reach a tensor core.
//
// The problem is cross.cuh's: A is one row source, B the rows of B1
// followed by those of B2, each given as a pointer, a row count and a row
// stride (elements), columns unit-strided, so a (P, width) view of a stacked
// leaf or a rank's column window of a slab goes in as it lies.
//
//   gram_block    A = U_a, B1 = U_b, B2 = g:   G_ab = U_a U_bᵀ, c_a = U_a g
//   stream_stats  A = D, B1 = D, B2 = GM, sym: G = D Dᵀ (the upper triangle
//                 computed, then mirrored), C = D GMᵀ; `accumulate` adds
//                 into the given outputs (a round's slabs, in slab order)
//   sketch        A = U, B1 = R, no B2 (m2 = 0): S_U = U Rᵀ; at K = 8,
//                 m = 1024 eight slices of 1 x 16 tiles, U's 8 rows staged
//                 beside each, R read once
//
// What bounds it on the H100 (3.35 TB/s; 33.45 TFMA/s f32).  gram_block at
// Ka = 64, Kb = 32, n = 2^24 reads 97 rows, 6.51 GB: 1.94 ms of bytes
// against 1.06 ms of its 2 112 FMAs a column; its tiles deal 2 560, which
// this loop issues at about a third of the FMA rate (3.76-3.80 ms on the
// card): each thread's 16 LDS.128 a group cost the shared memory as many
// cycles as its 256 FFMA cost the FMA pipes, and 5 of a block's 6 warps
// hold its 40 tiles.  The paths' shapes (Ka = Kb = 10, 25, 100 at
// n = 7 850; stream_stats P = 100 at n = 7 840) are below a microsecond of
// bytes and 0.2-3.5 us of FMAs: launch, the first copies from L2 (bound by
// the L2's rate to the SM), the products of the busiest block, the grid
// barrier and the cross-block sum are what they pay for.
//
// Design (the tile loop of gram_f32.cu (b), which the calibration in
// benchmarks/torch_gram_f32_calibration.py measured):
//
// Slices.  A's rows and B's index rows ([B1; B2] in one index space, B2
//   right after B1) are cut into 8-row tiles, TA and TB of them.  A's tiles
//   are cut into na groups and B's into nb, balanced (group a starts at tile
//   a·T/n), at most 16 tiles (128 rows) a group; under `sym` B's first TA
//   tiles are cut as A's and the rest into nb2 groups of at most 8 tiles (a
//   diagonal slice holds half a rectangle's tiles).  The grid has one slice
//   (blockIdx.y) a pair (a, b); under `sym` the pairs with b < a in B1's
//   groups lie below the diagonal and are left out, and a pair b = a stages
//   B's rows once and takes A's from them (A's rows are the first of B's).
//   A level k multiplies the groups (each side's base count times k, at
//   most one tile a group): the wrapper raises it above 1 only where the
//   columns alone cannot give about 2 blocks an SM (the paths' n ≈ 7 850:
//   62 blocks of 128 columns), to the k that least loads the busiest SM
//   (kernels/cross.py::f32_level).
// Tiles.  A slice's product is cut into 8 x 8 tiles: the upper triangle of
//   a diagonal slice (i <= j), else the rectangle, row-major.  Thread t
//   owns tile t % tiles and column phase t / tiles: phase f takes the
//   block's groups of 4 columns g ≡ f (mod phases), in order.  The thread
//   budget is 192 (two blocks an SM at 168 registers) where the widest
//   slice holds 10 to 192 tiles, else 256; phases are the budget over the
//   slice's tiles, at most a quarter of the block's groups.
// Staging.  A stage holds `groups` groups of 4 columns of every staged row,
//   laid out [group][row] of float4 with a pad slot after every 8 rows (row
//   r at slot r + r/8), filled by cp.async: 16-byte copies where every row
//   starts 16-byte aligned (aligned pointers, row strides and n multiples of
//   4: n = 7 840 and 2^24 do, n = 7 850 does not); else each row is copied
//   as its own start allows, one 16-byte, two 8-byte or four 4-byte copies
//   a group, the columns past n zero-filled (at n = 7 850 every other row
//   starts 8 bytes past a 16-byte boundary).  A warp copies 4 rows x 8
//   groups at a time.  Nothing is zeroed: a padding row only ever meets
//   entries that are discarded (each of a tile's 64 sums reads one A row
//   and one B row), and in a diagonal slice the rows past A's end are B's
//   (GM's) and meet only discarded entries too.  The ring is sized to the
//   block's column range: a stage holds at most 32 KB (a multiple of the
//   widest slice's phases) or the block's groups, and the ring has
//   min(3, the block's stages) of them, so a short range (128 columns at
//   the paths' n) is one stage loaded at once, or a few.  Where 16 groups
//   (256 bytes of each row, every lane of a warp's 8-group pass copying
//   two) pass 32 KB but two such stages fit the ring's 96 KB (staged rows
//   of 114-171: sketch's 8 rows of U beside 128 of R, stream_stats' P =
//   100), a stage holds 16 groups and the ring 2, at the same occupancy
//   and grid: at K = 8, m = 1 024,
//   n = 2^20 + 3 the 12-group stages of the rule above left 4 of a warp's
//   8 group lanes a second pass of four 4-byte copies a group and ran
//   4 353 us, two 16-group stages 2 540 (aligned rows: 2 410 either way).
//   A stage's size changes no sum: a thread's groups, and their order,
//   follow from its phase.
// Products.  Per group a thread reads its tile's 8 A rows (eight float4)
//   and, one at a time, its 8 B rows, and makes 4 FMAs per (A row, B row),
//   in column order: 16 LDS.128 for 256 FFMA.
// One launch a call.  Where the column split gives one block a slice (short
//   n, as the (100, 10) bias slab), the block adds its phases pairwise in a
//   fixed order (phase f takes f + 1, then f + 2, ...) through shared
//   memory, one thread per (entry, tile), and writes each entry through its
//   target; no scratch is used.  Otherwise each block writes its partial,
//   64 entries of one slot a thread (entry (r, k) of thread t at
//   (8r + k)·budget + t): where a full block has at most 8 phases each
//   thread writes its own sums as they are, else the block adds its phases
//   first (pairwise, as above) and tile q writes slot q.  A cooperative
//   launch sums the partials after one grid barrier, as gram_f32.cu (c):
//   the grid is one resident wave (kernels/cross.py::f32_call_plan from the
//   occupancy query).  After the barrier the blocks of a slice share its
//   entries, a contiguous run a block, so a block sums only entries of the
//   slice it holds; an entry is summed by L lanes of a warp (the least
//   power of two with 64·L >= its partials, 32·L at 128 registers): lane l
//   adds partials l, l + L, ... (blocks in order, phases in order), its
//   loads issued together, then a butterfly of shuffles adds the lanes.
// Targets.  Entry (x, y) of a slice (A row a0 + x, B index row b0 + y) goes
//   to out1[X][Y] for B1's rows (under `sym` only Y >= X, written with its
//   mirror out1[Y][X]), to out2[X][Y - M1] for B2's, or nowhere (padding).
//   With `accumulate` the sum is added to what the entry held.
//
// No float atomics: every sum runs in an order fixed by the shapes and the
// card (its SM count and the kernel's occupancy set the grid), so two calls
// on one card are bitwise equal.  Each output entry is written by one
// thread, with its mirror.  Offsets are 64-bit.
//
// Tried on the H100 in exploratory builds and not kept (a call's device us
// by torch.profiler beside the kept build's, NVIDIA H100 80GB HBM3, 700 W):
//   - the phases added in phase order by one thread a tile: 4.8e-4 off an
//     f64 product at Ka = Kb = 1, n = 2^20 + 3 (an entry of 1.45 from terms
//     of 666 000 in magnitude), against 1.0e-4 pairwise (cross.cuh: 3.1e-6,
//     the plain version 6.2e-5);
//   - phases up to the block's groups (a 1-tile slice over 128 columns in 32
//     phases) and each entry's target inlined 64 times in a thread's
//     writes: a one-block bias slab (P = 100, n = 10) took 26.6 us;
//   - phases added in the block through shared memory for every split
//     slice: P = 100, n = 7 840 spent 6.4 us a block on it (now 1.0);
//   - at most 8 loads a lane in the cross-block sum: 7 rounds of loads for
//     a block's 161 entries at P = 100, n = 7 840 (5.6 us, now 3.8-4.4);
//   - four 4-byte copies a group for every row at n = 7 850: the first
//     stage landed 4.6 us after a block began at Ka = Kb = 100;
//   - a short range cut into 4 stages or more, so its copies overlap its
//     products: Ka = Kb = 10 10.5 us against 8.2, Ka = Kb = 100 31.5
//     against 27.3;
//   - one B2 slice of 156 tiles (P = 100) beside the diagonal's 91: it ran
//     on one phase for 18 us;
//   - g's lone row shared out over U_b's tile columns (Ka = 64, Kb = 32: 32
//     tiles and 8 strip sums a thread, all 6 warps at work, 2 112 FMAs a
//     column dealt instead of 2 560): 4 248 us against 3 727-3 759;
//   - 32 phase sums per thread in registers: P = 100, n = 7 840 38.2 us
//     against 30.2.

#include <cooperative_groups.h>

#include <atomic>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;        // a block's threads, at most
constexpr int kNarrowThreads = 192;  // ... where the widest slice holds 10-192 tiles
constexpr int kSideTiles = 16;       // 8-row tiles of one side of a slice, at most
constexpr int kStages = 3;           // the cp.async ring, at most
constexpr int kStageBytes = 32768;   // a stage's size, at most
constexpr int kGroup = 4;            // columns of a group: one float4 a row
constexpr int kGranule = 128;        // a block's column range is a multiple
constexpr int kMaxSlices = 65535;    // gridDim.y
constexpr int kMaxSmem = 128 * 1024; // opted in for the kernel's instances
constexpr int kDirectPhases = 8;     // phases a split slice's partial holds as they are
constexpr int kLineGroups = 16;      // a stage of 256 bytes a row, where 32 KB holds fewer

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// 4 / 8 bytes global -> shared; the bytes past `bytes` are written as zeros
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async8(unsigned dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// One group of 4 columns of a row whose start lies `align` bytes past a
// 16-byte boundary (0, 4, 8 or 12), `left` columns of it inside the range
// (the rest zero-filled): one 16-byte copy, two 8-byte or four 4-byte.
__device__ __forceinline__ void copy_group(unsigned dst, const float* src,
                                           int align, long long left) {
  const int in = left < kGroup ? (int)left : kGroup;
  if (align == 0) {
    cp_async16(dst, src, 4 * in);
  } else if (align == 8) {
    cp_async8(dst, src, in >= 2 ? 8 : 4 * in);
    cp_async8(dst + 8, src + (in > 2 ? 2 : 0), in > 2 ? 4 * (in - 2) : 0);
  } else {
#pragma unroll
    for (int w = 0; w < kGroup; ++w)
      cp_async4(dst + 4 * w, src + (w < in ? w : 0), w < in ? 4 : 0);
  }
}

// (i, j), i <= j, of the q-th cell of the upper triangle of a T x T grid in
// row-major order
__host__ __device__ inline void tri_of(int q, int T, int* i, int* j) {
  int r = 0;
  while (q >= T - r) {
    q -= T - r;
    ++r;
  }
  *i = r;
  *j = r + q;
}

// Column phases of a slice of `tiles` tiles over a block's `groups` groups:
// the thread budget over the tiles, but at least 4 groups a phase, so a
// short range is not cut into phases whose sums cost more to add up than
// they save.
__host__ __device__ inline int phases_of(int budget, int tiles, int groups) {
  return imax(1, imin(budget / tiles, groups / 4));
}

// One row source: `rows` rows of `ld` elements apart.
struct Src {
  const float* ptr;
  long long ld;
  int rows;
};

// The cut of a problem into slices at a level (kernels/cross.py::F32Cuts).
struct Cuts {
  int ma, mb, sym;   // A's rows, B's index rows (B1's then B2's)
  int ta, tb;        // 8-row tiles of A and of B
  int na, nb, nb2;   // A's groups; B's (sym: na over [0, ta), nb2 after)

  __host__ __device__ Cuts(int ma_, int m1, int m2, int sym_, int level) {
    ma = ma_;
    mb = m1 + m2;
    sym = sym_;
    ta = cdiv(ma, 8);
    tb = cdiv(mb, 8);
    na = imin(ta, cdiv(ta, kSideTiles) * level);
    if (sym) {
      // B2's groups half the size of A's: a diagonal slice holds half the
      // tiles of a rectangle
      const int rest = tb - ta;
      nb2 = rest > 0 ? imin(rest, 2 * cdiv(rest, kSideTiles) * level) : 0;
      nb = na + nb2;
    } else {
      nb2 = 0;
      nb = imin(tb, cdiv(tb, kSideTiles) * level);
    }
  }
  // (32-bit: a·ta stays below 2^31 for every cut that fits gridDim.y)
  __host__ __device__ int a_tile(int a) const { return a * ta / na; }
  __host__ __device__ int b_tile(int b) const {
    if (!sym) return b * tb / nb;
    if (b <= na) return a_tile(b);
    return ta + (b - na) * (tb - ta) / nb2;
  }
  __host__ __device__ long long slices() const {
    if (!sym) return (long long)na * nb;
    return (long long)na * (na + 1) / 2 + (long long)na * nb2;
  }
  // (a, b) of slice s: row-major; under sym row a holds b = a .. na - 1,
  // then B2's groups
  __host__ __device__ void pair(int s, int* a, int* b) const {
    if (!sym) {
      *a = s / nb;
      *b = s % nb;
      return;
    }
    int r = 0;
    while (s >= na - r + nb2) {
      s -= na - r + nb2;
      ++r;
    }
    *a = r;
    *b = s < na - r ? r + s : na + s - (na - r);
  }
};

// One slice: A rows [a0, a0 + ka) against B index rows [b0, b0 + kb).
// Staged rows [0, rows_a) are A's, then B's; a diagonal slice (`shared`)
// stages B's alone and reads A's tiles from its first rows.
struct Slice {
  int a0, ka, b0, kb;
  int ta, tb;       // tiles of each side
  bool shared;
  int rows_a, rows;
  int tiles;

  __host__ __device__ Slice(const Cuts& c, int s) {
    int a = 0, b = 0;
    c.pair(s, &a, &b);
    const int t0 = c.a_tile(a), t1 = c.a_tile(a + 1);
    const int u0 = c.b_tile(b), u1 = c.b_tile(b + 1);
    a0 = 8 * t0;
    ka = imin(c.ma, 8 * t1) - a0;
    b0 = 8 * u0;
    kb = imin(c.mb, 8 * u1) - b0;
    ta = t1 - t0;
    tb = u1 - u0;
    shared = c.sym && a == b;
    rows_a = shared ? 0 : 8 * ta;
    rows = rows_a + 8 * tb;
    tiles = shared ? ta * (ta + 1) / 2 : ta * tb;
  }

  __device__ void tile(int q, int* i, int* j) const {
    if (shared) {
      tri_of(q, ta, i, j);
    } else {
      *i = q / tb;
      *j = q % tb;
    }
  }

  // (x, y) of entry e of tile q (x: A's row from a0, y: B's from b0)
  __device__ void entry(int q, int e, int* x, int* y) const {
    int i = 0, j = 0;
    tile(q, &i, &j);
    *x = 8 * i + e / 8;
    *y = 8 * j + e % 8;
  }
};

// What one launch runs (passed by value).
struct Params {
  Src a, b1, b2;
  int sym, level;
  long long n;
  long long cols_per_block;
  int groups;      // groups of 4 columns a stage
  int ring;        // stages in the ring (1-3)
  int slots;       // 16-byte slots of a staged group
  float* partial;
  float* out1;
  long long ld1;
  float* out2;
  long long ld2;
  int accumulate;
};

// first float of staged row x's row, or null (padding)
__device__ __forceinline__ const float* row_ptr(const Params& p,
                                                const Slice& sl, int x) {
  if (x < sl.rows_a) {
    if (x >= sl.ka) return nullptr;
    return p.a.ptr + (long long)(sl.a0 + x) * p.a.ld;
  }
  const int y = x - sl.rows_a;
  if (y >= sl.kb) return nullptr;
  const long long Y = sl.b0 + y;
  return Y < p.b1.rows ? p.b1.ptr + Y * p.b1.ld
                       : p.b2.ptr + (Y - p.b1.rows) * p.b2.ld;
}

// where entry (x, y) of a slice goes (x: A's row from a0, y: B's from b0):
// out1 and, under sym, its mirror; out2; or nowhere (p0 null)
__device__ __forceinline__ void target(const Params& p, const Slice& sl,
                                       int x, int y, float** p0,
                                       float** p1) {
  *p0 = *p1 = nullptr;
  if (x >= sl.ka || y >= sl.kb) return;
  const long long X = sl.a0 + x, Y = sl.b0 + y;
  if (Y < p.b1.rows) {
    if (p.sym && Y < X) return;   // the mirror of (Y, X)
    *p0 = p.out1 + X * p.ld1 + Y;
    if (p.sym && Y != X) *p1 = p.out1 + Y * p.ld1 + X;
  } else {
    *p0 = p.out2 + X * p.ld2 + (Y - p.b1.rows);
  }
}

__device__ __forceinline__ void store(const Params& p, float* p0, float* p1,
                                      float v) {
  if (p.accumulate) v = *p0 + v;
  *p0 = v;
  if (p1 != nullptr) *p1 = v;
}

template <bool kVec, int kBudget>
__global__ void __launch_bounds__(kBudget, 2)
cross_f32_tiles(const Params p) {
  extern __shared__ float4 smem[];
  const Cuts cuts(p.a.rows, p.b1.rows, p.b2.rows, p.sym, p.level);
  const Slice sl(cuts, (int)blockIdx.y);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const long long col0 = (long long)blockIdx.x * p.cols_per_block;
  const long long col1 = col0 + p.cols_per_block < p.n ? col0 + p.cols_per_block : p.n;
  const int G = p.groups;
  const int R = p.ring;
  const int stage_cols = kGroup * G;
  const int stage_slots = G * p.slots;
  const int block_groups = (int)((col1 - col0 + kGroup - 1) / kGroup);
  const int num_stages = cdiv(block_groups, G);
  const int phases = phases_of(kBudget, sl.tiles, block_groups);
  auto groups_in = [&](int tt) {      // groups of stage tt inside [col0, col1)
    const int left = block_groups - tt * G;
    return left < G ? left : G;
  };

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
      const float* rp = row_ptr(p, sl, x);
      if (rp == nullptr) continue;
      const float* src = rp + base;
      const int align = (int)(reinterpret_cast<uintptr_t>(src) & 15);
      unsigned dst = st + (cq * p.slots + x + (x >> 3)) * 16u;
      for (int gi = cq; gi < gv; gi += 8) {
        if constexpr (kVec)
          cp_async16(dst, src, 16);
        else
          copy_group(dst, src, align, col1 - (base + kGroup * (gi - cq)));
        src += 8 * kGroup;
        dst += 8u * p.slots * 16u;
      }
    }
  };

  const int q = tid % sl.tiles;
  const int ph = tid / sl.tiles;
  const bool active = ph < phases;
  int ti = 0, tj = 0;
  sl.tile(q, &ti, &tj);
  const int aoff = 9 * ti;                          // slot of A row 8·ti
  const int boff = 9 * (sl.rows_a / 8 + tj);        // slot of B row 8·tj
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[r][k] = 0.f;

  for (int s = 0; s < R - 1; ++s) {
    if (s < num_stages) load_stage(s, s);
    cp_async_commit();
  }
  for (int tt = 0; tt < num_stages; ++tt) {
    if (R == 1) {                 // one stage: the block's whole range
      load_stage(0, 0);
      cp_async_commit();
    }
    if (R == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // stage tt has landed; every thread is done with tt - 1
    if (R > 1) {
      if (tt + R - 1 < num_stages) load_stage(tt + R - 1, (tt + R - 1) % R);
      cp_async_commit();
    }
    if (active) {
      const float4* st = smem + (tt % R) * stage_slots;
      const int gv = groups_in(tt);
      // this thread's groups: the block's groups g ≡ ph (mod phases)
      int gi = (ph - (int)((long long)tt * G % phases) + phases) % phases;
      for (; gi < gv; gi += phases) {
        const float4* grp = st + gi * p.slots;
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

  // Each (tile, entry) sum once: written through its target where one block
  // owns the slice, else into the block's partial.
  // A split slice whose full blocks have at most kDirectPhases phases
  // writes every phase's sums to its partial as they are (slot ph·tiles +
  // q of each entry, zeros past a short block's own phases), and the sum
  // over the grid takes phases with blocks; else the block adds its phases
  // first (slot q).  A block's partial: 64 entries of kBudget slots.
  const bool one = gridDim.x == 1;
  const int full_phases =
      phases_of(kBudget, sl.tiles, (int)(p.cols_per_block / kGroup));
  const bool direct = !one && full_phases <= kDirectPhases;
  const long long P = 64LL * kBudget;
  float* part = one ? nullptr
                    : p.partial + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * P;
  auto emit = [&](int qq, int e, float v) {
    if (one) {
      int x = 0, y = 0;
      float *p0, *p1;
      sl.entry(qq, e, &x, &y);
      target(p, sl, x, y, &p0, &p1);
      if (p0 != nullptr) store(p, p0, p1, v);
    } else {
      part[e * kBudget + qq] = v;
    }
  };
  if (direct || (phases == 1 && !one)) {
    if (direct ? ph < full_phases : active) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k) part[(r * 8 + k) * kBudget + tid] = acc[r][k];
    }
  } else {
    // the phases of each (tile, entry), added pairwise, through shared
    // memory (so each entry's target is found at one place in the code: 64
    // inlined copies of it once took a one-tile block 20 us); an entry's
    // row of phase sums is phases·tiles + 1 floats long, so the readers of
    // one tile's 64 entries fall in distinct banks
    float* red = reinterpret_cast<float*>(smem);
    const int pt = phases * sl.tiles + 1;
    if (active) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int k = 0; k < 8; ++k) red[(r * 8 + k) * pt + tid] = acc[r][k];
    }
    __syncthreads();
    for (int item = tid; item < 64 * sl.tiles; item += nthreads) {
      const int e = item / sl.tiles;
      const int qq = item - e * sl.tiles;
      float* col = red + e * pt + qq;
      // pairwise, in a fixed order: phase f takes phase f + w, w = 1, 2, 4..
      for (int w = 1; w < phases; w *= 2)
        for (int f = 0; f + w < phases; f += 2 * w)
          col[f * sl.tiles] += col[(f + w) * sl.tiles];
      emit(qq, e, col[0]);
    }
  }
  if (one) return;

  __threadfence();
  cg::this_grid().sync();

  // the slice's entries j = 64·tiles in all (entry rk of tile qq: j =
  // rk·tiles + qq), a contiguous run of them for this block; an entry's
  // partials are w = b·F + f over blocks b and phase slots f, in that order
  const int nblk = gridDim.x;
  const int F = direct ? full_phases : 1;
  const int parts = nblk * F;
  const int entries = 64 * sl.tiles;
  const int run = cdiv(entries, nblk);
  // lanes an entry: kBatch loads a lane at most (64 at 168 registers, 32
  // at 128), issued together
  constexpr int kBatch = kBudget == kNarrowThreads ? 64 : 32;
  int L = 1;
  while (L < 32 && L * kBatch < parts) L <<= 1;
  const int step_b = L / F, step_f = L % F;   // w += L as (b, f)
  const int j0 = blockIdx.x * run;
  const int j1 = imin(entries, j0 + run);
  const int per_warp = 32 / L;
  const float* slice_part = p.partial + (long long)blockIdx.y * nblk * P;
  for (int base = j0 + warp * per_warp; base < j1; base += nwarps * per_warp) {
    const int j = base + lane / L;
    const bool live = j < j1;
    const int rk = live ? j / sl.tiles : 0;
    const int qq = live ? j - rk * sl.tiles : 0;
    const float* src = slice_part + rk * kBudget + qq;
    float v = 0.f;
    for (int w0 = lane % L; w0 < parts; w0 += kBatch * L) {
      float x[kBatch];
      int b = w0 / F, f = w0 - b * F;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        x[u] = live && b < nblk ? src[b * P + f * sl.tiles] : 0.f;
        b += step_b;
        f += step_f;
        if (f >= F) {
          f -= F;
          ++b;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (w0 + u * L < parts) v += x[u];
    }
    for (int off = L / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (live && lane % L == 0) {
      int x = 0, y = 0;
      float *p0, *p1;
      sl.entry(qq, rk, &x, &y);
      target(p, sl, x, y, &p0, &p1);
      if (p0 != nullptr) store(p, p0, p1, v);
    }
  }
}

// ------------------------------------------------------------- host side

// The tile counts a slice of these cuts can have: balanced groups hold the
// floor or the ceiling of T / n tiles, so the counts are the products of
// those (a diagonal slice: g(g+1)/2).  At most 12.
int tile_counts(const Cuts& c, int* out) {
  int k = 0;
  const int as[2] = {c.ta / c.na, cdiv(c.ta, c.na)};
  int bs[2] = {0, 0};           // B's groups: all of them, or B2's (sym)
  if (!c.sym) {
    bs[0] = c.tb / c.nb;
    bs[1] = cdiv(c.tb, c.nb);
  } else if (c.nb2 > 0) {
    bs[0] = (c.tb - c.ta) / c.nb2;
    bs[1] = cdiv(c.tb - c.ta, c.nb2);
  }
  for (int i = 0; i < 2; ++i) {
    if (as[i] == 0) continue;
    if (c.sym) {
      out[k++] = as[i] * (as[i] + 1) / 2;
      if (c.na > 1)
        for (int j = 0; j < 2; ++j)
          if (as[j] > 0) out[k++] = as[i] * as[j];
    }
    for (int j = 0; j < 2; ++j)
      if (bs[j] > 0) out[k++] = as[i] * bs[j];
  }
  return k;
}

// The staged rows of the widest slice: a diagonal one stages one side.
int max_rows(const Cuts& c) {
  const int a_hi = cdiv(c.ta, c.na);
  if (!c.sym) return 8 * (a_hi + cdiv(c.tb, c.nb));
  int rows = 8 * a_hi;
  if (c.na > 1) rows = 16 * a_hi;
  if (c.nb2 > 0) rows = imax(rows, 8 * (a_hi + cdiv(c.tb - c.ta, c.nb2)));
  return rows;
}

// What a launch of these cuts is (kernels/cross.py::f32_plan computes the
// same): threads, the stage and the ring for a block's range of
// `block_groups` groups (0: the widest the plan allows, for the occupancy
// query), and the dynamic shared memory.
struct Plan {
  int budget, slots, groups, ring, max_tiles, smem_bytes;
};

Plan plan_of(const Cuts& c, int block_groups) {
  Plan p;
  int counts[12];
  const int k = tile_counts(c, counts);
  p.max_tiles = 1;
  for (int i = 0; i < k; ++i) p.max_tiles = imax(p.max_tiles, counts[i]);
  p.budget = p.max_tiles >= 10 && p.max_tiles <= kNarrowThreads ? kNarrowThreads
                                                                 : kThreads;
  const int rows = max_rows(c);
  p.slots = rows + rows / 8;
  // a stage's groups: a multiple of the widest slice's phases (each phase
  // then takes as many of a whole stage), at most 32 KB
  const int full = imax(1, kStageBytes / (p.slots * 16));
  const int wide_phases = imax(1, p.budget / p.max_tiles);
  int stage = full >= wide_phases ? full / wide_phases * wide_phases : full;
  int max_ring = kStages;
  if (kLineGroups * p.slots * 16 > kStageBytes &&
      2 * kLineGroups * p.slots * 16 <= kStages * kStageBytes) {
    stage = kLineGroups;   // two stages of whole lines, the same 96 KB
    max_ring = 2;
  }
  const int bg = block_groups > 0 ? block_groups : 1 << 30;
  p.groups = imin(stage, bg);
  p.ring = block_groups > 0 ? imin(max_ring, cdiv(bg, p.groups)) : max_ring;
  int red = 0;
  for (int i = 0; i < k; ++i) {
    red = imax(red, 64 * (phases_of(p.budget, counts[i], bg) * counts[i] + 1));
  }
  p.smem_bytes = imax(p.ring * p.groups * p.slots * 16, red * 4);
  return p;
}

using Kernel = void (*)(const Params);

Kernel kernel_of(int vec, int budget) {
  if (budget == kNarrowThreads)
    return vec ? cross_f32_tiles<true, kNarrowThreads>
               : cross_f32_tiles<false, kNarrowThreads>;
  return vec ? cross_f32_tiles<true, kThreads>
             : cross_f32_tiles<false, kThreads>;
}

// Above 48 KB of dynamic shared memory a kernel must opt in: once per
// instance and device, to kMaxSmem (every plan stays under it).
cudaError_t opt_in(int vec, int budget) {
  static std::atomic<unsigned long long> opted_in[4];
  const int which = 2 * vec + (budget == kNarrowThreads);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (opted_in[which].load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel_of(vec, budget),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess) opted_in[which].fetch_or(bit);
  return err;
}

bool shape_ok(int ma, int m1, int m2, int sym, int level) {
  if (ma < 1 || m1 < 1 || m2 < 0 || level < 1 || level > kMaxSlices ||
      (sym && m1 != ma))
    return false;
  return Cuts(ma, m1, m2, sym, level).slices() <= kMaxSlices;
}

}  // namespace

// Launch configuration for A with ma rows against [B1 (m1 rows); B2 (m2)]
// (sym: B1 is A) at this level (vec: 16-byte copies): the blocks resident
// per SM at the widest ring the plan allows (the grid is one wave of them),
// the slices, and the floats of one block's partial.  Returns a CUDA error
// code.
extern "C" int cross_f32_launch_config(int ma, int m1, int m2, int sym,
                                       int level, int vec, int* blocks_per_sm,
                                       int* slices, int* partial_floats) {
  if (!shape_ok(ma, m1, m2, sym, level))
    return static_cast<int>(cudaErrorInvalidValue);
  const Cuts cuts(ma, m1, m2, sym, level);
  const Plan plan = plan_of(cuts, 0);
  cudaError_t err = opt_in(vec, plan.budget);
  if (err != cudaSuccess) return static_cast<int>(err);
  *slices = (int)cuts.slices();
  *partial_floats = 64 * plan.budget;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel_of(vec, plan.budget), plan.budget,
      plan.smem_bytes));
}

// A (ma, n), B1 (m1, n), B2 (m2, n) f32 with rows lda / ldb1 / ldb2
// elements apart (sym: B1 is A); vec: every pointer 16-byte aligned, every
// row stride and n multiples of 4.  num_blocks column ranges of
// cols_per_block (a multiple of 128) cover n for each slice, and the grid's
// blocks are one resident wave when num_blocks > 1; then partial holds
// partial_floats >= slices·num_blocks·(the block's partial) f32, else it is
// unused (may be null).  out1 (ma, m1) and out2 (ma, m2) f32 with row
// strides ld1, ld2, written (or added to, with accumulate).  Anything else:
// cudaErrorInvalidValue.  Returns cudaGetLastError() after the one launch on
// `stream`.
extern "C" int cross_f32_launch(const void* a, long long lda, int ma,
                                const void* b1, long long ldb1, int m1,
                                const void* b2, long long ldb2, int m2,
                                int sym, long long n, int level, int vec,
                                void* partial, long long partial_floats,
                                int num_blocks, long long cols_per_block,
                                void* out1, long long ld1, void* out2,
                                long long ld2, int accumulate, void* stream) {
  auto aligned = [](const void* ptr, long long ld, int rows) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
           (rows <= 1 || ld % kGroup == 0);
  };
  if (!shape_ok(ma, m1, m2, sym, level) || n < 1 || num_blocks < 1 ||
      cols_per_block % kGranule != 0 ||
      (long long)num_blocks * cols_per_block < n ||
      (sym && (a != b1 || lda != ldb1)) ||
      (vec && (n % kGroup != 0 || !aligned(a, lda, ma) ||
               !aligned(b1, ldb1, m1) || (m2 > 0 && !aligned(b2, ldb2, m2)))))
    return static_cast<int>(cudaErrorInvalidValue);
  const Cuts cuts(ma, m1, m2, sym, level);
  const long long bg = cols_per_block / kGroup;
  const Plan plan = plan_of(cuts, (int)(bg < (1 << 30) ? bg : 1 << 30));
  const long long slices = cuts.slices();
  if (num_blocks > 1 &&
      (partial == nullptr ||
       partial_floats < slices * num_blocks * 64LL * plan.budget))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in(vec, plan.budget);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.a = {static_cast<const float*>(a), lda, ma};
  p.b1 = {static_cast<const float*>(b1), ldb1, m1};
  p.b2 = {static_cast<const float*>(b2), ldb2, m2};
  p.sym = sym;
  p.level = level;
  p.n = n;
  p.cols_per_block = cols_per_block;
  p.groups = plan.groups;
  p.ring = plan.ring;
  p.slots = plan.slots;
  p.partial = static_cast<float*>(partial);
  p.out1 = static_cast<float*>(out1);
  p.ld1 = ld1;
  p.out2 = static_cast<float*>(out2);
  p.ld2 = ld2;
  p.accumulate = accumulate;
  const Kernel kernel = kernel_of(vec, plan.budget);
  const dim3 grid(num_blocks, (unsigned)slices);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (num_blocks == 1) {
    kernel<<<grid, plan.budget, plan.smem_bytes, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    grid, dim3(plan.budget), args,
                                    plan.smem_bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
