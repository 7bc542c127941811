// gram: G = U Uᵀ (K x K) and c = U g (K) in f32, one pass over the n columns.
//
// Replaces the Pallas TPU kernel repro/kernels/gram.py::gram_pallas
// (_gram_kernel), which carries a (K, K) accumulator across the sequential
// grid steps of one TPU core.  Hopper runs blocks in parallel and in no order,
// so nothing carries over between blocks; this is a deterministic two-pass
// split reduction instead:
//
//   pass 1 (gram_partial_entry): each block owns one slice of the output
//     (below) and one contiguous column range.  It stages (R x 128) tiles
//     (R x 64 above K = 64) of the slice's rows of the extended matrix
//     E = [U; g] in shared memory as f32, laid out [column][row] so a thread
//     reads four rows of a column with one 16-byte load.  The next tile is
//     loaded into registers while the current one is multiplied, so
//     global-load latency overlaps the FMAs.
//     The slice's part of E Eᵀ is cut into 4 x 4 register tiles; each thread
//     owns one tile and one phase of the columns, and accumulates its 16
//     entries in f32 registers with FMAs on the CUDA cores (no TF32).  The
//     column phases are summed in a fixed order and the block writes its
//     (R x R) partial to scratch.
//   pass 2 (gram_finish_kernel): one thread per output entry of a slice sums
//     the per-block partials in block order and writes G (mirrored) or c.
//
// Slices: the rows of U are cut into nb row blocks of up to kMaxK = 64 rows,
// and the grid has one slice (blockIdx.y) per pair of blocks a <= b.  A
// diagonal slice (a, a) stages [U_a; g] and computes the upper triangle of
// its product: U_a U_aᵀ and, in the column of g, c_a.  A cross slice (a < b)
// stages [U_a; U_b] (up to 128 rows) and computes only the rectangle
// U_a U_bᵀ.  Every slice owns all it computes, so each entry of G and c is
// written once.  Up to K = 64 the grid is the single diagonal slice, the
// kernel's fast path.  Above it U is read nb times (once by its diagonal
// slice, nb - 1 times by the cross slices): at K = 100, 202 staged rows per
// column and 5632 FMAs for the 5150 needed.  Staged rows cost time whatever
// their FMAs (32-row blocks staged 488 rows at K = 100 and ran 1.3x slower,
// PERF.md), so row blocks are as tall as a cross slice's register staging
// allows: 32 slots of a 64-column step hold its 128 rows.
//
// No float atomics: every sum runs in an order fixed by the shape, the dtypes
// and the card (its SM count and the kernel's occupancy set the grid), so two
// calls on one card give bitwise-equal results.
//
// What bounds it on the H100: the bytes of U and g, read once — (K+1)·n·4 B
// in f32 — against 3.35 TB/s, while the work is K(K+1)/2 + K FMAs per column.
// At K = 64 in f32 the two are close (1.30 ms of bytes, 1.07 ms of f32 FMA at
// 67 TFLOP/s for n = 2^24); in bf16 the bytes halve and a CUDA-core kernel
// becomes bound by its FMAs.  Above 64 rows the FMAs grow as K², so the
// product bounds it.  On this design the full cross slice sets the time: its
// 256 tiles keep every thread reading two 16-byte operands from shared
// memory per 16 FMAs, while the diagonal slices, with as many blocks, finish
// early.  Where U and g are both bf16 (K <= 127, n % 8 == 0, aligned), the
// product runs on the tensor cores instead: gram_mma.cu (mma.sync, bf16 in,
// f32 accumulate), chosen by kernels/gram.py::_mma_eligible.
// U's rows start at byte 4·k·n, which is not 16-byte aligned for odd n, so the
// global loads are scalar (coalesced along the columns).

#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kThreads = 256;
constexpr int kTile = 128;        // columns staged per step (64 when sliced)
constexpr int kMaxK = 64;         // rows of U in one row block
constexpr int kMaxSlicesPerLaunch = 65535;  // gridDim.y limit
static_assert(kThreads % kTile == 0, "a thread stages one column");

__host__ __device__ constexpr int min_int(int x, int y) { return x < y ? x : y; }
__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// Shared-memory row stride for R staged rows: R, or R + 4 when R / 4 is even,
// so that the float4 reads of consecutive column phases fall in other banks.
__host__ __device__ __forceinline__ int smem_stride(int R) {
  return (R / 4) % 2 == 0 ? R + 4 : R;
}

// (ti, tj), ti <= tj, of the t-th cell of the upper triangle of a T x T
// grid, row-major order.
__host__ __device__ __forceinline__ void tile_of(int t, int T, int* ti, int* tj) {
  int i = 0;
  while (t >= T - i) {
    t -= T - i;
    ++i;
  }
  *ti = i;
  *tj = i + t;
}

// Row blocks of U, of up to kMaxK rows each.
__host__ __device__ __forceinline__ int row_blocks(int K) {
  return (K + kMaxK - 1) / kMaxK;
}

// Rows a slice stages at most (and the scratch stride of one partial).
__host__ __device__ __forceinline__ int max_rows(int K) {
  return K <= kMaxK ? round4(K + 1) : 2 * kMaxK;
}

// One slice (a, b >= a) of the output.  E rows [0, Ka) are U rows
// [a0, a0 + Ka); on a cross slice rows [kMaxK, kMaxK + Kb) are U rows
// [b0, b0 + Kb), on a diagonal slice row g_row = Ka is g.
struct Slice {
  int a0, Ka, b0, Kb, g_row;
  int R;           // staged rows, a multiple of 4
  int tcols;       // cross slice: tile columns of the rectangle; 0 if diagonal
  int num_tiles;   // 4 x 4 tiles

  // the whole of U as one diagonal slice (K <= kMaxK)
  __host__ __device__ explicit Slice(int K)
      : a0(0), Ka(K), b0(0), Kb(0), g_row(K), R(round4(K + 1)), tcols(0),
        num_tiles(R / 4 * (R / 4 + 1) / 2) {}

  __host__ __device__ Slice(int s, int K) {
    int a = 0, b = 0;
    tile_of(s, row_blocks(K), &a, &b);
    a0 = a * kMaxK;
    Ka = min_int(kMaxK, K - a0);
    if (a == b) {
      b0 = 0;
      Kb = 0;
      g_row = Ka;
      R = round4(Ka + 1);
      tcols = 0;
      num_tiles = R / 4 * (R / 4 + 1) / 2;
    } else {              // a < b, so block a is whole: Ka = kMaxK
      b0 = b * kMaxK;
      Kb = min_int(kMaxK, K - b0);
      g_row = -1;
      R = kMaxK + round4(Kb);
      tcols = R / 4 - kMaxK / 4;
      num_tiles = kMaxK / 4 * tcols;
    }
  }

  // (ti, tj) of the t-th 4 x 4 tile: the upper triangle, or the rectangle
  // of U_a's rows against U_b's
  __device__ __forceinline__ void tile(int t, int* ti, int* tj) const {
    if (tcols == 0) {
      tile_of(t, R / 4, ti, tj);
    } else {
      *ti = t / tcols;
      *tj = kMaxK / 4 + t % tcols;
    }
  }

  // U row of E row r, or -1 (g or padding)
  __device__ __forceinline__ int urow(int r) const {
    if (r < Ka) return a0 + r;
    if (r >= kMaxK && r < kMaxK + Kb) return b0 + r - kMaxK;
    return -1;
  }
};

// Columns a block stages per step: a sliced block stages up to 128 rows, so
// it takes half as many columns to keep the same register slots per thread.
template <bool kSliced>
__host__ __device__ constexpr int step_cols() { return kSliced ? kTile / 2 : kTile; }

// Register slots per thread that stage the widest slice of an instance.
template <bool kSliced>
__host__ __device__ constexpr int max_slots() {
  return (kSliced ? 2 * kMaxK : round4(kMaxK + 1)) / (kThreads / step_cols<kSliced>());
}

// kSlots: register slots per thread for staging, >= R / kStep; the launch
// picks the smallest instance that fits, so small K pays for few slots.
// kSliced: the grid holds the slices of K > kMaxK; without it the one slice
// is the whole of U and its descriptor folds to constants at compile time.
template <typename TU, typename TG, int kSlots, bool kSliced>
__device__ __forceinline__ void
gram_partial_body(const TU* __restrict__ U, const TG* __restrict__ g,
                  float* __restrict__ partial, int K, int64_t n,
                  int64_t cols_per_block, int slice0) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int kCols = step_cols<kSliced>();
  constexpr int kStep = kThreads / kCols;   // rows a block stages per register slot
  const Slice sl = kSliced ? Slice(slice0 + blockIdx.y, K) : Slice(K);
  const int R = sl.R;
  const int S = min_int(kCols, kThreads / sl.num_tiles);  // column phases per tile
  const int Rs = smem_stride(R);
  const int tid = threadIdx.x;
  const int64_t col0 = (int64_t)blockIdx.x * cols_per_block;
  const int64_t col1 = col0 + cols_per_block < n ? col0 + cols_per_block : n;

  const int task = tid / S;
  const int phase = tid % S;
  const bool active = task < sl.num_tiles;
  int ti = 0, tj = 0;
  if (active) sl.tile(task, &ti, &tj);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // Thread t stages column t % kCols of each tile, rows t / kCols + kStep·i, in
  // registers first, in the input dtype: the next tile's loads are in flight
  // while this tile is multiplied out of shared memory, and nothing waits on
  // them (not even the bf16 -> f32 conversion) until the next stash.
  const int my_col = tid % kCols;
  const int my_row0 = tid / kCols;
  const TU zero_u = from_f32<TU>(0.f);
  const TG zero_g = from_f32<TG>(0.f);
  TU stage[kSlots];
  TG stage_g = zero_g;
  auto fetch = [&](int64_t base) {
    const bool in = base + my_col < col1;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int r = my_row0 + kStep * i;
      const int u = sl.urow(r);
      stage[i] = (in && u >= 0) ? U[(int64_t)u * n + base + my_col] : zero_u;
      if (r == sl.g_row) stage_g = in ? g[base + my_col] : zero_g;
    }
  };

  if (col0 < col1) fetch(col0);
  for (int64_t base = col0; base < col1; base += kCols) {
    const int width = col1 - base < kCols ? (int)(col1 - base) : kCols;
    // E[:, base:base + width] as f32, [column][row]
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int r = my_row0 + kStep * i;
      if (r < R)
        smem[my_col * Rs + r] = r == sl.g_row ? to_f32(stage_g) : to_f32(stage[i]);
    }
    __syncthreads();
    if (base + kCols < col1) fetch(base + kCols);
    if (active) {
      for (int cc = phase; cc < width; cc += S) {
        const float4 a = *reinterpret_cast<const float4*>(&smem[cc * Rs + 4 * ti]);
        const float4 b = *reinterpret_cast<const float4*>(&smem[cc * Rs + 4 * tj]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // sum the S column phases of each tile in phase order
  float* red = smem;  // [num_tiles * S][16]
  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[tid * 16 + i * 4 + j] = acc[i][j];
  }
  __syncthreads();
  const int P = max_rows(K) * max_rows(K);
  float* out = partial + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * P;
  for (int idx = tid; idx < sl.num_tiles * 16; idx += kThreads) {
    const int t = idx / 16;
    const int e = idx % 16;
    float s = 0.f;
    for (int p = 0; p < S; ++p) s += red[(t * S + p) * 16 + e];
    int a, b;
    sl.tile(t, &a, &b);
    out[(4 * a + e / 4) * R + 4 * b + e % 4] = s;
  }
}

// One thread per entry (i, j) of one slice's (R x R) partial: sums the
// per-block partials in block order and writes the entry of G (and its
// mirror) or of c that it stands for, if any.
__global__ void gram_finish_kernel(const float* __restrict__ partial,
                                   int num_blocks, int K, int slice0,
                                   float* __restrict__ G, float* __restrict__ c) {
  const Slice sl(slice0 + blockIdx.y, K);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= sl.R * sl.R) return;
  const int i = idx / sl.R;
  const int j = idx % sl.R;
  const int gi = sl.urow(i);
  const int gj = sl.urow(j);
  if (gi < 0) return;                                // i: a row of U
  if (sl.tcols ? (i >= kMaxK || j < kMaxK) : i > j)
    return;                                          // outside the slice's tiles
  const bool to_c = j == sl.g_row;
  if (gj < 0 && !to_c) return;                       // padding
  const int P = max_rows(K) * max_rows(K);
  const float* p = partial + (int64_t)blockIdx.y * num_blocks * P;
  float s = 0.f;
  for (int blk = 0; blk < num_blocks; ++blk) s += p[(int64_t)blk * P + i * sl.R + j];
  if (to_c) {
    c[gi] = s;
  } else {
    G[(int64_t)gi * K + gj] = s;
    G[(int64_t)gj * K + gi] = s;
  }
}

// Dynamic shared memory of a block: the staged tile at the widest slice's
// stride, or the phase-reduction buffer, whichever is larger.
int smem_bytes_of(int K) {
  const int cols = K <= kMaxK ? step_cols<false>() : step_cols<true>();
  const int tile = cols * smem_stride(max_rows(K));
  return (tile > kThreads * 16 ? tile : kThreads * 16) * (int)sizeof(float);
}

using PartialKernel = void (*)(const void*, const void*, float*, int, int64_t,
                               int64_t, int);

// Three blocks of 256 threads per SM cap a thread at 80 registers; the
// sliced instance takes two blocks per SM (128 registers) so its 32 slots
// do not spill.
template <typename TU, typename TG, int kSlots, bool kSliced>
__global__ void __launch_bounds__(kThreads, kSliced ? 2 : 3)
gram_partial_entry(const void* U, const void* g, float* partial, int K,
                   int64_t n, int64_t cols_per_block, int slice0) {
  gram_partial_body<TU, TG, kSlots, kSliced>(
      static_cast<const TU*>(U), static_cast<const TG*>(g), partial, K, n,
      cols_per_block, slice0);
}

template <typename TU, typename TG>
PartialKernel pick(int K) {
  if (K > kMaxK) return gram_partial_entry<TU, TG, max_slots<true>(), true>;
  const int slots = max_rows(K) / (kThreads / kTile);
  if (slots <= 4) return gram_partial_entry<TU, TG, 4, false>;
  if (slots <= 8) return gram_partial_entry<TU, TG, 8, false>;
  if (slots <= 16) return gram_partial_entry<TU, TG, 16, false>;
  return gram_partial_entry<TU, TG, max_slots<false>(), false>;
}

// The partial kernel for these input dtypes and this K.
PartialKernel partial_kernel(int K, int u_bf16, int g_bf16) {
  if (u_bf16 && g_bf16) return pick<__nv_bfloat16, __nv_bfloat16>(K);
  if (u_bf16) return pick<__nv_bfloat16, float>(K);
  if (g_bf16) return pick<float, __nv_bfloat16>(K);
  return pick<float, float>(K);
}

}  // namespace

// Launch configuration of the partial kernel for this K and these dtypes:
// its dynamic shared memory per block, and the blocks resident per SM (the
// grid is sized to fill the card in one wave).  Returns a CUDA error code.
extern "C" int gram_launch_config(int K, int u_bf16, int g_bf16,
                                  int* blocks_per_sm, int* smem_bytes) {
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  *smem_bytes = smem_bytes_of(K);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, partial_kernel(K, u_bf16, g_bf16), kThreads, *smem_bytes));
}

// U (K, n) and g (n,) row-major, f32 or bf16 each; partial holds
// partial_floats >= slices * num_blocks * Rm * Rm f32 (Rm = 4·ceil((K+1)/4)
// up to K = 64, else 128; slices = nb(nb+1)/2 for nb row blocks — checked);
// G (K, K) and c (K,) f32.  num_blocks is the column split of each slice.
// Returns cudaGetLastError() after the launches on `stream`.
extern "C" int gram_launch(const void* U, const void* g, void* partial,
                           long long partial_floats, void* G, void* c, int K,
                           long long n, int u_bf16, int g_bf16, int num_blocks,
                           long long cols_per_block, void* stream) {
  if (K < 1 || n < 1 || num_blocks < 1 ||
      (long long)num_blocks * cols_per_block < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Rm = max_rows(K);
  const long long nb = row_blocks(K);
  const long long slices = nb * (nb + 1) / 2;
  const long long per_slice = (long long)num_blocks * Rm * Rm;
  if (partial_floats < slices * per_slice)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  const PartialKernel kernel = partial_kernel(K, u_bf16, g_bf16);
  const int smem = smem_bytes_of(K);
  for (long long s0 = 0; s0 < slices; s0 += kMaxSlicesPerLaunch) {
    const int ns = (int)(slices - s0 < kMaxSlicesPerLaunch ? slices - s0 : kMaxSlicesPerLaunch);
    float* ps = p + s0 * per_slice;
    kernel<<<dim3(num_blocks, ns), kThreads, smem, st>>>(
        U, g, ps, K, n, cols_per_block, (int)s0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gram_finish_kernel<<<dim3((Rm * Rm + 127) / 128, ns), 128, 0, st>>>(
        ps, num_blocks, K, (int)s0, static_cast<float*>(G), static_cast<float*>(c));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
