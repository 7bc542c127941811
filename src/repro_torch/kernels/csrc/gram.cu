// gram: G = U Uᵀ (K x K) and c = U g (K) in f32, one pass over the n columns.
//
// Replaces the Pallas TPU kernel repro/kernels/gram.py::gram_pallas
// (_gram_kernel), which carries a (K, K) accumulator across the sequential
// grid steps of one TPU core.  Hopper runs blocks in parallel and in no order,
// so nothing carries over between blocks; this is a deterministic two-pass
// split reduction instead:
//
//   pass 1 (gram_partial_kernel): each block owns one contiguous column range.
//     It stages (R x 128) tiles of the extended matrix E = [U; g] (K + 1 rows,
//     zero-padded to R, a multiple of 4) in shared memory as f32, laid out
//     [column][row] so a thread reads four rows of a column with one 16-byte
//     load.  The next tile is loaded into registers while the current one is
//     multiplied, so global-load latency overlaps the FMAs.  The upper triangle of E Eᵀ is cut into 4 x 4 register tiles; each
//     thread owns one tile and one phase of the columns, and accumulates its 16
//     entries in f32 registers with FMAs on the CUDA cores (no TF32).  Row K of
//     E is g, so column K of E Eᵀ is c.  The column phases are summed in a
//     fixed order and the block writes its (R x R) partial to scratch.
//   pass 2 (gram_finish_kernel): one thread per (i <= j) entry sums the
//     per-block partials in block order and mirrors G.
//
// No float atomics: every sum runs in an order fixed by the shape, the dtypes
// and the card (its SM count and the kernel's occupancy set the grid), so two
// calls on one card give bitwise-equal results.
//
// What bounds it on the H100: the bytes of U and g, read once — (K+1)·n·4 B
// in f32 — against 3.35 TB/s, while the work is K(K+1)/2 + K FMAs per column.
// At K = 64 in f32 the two are close (1.30 ms of bytes, 1.07 ms of f32 FMA at
// 67 TFLOP/s for n = 2^24); in bf16 the bytes halve and a CUDA-core kernel
// becomes bound by its FMAs.  Moving the product to the tensor cores
// (mma.sync / wgmma, bf16 in, f32 accumulate) is the step beyond this design.
// U's rows start at byte 4·k·n, which is not 16-byte aligned for odd n, so the
// global loads are scalar (coalesced along the columns).

#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kThreads = 256;
constexpr int kTile = 128;  // columns staged per step
constexpr int kMaxK = 64;
constexpr int kRowStep = kThreads / kTile;  // rows a block stages per register slot
constexpr int kMaxRowsPerThread = (kMaxK + 1 + 3) / 4 * 4 / kRowStep;
static_assert(kThreads % kTile == 0, "a thread stages one column");

// (ti, tj) of the t-th 4 x 4 tile of the upper triangle, row-major order.
__device__ __forceinline__ void tile_of(int t, int T, int* ti, int* tj) {
  int i = 0;
  while (t >= T - i) {
    t -= T - i;
    ++i;
  }
  *ti = i;
  *tj = i + t;
}

// kSlots: register slots per thread for staging, >= R / kRowStep; the launch
// picks the smallest instance that fits, so small K pays for few slots.
template <typename TU, typename TG, int kSlots>
__device__ __forceinline__ void
gram_partial_body(const TU* __restrict__ U, const TG* __restrict__ g,
                  float* __restrict__ partial, int K, int64_t n,
                  int64_t cols_per_block, int R, int num_tiles, int S) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int64_t col0 = (int64_t)blockIdx.x * cols_per_block;
  const int64_t col1 = col0 + cols_per_block < n ? col0 + cols_per_block : n;

  const int task = tid / S;
  const int phase = tid % S;
  const bool active = task < num_tiles;
  int ti = 0, tj = 0;
  if (active) tile_of(task, R / 4, &ti, &tj);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // Thread t stages column t % kTile of each tile, rows t / kTile + 2i, in
  // registers first, in the input dtype: the next tile's loads are in flight
  // while this tile is multiplied out of shared memory, and nothing waits on
  // them (not even the bf16 -> f32 conversion) until the next stash.
  const int my_col = tid % kTile;
  const int my_row0 = tid / kTile;
  const TU zero_u = from_f32<TU>(0.f);
  const TG zero_g = from_f32<TG>(0.f);
  TU stage[kSlots];
  TG stage_g = zero_g;
  auto fetch = [&](int64_t base) {
    const bool in = base + my_col < col1;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int r = my_row0 + kRowStep * i;
      stage[i] = (in && r < K) ? U[(int64_t)r * n + base + my_col] : zero_u;
      if (r == K) stage_g = in ? g[base + my_col] : zero_g;
    }
  };

  if (col0 < col1) fetch(col0);
  for (int64_t base = col0; base < col1; base += kTile) {
    const int width = col1 - base < kTile ? (int)(col1 - base) : kTile;
    // E[:, base:base + width] as f32, [column][row]
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int r = my_row0 + kRowStep * i;
      if (r < R)
        smem[my_col * R + r] = r < K ? to_f32(stage[i]) : (r == K ? to_f32(stage_g) : 0.f);
    }
    __syncthreads();
    if (base + kTile < col1) fetch(base + kTile);
    if (active) {
      for (int cc = phase; cc < width; cc += S) {
        const float4 a = *reinterpret_cast<const float4*>(&smem[cc * R + 4 * ti]);
        const float4 b = *reinterpret_cast<const float4*>(&smem[cc * R + 4 * tj]);
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
  float* out = partial + (int64_t)blockIdx.x * R * R;
  for (int idx = tid; idx < num_tiles * 16; idx += kThreads) {
    const int t = idx / 16;
    const int e = idx % 16;
    float s = 0.f;
    for (int p = 0; p < S; ++p) s += red[(t * S + p) * 16 + e];
    int a, b;
    tile_of(t, R / 4, &a, &b);
    out[(4 * a + e / 4) * R + 4 * b + e % 4] = s;
  }
}

__global__ void gram_finish_kernel(const float* __restrict__ partial,
                                   int num_blocks, int K, int R,
                                   float* __restrict__ G, float* __restrict__ c) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int Kx = K + 1;
  if (idx >= Kx * Kx) return;
  const int i = idx / Kx;
  const int j = idx % Kx;
  if (i > j || i == K) return;
  float s = 0.f;
  for (int b = 0; b < num_blocks; ++b) s += partial[(int64_t)b * R * R + i * R + j];
  if (j < K) {
    G[i * K + j] = s;
    G[j * K + i] = s;
  } else {
    c[i] = s;
  }
}

struct Shape {
  int R, num_tiles, S, smem_bytes;
  explicit Shape(int K) {
    R = (K + 1 + 3) / 4 * 4;
    const int T = R / 4;
    num_tiles = T * (T + 1) / 2;
    S = kThreads / num_tiles;
    if (S > kTile) S = kTile;
    const int floats = kTile * R > kThreads * 16 ? kTile * R : kThreads * 16;
    smem_bytes = floats * (int)sizeof(float);
  }
};

using PartialKernel = void (*)(const void*, const void*, float*, int, int64_t,
                               int64_t, int, int, int);

template <typename TU, typename TG, int kSlots>
__global__ void __launch_bounds__(kThreads, 3)
gram_partial_entry(const void* U, const void* g, float* partial, int K,
                   int64_t n, int64_t cols_per_block, int R, int num_tiles,
                   int S) {
  gram_partial_body<TU, TG, kSlots>(static_cast<const TU*>(U),
                                    static_cast<const TG*>(g), partial, K, n,
                                    cols_per_block, R, num_tiles, S);
}

template <typename TU, typename TG>
PartialKernel pick(int R) {
  const int slots = R / kRowStep;
  if (slots <= 4) return gram_partial_entry<TU, TG, 4>;
  if (slots <= 8) return gram_partial_entry<TU, TG, 8>;
  if (slots <= 16) return gram_partial_entry<TU, TG, 16>;
  return gram_partial_entry<TU, TG, kMaxRowsPerThread>;
}

// The partial kernel for these input dtypes and this K.
PartialKernel partial_kernel(int K, int u_bf16, int g_bf16) {
  const int R = Shape(K).R;
  if (u_bf16 && g_bf16) return pick<__nv_bfloat16, __nv_bfloat16>(R);
  if (u_bf16) return pick<__nv_bfloat16, float>(R);
  if (g_bf16) return pick<float, __nv_bfloat16>(R);
  return pick<float, float>(R);
}

}  // namespace

// Launch configuration of the partial kernel for this K and these dtypes:
// its dynamic shared memory per block, and the blocks resident per SM (the
// grid is sized to fill the card in one wave).  Returns a CUDA error code.
extern "C" int gram_launch_config(int K, int u_bf16, int g_bf16,
                                  int* blocks_per_sm, int* smem_bytes) {
  if (K < 1 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  *smem_bytes = Shape(K).smem_bytes;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, partial_kernel(K, u_bf16, g_bf16), kThreads, *smem_bytes));
}

// U (K, n) and g (n,) row-major, f32 or bf16 each; partial holds
// partial_floats >= num_blocks * R * R f32 (R = 4·ceil((K+1)/4), checked);
// G (K, K) and c (K,) f32.
// Returns cudaGetLastError() after the two launches on `stream`.
extern "C" int gram_launch(const void* U, const void* g, void* partial,
                           long long partial_floats, void* G, void* c, int K,
                           long long n, int u_bf16, int g_bf16, int num_blocks,
                           long long cols_per_block, void* stream) {
  if (K < 1 || K > kMaxK || n < 1 || num_blocks < 1 ||
      (long long)num_blocks * cols_per_block < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh(K);
  if (partial_floats < (long long)num_blocks * sh.R * sh.R)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  const PartialKernel kernel = partial_kernel(K, u_bf16, g_bf16);
  kernel<<<num_blocks, kThreads, sh.smem_bytes, st>>>(
      U, g, p, K, n, cols_per_block, sh.R, sh.num_tiles, sh.S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int entries = (K + 1) * (K + 1);
  gram_finish_kernel<<<(entries + 127) / 128, 128, 0, st>>>(
      p, num_blocks, K, sh.R, static_cast<float*>(G), static_cast<float*>(c));
  return static_cast<int>(cudaGetLastError());
}
