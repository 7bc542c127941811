// sign_sketch: S = U Rᵀ / √m (K x m, f32) with the ±1 matrix R (m x n)
// generated from its (row, column, seed) counters and never stored, and its
// adjoint Rᵀ s / √m (n, f32) for the decode side.
//
// Replaces repro/kernels/rng_sketch.py::rng_sketch_pallas (the Pallas kernel
// builds each (m, block_n) sign tile in VMEM and contracts it on the MXU) and
// rng_sketch_adjoint_xla (no Pallas version in the reference).  The hash is
// rng_hash.cuh, shared by both kernels.
//
// What bounds it on the H100: not the bytes.  U is K·n values read once, but
// every one of the m·n entries of R costs a hash (rng_hash.cuh): for its
// sign, 5 shift/logic operations on the INT32 pipe (64 lanes per SM, 16.75
// Tops/s) and 2 multiplies on the FMA pipe (128 lanes, 33.5 Tops/s), then
// per row of U a sign flip (INT32) and an add (FMA).  The INT32 pipe binds:
// (5 + K)·m·n operations, ~3.4 µs at the path's shape (K = 1, n = 7850,
// m = 981) against ~10 ns of bytes.  The tensor cores cannot help: R is
// born in registers, one entry per hash.  So the design keeps every lane hashing: each thread owns one
// row i of R (its row hash computed once), blocks own (128-row tile,
// column range) pairs so K = 1 still fills the card from m and n, the
// block's U columns are staged in shared memory and read as broadcasts, and
// R·u is a sign-bit flip of u, not a multiply.
//
// Determinism: pass 1 writes one partial per (column range, k, row); pass 2
// sums the ranges in a fixed order and applies 1/√m.  Within a thread the
// columns are summed tile by tile (256 columns a tile, tiles then summed),
// which keeps the f32 rounding of long rows small.  No float atomics, so two
// calls give bitwise-equal results.  The adjoint gives every output column to
// one thread, which loops over the m rows (row hashes and s staged in shared
// memory per 256-row tile): deterministic with one pass.

#include <math.h>

#include "common.cuh"
#include "rng_hash.cuh"

namespace {

using repro_torch::apply_sign;
using repro_torch::row_hash;
using repro_torch::to_f32;

constexpr int kRowsPerBlock = 128;  // rows of R per block, one per thread
constexpr int kColTile = 256;       // columns of U staged per step
constexpr int kMaxKC = 8;           // rows of U one launch accumulates
constexpr int kAdjThreads = 64;     // adjoint: output columns per block
constexpr int kAdjRowTile = 256;    // adjoint: rows of R staged per step

template <typename TU, int KC>
__global__ void __launch_bounds__(kRowsPerBlock)
sign_sketch_partial(const TU* __restrict__ U, int K, int64_t n, uint32_t seed,
                    int m, int64_t cols_per_split, float* __restrict__ partial) {
  __shared__ float tile[KC][kColTile];
  const int i = blockIdx.x * kRowsPerBlock + threadIdx.x;
  const int64_t c0 = (int64_t)blockIdx.y * cols_per_split;
  const int64_t c1 = c0 + cols_per_split < n ? c0 + cols_per_split : n;
  const uint32_t rh = row_hash((uint32_t)i, seed);
  float acc[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) acc[k] = 0.f;
  for (int64_t base = c0; base < c1; base += kColTile) {
    const int width = c1 - base < kColTile ? (int)(c1 - base) : kColTile;
    __syncthreads();
    for (int e = threadIdx.x; e < KC * kColTile; e += kRowsPerBlock) {
      const int k = e / kColTile;
      const int t = e % kColTile;
      tile[k][t] = (k < K && t < width) ? to_f32(U[(int64_t)k * n + base + t]) : 0.f;
    }
    __syncthreads();
    float tacc[KC];
#pragma unroll
    for (int k = 0; k < KC; ++k) tacc[k] = 0.f;
    const uint32_t j0 = (uint32_t)base;
    for (int t = 0; t < width; ++t) {
      const uint32_t h = repro_torch::mix32((j0 + (uint32_t)t) ^ rh);
      const uint32_t sbit = h & 0x80000000u;
#pragma unroll
      for (int k = 0; k < KC; ++k)
        tacc[k] += __uint_as_float(__float_as_uint(tile[k][t]) ^ sbit);
    }
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] += tacc[k];
  }
  if (i < m) {
#pragma unroll
    for (int k = 0; k < KC; ++k)
      if (k < K) partial[((int64_t)blockIdx.y * KC + k) * m + i] = acc[k];
  }
}

// out[k, i] = Σ_split partial[split, k, i] / √m, splits in order.
__global__ void sign_sketch_finish(const float* __restrict__ partial, int KC,
                                   int K, int m, int n_splits, float sqrt_m,
                                   float* __restrict__ out) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)K * m) return;
  const int k = (int)(e / m);
  const int i = (int)(e % m);
  float s = 0.f;
  for (int sp = 0; sp < n_splits; ++sp) s += partial[((int64_t)sp * KC + k) * m + i];
  out[(int64_t)k * m + i] = s / sqrt_m;
}

__global__ void __launch_bounds__(kAdjThreads)
sign_sketch_adjoint_kernel(const float* __restrict__ s, int m, uint32_t seed,
                           int64_t n, float sqrt_m, float* __restrict__ out) {
  __shared__ float ss[kAdjRowTile];
  __shared__ uint32_t rh[kAdjRowTile];
  const int64_t j = (int64_t)blockIdx.x * kAdjThreads + threadIdx.x;
  const uint32_t col = (uint32_t)j;
  float acc = 0.f;
  for (int base = 0; base < m; base += kAdjRowTile) {
    const int h = m - base < kAdjRowTile ? m - base : kAdjRowTile;
    __syncthreads();
    for (int r = threadIdx.x; r < h; r += kAdjThreads) {
      ss[r] = s[base + r];
      rh[r] = row_hash((uint32_t)(base + r), seed);
    }
    __syncthreads();
    float tacc = 0.f;
    for (int r = 0; r < h; ++r) tacc += apply_sign(ss[r], rh[r], col);
    acc += tacc;
  }
  if (j < n) out[j] = acc / sqrt_m;
}

template <typename TU>
cudaError_t launch_partial(int KC, const TU* U, int K, int64_t n, uint32_t seed,
                           int m, int m_tiles, int n_splits,
                           int64_t cols_per_split, float* partial,
                           cudaStream_t st) {
  const dim3 grid(m_tiles, n_splits);
  switch (KC) {
    case 1: sign_sketch_partial<TU, 1><<<grid, kRowsPerBlock, 0, st>>>(U, K, n, seed, m, cols_per_split, partial); break;
    case 2: sign_sketch_partial<TU, 2><<<grid, kRowsPerBlock, 0, st>>>(U, K, n, seed, m, cols_per_split, partial); break;
    case 4: sign_sketch_partial<TU, 4><<<grid, kRowsPerBlock, 0, st>>>(U, K, n, seed, m, cols_per_split, partial); break;
    default: sign_sketch_partial<TU, kMaxKC><<<grid, kRowsPerBlock, 0, st>>>(U, K, n, seed, m, cols_per_split, partial); break;
  }
  return cudaGetLastError();
}

int chunk_rows(int K) { return K <= 1 ? 1 : K <= 2 ? 2 : K <= 4 ? 4 : kMaxKC; }

}  // namespace

// U (K, n) row-major, f32 or bf16; out (K, m) f32.  The grid is m_tiles =
// ceil(m / 128) row tiles by n_splits column ranges of cols_per_split; U's
// rows go through in chunks of up to 8 (one partial pass each), so partial
// holds partial_floats >= n_splits * min(K, 8) * m f32 (checked).
// Returns cudaGetLastError() after the launches on `stream`.
extern "C" int sign_sketch_launch(const void* U, int K, long long n, int u_bf16,
                                  unsigned seed, int m, void* partial,
                                  long long partial_floats, void* out,
                                  int n_splits, long long cols_per_split,
                                  void* stream) {
  if (K < 1 || n < 1 || m < 1 || n_splits < 1 ||
      (long long)n_splits * cols_per_split < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const int KC = chunk_rows(K);
  if (partial_floats < (long long)n_splits * KC * m)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m_tiles = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  const float sqrt_m = sqrtf(static_cast<float>(m));
  float* p = static_cast<float*>(partial);
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = K - k0 < KC ? K - k0 : KC;
    cudaError_t err;
    if (u_bf16)
      err = launch_partial(KC, static_cast<const __nv_bfloat16*>(U) + (int64_t)k0 * n,
                           kc, n, seed, m, m_tiles, n_splits, cols_per_split, p, st);
    else
      err = launch_partial(KC, static_cast<const float*>(U) + (int64_t)k0 * n, kc,
                           n, seed, m, m_tiles, n_splits, cols_per_split, p, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long outs = (long long)kc * m;
    sign_sketch_finish<<<(unsigned)((outs + 255) / 256), 256, 0, st>>>(
        p, KC, kc, m, n_splits, sqrt_m, static_cast<float*>(out) + (int64_t)k0 * m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// s (m,) f32 -> out (n,) f32 = Rᵀ s / √m.  Returns cudaGetLastError().
extern "C" int sign_sketch_adjoint_launch(const void* s, int m, unsigned seed,
                                          long long n, void* out, void* stream) {
  if (m < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + kAdjThreads - 1) / kAdjThreads;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  sign_sketch_adjoint_kernel<<<(unsigned)blocks, kAdjThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), m, seed, n, sqrtf(static_cast<float>(m)),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
