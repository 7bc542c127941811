// sign_sketch, second body: S = U Rᵀ / √m (K x m, f32) and its adjoint
// Rᵀ s / √m (n, f32), with the ±1 matrix R (m x n) hashed from its (row,
// column, seed) counters and never stored.  Every call takes this body;
// rng_sketch.cu keeps the first one, run only to compare the two.
//
// Replaces repro/kernels/rng_sketch.py::rng_sketch_pallas (the Pallas kernel
// builds each (m, block_n) sign tile in VMEM and contracts it on the MXU) and
// rng_sketch_adjoint_xla (no Pallas version in the reference), as
// rng_sketch.cu does.
//
// The hash, factored.  R[i, j] = 1 - 2·msb(mix32(j ^ rh_i)), rh_i =
// mix32(i ^ seed) (rng_hash.cuh).  mix32's first step is x ^ (x >> 16), and
// a shift distributes over xor, so for x = j ^ rh_i it equals
// cc_j ^ R1_i with cc_j = j ^ (j >> 16) (the column's half) and R1_i =
// rh_i ^ (rh_i >> 16) (the row's half).  Each half is computed once per
// column or row, and a sign costs what is left: y = (cc_j ^ R1_i)·M1,
// y ^= y >> 13, y ·= M2 (mix32's last xor-shift keeps the msb), and ±1.0f
// from y's msb in one LOP3.  Six integer operations, then one FFMA per row
// of U: acc + u·(±1) rounds once, exactly as the first body's sign flip and
// add did.
//
// What bounds it on the H100: the instructions a sign needs, not the bytes
// (U is read once, R never is).  Each SM issues four warp instructions a
// clock, 128 thread operations, the FP32 (FFMA) lanes' rate: 6 + K
// operations a sign at 33.5 Tops/s, of which 3 (the two xors and the LOP3)
// only the 64 INT32 lanes can run (chip_smoke.py's hash_ops_s).  In
// practice the INT32 lanes bind (the shift stays there too: 4 of the 6),
// and beside them the shared-memory broadcasts: a 16-byte load that every
// lane of a warp reads costs the SM's shared memory as much as one that
// each lane reads for itself, so each broadcast value is used for RI rows
// (the sketch) or CJ columns (the adjoint) a lane.
//
// The sketch.  A block of 8 warps owns 32·RI rows of R (a lane owns RI rows,
// lane + 32·r) and one of RANKS column ranges; the RANKS blocks of a row
// tile form a thread-block cluster, one range per cluster rank.  A rank's columns are
// dealt evenly to its warps, and each warp stages its own, 32 at a time: lane
// l loads column base + l of U's KC rows (kept in registers while the
// previous 32 are summed) and writes it, as f32, with cc_j beside it, into
// the warp's slice of shared memory, read back as 16-byte broadcasts (four
// columns a load).  No block barrier in the loop, so a warp waiting on its
// loads holds up no other.  A lane sums each 32 columns into a chunk sum,
// added to its running sum after the chunk (a long row is summed in 32-column
// pieces).  RI and RANKS come from the shapes (kernels/rng_sketch.py
// col_plan): the most rows a lane that still leave every SM two blocks, and
// clusters of 16 (past the portable 8, opt-in) where 8 column ranges leave
// fewer than two blocks an SM.
//
// One launch per chunk of at most 8 rows of U, and no partials in device
// memory: the 8 warps' sums go through shared memory and are added in warp
// order; then the cluster adds its blocks' sums through distributed shared
// memory in rank order (each rank adds and writes 1/RANKS of the row tile's
// outputs, / √m), between two cluster barriers.  A cluster and not a
// last-block-done pass over a counter in device memory: no scratch, no
// counter to keep zeroed across calls and streams, and no fence.  The cost
// is a cap of 16 column splits: at small m and large n (m = 1 024, n = 2^20)
// 512 blocks share the SMs unevenly.
// No float atomics, so two calls are bitwise equal.
//
// The adjoint.  A block of 16 warps is 16 / WR column groups of 32·CJ columns
// (a lane owns CJ columns, j and j + 32·c, their cc_j in registers) by WR
// row slices.  R1_i and s_i are staged for 2 048 rows at a time (four rows a
// thread); the tile's rows are dealt evenly to the slices, each slice sums
// its rows tile by tile, then the slices' sums are added in slice order
// through shared memory.  WR and CJ come from the shapes
// (kernels/rng_sketch.py adjoint_plan): WR = 16, CJ = 1 at the paths' n =
// 7 850 (246 blocks, ~30 warps an SM), WR = 1, CJ = 4 at model widths.

#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"
#include "rng_hash.cuh"

namespace cg = cooperative_groups;

namespace {

using repro_torch::row_hash;
using repro_torch::to_f32;

constexpr int kWarps = 8;                       // sketch: warps of a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxKC = 8;                       // rows of U a launch sums
constexpr int kAdjWarps = 16;                   // adjoint: warps of a block
constexpr int kAdjThreads = 32 * kAdjWarps;
constexpr int kAdjRowTile = 2048;               // adjoint: rows staged at a time

// The column's half of mix32's first xor-shift.
__device__ __forceinline__ uint32_t col_half(uint32_t j) { return j ^ (j >> 16); }

// The row's half: R1_i = rh ^ (rh >> 16), rh = mix32(i ^ seed).
__device__ __forceinline__ uint32_t row_half(uint32_t i, uint32_t seed) {
  const uint32_t rh = row_hash(i, seed);
  return rh ^ (rh >> 16);
}

// R[i, j] as ±1.0f from x = cc_j ^ R1_i: the rest of mix32 up to its msb,
// then (y & 0x80000000) | 1.0f as one LOP3 (written out: from the two
// immediates the compiler makes two)
__device__ __forceinline__ float sign_of(uint32_t x) {
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  uint32_t s;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(s) : "r"(x), "r"(0x80000000u), "r"(0x3F800000u));
  return __uint_as_float(s);
}

template <typename TU, int KC, int RI, int RANKS>
__global__ void __launch_bounds__(kThreads)
sign_sketch_col(const TU* __restrict__ U, int K, long long n, uint32_t seed,
                int m, long long cols_per_rank, float sqrt_m,
                float* __restrict__ out) {
  constexpr int kRows = 32 * RI;           // rows of R of a block
  constexpr int kOut = KC * kRows;         // its outputs
  __shared__ __align__(16) float us[kWarps][KC][32];   // a warp's chunk of U
  __shared__ __align__(16) uint32_t ccs[kWarps][32];   // ... and its cc_j
  __shared__ float red[kWarps * kOut];
  __shared__ float part[kOut];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row0 = (long long)(blockIdx.x / RANKS) * kRows;
  const long long c0 = (long long)rank * cols_per_rank;
  const long long c1 = c0 + cols_per_rank < n ? c0 + cols_per_rank : n;
  // the rank's columns dealt evenly to the warps, in multiples of 4
  const long long per_warp = ((c1 - c0 + kWarps - 1) / kWarps + 3) & ~3LL;
  const long long w0 = c0 + warp * per_warp;
  const long long w1 = w0 + per_warp < c1 ? w0 + per_warp : c1;

  uint32_t r1[RI];
#pragma unroll
  for (int r = 0; r < RI; ++r) r1[r] = row_half((uint32_t)(row0 + lane + 32 * r), seed);
  float acc[RI][KC];
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[r][k] = 0.f;

  // A warp stages its own columns, 32 at a time (lane l loads column
  // base + l of each row of U), loading the next chunk into registers
  // while it sums the current one: no block barrier in the loop.
  TU nu[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k)
    if (k < K && w0 + lane < w1) nu[k] = U[(long long)k * n + w0 + lane];
  for (long long base = w0; base < w1; base += 32) {
    __syncwarp();
#pragma unroll
    for (int k = 0; k < KC; ++k)
      us[warp][k][lane] = (k < K && base + lane < w1) ? to_f32(nu[k]) : 0.f;
    ccs[warp][lane] = col_half((uint32_t)(base + lane));
    __syncwarp();
    const long long next = base + 32;
#pragma unroll
    for (int k = 0; k < KC; ++k)
      if (k < K && next + lane < w1) nu[k] = U[(long long)k * n + next + lane];

    const int cnt = w1 - base < 32 ? (int)(w1 - base) : 32;
    float tacc[RI][KC];
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int k = 0; k < KC; ++k) tacc[r][k] = 0.f;
    // a group past w1 was staged as u = 0 and adds ±0
#pragma unroll 2
    for (int t = 0; t < cnt; t += 4) {
      const uint4 c4 = *reinterpret_cast<const uint4*>(&ccs[warp][t]);
      float4 u4[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) u4[k] = *reinterpret_cast<const float4*>(&us[warp][k][t]);
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const float s0 = sign_of(c4.x ^ r1[r]);
        const float s1 = sign_of(c4.y ^ r1[r]);
        const float s2 = sign_of(c4.z ^ r1[r]);
        const float s3 = sign_of(c4.w ^ r1[r]);
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          float a = tacc[r][k];
          a = fmaf(u4[k].x, s0, a);
          a = fmaf(u4[k].y, s1, a);
          a = fmaf(u4[k].z, s2, a);
          a = fmaf(u4[k].w, s3, a);
          tacc[r][k] = a;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int k = 0; k < KC; ++k) acc[r][k] += tacc[r][k];
  }

  // the warps' sums, added in warp order
#pragma unroll
  for (int r = 0; r < RI; ++r)
#pragma unroll
    for (int k = 0; k < KC; ++k) red[(warp * KC + k) * kRows + 32 * r + lane] = acc[r][k];
  __syncthreads();
  for (int e = threadIdx.x; e < kOut; e += kThreads) {
    float v = red[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += red[w * kOut + e];
    part[e] = v;
  }
  // the cluster's column ranges, added in rank order; rank ρ writes
  // outputs [ρ·kOut/RANKS, (ρ+1)·kOut/RANKS) of the row tile
  cluster.sync();
  constexpr int kShare = kOut / RANKS;
  if (threadIdx.x < kShare) {
    const int e = (int)rank * kShare + threadIdx.x;
    float v = *cluster.map_shared_rank(&part[e], 0);
#pragma unroll
    for (int src = 1; src < RANKS; ++src) v += *cluster.map_shared_rank(&part[e], src);
    const int k = e / kRows;
    const long long i = row0 + e % kRows;
    if (k < K && i < m) out[(long long)k * m + i] = v / sqrt_m;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int CJ>
__global__ void __launch_bounds__(kAdjThreads)
sign_sketch_adjoint_col(const float* __restrict__ s, int m, uint32_t seed,
                        long long n, int wr, float sqrt_m,
                        float* __restrict__ out) {
  __shared__ __align__(16) float ss[kAdjRowTile];
  __shared__ __align__(16) uint32_t r1s[kAdjRowTile];
  __shared__ float red[kAdjWarps][CJ][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = warp % wr;                  // row slice
  const int g = warp / wr;                  // column group
  // the lane's columns: j0 + 32·c, c < CJ
  const long long j0 = (long long)blockIdx.x * (32 * CJ * (kAdjWarps / wr)) + 32 * CJ * g + lane;
  uint32_t cc[CJ];
  float acc[CJ];
#pragma unroll
  for (int c = 0; c < CJ; ++c) {
    cc[c] = col_half((uint32_t)(j0 + 32 * c));
    acc[c] = 0.f;
  }
  for (int base = 0; base < m; base += kAdjRowTile) {
    const int h = m - base < kAdjRowTile ? m - base : kAdjRowTile;
    __syncthreads();
#pragma unroll
    for (int t = threadIdx.x; t < kAdjRowTile; t += kAdjThreads) {
      ss[t] = t < h ? s[base + t] : 0.f;
      r1s[t] = row_half((uint32_t)(base + t), seed);
    }
    __syncthreads();
    // the tile's rows dealt evenly to the slices, in multiples of 4; a
    // group past h was staged as s = 0 and adds ±0
    const int per = ((h + wr - 1) / wr + 3) & ~3;
    const int lo = q * per;
    const int hi = lo + per < h ? lo + per : h;
    float tacc[CJ];
#pragma unroll
    for (int c = 0; c < CJ; ++c) tacc[c] = 0.f;
#pragma unroll 2
    for (int r = lo; r < hi; r += 4) {
      const uint4 R = *reinterpret_cast<const uint4*>(&r1s[r]);
      const float4 S = *reinterpret_cast<const float4*>(&ss[r]);
#pragma unroll
      for (int c = 0; c < CJ; ++c) {
        float a = tacc[c];
        a = fmaf(S.x, sign_of(cc[c] ^ R.x), a);
        a = fmaf(S.y, sign_of(cc[c] ^ R.y), a);
        a = fmaf(S.z, sign_of(cc[c] ^ R.z), a);
        a = fmaf(S.w, sign_of(cc[c] ^ R.w), a);
        tacc[c] = a;
      }
    }
#pragma unroll
    for (int c = 0; c < CJ; ++c) acc[c] += tacc[c];
  }
  // the slices' sums, added in slice order
#pragma unroll
  for (int c = 0; c < CJ; ++c) red[warp][c][lane] = acc[c];
  __syncthreads();
  if (q == 0) {
#pragma unroll
    for (int c = 0; c < CJ; ++c) {
      float v = acc[c];
      for (int p = 1; p < wr; ++p) v += red[warp + p][c][lane];
      if (j0 + 32 * c < n) out[j0 + 32 * c] = v / sqrt_m;
    }
  }
}

// One chunk's launch: blocks of 256 threads in clusters of `ranks` (8, or
// 16 with the non-portable cluster size allowed).
template <typename TU, int KC, int RI, int RANKS>
cudaError_t launch_chunk(const TU* U, int K, long long n, uint32_t seed, int m,
                         long long cols_per_rank, float sqrt_m, float* out,
                         unsigned blocks, cudaStream_t st) {
  auto kern = sign_sketch_col<TU, KC, RI, RANKS>;
  if (RANKS > 8) {  // once per device: clusters past 8 blocks are opt-in
    static unsigned long long allowed = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (!(allowed >> dev & 1ULL)) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      allowed |= 1ULL << dev;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = RANKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, U, K, n, seed, m, cols_per_rank, sqrt_m, out);
}

template <typename TU, int RANKS>
cudaError_t launch_ranks(int KC, int RI, const TU* U, int K, long long n,
                         uint32_t seed, int m, long long cols_per_rank,
                         float sqrt_m, float* out, unsigned blocks,
                         cudaStream_t st) {
#define REPRO_COL_CASE(kc, ri) \
  case kc * 10 + ri: \
    return launch_chunk<TU, kc, ri, RANKS>(U, K, n, seed, m, cols_per_rank, sqrt_m, out, blocks, st);
  switch (KC * 10 + RI) {
    REPRO_COL_CASE(1, 1) REPRO_COL_CASE(1, 2) REPRO_COL_CASE(1, 4)
    REPRO_COL_CASE(2, 1) REPRO_COL_CASE(2, 2) REPRO_COL_CASE(2, 4)
    REPRO_COL_CASE(4, 1) REPRO_COL_CASE(4, 2)
    REPRO_COL_CASE(8, 1) REPRO_COL_CASE(8, 2)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_COL_CASE
}

template <typename TU>
cudaError_t launch_col(int ranks, int KC, int RI, const TU* U, int K,
                       long long n, uint32_t seed, int m,
                       long long cols_per_rank, float sqrt_m, float* out,
                       unsigned blocks, cudaStream_t st) {
  return ranks == 16 ? launch_ranks<TU, 16>(KC, RI, U, K, n, seed, m, cols_per_rank, sqrt_m, out, blocks, st)
                     : launch_ranks<TU, 8>(KC, RI, U, K, n, seed, m, cols_per_rank, sqrt_m, out, blocks, st);
}

int chunk_rows(int K) { return K <= 1 ? 1 : K <= 2 ? 2 : K <= 4 ? 4 : kMaxKC; }

}  // namespace

// U (K, n) row-major, f32 or bf16; out (K, m) f32.  U's rows go through in
// chunks of up to 8, one launch each, of ceil(m / (32·ri)) row tiles x
// `ranks` (8 or 16) cluster ranks; rank ρ sums columns [ρ·cols_per_rank,
// (ρ+1)·cols_per_rank) (ranks·cols_per_rank >= n).  ri, a lane's rows, is 1 or 2, or 4 with chunks of
// 1 or 2 rows.
// Returns cudaGetLastError() after the launches on `stream`.
extern "C" int sign_sketch_col_launch(const void* U, int K, long long n,
                                      int u_bf16, unsigned seed, int m, int ri,
                                      int ranks, long long cols_per_rank, void* out,
                                      void* stream) {
  const int KC = chunk_rows(K);
  if (K < 1 || n < 1 || m < 1 || (ranks != 8 && ranks != 16) ||
      (long long)ranks * cols_per_rank < n ||
      (ri != 1 && ri != 2 && (ri != 4 || KC > 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = ((long long)m + 32 * ri - 1) / (32 * ri);
  if (tiles * ranks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = (unsigned)(tiles * ranks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sqrt_m = sqrtf(static_cast<float>(m));
  float* o = static_cast<float*>(out);
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = K - k0 < KC ? K - k0 : KC;
    const cudaError_t err =
        u_bf16 ? launch_col(ranks, KC, ri, static_cast<const __nv_bfloat16*>(U) + (long long)k0 * n,
                            kc, n, seed, m, cols_per_rank, sqrt_m,
                            o + (long long)k0 * m, blocks, st)
               : launch_col(ranks, KC, ri, static_cast<const float*>(U) + (long long)k0 * n,
                            kc, n, seed, m, cols_per_rank, sqrt_m,
                            o + (long long)k0 * m, blocks, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// s (m,) f32 -> out (n,) f32 = Rᵀ s / √m, in blocks of 16 / wr column groups
// of 32·cj columns by wr row slices (wr in {1, 2, 4, 8, 16}, cj in {1, 2,
// 4}).  Returns cudaGetLastError().
extern "C" int sign_sketch_adjoint_col_launch(const void* s, int m,
                                              unsigned seed, long long n,
                                              int wr, int cj, void* out,
                                              void* stream) {
  if (m < 1 || n < 1 || wr < 1 || wr > kAdjWarps || (wr & (wr - 1)) != 0 ||
      (cj != 1 && cj != 2 && cj != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long cols = 32LL * cj * (kAdjWarps / wr);
  const long long blocks = (n + cols - 1) / cols;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const float* sp = static_cast<const float*>(s);
  float* o = static_cast<float*>(out);
  const float sqrt_m = sqrtf(static_cast<float>(m));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cj == 1) sign_sketch_adjoint_col<1><<<(unsigned)blocks, kAdjThreads, 0, st>>>(sp, m, seed, n, wr, sqrt_m, o);
  if (cj == 2) sign_sketch_adjoint_col<2><<<(unsigned)blocks, kAdjThreads, 0, st>>>(sp, m, seed, n, wr, sqrt_m, o);
  if (cj == 4) sign_sketch_adjoint_col<4><<<(unsigned)blocks, kAdjThreads, 0, st>>>(sp, m, seed, n, wr, sqrt_m, o);
  return static_cast<int>(cudaGetLastError());
}
