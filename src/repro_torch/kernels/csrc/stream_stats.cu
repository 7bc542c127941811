// stream_stats: G = D Dᵀ and C = D GMᵀ (P x P each, f32) in one pass over the
// n columns of a round's stacked updates D and gradient estimates GM.
//
// Replaces the Pallas TPU kernel repro/kernels/stream.py::stream_stats_pallas
// (_stream_stats_kernel), which walks (P, block_n) tiles of both streams
// through VMEM and carries (G, C) across the sequential grid of one TPU
// core, after padding P to 8 rows and n to a block_n multiple.  That pad is
// an O(P·n) copy of the inputs, which the streamed round engine exists to
// avoid, so the reference runs it only on aligned shapes.  Each (P, width)
// slab goes in as it lies, a strided view of a stacked leaf, with no pad and
// no copy.  Two calls give bitwise-equal results (no float atomics); with
// `accumulate` the finish pass adds into G and C, so a round's slabs sum in
// slab order.
//
// Two bodies, chosen by the wrapper from the inputs alone
// (kernels/stream.py::_mma_eligible):
//
//   stream_stats_mma<MT>  D and GM both bf16, P <= 32, rows 16-byte aligned
//     (every slab of the big-model round).  The bf16 tensor cores form each
//     product exactly and sum in f32 (mma.sync m16n8k16, fed straight from
//     16-byte global loads into registers; no shared-memory staging).
//   cross_partial         everything else (f32 or mixed inputs, P > 32,
//     unaligned views): the shared cross product of cross.cuh with A = D,
//     B = [D; GM] and `sym`, on the f32 CUDA cores.
//
// Both write cross.cuh's partial layout, and cross.cuh's cross_finish sums
// the column blocks' partials in block order, mirrors G and writes or adds
// the outputs.
//
// What bounds it on the H100: the bytes of D and GM, read once — 2·P·n·s
// for s-byte entries — against 3.35 TB/s.  At the transformer width
// (P = 16, bf16, n = 58.7 M) that is 1.12 ms; the products are 0.69 ms on
// the f32 CUDA cores but 0.05 ms on the bf16 tensor cores, so only the mma
// body can come near the bytes.  The cross body is bound by its shared
// memory (two 16-byte reads per 16 FMAs); at the paper's P = 100 and
// n = 7 850 (f32) it is launch-bound.
//
// The mma body.  A warp works on 32-column chunks; lane (g = lane / 4,
// t = lane % 4) loads columns 8t..8t+7 of rows g + 8i of D and of GM, one
// 16-byte load each, so four lanes read 64 contiguous bytes of a row.  A
// warp takes U contiguous chunks at a time (U = 8 for P <= 16: 512 bytes of
// each row, 16 KB a warp in flight), the warps of a block neighbouring runs
// of them, and all of a batch's loads are issued before its first mma; the
// loads bypass L1 (each byte is read once).  In
// m16n8k16 the A fragment (row-major) and the B fragment (col-major, its n
// a row of D or GM) hold the same k slots per lane: {2t, 2t+1, 2t+8, 2t+9}.
// A dot product does not care which column sits in which k slot as long as
// A and B agree, so columns 8t+4s+{0,1} go to slots {2t, 2t+1} of k-step s
// and 8t+4s+{2,3} to {2t+8, 2t+9}: the loaded registers are the fragments
// as they are.  D's registers serve as A (16-row m-tiles), as B of G's
// 8-row n-tiles and, with GM's registers as B, of C's n-tiles; G's tiles
// wholly below the diagonal are left out (cross_finish mirrors them).  Rows
// >= P load as zeros.  Each step's mma run into zeroed fragments and then
// join f32 running sums with a plain add, so no f32 chain runs over more
// than one step's columns (a single chain over ~3 500 columns lost 4e-6 of a
// diagonal entry of G at P = 16, n = 2^23).  The warps' sums are added in
// warp order through shared memory and the last warp writes the block's
// partial.

#include "cross.cuh"
#include "mma.cuh"

namespace {

constexpr int kMmaThreads = 256;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kChunk = 32;        // columns of one warp chunk
constexpr int kStepChunks = 8;    // chunks of one step: 256 columns a warp

Problem stream_problem(const void* D, long long ldd, int d_bf16,
                       const void* GM, long long ldg, int g_bf16, int P,
                       long long n) {
  Problem p;
  p.a = rows_of(D, P, ldd, d_bf16);
  p.b1 = p.a;
  p.b2 = rows_of(GM, P, ldg, g_bf16);
  p.sym = 1;
  p.n = n;
  return p;
}

// One lane's registers of one chunk: 8 bf16 of rows g + 8i of D and GM.
template <int MT>
struct Chunk {
  uint4 d[2 * MT];
  uint4 m[2 * MT];
};

// A whole chunk: one 16-byte load per row (null row: zeros).
template <int MT>
__device__ __forceinline__ void load_chunk(Chunk<MT>& ch,
                                           const __nv_bfloat16* (&dp)[2 * MT],
                                           const __nv_bfloat16* (&gp)[2 * MT],
                                           long long col) {
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) {
    ch.d[i] = dp[i] ? load16(dp[i] + col) : make_uint4(0u, 0u, 0u, 0u);
    ch.m[i] = gp[i] ? load16(gp[i] + col) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// 8 entries from col on, those at or past col1 as zeros.
__device__ __forceinline__ uint4 load_ragged(const __nv_bfloat16* row,
                                             long long col, long long col1) {
  unsigned w[4];
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long c = col + 2 * e;
    const unsigned lo = row && c < col1 ? __ldg(r + c) : 0u;
    const unsigned hi = row && c + 1 < col1 ? __ldg(r + c + 1) : 0u;
    w[e] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int MT>
__device__ __forceinline__ void load_chunk_ragged(
    Chunk<MT>& ch, const __nv_bfloat16* (&dp)[2 * MT],
    const __nv_bfloat16* (&gp)[2 * MT], long long col, long long col1) {
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) {
    ch.d[i] = load_ragged(dp[i], col, col1);
    ch.m[i] = load_ragged(gp[i], col, col1);
  }
}

// The chunk's two k-steps into the step fragments: G's tiles (mt, nt >= 2mt)
// and C's tiles (mt, nt), in a fixed order.
template <int MT>
__device__ __forceinline__ void mma_chunk(const Chunk<MT>& ch,
                                          float (&sg)[MT * (MT + 1)][4],
                                          float (&sc)[2 * MT * MT][4]) {
  constexpr int L = 2 * MT;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    unsigned dlo[L], dhi[L], mlo[L], mhi[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      dlo[i] = s ? ch.d[i].z : ch.d[i].x;
      dhi[i] = s ? ch.d[i].w : ch.d[i].y;
      mlo[i] = s ? ch.m[i].z : ch.m[i].x;
      mhi[i] = s ? ch.m[i].w : ch.m[i].y;
    }
    int k = 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 2 * mt; nt < L; ++nt, ++k)
        mma_bf16(sg[k], dlo[2 * mt], dlo[2 * mt + 1], dhi[2 * mt],
                 dhi[2 * mt + 1], dlo[nt], dhi[nt]);
    k = 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < L; ++nt, ++k)
        mma_bf16(sc[k], dlo[2 * mt], dlo[2 * mt + 1], dhi[2 * mt],
                 dhi[2 * mt + 1], mlo[nt], mhi[nt]);
  }
}

template <int N>
__device__ __forceinline__ void fold(float (&run)[N][4], float (&step)[N][4]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      run[k][r] += step[k][r];
      step[k][r] = 0.f;
    }
}

// MT 16-row tiles: MT = 1 for P <= 16, 2 for P <= 32.  One block per column
// range of cross.grid (one slice); its partial in cross.cuh's 64 x 64 layout,
// entry (i, j) of G at [i][j] (j >= i only), of C at [i][b2_off + j].
template <int MT>
__global__ void __launch_bounds__(kMmaThreads, 1)
stream_stats_mma(const __nv_bfloat16* __restrict__ D, long long ldd,
                 const __nv_bfloat16* __restrict__ GM, long long ldg, int P,
                 long long n, float* __restrict__ partial,
                 long long cols_per_block, int b2_off) {
  constexpr int L = 2 * MT;              // rows a lane loads of each source
  constexpr int NG = MT * (MT + 1);      // G tiles (on or above the diagonal)
  constexpr int NC = 2 * MT * MT;        // C tiles
  constexpr int U = MT == 1 ? 8 : 2;     // contiguous chunks loaded together
  static_assert(kStepChunks % U == 0, "a step holds whole load batches");
  __shared__ float red[(NG + NC) * 4][32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const __nv_bfloat16* dp[L];
  const __nv_bfloat16* gp[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int row = g + 8 * i;
    dp[i] = row < P ? D + row * ldd : nullptr;
    gp[i] = row < P ? GM + row * ldg : nullptr;
  }

  const long long col0 = (long long)blockIdx.x * cols_per_block;
  const long long col1 = col0 + cols_per_block < n ? col0 + cols_per_block : n;
  const long long whole = (col1 - col0) / kChunk;
  const long long chunks = (col1 - col0 + kChunk - 1) / kChunk;

  float run_g[NG][4], run_c[NC][4], step_g[NG][4], step_c[NC][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int k = 0; k < NG; ++k) run_g[k][r] = step_g[k][r] = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) run_c[k][r] = step_c[k][r] = 0.f;
  }

  // runs of U contiguous chunks: warp w takes runs w, w + W, ...; a run's
  // loads are all issued before its first mma.  The one run that the whole
  // chunks do not fill goes one chunk at a time (the last block's ragged
  // chunk with bounds checks).
  int in_step = 0;
  long long c = (long long)warp * U;
  for (; c + U <= whole; c += U * kMmaWarps) {
    Chunk<MT> ch[U];
#pragma unroll
    for (int j = 0; j < U; ++j)
      load_chunk<MT>(ch[j], dp, gp, col0 + (c + j) * kChunk + 8 * t);
#pragma unroll
    for (int j = 0; j < U; ++j) mma_chunk<MT>(ch[j], step_g, step_c);
    in_step += U;
    if (in_step == kStepChunks) {
      fold(run_g, step_g);
      fold(run_c, step_c);
      in_step = 0;
    }
  }
  for (long long e = c; e < c + U && e < chunks; ++e) {
    Chunk<MT> ch;
    const long long col = col0 + e * kChunk + 8 * t;
    if (e < whole)
      load_chunk<MT>(ch, dp, gp, col);
    else
      load_chunk_ragged<MT>(ch, dp, gp, col, col1);
    mma_chunk<MT>(ch, step_g, step_c);
    if (++in_step == kStepChunks) {
      fold(run_g, step_g);
      fold(run_c, step_c);
      in_step = 0;
    }
  }
  fold(run_g, step_g);
  fold(run_c, step_c);

  // the warps' sums in warp order; the last warp writes the partial.  A
  // fragment's entry r of tile (mt, nt) is row 16mt + g + 8(r / 2), column
  // 8nt + 2t + r % 2.
  float* out = partial + (long long)blockIdx.x * kPartial;
  for (int w = 0; w < kMmaWarps; ++w) {
    if (warp == w) {
      int k = 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 2 * mt; nt < L; ++nt, ++k)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float s = w ? red[k * 4 + r][lane] + run_g[k][r] : run_g[k][r];
            const int i = 16 * mt + g + 8 * (r >> 1);
            const int j = 8 * nt + 2 * t + (r & 1);
            if (w < kMmaWarps - 1)
              red[k * 4 + r][lane] = s;
            else if (i < P && j < P && j >= i)
              out[i * kBlockRows + j] = s;
          }
      k = 0;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < L; ++nt, ++k)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int v = (NG + k) * 4 + r;
            const float s = w ? red[v][lane] + run_c[k][r] : run_c[k][r];
            const int i = 16 * mt + g + 8 * (r >> 1);
            const int j = 8 * nt + 2 * t + (r & 1);
            if (w < kMmaWarps - 1)
              red[v][lane] = s;
            else if (i < P && j < P)
              out[i * kBlockRows + b2_off + j] = s;
          }
    }
    __syncthreads();
  }
}

using MmaKernel = void (*)(const __nv_bfloat16*, long long, const __nv_bfloat16*,
                           long long, int, long long, float*, long long, int);

MmaKernel mma_kernel(int P) { return P <= 16 ? stream_stats_mma<1> : stream_stats_mma<2>; }

bool mma_takes(const void* D, long long ldd, const void* GM, long long ldg,
               int P, long long n) {
  return P >= 1 && P <= 32 && n >= 1 && ldd % 8 == 0 && ldg % 8 == 0 &&
         reinterpret_cast<uintptr_t>(D) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(GM) % 16 == 0;
}

}  // namespace

// Resident blocks per SM of the partial kernel that a call with P rows runs
// (mma: the tensor-core body, P <= 32; else cross_partial) and the number of
// slices.  Returns a CUDA error code.
extern "C" int stream_stats_launch_config(int P, int mma, int* blocks_per_sm,
                                          long long* slices) {
  if (P < 1 || (mma && P > 32)) return static_cast<int>(cudaErrorInvalidValue);
  const Problem p = stream_problem(nullptr, 1, mma, nullptr, 1, mma, P, 1);
  if (!mma) return static_cast<int>(cross_launch_config(p, blocks_per_sm, slices));
  *slices = p.slices();
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, mma_kernel(P), kMmaThreads, 0));
}

// D and GM (P, n), rows ldd / ldg elements apart, f32 or bf16 each; G and C
// (P, P) f32 contiguous, written (or added to, with accumulate).  partial
// holds slices * num_blocks * 4096 f32.  Returns cudaGetLastError() after
// the launches on `stream`.
extern "C" int stream_stats_launch(const void* D, long long ldd, int d_bf16,
                                   const void* GM, long long ldg, int g_bf16,
                                   int P, long long n, void* partial,
                                   long long partial_floats, int num_blocks,
                                   long long cols_per_block, void* G, void* C,
                                   int accumulate, void* stream) {
  const Problem p = stream_problem(D, ldd, d_bf16, GM, ldg, g_bf16, P, n);
  return static_cast<int>(cross_run(
      p, static_cast<float*>(partial), partial_floats, num_blocks,
      cols_per_block, static_cast<float*>(G), P, static_cast<float*>(C), P,
      accumulate, static_cast<cudaStream_t>(stream)));
}

// The tensor-core body: D and GM (P, n) bf16, P <= 32, both 16-byte aligned
// with rows ldd / ldg elements apart, multiples of 8 (else
// cudaErrorInvalidValue); the rest as stream_stats_launch, with the grid's
// column ranges whole 256-column granules.
extern "C" int stream_stats_mma_launch(const void* D, long long ldd,
                                       const void* GM, long long ldg, int P,
                                       long long n, void* partial,
                                       long long partial_floats, int num_blocks,
                                       long long cols_per_block, void* G,
                                       void* C, int accumulate, void* stream) {
  const Problem p = stream_problem(D, ldd, 1, GM, ldg, 1, P, n);
  if (!mma_takes(D, ldd, GM, ldg, P, n) || num_blocks < 1 ||
      cols_per_block % 256 != 0 || (long long)num_blocks * cols_per_block < n ||
      partial_floats < (long long)num_blocks * kPartial)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mma_kernel(P)<<<num_blocks, kMmaThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(D), ldd,
      static_cast<const __nv_bfloat16*>(GM), ldg, P, n,
      static_cast<float*>(partial), cols_per_block, p.b2_off());
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cross_finish<<<dim3(kPartial / kFinishThreads, 1), kFinishThreads, 0, st>>>(
      p, static_cast<const float*>(partial), num_blocks, 0,
      static_cast<float*>(G), P, static_cast<float*>(C), P, accumulate);
  return static_cast<int>(cudaGetLastError());
}
