// cross: out = A Bᵀ over n columns in f32, the tall-skinny cross product
// that stream_stats.cu, gram_block.cu and sketch.cu share.
//
// A is one set of Ma rows, B the rows of B1 followed by those of B2 (B2 may
// be empty), each set given as a pointer, a row count and a row stride in
// elements, f32 or bf16, columns unit-strided.  So a (P, width) view of a
// stacked leaf goes in as it lies: no copy, no pad, no upcast.  The three
// kernels are three ways of filling these sources:
//
//   stream_stats  A = D, B1 = D, B2 = GM (sym): G = D Dᵀ, C = D GMᵀ
//   gram_block    A = U_a, B1 = U_b, B2 = g:   G_ab = U_a U_bᵀ, c_a = U_a g
//   sketch        A = U, B1 = R:               S_U = U Rᵀ
//
// Design (a deterministic two-pass split reduction, as gram.cu):
//
//   pass 1 (cross_partial): A and B are cut into row blocks of 64, and the
//     grid has one slice (blockIdx.y) per pair (a, b) of an A block and a B
//     block, times a split of the columns into contiguous ranges
//     (blockIdx.x).  With `sym` (B1 is A) the slices with b < a are left out
//     and their entries are written as mirrors; on a diagonal slice (a == b)
//     the A block lies inside the B block, so its rows are staged once.  A
//     block stages (R x kCols) tiles of the slice's rows in shared memory as
//     f32, [column][row], R <= 128; the next tile is loaded into registers,
//     as raw bits in the input dtype, while the current one is multiplied, so
//     global-load latency overlaps the FMAs.  The slice's (Ka x Kb) product
//     is cut into 4 x 4 register tiles; each thread owns one tile and one
//     phase of the columns and accumulates in f32 with FMAs on the CUDA cores
//     (no TF32), each step's columns apart before they join its running
//     sums.  The phases are summed in a fixed order and the block writes its
//     (64 x 64) partial to scratch.
//   pass 2 (cross_finish): one thread per entry of a slice sums the blocks'
//     partials in block order and writes the entry of out1 (B1's columns,
//     with its mirror under `sym`) or out2 (B2's), or adds it there
//     (`accumulate`: the streamed engine sums its leaf slabs into one G and C
//     in slab order).
//
// No float atomics: every sum runs in an order fixed by the shapes and the
// card (its SM count and the kernel's occupancy set the grid), so two calls
// on one card give bitwise-equal results.  Each entry of the output is
// written by one thread.
//
// What bounds it on the H100 is in each kernel's own .cu: the bytes of the
// row sources (read once) against the FMAs of the product.  The design's own
// limit is shared memory: each 16 FMAs of a register tile read two 16-byte
// operands from it, as in gram.cu; the tensor cores (mma.sync / wgmma, bf16
// in, f32 accumulate) are the step beyond it.
#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockRows = 64;                      // rows of one row block
constexpr int kMaxRows = 2 * kBlockRows;            // rows a slice stages
constexpr int kSlots = 32;                          // register slots per thread
constexpr int kPartial = kBlockRows * kBlockRows;   // floats of one partial
constexpr int kMaxSlicesPerLaunch = 65535;          // gridDim.y limit
constexpr int kFinishThreads = 128;

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }
__host__ __device__ constexpr int min_int(int x, int y) { return x < y ? x : y; }

// Shared-memory row stride for R staged rows: R, or R + 4 when R / 4 is even,
// so that the float4 reads of neighbouring column phases fall in other banks.
__host__ __device__ __forceinline__ int smem_stride(int R) {
  return (R / 4) % 2 == 0 ? R + 4 : R;
}

// One row source: `rows` rows of `ld` elements apart, f32 or bf16.
struct Rows {
  const void* ptr;
  int rows;
  long long ld;
  int bf16;
};

struct Problem {
  Rows a, b1, b2;
  int sym;         // B1 is A: only entries (i, j >= i) of A B1ᵀ, mirrored
  long long n;

  // B's row index space: B1 at [0, b1.rows), B2 from b2_off on, so that no
  // 4-row tile straddles the two sources.
  __host__ __device__ int b2_off() const { return b2.rows ? round4(b1.rows) : b1.rows; }
  __host__ __device__ int mb() const { return b2_off() + b2.rows; }
  __host__ __device__ int na() const { return (a.rows + kBlockRows - 1) / kBlockRows; }
  __host__ __device__ int nb() const { return (mb() + kBlockRows - 1) / kBlockRows; }
  __host__ __device__ long long slices() const {
    const long long A = na(), B = nb();
    return sym ? A * B - A * (A - 1) / 2 : A * B;
  }
};

// One slice: A rows [a0, a0 + Ka) against B index rows [b0, b0 + Kb).  Staged
// row r < eb is A row a0 + r; row eb + i is B index row b0 + i.  On a
// diagonal slice eb = 0: the A part is the first Ka rows of the B part.
struct Slice {
  int a0, Ka, b0, Kb, eb, R, ta, tb, diag, num_tiles;

  __host__ __device__ Slice(const Problem& p, long long s) {
    int a = 0, b = 0;
    const int nb = p.nb();
    if (p.sym) {              // row a holds the pairs (a, b >= a)
      while (s >= nb - a) {
        s -= nb - a;
        ++a;
      }
      b = a + (int)s;
    } else {
      a = (int)(s / nb);
      b = (int)(s % nb);
    }
    a0 = a * kBlockRows;
    Ka = min_int(kBlockRows, p.a.rows - a0);
    b0 = b * kBlockRows;
    Kb = min_int(kBlockRows, p.mb() - b0);
    diag = p.sym && a == b;
    eb = diag ? 0 : round4(Ka);
    R = eb + round4(Kb);
    ta = (Ka + 3) / 4;
    tb = (Kb + 3) / 4;
    num_tiles = diag ? ta * tb - ta * (ta - 1) / 2 : ta * tb;
  }

  // (i, j) of the t-th 4 x 4 tile: A rows 4i.., B rows 4j..; a diagonal
  // slice leaves out the tiles below its diagonal (j < i)
  __device__ __forceinline__ void tile(int t, int* i, int* j) const {
    if (diag) {
      int r = 0;
      while (t >= tb - r) {
        t -= tb - r;
        ++r;
      }
      *i = r;
      *j = r + t;
    } else {
      *i = t / tb;
      *j = t % tb;
    }
  }

  // first byte of the row that staged row r holds, or null (padding)
  __device__ __forceinline__ const unsigned char* row(const Problem& p, int r,
                                                      int* bf16) const {
    const Rows* src;
    long long k;
    if (r < eb) {
      if (r >= Ka) return nullptr;
      src = &p.a;
      k = a0 + r;
    } else {
      const int i = r - eb;
      if (i >= Kb) return nullptr;
      const int B = b0 + i;
      if (B < p.b1.rows) {
        src = &p.b1;
        k = B;
      } else if (B >= p.b2_off()) {
        src = &p.b2;
        k = B - p.b2_off();
      } else {
        return nullptr;
      }
    }
    *bf16 = src->bf16;
    return static_cast<const unsigned char*>(src->ptr) + k * src->ld * (src->bf16 ? 2 : 4);
  }
};

// kCols columns per step; a thread stages rows tid / kCols + kStep·i, one
// per register slot, so an instance stages up to kSlots·kStep rows.
template <int kCols>
__global__ void __launch_bounds__(kThreads, 2)
cross_partial(const Problem p, float* partial,
              long long cols_per_block, long long slice0) {
  constexpr int kStep = kThreads / kCols;
  static_assert(kSlots * kStep <= kMaxRows, "an instance stages at most 128 rows");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ const unsigned char* row_base[kMaxRows];
  __shared__ int row_bf16[kMaxRows];

  const Slice sl(p, slice0 + blockIdx.y);
  const int R = sl.R;
  const int Rs = smem_stride(R);
  const int tid = threadIdx.x;
  for (int r = tid; r < kMaxRows; r += kThreads) {
    int bf = 0;
    row_base[r] = r < R ? sl.row(p, r, &bf) : nullptr;
    row_bf16[r] = bf;
  }
  __syncthreads();

  const int S = min_int(kCols, kThreads / sl.num_tiles);  // column phases per tile
  const int task = tid / S;
  const int phase = tid % S;
  const bool active = task < sl.num_tiles;
  int ti = 0, tj = 0;
  if (active) sl.tile(task, &ti, &tj);
  const int a_off = 4 * ti;
  const int b_off = sl.eb + 4 * tj;

  const long long col0 = (long long)blockIdx.x * cols_per_block;
  const long long col1 = col0 + cols_per_block < p.n ? col0 + cols_per_block : p.n;
  const int my_col = tid % kCols;
  const int my_row0 = tid / kCols;
  unsigned bf16_mask = 0;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int r = my_row0 + kStep * i;
    if (r < R && row_bf16[r]) bf16_mask |= 1u << i;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // raw bits of the next tile's entries: f32 as is, bf16 in the low half;
  // nothing waits on the loads until the next stash
  unsigned stage[kSlots];
  auto fetch = [&](long long base) {
    const long long col = base + my_col;
    const bool in = col < col1;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int r = my_row0 + kStep * i;
      unsigned v = 0u;
      if (in && r < R) {
        const unsigned char* rp = row_base[r];
        if (rp != nullptr) {
          v = (bf16_mask >> i) & 1u
                  ? (unsigned)__bfloat16_as_ushort(
                        __ldg(reinterpret_cast<const __nv_bfloat16*>(rp) + col))
                  : __float_as_uint(__ldg(reinterpret_cast<const float*>(rp) + col));
        }
      }
      stage[i] = v;
    }
  };

  if (col0 < col1) fetch(col0);
  for (long long base = col0; base < col1; base += kCols) {
    const int width = col1 - base < kCols ? (int)(col1 - base) : kCols;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int r = my_row0 + kStep * i;
      if (r < R)
        smem[my_col * Rs + r] = (bf16_mask >> i) & 1u ? __uint_as_float(stage[i] << 16)
                                                      : __uint_as_float(stage[i]);
    }
    __syncthreads();
    if (base + kCols < col1) fetch(base + kCols);
    if (active) {
      // this step's columns sum apart and then join the running sums, so no
      // f32 chain runs over more than one step's columns or the block's
      // steps (a single chain over ~3 500 columns lost 4e-6 of a diagonal
      // entry of G at P = 16, n = 2^23)
      float step[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) step[i][j] = 0.f;
      for (int cc = phase; cc < width; cc += S) {
        const float4 x = *reinterpret_cast<const float4*>(&smem[cc * Rs + a_off]);
        const float4 y = *reinterpret_cast<const float4*>(&smem[cc * Rs + b_off]);
        const float xv[4] = {x.x, x.y, x.z, x.w};
        const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) step[i][j] = fmaf(xv[i], yv[j], step[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += step[i][j];
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
  float* out = partial + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * kPartial;
  for (int idx = tid; idx < sl.num_tiles * 16; idx += kThreads) {
    const int t = idx / 16;
    const int e = idx % 16;
    float s = 0.f;
    for (int q = 0; q < S; ++q) s += red[(t * S + q) * 16 + e];
    int i, j;
    sl.tile(t, &i, &j);
    out[(4 * i + e / 4) * kBlockRows + 4 * j + e % 4] = s;
  }
}

// One thread per entry (ia, jb) of one slice: sums the column blocks'
// partials in block order and writes (or adds) the output entry it stands
// for, if any.
__global__ void cross_finish(const Problem p, const float* __restrict__ partial,
                             int num_blocks, long long slice0, float* out1,
                             long long ld1, float* out2, long long ld2,
                             int accumulate) {
  const Slice sl(p, slice0 + blockIdx.y);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int ia = idx / kBlockRows;
  const int jb = idx % kBlockRows;
  if (ia >= sl.Ka || jb >= sl.Kb) return;
  const long long arow = sl.a0 + ia;
  const int B = sl.b0 + jb;
  float* dst;
  float* mirror = nullptr;
  if (B < p.b1.rows) {
    if (p.sym && B < arow) return;                // the mirror of (B, arow)
    dst = out1 + arow * ld1 + B;
    if (p.sym && B != arow) mirror = out1 + (long long)B * ld1 + arow;
  } else if (B >= p.b2_off()) {
    dst = out2 + arow * ld2 + (B - p.b2_off());
  } else {
    return;                                       // padding between B1 and B2
  }
  const float* q = partial + (long long)blockIdx.y * num_blocks * kPartial + idx;
  float s = 0.f;
  for (int blk = 0; blk < num_blocks; ++blk) s += q[(long long)blk * kPartial];
  if (accumulate) s = *dst + s;
  *dst = s;
  if (mirror != nullptr) *mirror = s;
}

using PartialKernel = void (*)(const Problem, float*, long long, long long);

// Rows the widest slice stages.
int max_rows(const Problem& p) {
  int rmax = 4;
  for (long long s = 0, n = p.slices(); s < n; ++s) {
    const Slice sl(p, s);
    if (sl.R > rmax) rmax = sl.R;
  }
  return rmax;
}

// The widest column step whose register slots hold rmax rows.
PartialKernel partial_kernel(int rmax) {
  if (rmax <= kSlots) return cross_partial<256>;
  if (rmax <= 2 * kSlots) return cross_partial<128>;
  return cross_partial<64>;
}

int partial_cols(int rmax) { return rmax <= kSlots ? 256 : rmax <= 2 * kSlots ? 128 : 64; }

// Dynamic shared memory: the staged tile at the widest stride, or the phase
// reduction buffer (256 threads x 16 floats), whichever is larger.
int smem_bytes(int rmax) {
  const int tile = partial_cols(rmax) * (rmax + 4);
  return (tile > kThreads * 16 ? tile : kThreads * 16) * (int)sizeof(float);
}

bool valid(const Problem& p) {
  return p.a.rows >= 1 && p.b1.rows >= 1 && p.b2.rows >= 0 && p.n >= 1 &&
         (!p.sym || (p.b1.ptr == p.a.ptr && p.b1.rows == p.a.rows &&
                     p.b1.ld == p.a.ld && p.b1.bf16 == p.a.bf16));
}

// Resident blocks per SM of the partial kernel (the grid fills the card in
// one wave) and the number of slices.
cudaError_t cross_launch_config(const Problem& p, int* blocks_per_sm,
                                long long* slices) {
  if (!valid(p)) return cudaErrorInvalidValue;
  const int rmax = max_rows(p);
  *slices = p.slices();
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, partial_kernel(rmax), kThreads, smem_bytes(rmax));
}

// partial holds partial_floats >= slices * num_blocks * 64 * 64 f32 (checked);
// out1 (Ma, B1 rows) and out2 (Ma, B2 rows) f32 with row strides ld1, ld2.
cudaError_t cross_run(const Problem& p, float* partial, long long partial_floats,
                      int num_blocks, long long cols_per_block, float* out1,
                      long long ld1, float* out2, long long ld2, int accumulate,
                      cudaStream_t st) {
  if (!valid(p) || num_blocks < 1 || (long long)num_blocks * cols_per_block < p.n)
    return cudaErrorInvalidValue;
  const long long slices = p.slices();
  const long long per_slice = (long long)num_blocks * kPartial;
  if (partial_floats < slices * per_slice) return cudaErrorInvalidValue;
  const int rmax = max_rows(p);
  const PartialKernel kernel = partial_kernel(rmax);
  const int smem = smem_bytes(rmax);
  for (long long s0 = 0; s0 < slices; s0 += kMaxSlicesPerLaunch) {
    const int ns = (int)(slices - s0 < kMaxSlicesPerLaunch ? slices - s0 : kMaxSlicesPerLaunch);
    float* ps = partial + s0 * per_slice;
    kernel<<<dim3(num_blocks, ns), kThreads, smem, st>>>(p, ps, cols_per_block, s0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    cross_finish<<<dim3(kPartial / kFinishThreads, ns), kFinishThreads, 0, st>>>(
        p, ps, num_blocks, s0, out1, ld1, out2, ld2, accumulate);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

Rows rows_of(const void* ptr, int rows, long long ld, int bf16) {
  Rows r;
  r.ptr = ptr;
  r.rows = rows;
  r.ld = ld;
  r.bf16 = bf16;
  return r;
}

}  // namespace
