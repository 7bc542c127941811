// topk_select: the k largest-|v| entries of v (n,) f32, as candidates
// (values v[idx], indices int32) holding exactly the top-k set.
//
// Replaces repro/kernels/topk.py::topk_select_pallas (per-chunk lax.top_k of
// block_n entries, k <= block_n) and its candidate merge (topk.py:64-68).
// That design leans on the TPU's vector sort; on Hopper a select that reads v
// a few times is simpler and has no k <= block_n limit (k = n/16 is about a
// million at model width).
//
// Radix select on the magnitude bits: |v| as an IEEE float with the sign bit
// cleared orders like its uint32 bits, so the k-th largest magnitude T is
// found one 8-bit digit at a time, top digit first:
//   hist   — each block counts, in shared memory, the digit of every entry of
//            its contiguous range whose higher digits equal T's so far, and
//            writes its 256 counts to global memory;
//   select — one block sums the per-block counts in block order and fixes the
//            next digit of T and the rank of T among the entries still tied
//            (integer sums: the same in any order, and fixed here anyway).
// Four rounds give T and r, the number of entries equal to T that belong to
// the top k (those with the lowest indices).  Then
//   count   — each block counts its entries > T and == T,
//   offsets — one block turns the counts into exclusive offsets, block order,
//   scatter — each block writes its entries > T, then its first entries == T
//             (while the running count of == T stays below r), in index order
//             within the block, at those offsets.
// The output is the top-k set with the entries > T first, each group in
// index order; the wrapper (topk.py) puts it in lax.top_k's order, |v|
// descending and the lower index first among ties, with one stable sort of
// the k candidates — the reference's own merge also runs outside its kernel.
//
// What bounds it on the H100: the bytes.  v is read six times (four
// histograms, count, scatter) and the k values and indices written once;
// the bound is one read of 4n bytes plus 8k written at 3.35 TB/s.  Every
// pass streams v with coalesced loads; the select and offset steps are one
// block each and take microseconds.  -0.0 and +0.0 have equal keys, as
// |-0.0| == |+0.0| in the reference.  Deterministic: nothing depends on the
// order blocks run in.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;

struct SelectState {
  uint32_t prefix;  // the digits of T fixed so far
  uint32_t mask;    // their bits
  uint32_t rank;    // rank of T among the entries that match prefix/mask
  uint32_t pad;
};

__device__ __forceinline__ uint32_t key_of(float x) {
  return __float_as_uint(x) & 0x7FFFFFFFu;
}

__device__ __forceinline__ void block_range(int64_t n, int64_t chunk,
                                            int64_t* lo, int64_t* hi) {
  *lo = (int64_t)blockIdx.x * chunk;
  *hi = *lo + chunk < n ? *lo + chunk : n;
}

__global__ void topk_init(SelectState* st, uint32_t k) {
  st->prefix = 0u;
  st->mask = 0u;
  st->rank = k;
  st->pad = 0u;
}

__global__ void __launch_bounds__(kThreads)
topk_hist(const float* __restrict__ v, int64_t n, int64_t chunk, int shift,
          const SelectState* __restrict__ st, uint32_t* __restrict__ hist) {
  __shared__ uint32_t h[kBins];
  h[threadIdx.x] = 0u;
  __syncthreads();
  const uint32_t prefix = st->prefix;
  const uint32_t mask = st->mask;
  int64_t lo, hi;
  block_range(n, chunk, &lo, &hi);
  for (int64_t e = lo + threadIdx.x; e < hi; e += kThreads) {
    const uint32_t key = key_of(v[e]);
    if ((key & mask) == prefix) atomicAdd(&h[(key >> shift) & 0xFFu], 1u);
  }
  __syncthreads();
  hist[(int64_t)blockIdx.x * kBins + threadIdx.x] = h[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
topk_select_digit(const uint32_t* __restrict__ hist, int num_blocks, int shift,
                  SelectState* st) {
  __shared__ uint32_t total[kBins];
  uint32_t s = 0u;
  for (int b = 0; b < num_blocks; ++b) s += hist[(int64_t)b * kBins + threadIdx.x];
  total[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t rank = st->rank;
    uint32_t above = 0u;
    for (int d = kBins - 1; d >= 0; --d) {
      if (above + total[d] >= rank) {
        st->prefix |= (uint32_t)d << shift;
        st->mask |= 0xFFu << shift;
        st->rank = rank - above;
        break;
      }
      above += total[d];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
topk_count(const float* __restrict__ v, int64_t n, int64_t chunk,
           const SelectState* __restrict__ st, uint32_t* __restrict__ counts) {
  const uint32_t T = st->prefix;
  int64_t lo, hi;
  block_range(n, chunk, &lo, &hi);
  uint32_t gt = 0u, eq = 0u;
  for (int64_t base = lo; base < hi; base += kThreads) {
    const int64_t e = base + threadIdx.x;
    const uint32_t key = e < hi ? key_of(v[e]) : 0u;
    gt += __syncthreads_count(e < hi && key > T);
    eq += __syncthreads_count(e < hi && key == T);
  }
  if (threadIdx.x == 0) {
    counts[2 * blockIdx.x] = gt;
    counts[2 * blockIdx.x + 1] = eq;
  }
}

__global__ void topk_offsets(const uint32_t* __restrict__ counts, int num_blocks,
                             uint32_t* __restrict__ offsets) {
  if (threadIdx.x != 0) return;
  uint32_t gt = 0u, eq = 0u;
  for (int b = 0; b < num_blocks; ++b) {
    offsets[2 * b] = gt;
    offsets[2 * b + 1] = eq;
    gt += counts[2 * b];
    eq += counts[2 * b + 1];
  }
}

// Exclusive rank of this thread's flag among the block's threads, and the
// block's total, in thread order.
__device__ __forceinline__ uint32_t block_rank(bool flag, uint32_t* warp_tot,
                                               uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, flag);
  const uint32_t in_warp = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_tot[warp] = __popc(ballot);
  __syncthreads();
  uint32_t before = 0u, all = 0u;
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < warp) before += warp_tot[w];
    all += warp_tot[w];
  }
  __syncthreads();
  *total = all;
  return before + in_warp;
}

__global__ void __launch_bounds__(kThreads)
topk_scatter(const float* __restrict__ v, int64_t n, int64_t chunk, uint32_t k,
             const SelectState* __restrict__ st,
             const uint32_t* __restrict__ offsets, float* __restrict__ out_vals,
             int* __restrict__ out_idx) {
  __shared__ uint32_t warp_tot[kThreads / 32];
  const uint32_t T = st->prefix;
  const uint32_t take_eq = st->rank;       // entries == T in the top k
  const uint32_t num_gt = k - take_eq;     // entries > T, all in the top k
  int64_t lo, hi;
  block_range(n, chunk, &lo, &hi);
  uint32_t gt_pos = offsets[2 * blockIdx.x];
  uint32_t eq_pos = offsets[2 * blockIdx.x + 1];
  for (int64_t base = lo; base < hi; base += kThreads) {
    if (eq_pos >= take_eq && gt_pos >= num_gt) break;  // uniform: block-wide values
    const int64_t e = base + threadIdx.x;
    const bool in = e < hi;
    const float x = in ? v[e] : 0.f;
    const uint32_t key = key_of(x);
    const bool is_gt = in && key > T;
    const bool is_eq = in && key == T;
    uint32_t n_gt, n_eq;
    const uint32_t r_gt = block_rank(is_gt, warp_tot, &n_gt);
    const uint32_t r_eq = block_rank(is_eq, warp_tot, &n_eq);
    if (is_gt) {
      out_vals[gt_pos + r_gt] = x;
      out_idx[gt_pos + r_gt] = (int)e;
    } else if (is_eq && eq_pos + r_eq < take_eq) {
      out_vals[num_gt + eq_pos + r_eq] = x;
      out_idx[num_gt + eq_pos + r_eq] = (int)e;
    }
    gt_pos += n_gt;
    eq_pos += n_eq;
  }
}

}  // namespace

// v (n,) f32; out_vals (k,) f32 and out_idx (k,) int32 receive the top-k set
// (see the head comment for its order).  1 <= k <= n < 2^31.  The grid is
// num_blocks contiguous ranges of chunk entries; scratch holds
// scratch_words >= 4 + num_blocks * (256 + 4) uint32 (checked).
// Returns cudaGetLastError() after the launches on `stream`.
extern "C" int topk_launch(const void* v, long long n, int k, void* scratch,
                           long long scratch_words, void* out_vals,
                           void* out_idx, int num_blocks, long long chunk,
                           void* stream) {
  if (n < 1 || n > 0x7FFFFFFFLL || k < 1 || k > n || num_blocks < 1 ||
      (long long)num_blocks * chunk < n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (scratch_words < 4 + (long long)num_blocks * (kBins + 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* words = static_cast<uint32_t*>(scratch);
  SelectState* state = reinterpret_cast<SelectState*>(words);
  uint32_t* hist = words + 4;
  uint32_t* counts = hist + (int64_t)num_blocks * kBins;
  uint32_t* offsets = counts + 2 * (int64_t)num_blocks;
  const float* vf = static_cast<const float*>(v);
  topk_init<<<1, 1, 0, st>>>(state, (uint32_t)k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int shift = 24; shift >= 0; shift -= 8) {
    topk_hist<<<num_blocks, kThreads, 0, st>>>(vf, n, chunk, shift, state, hist);
    topk_select_digit<<<1, kThreads, 0, st>>>(hist, num_blocks, shift, state);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  topk_count<<<num_blocks, kThreads, 0, st>>>(vf, n, chunk, state, counts);
  topk_offsets<<<1, 32, 0, st>>>(counts, num_blocks, offsets);
  topk_scatter<<<num_blocks, kThreads, 0, st>>>(
      vf, n, chunk, (uint32_t)k, state, offsets, static_cast<float*>(out_vals),
      static_cast<int*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}
