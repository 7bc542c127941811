// topk_select: the k largest-|v| entries of v (n,) f32, as (values v[idx],
// indices int32).
//
// Replaces repro/kernels/topk.py::topk_select_pallas (per-chunk lax.top_k of
// block_n entries, k <= block_n) and its candidate merge (topk.py:64-68).
// That design leans on the TPU's vector sort; on Hopper a radix select has
// no k <= block_n limit (k = n/16 is about a million at model width).
//
// Both paths select on the magnitude bits: |v| as an IEEE float with the
// sign bit cleared orders like its uint32 bits (key_of), so the k-th largest
// key T is found one 8-bit digit at a time, top digit first, with r, the
// number of entries equal to T that belong to the top k (those with the
// lowest indices).  -0.0 and +0.0 have equal keys, as |-0.0| == |+0.0| in
// the reference.  Integer counts only, no float atomics: nothing depends on
// the order threads or blocks run in.
//
// Single block, n <= kSmallMaxN (topk_small; every shape of the paper paths,
// n = 7 850).  One block of 1 024 threads does it all in one launch:
//   load    — v once, coalesced, a thread's (up to 16) loads all in flight,
//             into shared memory as raw bits;
//   select  — four rounds of a 256-bin shared histogram (integer atomics)
//             of the digit of every entry whose higher digits equal T's so
//             far; warp 0 picks the digit with a suffix scan over its lanes;
//   compact — the entries > T and the first r entries == T, in index order
//             (ballot/popc ranks), as 64-bit keys ((~key) << 32) | idx;
//   order   — a bitonic sort of those keys, padded to P = the next power of
//             two >= max(k, 64), ascending: |v| descending, then the lower
//             index first — lax.top_k's order — so the kernel writes the
//             final values (the original bits, sign included) and indices.
//             A warp holds 64-key segments in registers, two keys a lane,
//             and runs every stage of stride <= 32 with shuffles; only the
//             strides >= 64 (15 of the 66 stages at P = 2 048) go through
//             shared memory, each behind a block-wide barrier.
// Shared memory: 4n bytes of entries and 8P of sort keys.  At n = 16 384
// that is 64 KB + 128 KB of the 227 KB a block may opt into; n = 32 768
// would need 128 KB + 256 KB, so the cap is 16 384.  What bounds it is
// launch and latency, not bytes: at n = 7 850 the 31 KB read and 14 KB
// written take 0.01 us at 3.35 TB/s, while one SM walks ~40 block-wide
// barriers.  On an H100 (700 W; chip_smoke.py) the block takes 18.8-18.9 us
// of device time at k = 1 731 and 12.2-12.3 us at k = 490, and the host
// 31-58 us to issue a call, so back-to-back calls are host-paced.
// ptxas (sm_90a): topk_small 32 registers, 1 552 bytes of static shared
// memory (histogram, warp totals, T's state), no stack, no spills; its
// dynamic shared memory is 4n (8-aligned) + 8P bytes.
//
// Multi-block, n > kSmallMaxN (model widths):
//   hist    — each block counts, in shared memory, the digit of every entry of
//             its contiguous range whose higher digits equal T's so far, and
//             writes its 256 counts to global memory;
//   select  — one block sums the per-block counts in block order and fixes
//             the next digit of T and the rank of T among the entries still
//             tied;
//   count   — each block counts its entries > T and == T,
//   offsets — one block turns the counts into exclusive offsets, block order,
//   scatter — each block writes its entries > T, then its first entries == T
//             (while the running count of == T stays below r), in index order
//             within the block, at those offsets.
// Its output is the top-k set with the entries > T first, each group in
// index order; the wrapper (topk.py) puts it in lax.top_k's order with one
// stable sort of the k candidates.  What bounds it is the bytes: v is read
// six times (four histograms, count, scatter) and the k values and indices
// written once; the bound is one read of 4n bytes plus 8k written at
// 3.35 TB/s.

#include <atomic>

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

// ---------------------------------------------------------------- one block

constexpr int kSmallThreads = 1024;
constexpr int kSmallWarps = kSmallThreads / 32;
constexpr int kSmallMaxN = 16384;
constexpr int kSmallPerThread = kSmallMaxN / kSmallThreads;

__host__ __device__ constexpr int pow2_at_least(int k) {
  int p = 1;
  while (p < k) p <<= 1;
  return p;
}

// At least one 64-key warp segment (see the sort in topk_small).
__host__ __device__ constexpr int sort_size(int k) {
  return pow2_at_least(k) > 64 ? pow2_at_least(k) : 64;
}

using Key = unsigned long long;  // ((~key) << 32) | index: sorts like lax.top_k

// The bitonic stages of strides j_top, j_top / 2, ..., 1 of a sort of
// `size`-key runs on one warp's 64-key segment, whose keys at positions pos
// and pos + 1 (pos = segment start + 2 * lane) this lane holds.  A run
// sorts ascending where (pos & size) == 0; the partner of pos at a stride
// j >= 2 is the same slot of lane ^ (j / 2).
__device__ __forceinline__ void warp_stages(Key& x0, Key& x1, int pos, int size,
                                            int j_top) {
  const bool asc = (pos & size) == 0;
  for (int j = j_top; j >= 2; j >>= 1) {
    const Key y0 = __shfl_xor_sync(0xFFFFFFFFu, x0, j >> 1);
    const Key y1 = __shfl_xor_sync(0xFFFFFFFFu, x1, j >> 1);
    const bool keep_min = ((pos & j) == 0) == asc;
    x0 = keep_min == (y0 < x0) ? y0 : x0;
    x1 = keep_min == (y1 < x1) ? y1 : x1;
  }
  if ((x0 > x1) == asc) {
    const Key t = x0;
    x0 = x1;
    x1 = t;
  }
}

__host__ __device__ constexpr int small_bits_bytes(int n) {
  return (4 * n + 7) & ~7;  // the sort keys that follow are 8-aligned
}

// 192 KB: 64 KB of entries and 128 KB of sort keys at n = k = 16 384
constexpr int kSmallMaxSmem = small_bits_bytes(kSmallMaxN) + 8 * sort_size(kSmallMaxN);

__global__ void __launch_bounds__(kSmallThreads)
topk_small(const float* __restrict__ v, int n, int k,
           float* __restrict__ out_vals, int* __restrict__ out_idx) {
  extern __shared__ Key smem_small[];
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem_small);
  Key* keys = smem_small + small_bits_bytes(n) / 8;
  __shared__ uint32_t hist[kBins];
  __shared__ uint32_t warp_tot[2][2][kSmallWarps];  // [tile parity][gt, eq]
  __shared__ uint32_t st_prefix, st_mask, st_rank;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  {
    // all of a thread's loads in flight at once, then into shared memory
    float x[kSmallPerThread];
#pragma unroll
    for (int r = 0; r < kSmallPerThread; ++r) {
      const int i = r * kSmallThreads + tid;
      if (i < n) x[r] = v[i];
    }
#pragma unroll
    for (int r = 0; r < kSmallPerThread; ++r) {
      const int i = r * kSmallThreads + tid;
      if (i < n) bits[i] = __float_as_uint(x[r]);
    }
  }
  if (tid < kBins) hist[tid] = 0u;
  if (tid == 0) {
    st_prefix = 0u;
    st_mask = 0u;
    st_rank = (uint32_t)k;
  }
  __syncthreads();

  // T and r, one digit a round: the same digits and integer arithmetic as
  // topk_hist + topk_select_digit, on one block's shared histogram.
  for (int shift = 24; shift >= 0; shift -= 8) {
    const uint32_t prefix = st_prefix, mask = st_mask;
    for (int i = tid; i < n; i += kSmallThreads) {
      const uint32_t key = bits[i] & 0x7FFFFFFFu;
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 0xFFu], 1u);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l owns bins [8l, 8l + 8); suf = entries in the bins >= 8l
      uint32_t seg = 0u;
#pragma unroll
      for (int b = 0; b < 8; ++b) seg += hist[8 * lane + b];
      uint32_t suf = seg;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t t = __shfl_down_sync(0xFFFFFFFFu, suf, off);
        if (lane + off < 32) suf += t;
      }
      const uint32_t rank = st_rank;
      // suf falls with the lane and suf(lane 0) >= rank: the digit lies in
      // the highest lane whose suffix still reaches the rank
      const unsigned reach = __ballot_sync(0xFFFFFFFFu, suf >= rank);
      if (lane == 31 - __clz(reach)) {
        uint32_t above = suf - seg;
        for (int d = 8 * lane + 7; d >= 8 * lane; --d) {
          if (above + hist[d] >= rank) {
            st_prefix = prefix | ((uint32_t)d << shift);
            st_mask = mask | (0xFFu << shift);
            st_rank = rank - above;
            break;
          }
          above += hist[d];
        }
      }
      __syncwarp();
#pragma unroll
      for (int b = 0; b < 8; ++b) hist[8 * lane + b] = 0u;
    }
    __syncthreads();
  }

  // The survivors as sort keys: the entries > T and the first r == T, in
  // index order, one tile of 1 024 entries at a time (each thread keeps the
  // same running counts, so the early exit is uniform).
  const uint32_t T = st_prefix;
  const uint32_t take_eq = st_rank;
  const uint32_t num_gt = (uint32_t)k - take_eq;
  uint32_t gt_pos = 0u, eq_pos = 0u;
  for (int base = 0, tile = 0; base < n; base += kSmallThreads, ++tile) {
    if (gt_pos >= num_gt && eq_pos >= take_eq) break;
    const int e = base + tid;
    const uint32_t key = e < n ? bits[e] & 0x7FFFFFFFu : 0u;
    const bool is_gt = e < n && key > T;
    const bool is_eq = e < n && key == T;
    const unsigned b_gt = __ballot_sync(0xFFFFFFFFu, is_gt);
    const unsigned b_eq = __ballot_sync(0xFFFFFFFFu, is_eq);
    uint32_t(*tot)[kSmallWarps] = warp_tot[tile & 1];
    if (lane == 0) {
      tot[0][warp] = __popc(b_gt);
      tot[1][warp] = __popc(b_eq);
    }
    __syncthreads();  // double-buffered: the next tile writes the other half
    // each warp scans the 32 warp totals across its lanes
    uint32_t s_gt = tot[0][lane], s_eq = tot[1][lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t a = __shfl_up_sync(0xFFFFFFFFu, s_gt, off);
      const uint32_t b = __shfl_up_sync(0xFFFFFFFFu, s_eq, off);
      if (lane >= off) {
        s_gt += a;
        s_eq += b;
      }
    }
    const uint32_t all_gt = __shfl_sync(0xFFFFFFFFu, s_gt, 31);
    const uint32_t all_eq = __shfl_sync(0xFFFFFFFFu, s_eq, 31);
    const uint32_t before_gt = __shfl_sync(0xFFFFFFFFu, s_gt, warp) - tot[0][warp];
    const uint32_t before_eq = __shfl_sync(0xFFFFFFFFu, s_eq, warp) - tot[1][warp];
    const unsigned below = (1u << lane) - 1u;
    const Key sort_key = ((Key)(~key) << 32) | (uint32_t)e;
    if (is_gt) {
      keys[gt_pos + before_gt + __popc(b_gt & below)] = sort_key;
    } else if (is_eq) {
      const uint32_t r = eq_pos + before_eq + __popc(b_eq & below);
      if (r < take_eq) keys[num_gt + r] = sort_key;
    }
    gt_pos += all_gt;
    eq_pos += all_eq;
  }
  const int P = sort_size(k);
  for (int i = k + tid; i < P; i += kSmallThreads) keys[i] = ~0ull;  // pads sort last
  __syncthreads();

  // Bitonic sort of P keys, ascending.  Each warp owns 64-key segments
  // (m = warp, warp + 32, ...), two keys a lane, in registers: every stage
  // of stride j <= 32 stays inside a segment (shuffles), so only the
  // strides >= 64 go through shared memory with a block-wide barrier.
  for (int m = warp; m < P / 64; m += kSmallWarps) {
    Key* seg = keys + 64 * m + 2 * lane;
    Key x0 = seg[0], x1 = seg[1];
    for (int size = 2; size <= 64; size <<= 1)
      warp_stages(x0, x1, 64 * m + 2 * lane, size, size >> 1);
    seg[0] = x0;
    seg[1] = x1;
  }
  __syncthreads();
  for (int size = 128; size <= P; size <<= 1) {
    for (int j = size >> 1; j >= 64; j >>= 1) {
      for (int p = tid; p < P / 2; p += kSmallThreads) {
        const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));  // bit j clear
        const Key a = keys[lo], b = keys[lo + j];
        if ((a > b) == ((lo & size) == 0)) {
          keys[lo] = b;
          keys[lo + j] = a;
        }
      }
      __syncthreads();
    }
    for (int m = warp; m < P / 64; m += kSmallWarps) {
      Key* seg = keys + 64 * m + 2 * lane;
      Key x0 = seg[0], x1 = seg[1];
      warp_stages(x0, x1, 64 * m + 2 * lane, size, 32);
      seg[0] = x0;
      seg[1] = x1;
    }
    __syncthreads();
  }

  for (int i = tid; i < k; i += kSmallThreads) {
    const uint32_t idx = (uint32_t)keys[i];
    out_vals[i] = __uint_as_float(bits[idx]);
    out_idx[i] = (int)idx;
  }
}

}  // namespace

// v (n,) f32 with 1 <= k <= n <= 16 384; out_vals (k,) f32 and out_idx (k,)
// int32 receive the top k in lax.top_k's order.  One launch of one block on
// `stream`; returns cudaGetLastError() after it.
extern "C" int topk_small_launch(const void* v, int n, int k, void* out_vals,
                                 void* out_idx, void* stream) {
  if (n < 1 || n > kSmallMaxN || k < 1 || k > n)
    return static_cast<int>(cudaErrorInvalidValue);
  // The 48 KB default covers static and dynamic shared memory together, so
  // opt in to the largest size once per device.
  static std::atomic<unsigned long long> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted_in.load() & bit)) {
    err = cudaFuncSetAttribute(topk_small,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmallMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in.fetch_or(bit);
  }
  const int smem = small_bits_bytes(n) + 8 * sort_size(k);
  topk_small<<<1, kSmallThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), n, k, static_cast<float*>(out_vals),
      static_cast<int*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}

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
