// flash_decode: one new token per batch row attends to its rows of a KV
// cache — grouped-query attention with per-row lengths, an optional sliding
// window and an optional tanh logit cap.  Returns o (B, KV, G, hd) f32 and
// the log-sum-exp lse (B, KV, G, 1) f32, the partials a sharded cache merges.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn.py::
// flash_decode_pallas (_decode_kernel), whose grid walks (B, KV, S/block_s)
// in order and carries the online-softmax state in VMEM across the seq axis.
// Here the seq axis is cut into `splits` ranges of `split_rows` rows, fixed
// by the shapes alone (never by the lengths: the wrapper sizes them so that
// the blocks over the rows a query can see fill one wave of resident
// blocks), and every (split, kv head, batch row) is one block of 128
// threads:
//
//   * the G query rows of the head, scaled by hd^-1/2, sit in shared memory
//     in f32;
//   * each warp streams key rows straight from the cache: hd/8 lanes hold
//     8 consecutive dims of one row (one 16-byte load for bf16, two for f32),
//     so a warp reads 32/(hd/8) rows per step, and the 4 warps interleave
//     steps.  Rows are addressed through the cache's strides (batch, row,
//     head), so a layer's view of a stacked (L, B, S, KV, hd) cache is read
//     in place, 16 bytes per lane, with no copy.  The loads of the next
//     stage (two steps) are issued before the current one is computed, so
//     the memory latency overlaps the arithmetic;
//   * a row's score is its lanes' partial dots summed by xor shuffles; every
//     lane of the row keeps its own online-softmax state (m, l) and an f32
//     accumulator for its 8 dims of each of the G query rows.  A stage's
//     scores are formed for all its rows and query rows before any softmax
//     update, with no branch between them, so the independent chains
//     interleave; the running max then moves once per stage;
//   * rows at or past the row's length, or at or before length-1-window, are
//     masked; whole steps outside [max(0, length-window), length) are never
//     visited, so dead rows of the cache are not read;
//   * at the end the key streams of a warp merge through shuffles, the warps
//     through shared memory, in a fixed order; the block writes its split's
//     (o, lse) — normalised, with l clamped to 1e-30 as the reference does.
//
// A second kernel merges the splits' partials with the lse_merge arithmetic,
// one block per query row, in a fixed order (no float atomics), so a row's
// output depends only on its own rows and the result is bitwise repeatable.  With one split the
// first kernel writes (o, lse) directly.
//
// What bounds it on the H100: the bytes of the live K and V rows against
// 3.35 TB/s; the 2·G·hd FMAs per row are far below the f32 rate.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStage = 2;   // steps per load stage
constexpr int kMaxSplits = 4096;   // the merge's weights fit 16 KB of shared memory

// 8 consecutive elements of a row, raw: one 16-byte load for bf16, two for
// f32.  The pointer is 16-byte aligned (checked by the wrapper).  The loads
// are issued a stage ahead of their use and converted to f32 only then.
template <typename T> struct Row8;
template <> struct Row8<__nv_bfloat16> { uint4 u; };
template <> struct Row8<float> { float4 a, b; };

__device__ __forceinline__ Row8<__nv_bfloat16> load8(const __nv_bfloat16* p) {
  return {__ldg(reinterpret_cast<const uint4*>(p))};
}
__device__ __forceinline__ Row8<float> load8(const float* p) {
  return {__ldg(reinterpret_cast<const float4*>(p)),
          __ldg(reinterpret_cast<const float4*>(p) + 1)};
}

__device__ __forceinline__ void to_f32x8(const Row8<__nv_bfloat16>& r, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void to_f32x8(const Row8<float>& r, float (&x)[8]) {
  x[0] = r.a.x; x[1] = r.a.y; x[2] = r.a.z; x[3] = r.a.w;
  x[4] = r.b.x; x[5] = r.b.y; x[6] = r.b.z; x[7] = r.b.w;
}

template <typename T, int HD, int GT>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const void* __restrict__ q, int q_bf16,
                      const T* __restrict__ k, const T* __restrict__ v,
                      const int* __restrict__ lengths,
                      float* __restrict__ o_part, float* __restrict__ lse_part,
                      int B, int S, int KV, int G,
                      int64_t ks_b, int64_t ks_s, int64_t ks_h,
                      int64_t vs_b, int64_t vs_s, int64_t vs_h,
                      int split_rows, int has_window, int window,
                      float scale, int has_cap, float cap) {
  constexpr int LPK = HD / 8;         // lanes per key row
  constexpr int KPW = 32 / LPK;       // rows per warp per step
  constexpr int KPB = kWarps * KPW;   // rows per block per step
  __shared__ __align__(16) float q_s[GT * HD];
  __shared__ float red_acc[kWarps][GT * HD];
  __shared__ float red_m[kWarps][GT];
  __shared__ float red_l[kWarps][GT];

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kg = lane / LPK;          // which row of the warp's step
  const int c = lane % LPK;           // which 8 dims

  const int64_t q_base = ((int64_t)b * KV + h) * G * HD;
  for (int i = tid; i < GT * HD; i += kThreads) {
    float x = 0.f;
    if (i < G * HD) {
      x = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[q_base + i])
                 : static_cast<const float*>(q)[q_base + i];
    }
    q_s[i] = x * scale;
  }
  __syncthreads();

  // live rows: lo <= t < hi; this split's rows: s0 <= t < s1
  const int length = lengths[b];
  const int hi = min(length, S);
  const int lo = has_window ? max(0, length - window) : 0;
  const int s0 = split * split_rows;
  const int s1 = min(S, s0 + split_rows);
  const int end = min(s1, hi);
  int begin = max(s0, lo);
  begin = s0 + ((begin - s0) / KPB) * KPB;   // a step boundary of the split

  float m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  }

  const T* kb = k + (int64_t)b * ks_b + (int64_t)h * ks_h + c * 8;
  const T* vb = v + (int64_t)b * vs_b + (int64_t)h * vs_h + c * 8;
  // A stage is kStage steps.  The next stage's rows are loaded before the
  // current stage is computed, so a warp keeps 2·kStage 16-byte loads per
  // lane in flight while it works.  A lane whose row is not live loads a
  // live row instead (clamped into [lo, end)) and ignores it: no dead row
  // is read, and every load is unconditional.
  Row8<T> kn[kStage], vn[kStage];
  auto load_stage = [&](int base) {
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int t = min(max(base + u * KPB + kg, lo), end - 1);
      kn[u] = load8(kb + (int64_t)t * ks_s);
      vn[u] = load8(vb + (int64_t)t * vs_s);
    }
  };
  int base = begin + warp * KPW;
  if (base < end) load_stage(base);
  for (; base < end; base += kStage * KPB) {
    Row8<T> kc[kStage], vc[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      kc[u] = kn[u];
      vc[u] = vn[u];
    }
    if (base + kStage * KPB < end) load_stage(base + kStage * KPB);
    float kx[kStage][8], vx[kStage][8];
    bool live[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int t = base + u * KPB + kg;
      live[u] = t >= lo && t < end;
      to_f32x8(kc[u], kx[u]);
    }
    // the stage's scores, then their lane sums: no branch between the
    // kStage · GT independent chains, so they interleave
    float sc[kStage][GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float4* qv = reinterpret_cast<const float4*>(q_s + g * HD + c * 8);
      const float4 qa = qv[0], qb = qv[1];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        float s = qa.x * kx[u][0];
        s = fmaf(qa.y, kx[u][1], s);
        s = fmaf(qa.z, kx[u][2], s);
        s = fmaf(qa.w, kx[u][3], s);
        s = fmaf(qb.x, kx[u][4], s);
        s = fmaf(qb.y, kx[u][5], s);
        s = fmaf(qb.z, kx[u][6], s);
        s = fmaf(qb.w, kx[u][7], s);
        sc[u][g] = s;
      }
    }
#pragma unroll
    for (int off = LPK / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int u = 0; u < kStage; ++u)
          sc[u][g] += __shfl_xor_sync(kFull, sc[u][g], off);
      }
    }
    if (has_cap) {
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int u = 0; u < kStage; ++u)
          sc[u][g] = tanhf(sc[u][g] / cap) * cap;
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) to_f32x8(vc[u], vx[u]);
    // one online-softmax update per stage: the running max moves once, the
    // accumulator is rescaled once
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kStage; ++u)
        if (live[u]) mx = fmaxf(mx, sc[u][g]);
      const float corr = __expf(m[g] - mx);
      float p[kStage];
      float lsum = l[g] * corr;
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        p[u] = live[u] ? __expf(sc[u][g] - mx) : 0.f;
        lsum += p[u];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float a = acc[g][j] * corr;
#pragma unroll
        for (int u = 0; u < kStage; ++u) a = fmaf(p[u], vx[u][j], a);
        acc[g][j] = a;
      }
      l[g] = lsum;
      m[g] = mx;
    }
  }

  // merge the warp's KPW row streams (lanes c, c+LPK, ...) in xor order
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    float mg = m[g];
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1)
      mg = fmaxf(mg, __shfl_xor_sync(kFull, mg, off));
    const float w = __expf(m[g] - mg);
    float lg = l[g] * w;
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1) lg += __shfl_xor_sync(kFull, lg, off);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float a = acc[g][j] * w;
#pragma unroll
      for (int off = LPK; off < 32; off <<= 1) a += __shfl_xor_sync(kFull, a, off);
      acc[g][j] = a;
    }
    if (kg == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) red_acc[warp][g * HD + c * 8 + j] = acc[g][j];
      if (c == 0) {
        red_m[warp][g] = mg;
        red_l[warp][g] = lg;
      }
    }
  }
  __syncthreads();

  // merge the warps in warp order and write this split's partial
  const int64_t out_row = ((int64_t)split * B + b) * KV + h;
  for (int idx = tid; idx < G * HD; idx += kThreads) {
    const int g = idx / HD;
    float M = red_m[0][g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, red_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float sc = __expf(red_m[w][g] - M);
      L += red_l[w][g] * sc;
      A += red_acc[w][idx] * sc;
    }
    const float Lc = fmaxf(L, 1e-30f);
    o_part[out_row * G * HD + idx] = A / Lc;
    if (idx % HD == 0) lse_part[out_row * G + g] = M + logf(Lc);
  }
}

// o = Σ_j o_j w_j / max(Σ_j w_j, 1e-30), w_j = exp(lse_j - max lse),
// lse = max lse + log(max(Σ w_j, 1e-30)), over the splits.  One block per
// query row (b, kv, g): the weights are formed once in shared memory (the
// max and the sum by a fixed tree, so the result is bitwise repeatable), and
// each thread sums one output dim over the splits in split order.
constexpr int kMergeThreads = 128;

__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const float* __restrict__ o_part,
                    const float* __restrict__ lse_part, float* __restrict__ o,
                    float* __restrict__ lse, int splits, int rows, int HD) {
  extern __shared__ float w_s[];                  // splits weights
  __shared__ float red[kMergeThreads];
  const int64_t row = blockIdx.x;                 // (b, kv, g)
  const int64_t o_stride = (int64_t)rows * HD;    // one split's partials
  const int tid = threadIdx.x;

  float mx = -INFINITY;
  for (int j = tid; j < splits; j += kMergeThreads) {
    w_s[j] = lse_part[j * (int64_t)rows + row];
    mx = fmaxf(mx, w_s[j]);
  }
  red[tid] = mx;
  __syncthreads();
  for (int half = kMergeThreads / 2; half > 0; half >>= 1) {
    if (tid < half) red[tid] = fmaxf(red[tid], red[tid + half]);
    __syncthreads();
  }
  const float M = red[0];
  __syncthreads();
  float part = 0.f;
  for (int j = tid; j < splits; j += kMergeThreads) {
    w_s[j] = __expf(w_s[j] - M);
    part += w_s[j];
  }
  red[tid] = part;
  __syncthreads();
  for (int half = kMergeThreads / 2; half > 0; half >>= 1) {
    if (tid < half) red[tid] += red[tid + half];
    __syncthreads();
  }
  const float den = fmaxf(red[0], 1e-30f);
  for (int d = tid; d < HD; d += kMergeThreads) {
    const float* op = o_part + row * HD + d;
    float A = 0.f;
    for (int j = 0; j < splits; ++j) A = fmaf(op[j * o_stride], w_s[j], A);
    o[row * HD + d] = A / den;
  }
  if (tid == 0) lse[row] = M + logf(den);
}

template <int N> struct Int { static constexpr int value = N; };

// Calls f(T{}, Int<HD>{}, Int<GT>{}) for the instantiation that serves a
// cache type, head dim and G: GT is the smallest of 1, 4, 5, 8, 12, 16 that
// holds G (the G of every config has its own; another G runs in the next
// one up, its extra query rows zero and never written), with GT · hd <= 2048.
template <typename T, int HD, typename F>
cudaError_t with_groups(int G, F& f) {
  if (G <= 1) return f(T{}, Int<HD>{}, Int<1>{});
  if (G <= 4) return f(T{}, Int<HD>{}, Int<4>{});
  if (G <= 5) return f(T{}, Int<HD>{}, Int<5>{});
  if (G <= 8) return f(T{}, Int<HD>{}, Int<8>{});
  if constexpr (HD <= 128) {
    if (G <= 12) return f(T{}, Int<HD>{}, Int<12>{});
    if (G <= 16) return f(T{}, Int<HD>{}, Int<16>{});
  }
  return cudaErrorInvalidValue;
}

template <typename T, typename F>
cudaError_t with_head_dim(int hd, int G, F& f) {
  switch (hd) {
    case 64: return with_groups<T, 64>(G, f);
    case 128: return with_groups<T, 128>(G, f);
    case 256: return with_groups<T, 256>(G, f);
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t with_kernel(int kv_bf16, int hd, int G, F&& f) {
  return kv_bf16 ? with_head_dim<__nv_bfloat16>(hd, G, f)
                 : with_head_dim<float>(hd, G, f);
}

}  // namespace

// Blocks of the partial kernel resident per SM for this cache type, head
// dim and G (the wrapper sizes the seq split with it).
extern "C" int flash_decode_launch_config(int hd, int G, int kv_bf16,
                                          int* blocks_per_sm) {
  auto query = [&](auto t, auto hd_c, auto g_c) {
    using T = decltype(t);
    constexpr int HD = decltype(hd_c)::value, GT = decltype(g_c)::value;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, decode_partial_kernel<T, HD, GT>, kThreads, 0);
  };
  return static_cast<int>(with_kernel(kv_bf16, hd, G, query));
}

// q (B, KV, G, hd) contiguous, f32 or bf16; k, v (B, S, KV, hd), both f32
// or both bf16, the last dim contiguous, strides in elements (batch, row,
// head) with 16-byte aligned rows; lengths (B,) int32 >= 1.  o (B, KV, G, hd)
// and lse (B, KV, G, 1) f32; scale is hd^-1/2 rounded to f32.  With
// splits > 1, o_part (splits, B, KV, G, hd) and lse_part (splits, B, KV, G)
// f32 are scratch and a merge pass follows; with one split they are o and
// lse.  Returns cudaGetLastError() after the launches on `stream`.
extern "C" int flash_decode_launch(
    const void* q, int q_bf16, const void* k, const void* v, int kv_bf16,
    const void* lengths, void* o, void* lse, void* o_part, void* lse_part,
    int B, int S, int KV, int G, int hd, long long ks_b, long long ks_s,
    long long ks_h, long long vs_b, long long vs_s, long long vs_h, int splits,
    int split_rows, float scale, int has_window, int window, int has_cap,
    float cap, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || G < 1 || splits < 1 || split_rows < 1 ||
      B > 65535 || KV > 65535 || (has_window && window < 1) ||
      (has_cap && !(cap > 0.f)) || (long long)splits * split_rows < S ||
      splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* op = static_cast<float*>(splits > 1 ? o_part : o);
  float* lp = static_cast<float*>(splits > 1 ? lse_part : lse);
  const dim3 grid(splits, KV, B);
  auto partial = [&](auto t, auto hd_c, auto g_c) {
    using T = decltype(t);
    constexpr int HD = decltype(hd_c)::value, GT = decltype(g_c)::value;
    decode_partial_kernel<T, HD, GT><<<grid, kThreads, 0, st>>>(
        q, q_bf16, static_cast<const T*>(k), static_cast<const T*>(v), len, op,
        lp, B, S, KV, G, ks_b, ks_s, ks_h, vs_b, vs_s, vs_h, split_rows,
        has_window, window, scale, has_cap, cap);
    return cudaGetLastError();
  };
  cudaError_t err = with_kernel(kv_bf16, hd, G, partial);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int rows = B * KV * G;
  decode_merge_kernel<<<rows, kMergeThreads, splits * sizeof(float), st>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(lse_part),
      static_cast<float*>(o), static_cast<float*>(lse), splits, rows, hd);
  return static_cast<int>(cudaGetLastError());
}
