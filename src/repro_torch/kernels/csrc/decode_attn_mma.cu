// decode_attn_mma: flash_decode on the bf16 tensor cores — one new token per
// batch row attends to its rows of a KV cache (grouped-query attention with
// per-row lengths, an optional sliding window and an optional tanh logit
// cap applied before masking), returning o (B, KV, G, hd) f32 and the
// log-sum-exp lse (B, KV, G, 1) f32, for the calls that
// kernels/decode_attn.py::_mma_eligible accepts: q, k and v all bf16,
// hd in {64, 128}, 1 <= G <= 16, q contiguous and every pointer, row and
// stride 16-byte aligned.  Every other call (f32 caches, f32 q against a
// bf16 cache, hd = 256) runs decode_attn.cu.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn.py::
// flash_decode_pallas (_decode_kernel), whose grid walks (B, KV, S/block_s)
// in order and carries the online-softmax state in VMEM across the seq axis.
//
// What bounds it on the H100: the bytes of the live K and V rows, read
// once, against 3.35 TB/s.  A live bf16 row at hd 128 is 512 bytes of K
// and V and carries 2·G·hd multiply-adds: at G = 12 that is 40 TFLOP/s at
// the byte rate, 60 % of the f32 CUDA-core peak, which is what held
// decode_attn.cu (each key row spread over hd/8 lanes, G scores summed by
// shuffles, every exponential repeated on every lane of a row) far from
// the bytes at starcoder2's heads.  Here both products run on the tensor
// cores, where the same work is a few per cent of the bf16 rate.
//
// Work split.  A block of 4 warps takes one (batch row b, kv head h) and
// one split of that row's live window [lo_b, len_b), lo_b = max(0, len_b -
// window) (0 without a window), computed here from lengths[b]: split j
// covers [lo_b + j·rows, min(lo_b + (j+1)·rows, len_b)).  The wrapper sizes
// `rows` (a multiple of 64) from the shapes alone (decode_mma_splits), so
// that ceil(live / rows) splits of all B·KV heads fill one wave, live =
// min(S, window): at starcoder2's window of 4 096 the grid holds the 16
// splits a full row needs, not the whole cache's 64.  A slot's splits
// depend only on its own length, so its output depends only on its own
// rows, and batched equals solo.
//
// Reading.  The split's rows go through shared memory in 64-row tiles of K
// and V, staged by 16-byte cp.async copies (L1 bypassed) in a ring of 3
// stages, two tiles in flight while one is used.  Rows are addressed
// through the cache's (batch, row, head) strides, so a layer's view of a
// stacked cache is read in place.  Rows of a tile at or past the split's
// end are zero-filled (cp.async with 0 source bytes, the source pointer
// clamped to a live row): no dead row is read, even in part, so a NaN
// there cannot reach the product through 0 · NaN.  The 16-byte chunk c of
// staged row r lies at chunk c ^ (r % 8) of its row, so the 8 rows of each
// 8 x 8 matrix that ldmatrix reads fall in distinct banks.  At hd 128 a
// stage is 32 KB (96 KB for the ring plus 4 KB for q: two blocks an SM).
//
// Products.  The G query rows, zero-padded to 16, are m16n8k16's M; q is
// loaded once into A fragments (hd/16 k-steps) and stays bf16, exact: the
// scale hd^-1/2 multiplies the f32 scores after the product.  Warp w takes
// rows 16w..16w+15 of each tile: S = Q Kᵀ as two n-tiles of 8 keys, K's
// [key][dim] rows being the col-major B operand as they lie (plain
// ldmatrix).  The online softmax runs in the accumulator layout: a thread
// holds 2 query rows x 4 keys, a row's max needs two quad shuffles, and
// each exponential is computed once.  Keys past the split's end get p = 0
// explicitly, never exp(-1e30 - m): a tile that is all masked would
// otherwise give p = 1.  O += P V reuses P's accumulator fragments as the
// A operand (FlashAttention-2), V through ldmatrix.trans.  P goes in as
// three bf16 parts, each the rest of p after the ones before rounded to
// bf16, in three mma: about 24 bits, the f32 p's own.  P rounded once to
// bf16 (2^-9 relative) puts o 1.2-3.7e-4 off an f64 attention, past the
// 1e-4 gate; two parts (~16 bits) pass that gate but leave o 1.7-3.3x as
// far from f64 as the plain f32 version; three are as close as it
// (tests/test_torch_kernels.py emulates all three at the path's shapes).
// The extra mma cost little in a body bound by bytes.  V is bf16 in the
// cache, so it goes in exact.  A thread's O is hd/8 x 4 f32 (64 registers
// at hd 128).
//
// Rounding.  The tensor cores round the f32 sum of an mma toward zero.
// Accumulated in the mma's own accumulator across k-steps (S) and across
// parts and tiles (O), that shrank every attention output by ~1.7e-7 of
// itself on an H100, where the CUDA-core body and the plain version show
// no bias (< 1.4e-8), and 40 bf16 layers of the full qwen3-14b turned
// that into decode-step logits 3.3-3.4e-2 off the plain version's, past
// the serve gate.  So each k-step of S, and each tile's P V (its parts from
// the smallest), runs into zeroed fragments, and f32 adds (round to
// nearest) carry the sums: one truncation per k-step or tile, none on a
// running sum.
//
// Merge.  The 4 warps merge their (m, l, O) through shared memory (the
// ring's, after the loop) in warp order; the block writes its split's
// normalised (o, lse), l clamped to 1e-30, straight to (o, lse) when there
// is one split.  Otherwise decode_mma_merge sums the splits with the
// lse_merge arithmetic in split order, its loop unrolled by 8 so that each
// group's loads issue before its FMA chain.  No float atomics: two calls
// on one card are bitwise equal.
//
// Two instances, one per hd; the window and the cap are run-time flags.

#include <math.h>

#include <atomic>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 16 * kWarps;  // rows of a staged tile: 16 a warp
constexpr int kStages = 3;              // ring of staged (K, V) tiles
constexpr int kQRows = 16;              // query rows: m16n8k16's M
constexpr int kMaxG = 16;
constexpr int kUnroll = 8;              // splits a merge group loads at once
constexpr int kPParts = 3;              // bf16 parts of P in O += P V
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <int HD>
struct Shape {
  static constexpr int kChunks = HD / 8;                 // 16-byte chunks a row
  static constexpr int kRowBytes = HD * 2;
  static constexpr int kTileBytes = kTileRows * kRowBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;     // K then V
  static constexpr int kQBytes = kQRows * kRowBytes;
  static constexpr int kSmemBytes = kStages * kStageBytes + kQBytes;
  // the warps' (O, m, l) after the loop, in the ring's memory
  static constexpr int kMergeBytes = kWarps * kQRows * (HD + 2) * 4;
  static_assert(kMergeBytes <= kStages * kStageBytes, "merge fits the ring");
};

// Byte offset of 16-byte chunk c of row r in a staged tile (rows of hd
// bf16, chunks XOR-swizzled by r % 8).
template <int HD>
__device__ __forceinline__ unsigned chunk_at(int r, int c) {
  return (unsigned)(r * Shape<HD>::kRowBytes + ((c ^ (r & 7)) << 4));
}

// The lane's byte offsets, within its row, of chunks 2i + hi (i = 0..3) of
// each 8-chunk group, swizzled by its row's r % 8 = x: chunk 2·ks + hi of
// the row lies at 128·(ks / 4) + off[ks % 4].
__device__ __forceinline__ void lane_chunks(int hi, int x, unsigned (&off)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) off[i] = (unsigned)(((2 * i + hi) ^ x) << 4);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 4 : 2)
decode_mma_partial(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const int* __restrict__ lengths,
                   float* __restrict__ o_part, float* __restrict__ lse_part,
                   int B, int S, int KV, int G,
                   long long ks_b, long long ks_s, long long ks_h,
                   long long vs_b, long long vs_s, long long vs_h,
                   int split_rows, int has_window, int window, float scale,
                   int has_cap, float cap) {
  using Sh = Shape<HD>;
  constexpr int kChunks = Sh::kChunks;
  constexpr int kKSteps = HD / 16;   // k-steps of S = Q Kᵀ; dim pairs of O
  extern __shared__ uint4 smem[];
  const unsigned smem0 = smem_addr(smem);
  const unsigned q_s = smem0 + kStages * Sh::kStageBytes;

  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;   // the lane's rows of a fragment: gid, gid + 8
  const int tq = lane & 3;     // the lane's column pair of a fragment

  // this split's rows [s0, s1) of the row's live window [lo, hi)
  const int length = lengths[b];
  const int hi = min(length, S);
  const int lo = has_window ? max(0, length - window) : 0;
  const int s0 = lo + split * split_rows;
  const int s1 = min(hi, s0 + split_rows);
  const int num_tiles = s1 > s0 ? (s1 - s0 + kTileRows - 1) / kTileRows : 0;

  const __nv_bfloat16* kb = k + b * ks_b + h * ks_h;
  const __nv_bfloat16* vb = v + b * vs_b + h * vs_h;

  // q's G rows, zero-padded to 16, into their swizzled rows (the first
  // commit group, with tile 0)
  const __nv_bfloat16* qb = q + ((long long)b * KV + h) * G * HD;
  for (int i = tid; i < kQRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r < G;
    cp_async16(q_s + chunk_at<HD>(r, c), qb + (in ? r : 0) * HD + 8 * c,
               in ? 16 : 0);
  }

  // tile tt of the split into ring slot st: K's 64 rows then V's, rows at
  // or past s1 zero-filled from a clamped (live) source
  auto load_tile = [&](int tt, int st) {
    const unsigned dk = smem0 + st * Sh::kStageBytes;
    const unsigned dv = dk + Sh::kTileBytes;
    const int base = s0 + tt * kTileRows;
#pragma unroll
    for (int it = 0; it < kTileRows * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kChunks, c = i % kChunks;
      const int t = base + r;
      const bool in = t < s1;
      const long long row = in ? t : s0;
      cp_async16(dk + chunk_at<HD>(r, c), kb + row * ks_s + 8 * c, in ? 16 : 0);
      cp_async16(dv + chunk_at<HD>(r, c), vb + row * vs_s + 8 * c, in ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < num_tiles) load_tile(s, s);
    cp_async_commit();
  }

  // the lane's ldmatrix rows and chunk offsets: A (q, x4) row lane % 16,
  // chunks 2ks + lane / 16; K (x4) key 8·(lane / 16) + lane % 8 of the
  // warp's 16, chunks 2ks + (lane / 8) % 2; V (x4 trans) key lane % 8 +
  // 8·((lane / 8) % 2), dims chunk 2nn + lane / 16.  Every row is lane % 8
  // modulo 8.
  unsigned q_off[4], k_off[4], v_off[4];
  lane_chunks(lane >> 4, lane & 7, q_off);
  lane_chunks((lane >> 3) & 1, lane & 7, k_off);
  lane_chunks(lane >> 4, lane & 7, v_off);
  const unsigned q_row = (unsigned)((lane & 15) * Sh::kRowBytes);
  const unsigned k_row = (unsigned)((16 * warp + 8 * (lane >> 4) + (lane & 7)) *
                                    Sh::kRowBytes);
  const unsigned v_row = (unsigned)((16 * warp + (lane & 7) +
                                     8 * ((lane >> 3) & 1)) * Sh::kRowBytes);

  unsigned qa[kKSteps][4];
  float m_r[2] = {kNegInf, kNegInf};   // rows gid and gid + 8
  float l_r[2] = {0.f, 0.f};           // the lane's partial sums
  float o[2 * kKSteps][4];             // O's n-tiles of 8 dims
#pragma unroll
  for (int n = 0; n < 2 * kKSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int tt = 0; tt < num_tiles; ++tt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile tt (and q) landed; every warp is done with tt - 1
    if (tt == 0) {
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        ldmatrix_x4(qa[ks], q_s + q_row + 128 * (ks >> 2) + q_off[ks & 3]);
    }
    if (tt + kStages - 1 < num_tiles)
      load_tile(tt + kStages - 1, (tt + kStages - 1) % kStages);
    cp_async_commit();
    const int key0 = s0 + tt * kTileRows + 16 * warp;  // the warp's first key
    if (key0 >= s1) continue;                          // warp-uniform
    const unsigned stage_k = smem0 + (tt % kStages) * Sh::kStageBytes;
    const unsigned stage_v = stage_k + Sh::kTileBytes;

    // S = Q Kᵀ: sc[j] holds keys 8j..8j+7 of the warp's 16.  Each k-step
    // runs into zeroed fragments, added to sc by f32 adds (round to
    // nearest): see "Rounding" above.
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      unsigned kf[4];
      ldmatrix_x4(kf, stage_k + k_row + 128 * (ks >> 2) + k_off[ks & 3]);
      float t[2][4] = {};
      mma_bf16(t[0], qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], kf[0], kf[1]);
      mma_bf16(t[1], qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], kf[2], kf[3]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += t[j][e];
    }

    // entry e of sc[j]: query row gid + 8·(e / 2), key key0 + 8j + 2tq + e % 2
    float mx[2] = {m_r[0], m_r[1]};
    bool live[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale;
        if (has_cap) x = tanhf(x / cap) * cap;
        sc[j][e] = x;
        live[j][e] = key0 + 8 * j + 2 * tq + (e & 1) < s1;
        if (live[j][e]) mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      corr[r] = __expf(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = live[j][e] ? __expf(sc[j][e] - mx[e >> 1]) : 0.f;
        l_r[e >> 1] += p;
        sc[j][e] = p;
      }

    // P as A fragments (a0: row gid keys 2tq.., a1: row gid+8, a2 and a3:
    // keys 8 + 2tq..), in kPParts bf16 parts: part t is the rest of p after
    // parts 0..t-1, rounded to bf16 (each rest is exact in f32)
    unsigned pa[kPParts][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = i >> 1, e = 2 * (i & 1);
      float2 rest = make_float2(sc[j][e], sc[j][e + 1]);
#pragma unroll
      for (int t = 0; t < kPParts; ++t) {
        const __nv_bfloat162 part = __floats2bfloat162_rn(rest.x, rest.y);
        const float2 pf = __bfloat1622float2(part);
        rest = make_float2(rest.x - pf.x, rest.y - pf.y);
        pa[t][i] = *reinterpret_cast<const unsigned*>(&part);
      }
    }

    // O = O·corr + P V: per pair of 8-dim n-tiles one ldmatrix.x4.trans of
    // V (keys 0-7 and 8-15 of dims 16nn.., then of dims 16nn + 8..), the
    // parts of P from the smallest into zeroed fragments, then one f32 FMA
    // (round to nearest) into O
#pragma unroll
    for (int nn = 0; nn < kKSteps; ++nn) {
      unsigned vf[4];
      ldmatrix_x4_trans(vf, stage_v + v_row + 128 * (nn >> 2) + v_off[nn & 3]);
      float pv[2][4] = {};
#pragma unroll
      for (int t = kPParts - 1; t >= 0; --t) {
        mma_bf16(pv[0], pa[t][0], pa[t][1], pa[t][2], pa[t][3], vf[0], vf[1]);
        mma_bf16(pv[1], pa[t][0], pa[t][1], pa[t][2], pa[t][3], vf[2], vf[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[2 * nn + j][e] = fmaf(o[2 * nn + j][e], corr[e >> 1], pv[j][e]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the merge

  // the warps' (O, m, l) in shared memory: O [warp][row][hd], then m and l
  // [warp][row]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(kFull, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(kFull, l_r[r], 2);
  }
  float* red_o = reinterpret_cast<float*>(smem);
  float* red_m = red_o + kWarps * kQRows * HD;
  float* red_l = red_m + kWarps * kQRows;
#pragma unroll
  for (int n = 0; n < 2 * kKSteps; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(
          red_o + (warp * kQRows + gid + 8 * r) * HD + 8 * n + 2 * tq) =
          make_float2(o[n][2 * r], o[n][2 * r + 1]);
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      red_m[warp * kQRows + gid + 8 * r] = m_r[r];
      red_l[warp * kQRows + gid + 8 * r] = l_r[r];
    }
  }
  __syncthreads();

  // merge the warps in warp order and write this split's partial
  const long long out_row = ((long long)split * B + b) * KV + h;
  for (int idx = tid; idx < G * HD; idx += kThreads) {
    const int g = idx / HD;
    float M = red_m[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, red_m[w * kQRows + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float sc = __expf(red_m[w * kQRows + g] - M);
      L += red_l[w * kQRows + g] * sc;
      A += red_o[w * kQRows * HD + idx] * sc;
    }
    const float Lc = fmaxf(L, 1e-30f);
    o_part[out_row * G * HD + idx] = A / Lc;
    if (idx % HD == 0) lse_part[out_row * G + g] = M + logf(Lc);
  }
}

// o = Σ_j o_j w_j / max(Σ_j w_j, 1e-30), w_j = exp(lse_j - max lse),
// lse = max lse + log(max(Σ w_j, 1e-30)), over the splits in split order.
// One block of hd threads per query row (b, kv, g), one output dim a
// thread; the splits' lse are read by every thread of the block (one line,
// broadcast).  The loops run in groups of kUnroll splits, each group's
// loads issued before its arithmetic.
__global__ void decode_mma_merge(const float* __restrict__ o_part,
                                 const float* __restrict__ lse_part,
                                 float* __restrict__ o, float* __restrict__ lse,
                                 int splits, int rows, int HD) {
  const long long row = blockIdx.x;
  const int d = threadIdx.x;
  const float* lp = lse_part + row;
  const float* op = o_part + row * HD + d;
  const long long o_stride = (long long)rows * HD;

  float M = -INFINITY;
  int j = 0;
  for (; j + kUnroll <= splits; j += kUnroll) {
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = lp[(long long)(j + u) * rows];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) M = fmaxf(M, x[u]);
  }
  for (; j < splits; ++j) M = fmaxf(M, lp[(long long)j * rows]);

  float den = 0.f, A = 0.f;
  j = 0;
  for (; j + kUnroll <= splits; j += kUnroll) {
    float x[kUnroll], y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      x[u] = lp[(long long)(j + u) * rows];
      y[u] = op[(j + u) * o_stride];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float w = __expf(x[u] - M);
      den += w;
      A = fmaf(y[u], w, A);
    }
  }
  for (; j < splits; ++j) {
    const float w = __expf(lp[(long long)j * rows] - M);
    den += w;
    A = fmaf(op[j * o_stride], w, A);
  }
  const float dc = fmaxf(den, 1e-30f);
  o[row * HD + d] = A / dc;
  if (d == 0) lse[row] = M + logf(dc);
}

using PartialKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                               const __nv_bfloat16*, const int*, float*, float*,
                               int, int, int, int, long long, long long,
                               long long, long long, long long, long long, int,
                               int, int, float, int, float);

PartialKernel partial_kernel(int hd) {
  return hd == 64 ? decode_mma_partial<64> : decode_mma_partial<128>;
}

int smem_bytes_of(int hd) {
  return hd == 64 ? Shape<64>::kSmemBytes : Shape<128>::kSmemBytes;
}

// Above 48 KB of dynamic shared memory a kernel must opt in; once per
// instance and device.
cudaError_t opt_in(int hd) {
  static std::atomic<unsigned long long> opted_in[2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  std::atomic<unsigned long long>& done = opted_in[hd == 64 ? 0 : 1];
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(partial_kernel(hd),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes_of(hd));
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace

// Blocks of the partial kernel resident per SM at head dim hd (64 or 128;
// the wrapper sizes the splits with it).  Returns a CUDA error code.
extern "C" int flash_decode_mma_launch_config(int hd, int* blocks_per_sm) {
  if (hd != 64 && hd != 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in(hd);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, partial_kernel(hd), kThreads, smem_bytes_of(hd)));
}

// q (B, KV, G, hd) bf16 contiguous, 16-byte aligned; k, v (B, S, KV, hd)
// bf16 with the last dim contiguous and strides in elements (batch, row,
// head), all multiples of 8 and both pointers 16-byte aligned; lengths (B,)
// int32 >= 1; hd in {64, 128}, 1 <= G <= 16.  o (B, KV, G, hd) and lse
// (B, KV, G, 1) f32; scale is hd^-1/2 rounded to f32.  Split j of row b
// covers [lo_b + j·split_rows, ...) of the row's live window, and
// splits·split_rows must cover min(S, window) (S without a window).  With
// splits > 1, o_part (splits, B, KV, G, hd) and lse_part (splits, B, KV, G)
// f32 are scratch and a merge pass follows; with one split they are o and
// lse.  Anything else: cudaErrorInvalidValue.  Returns cudaGetLastError()
// after the launches on `stream`.
extern "C" int flash_decode_mma_launch(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    void* lse, void* o_part, void* lse_part, int B, int S, int KV, int G,
    int hd, long long ks_b, long long ks_s, long long ks_h, long long vs_b,
    long long vs_s, long long vs_h, int splits, int split_rows, float scale,
    int has_window, int window, int has_cap, float cap, void* stream) {
  const long long live = has_window && window < S ? window : S;
  const long long strides[] = {ks_b, ks_s, ks_h, vs_b, vs_s, vs_h};
  bool aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(v) % 16 == 0;
  for (long long s : strides) aligned = aligned && s % 8 == 0;
  if ((hd != 64 && hd != 128) || B < 1 || S < 1 || KV < 1 || G < 1 ||
      G > kMaxG || splits < 1 || split_rows < 1 ||
      split_rows % kTileRows != 0 || B > 65535 || KV > 65535 ||
      (has_window && window < 1) || (has_cap && !(cap > 0.f)) ||
      (long long)splits * split_rows < live || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in(hd);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(splits > 1 ? o_part : o);
  float* lp = static_cast<float*>(splits > 1 ? lse_part : lse);
  partial_kernel(hd)<<<dim3(splits, KV, B), kThreads, smem_bytes_of(hd), st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      op, lp, B, S, KV, G, ks_b, ks_s, ks_h, vs_b, vs_s, vs_h, split_rows,
      has_window, window, scale, has_cap, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int rows = B * KV * G;
  decode_mma_merge<<<rows, hd, 0, st>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(lse_part),
      static_cast<float*>(o), static_cast<float*>(lse), splits, rows, hd);
  return static_cast<int>(cudaGetLastError());
}
