// decode_attn_cluster: flash_decode on the bf16 tensor cores in one launch a
// call — one new token per batch row attends to its rows of a KV cache
// (grouped-query attention with per-row lengths, an optional sliding window
// and an optional tanh logit cap applied before masking), returning o (B,
// KV, G, hd) f32 and the log-sum-exp lse (B, KV, G, 1) f32, for the calls
// that kernels/decode_attn.py's validation pass finds the tensor cores take:
// q, k and v all bf16, hd in {64, 128}, 1 <= G <= 16, q contiguous and every
// pointer, row and stride 16-byte aligned.  Every other call (f32 caches,
// f32 q against a bf16 cache, hd = 256) runs decode_attn.cu.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn.py::
// flash_decode_pallas (_decode_kernel), whose grid walks (B, KV, S/block_s)
// in order and carries the online-softmax state in VMEM across the seq axis.
//
// What bounds it on the H100: the bytes of the live K and V rows, read once,
// against 3.35 TB/s (the products run on the tensor cores, a few per cent of
// their bf16 rate).  At the serve path's shapes the rows are a few hundred
// KB: a call is then bound by its fixed costs, a launch and the merge of
// the splits, which is what this body takes out.
//
// The work of a split is decode_attn_mma.cu's (decode_mma_partial),
// carried over unchanged: a block of 4 warps takes one (batch row b, kv
// head h) and one split of that row's live window [lo_b, len_b), lo_b =
// max(0, len_b - window), in 64-row tiles of K and V through a 3-stage
// cp.async ring (XOR-swizzled 16-byte chunks, rows at or past the split's
// end zero-filled from a clamped live source, so no dead row is read), S =
// Q Kᵀ and O += P V on mma.sync m16n8k16 (P in three bf16 parts, one
// truncation per k-step or tile), an online softmax in the accumulator
// layout, and the 4 warps merged in warp order through the ring's shared
// memory.  A row with no live key in the block (a local length <= 0, or a
// window that ends before the block) runs no tile and gives o = 0, lse =
// -1e30.  decode_attn_mma.cu's header says why each of these is so.
//
// The merge.  The splits of one (b, h) head are one thread-block cluster:
// grid (splits, KV, B), cluster dims (splits, 1, 1), launched with
// cudaLaunchKernelEx (clusters past the portable 8 opt in with
// cudaFuncAttributeNonPortableClusterSizeAllowed, up to 16) under the
// load-balancing scheduling policy.  A cluster's blocks must be resident
// together in one GPC, so the card holds fewer blocks of a call in
// clusters than alone (at hd 128, 66 clusters of 4 or 15 of 16, against
// 264 blocks); the wrapper caps the splits at the largest cluster of which
// the card co-schedules one for every head (cudaOccupancyMaxActiveClusters,
// flash_decode_cluster_launch_config), so that a call is one wave: a call
// of more clusters ran a second wave on the card, up to 2x slower.  Block
// r of a cluster merges quads (four consecutive dims) [r·share,
// (r+1)·share) of the head's G·hd outputs.  After the warp merge every
// block pushes its split's normalised o_j, four dims a store, and its
// lse_j into the merging blocks' shared memory (distributed shared memory,
// cluster.map_shared_rank), into a region past q that the ring never uses,
// so a block that is still in its loop can take them.  One cluster barrier
// (arrive.release, wait.acquire) makes the pushes visible; then each block
// merges from its own shared memory, in split order j = 0..splits-1, with
// decode_mma_merge's arithmetic: M = max lse_j, w_j = __expf(lse_j - M),
// den += w_j, A = fmaf(o_j, w_j, A), den clamped to 1e-30, lse = M +
// logf(den).  The warp merge forms each row's max, warp weights and sum
// once instead of once a dim: the same values in the same order.  So with
// the same split plan the result is bitwise equal to decode_attn_mma.cu's
// two launches.  No block reads or writes another's shared memory after
// the barrier, so none waits for the others before it exits; and none
// writes into another before that one runs: each arrives (relaxed) on
// the barrier once its first copies are issued and waits before its first
// push.  Every block reaches every barrier: a split with no live row
// pushes o_j = 0, lse_j = -1e30 (a return before would hang the cluster).
// With one split the block writes o and lse itself.  No partials in device
// memory, no scratch, no second launch, no atomics: two calls on one card
// are bitwise equal.
//
// The per-plan constants (shapes, strides, splits, rows, scale, flags) come
// by pointer in one ClusterPlan, which the wrapper builds once per plan
// (kernels/decode_attn.py ClusterPlan, the same fields in the same order);
// the call passes only the pointers and the stream.
//
// Two instances, one per hd; the window and the cap are run-time flags.

#include <cooperative_groups.h>
#include <math.h>

#include <atomic>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

// The constants of a call's plan; kernels/decode_attn.py ClusterPlan
// mirrors it field for field (8-byte fields first: no padding).
struct ClusterPlan {
  long long ks_b, ks_s, ks_h;     // k's strides in elements (batch, row, head)
  long long vs_b, vs_s, vs_h;     // v's
  long long lse_offset;           // floats from o to lse in the output buffer
  int B, S, KV, G, hd;
  int splits, split_rows;         // split j of row b: [lo_b + j·rows, ...)
  int has_window, window, has_cap;
  float scale, cap;               // hd^-1/2 rounded to f32; the logit cap
};

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 16 * kWarps;  // rows of a staged tile: 16 a warp
constexpr int kStages = 3;              // ring of staged (K, V) tiles
constexpr int kQRows = 16;              // query rows: m16n8k16's M
constexpr int kMaxG = 16;
constexpr int kPParts = 3;              // bf16 parts of P in O += P V
constexpr int kPortableCluster = 8;     // cluster size without the opt-in
constexpr int kMaxCluster = 16;         // the largest with it
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <int HD>
struct Shape {
  static constexpr int kChunks = HD / 8;                 // 16-byte chunks a row
  static constexpr int kRowBytes = HD * 2;
  static constexpr int kTileBytes = kTileRows * kRowBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;     // K then V
  static constexpr int kQBytes = kQRows * kRowBytes;
  // what the cluster's blocks push into this one (its share of every
  // split's o_j, every split's lse_j), past q: never the ring, which the
  // block may still be using when a faster block pushes
  static constexpr int kRecvFloats = kQRows * HD + 4 * kMaxCluster +
                                     kMaxCluster * kQRows;
  static constexpr int kSmemBytes = kStages * kStageBytes + kQBytes +
                                    kRecvFloats * 4;
  // after the loop, in the ring: the warps' (O, m, l), O's rows kRed
  // floats apart (a warp's float2 stores to 8 rows then take the 2
  // wavefronts their 256 bytes need, not 8), then each row's warp weights,
  // clamped sum and lse_j, then the cluster merge's split weights, max and
  // clamped sum
  static constexpr int kRed = HD + 8;
  static constexpr int kMergeFloats =
      kWarps * kQRows * (kRed + 3) + 2 * kQRows + kMaxCluster * kQRows +
      2 * kQRows;
  static_assert(kMergeFloats * 4 <= kStages * kStageBytes,
                "the merges fit the ring");
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

// The cluster barrier in its two halves (every thread of every block of
// the cluster, converged): arrive without ordering, wait; and a full
// barrier whose arrive releases and whose wait acquires the shared-memory
// writes made before it, remote ones included.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 4 : 2)
decode_cluster(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const int* __restrict__ lengths, float* __restrict__ o,
               float* __restrict__ lse, const ClusterPlan p) {
  using Sh = Shape<HD>;
  constexpr int kChunks = Sh::kChunks;
  constexpr int kKSteps = HD / 16;   // k-steps of S = Q Kᵀ; dim pairs of O
  extern __shared__ uint4 smem[];
  const unsigned smem0 = smem_addr(smem);
  const unsigned q_s = smem0 + kStages * Sh::kStageBytes;

  const int KV = p.KV, G = p.G, S = p.S;
  const long long ks_b = p.ks_b, ks_s = p.ks_s, ks_h = p.ks_h;
  const long long vs_b = p.vs_b, vs_s = p.vs_s, vs_h = p.vs_h;
  const int split_rows = p.split_rows, window = p.window;
  const int has_window = p.has_window, has_cap = p.has_cap;
  const float scale = p.scale, cap = p.cap;

  const int split = blockIdx.x;
  const int splits = gridDim.x;
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
  // a block may write into another's shared memory only once that block
  // runs: every block arrives here and waits before its first push
  if (splits > 1) cluster_arrive_relaxed();

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
  float acc[2 * kKSteps][4];           // O's n-tiles of 8 dims
#pragma unroll
  for (int n = 0; n < 2 * kKSteps; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

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
    // nearest).
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
        const float pr = live[j][e] ? __expf(sc[j][e] - mx[e >> 1]) : 0.f;
        l_r[e >> 1] += pr;
        sc[j][e] = pr;
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
    // V, the parts of P from the smallest into zeroed fragments, then one
    // f32 FMA (round to nearest) into O
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
          acc[2 * nn + j][e] = fmaf(acc[2 * nn + j][e], corr[e >> 1], pv[j][e]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the merges

  // the warps' (O, m, l) in shared memory: O [warp][row][hd], then m and l
  // [warp][row]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(kFull, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(kFull, l_r[r], 2);
  }
  float* red_o = reinterpret_cast<float*>(smem);
  float* red_m = red_o + kWarps * kQRows * Sh::kRed;
  float* red_l = red_m + kWarps * kQRows;
#pragma unroll
  for (int n = 0; n < 2 * kKSteps; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(
          red_o + (warp * kQRows + gid + 8 * r) * Sh::kRed + 8 * n + 2 * tq) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      red_m[warp * kQRows + gid + 8 * r] = m_r[r];
      red_l[warp * kQRows + gid + 8 * r] = l_r[r];
    }
  }
  __syncthreads();

  // merge the warps in warp order into this split's normalised (o_j,
  // lse_j): each row's max, warp weights and clamped sum once (threads
  // tid < G), then four consecutive dims a thread; into (o, lse) when it
  // is the only split, else pushed to the blocks that merge them
  float* scw = red_l + kWarps * kQRows;    // [warp][row] weights
  float* lc_row = scw + kWarps * kQRows;   // [row] clamped sum
  float* lse_j = lc_row + kQRows;          // [row] this split's lse
  if (tid < G) {
    const int g = tid;
    float M = red_m[g];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, red_m[w * kQRows + g]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float sw = __expf(red_m[w * kQRows + g] - M);
      scw[w * kQRows + g] = sw;
      L += red_l[w * kQRows + g] * sw;
    }
    const float Lc = fmaxf(L, 1e-30f);
    lc_row[g] = Lc;
    lse_j[g] = M + logf(Lc);
  }
  __syncthreads();
  const long long head = (long long)b * KV + h;
  const int quads = G * HD / 4;
  // block r merges quads [r·share, (r+1)·share) of every split
  const int share = (quads + splits - 1) / splits;
  float* recv_o = reinterpret_cast<float*>(smem) +
                  (kStages * Sh::kStageBytes + Sh::kQBytes) / 4;
  float* recv_lse = recv_o + kQRows * HD + 4 * kMaxCluster;  // [split][row]
  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) {
    cluster_wait();   // every block of the cluster runs
    for (int i = tid; i < splits * G; i += kThreads) {
      const int r = i / G, g = i % G;
      *cluster.map_shared_rank(recv_lse + split * kQRows + g, r) = lse_j[g];
    }
  }
  for (int qd = tid; qd < quads; qd += kThreads) {
    const int idx = 4 * qd;
    const int g = idx / HD;
    float A[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(
          red_o + (w * kQRows + g) * Sh::kRed + idx - g * HD);
      const float sw = scw[w * kQRows + g];
      A[0] += x.x * sw;
      A[1] += x.y * sw;
      A[2] += x.z * sw;
      A[3] += x.w * sw;
    }
    const float Lc = lc_row[g];
    const float4 oj = make_float4(A[0] / Lc, A[1] / Lc, A[2] / Lc, A[3] / Lc);
    if (splits == 1) {
      *reinterpret_cast<float4*>(o + head * G * HD + idx) = oj;
      if (idx % HD == 0) lse[head * G + g] = lse_j[g];
    } else {
      const int r = qd / share;
      float4* to = reinterpret_cast<float4*>(recv_o) + split * share +
                   (qd - r * share);
      *cluster.map_shared_rank(to, r) = oj;
    }
  }
  if (splits == 1) return;   // not a cluster: no barrier to reach

  // the head's splits merged in split order, from this block's own shared
  // memory: each row's max, split weights and clamped sum (as
  // decode_mma_merge forms them on every thread of the row), then this
  // block's quads, every split's four dims before their FMA chain
  cluster_sync();   // every push has landed; no remote access after this
  float* w_all = lse_j + kQRows;                 // [split][row]
  float* m_row = w_all + kMaxCluster * kQRows;   // [row]
  float* dc_row = m_row + kQRows;                // [row]
  if (tid < G) {
    float M = -INFINITY;
    for (int j = 0; j < splits; ++j) M = fmaxf(M, recv_lse[j * kQRows + tid]);
    float den = 0.f;
    for (int j = 0; j < splits; ++j) {
      const float w = __expf(recv_lse[j * kQRows + tid] - M);
      w_all[j * kQRows + tid] = w;
      den += w;
    }
    m_row[tid] = M;
    dc_row[tid] = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  const int q0 = split * share;
  const int q1 = min(quads, q0 + share);
  for (int qd = q0 + tid; qd < q1; qd += kThreads) {
    const int idx = 4 * qd;
    const int g = idx / HD;
    const float4* from = reinterpret_cast<const float4*>(recv_o) + (qd - q0);
    float4 y[kMaxCluster];
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      if (j < splits) y[j] = from[j * share];
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      if (j < splits) {
        const float w = w_all[j * kQRows + g];
        A.x = fmaf(y[j].x, w, A.x);
        A.y = fmaf(y[j].y, w, A.y);
        A.z = fmaf(y[j].z, w, A.z);
        A.w = fmaf(y[j].w, w, A.w);
      }
    const float dc = dc_row[g];
    *reinterpret_cast<float4*>(o + head * G * HD + idx) =
        make_float4(A.x / dc, A.y / dc, A.z / dc, A.w / dc);
    if (idx % HD == 0) lse[head * G + g] = m_row[g] + logf(dc);
  }
}

using Kernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                        const __nv_bfloat16*, const int*, float*, float*,
                        const ClusterPlan);

Kernel kernel_of(int hd) {
  return hd == 64 ? decode_cluster<64> : decode_cluster<128>;
}

int smem_bytes_of(int hd) {
  return hd == 64 ? Shape<64>::kSmemBytes : Shape<128>::kSmemBytes;
}

// Once per instance and device: above 48 KB of dynamic shared memory a
// kernel must opt in (what = 0), and clusters past the portable 8 blocks
// too (what = 1).  Returns the attribute call's error, if any.
cudaError_t opt_in(int hd, int what) {
  static std::atomic<unsigned long long> done_bits[2][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  std::atomic<unsigned long long>& done = done_bits[hd == 64 ? 0 : 1][what];
  if (done.load() & bit) return cudaSuccess;
  err = what == 0
            ? cudaFuncSetAttribute(kernel_of(hd),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes_of(hd))
            : cudaFuncSetAttribute(kernel_of(hd),
                                   cudaFuncAttributeNonPortableClusterSizeAllowed,
                                   1);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// The launch of `splits`-block clusters over (splits, KV, B), attr[2] its
// attributes: the cluster shape, and the load-balancing scheduling policy,
// under which the card places clusters on all 132 SMs (the default policy
// used 124 at most in every trace) and co-schedules more of them.
cudaLaunchConfig_t config_of(int hd, int splits, int KV, int B,
                             cudaLaunchAttribute (&attr)[2], cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KV, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes_of(hd);
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr[1].val.clusterSchedulingPolicyPreference =
      cudaClusterSchedulingPolicyLoadBalancing;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 2 : 0;
  return cfg;
}

}  // namespace

// At head dim hd (64 or 128): the kernel's blocks resident per SM, and how
// many clusters of `cluster` blocks (1..16) the card co-schedules under the
// launch's scheduling policy (cudaOccupancyMaxActiveClusters).  Past 8
// blocks the non-portable size is asked for first; where it is refused,
// max_clusters is 0 and the call succeeds (the wrapper then caps the
// splits at 8).  Returns a CUDA error code.
extern "C" int flash_decode_cluster_launch_config(int hd, int cluster,
                                                  int* blocks_per_sm,
                                                  int* max_clusters) {
  if ((hd != 64 && hd != 128) || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in(hd, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel_of(hd), kThreads, smem_bytes_of(hd));
  if (err != cudaSuccess) return static_cast<int>(err);
  *max_clusters = 0;
  if (cluster > kPortableCluster && opt_in(hd, 1) != cudaSuccess) {
    cudaGetLastError();   // refused: not a sticky error
    return static_cast<int>(cudaSuccess);
  }
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = config_of(hd, cluster, 1, 1, attr, nullptr);
  cfg.numAttrs = 2;
  err = cudaOccupancyMaxActiveClusters(max_clusters, kernel_of(hd), &cfg);
  if (err != cudaSuccess && cluster > kPortableCluster) {
    cudaGetLastError();
    *max_clusters = 0;
    return static_cast<int>(cudaSuccess);
  }
  return static_cast<int>(err);
}

// plan: the call's ClusterPlan (hd in {64, 128}, 1 <= G <= 16, 1 <= splits
// <= 16, split_rows a multiple of 64, splits·split_rows covering min(S,
// window) (S without a window), every stride a multiple of 8).  q (B, KV, G,
// hd) bf16 contiguous; k, v (B, S, KV, hd) bf16 with the last dim
// contiguous; all three 16-byte aligned; lengths (B,) int32, any values.
// out holds o (B, KV, G, hd) f32 and, lse_offset floats further, lse (B,
// KV, G, 1) f32.  Anything else: cudaErrorInvalidValue.  One launch on
// `stream`, clusters of `splits` blocks; returns its error, or
// cudaGetLastError() after it (a cluster shape the card refuses never runs).
extern "C" int flash_decode_cluster_launch(const void* plan, const void* q,
                                           const void* k, const void* v,
                                           const void* lengths, void* out,
                                           void* stream) {
  const ClusterPlan& p = *static_cast<const ClusterPlan*>(plan);
  const long long live = p.has_window && p.window < p.S ? p.window : p.S;
  const long long strides[] = {p.ks_b, p.ks_s, p.ks_h, p.vs_b, p.vs_s, p.vs_h};
  bool aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (long long s : strides) aligned = aligned && s % 8 == 0;
  if ((p.hd != 64 && p.hd != 128) || p.B < 1 || p.S < 1 || p.KV < 1 ||
      p.G < 1 || p.G > kMaxG || p.splits < 1 || p.splits > kMaxCluster ||
      p.split_rows < 1 || p.split_rows % kTileRows != 0 || p.B > 65535 ||
      p.KV > 65535 || (p.has_window && p.window < 1) ||
      (p.has_cap && !(p.cap > 0.f)) ||
      (long long)p.splits * p.split_rows < live ||
      p.lse_offset != (long long)p.B * p.KV * p.G * p.hd || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in(p.hd, 0);
  if (err == cudaSuccess && p.splits > kPortableCluster) err = opt_in(p.hd, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = config_of(p.hd, p.splits, p.KV, p.B, attr,
                                           static_cast<cudaStream_t>(stream));
  float* o = static_cast<float*>(out);
  err = cudaLaunchKernelEx(&cfg, kernel_of(p.hd),
                           static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(k),
                           static_cast<const __nv_bfloat16*>(v),
                           static_cast<const int*>(lengths), o,
                           o + p.lse_offset, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
