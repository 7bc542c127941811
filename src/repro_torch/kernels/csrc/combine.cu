// combine: out = w + Σ_k α_k U[k, :], f32 accumulation, out in w's dtype.
//
// Replaces the Pallas TPU kernel repro/kernels/combine.py::combine_pallas
// (_combine_kernel), which forms the α-weighted sum of a (K, block_n) tile on
// the MXU and adds w.  Here it is one grid-stride elementwise pass with a
// K-reduction per column: α (K floats) sits in shared memory; each thread owns
// kCols columns of a (blockDim · kCols)-column chunk, spaced blockDim apart so
// that every scalar load of a warp reads 32 consecutive elements; it sums
// α_k · U[k, j] in f32 in k order, adds w[j] and stores in w's dtype.
//
// What bounds it on the H100: bytes only — read U (K·n) and w (n), write out
// (n) — against 3.35 TB/s; the 2·K·n flops are far below the f32 rate.  The
// design keeps every load coalesced and several rows in flight per thread.
// U's rows start at byte 4·k·n, not 16-byte aligned for odd n, so the loads
// are scalar.  out may be w itself (an update in place): each w[j] is read
// once, by the thread that then writes out[j], so w and out carry no
// __restrict__.

#include "common.cuh"

namespace {

using repro_torch::from_f32;
using repro_torch::to_f32;

constexpr int kThreads = 256;
constexpr int kCols = 4;  // columns per thread per chunk
constexpr int kMaxK = 4096;

template <typename TU, typename TW>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const TW* w, const TU* __restrict__ U,
               const float* __restrict__ alpha, TW* out, int K, int64_t n) {
  extern __shared__ float alpha_s[];
  for (int k = threadIdx.x; k < K; k += blockDim.x) alpha_s[k] = alpha[k];
  __syncthreads();

  const int64_t chunk = (int64_t)kThreads * kCols;
  for (int64_t base = (int64_t)blockIdx.x * chunk; base < n;
       base += (int64_t)gridDim.x * chunk) {
    float acc[kCols];
#pragma unroll
    for (int v = 0; v < kCols; ++v) acc[v] = 0.f;
    if (base + chunk <= n) {
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const TU* row = U + (int64_t)k * n + base + threadIdx.x;
        const float a = alpha_s[k];
#pragma unroll
        for (int v = 0; v < kCols; ++v) acc[v] = fmaf(a, to_f32(row[v * kThreads]), acc[v]);
      }
#pragma unroll
      for (int v = 0; v < kCols; ++v) {
        const int64_t j = base + threadIdx.x + v * kThreads;
        out[j] = from_f32<TW>(to_f32(w[j]) + acc[v]);
      }
    } else {  // the ragged last chunk
      for (int k = 0; k < K; ++k) {
        const float a = alpha_s[k];
#pragma unroll
        for (int v = 0; v < kCols; ++v) {
          const int64_t j = base + threadIdx.x + v * kThreads;
          if (j < n) acc[v] = fmaf(a, to_f32(U[(int64_t)k * n + j]), acc[v]);
        }
      }
#pragma unroll
      for (int v = 0; v < kCols; ++v) {
        const int64_t j = base + threadIdx.x + v * kThreads;
        if (j < n) out[j] = from_f32<TW>(to_f32(w[j]) + acc[v]);
      }
    }
  }
}

template <typename TU, typename TW>
cudaError_t launch(const void* w, const void* U, const float* alpha, void* out,
                   int K, int64_t n, int max_blocks, cudaStream_t stream) {
  const int64_t chunk = (int64_t)kThreads * kCols;
  int64_t blocks = (n + chunk - 1) / chunk;
  if (blocks > max_blocks) blocks = max_blocks;
  combine_kernel<TU, TW><<<(int)blocks, kThreads, K * sizeof(float), stream>>>(
      static_cast<const TW*>(w), static_cast<const TU*>(U), alpha,
      static_cast<TW*>(out), K, n);
  return cudaGetLastError();
}

}  // namespace

// w (n,), U (K, n) row-major, each f32 or bf16; alpha (K,) f32; out (n,) in
// w's dtype, possibly w itself.  The grid is capped at max_blocks (grid-stride beyond it).
// Returns cudaGetLastError() after the launch on `stream`.
extern "C" int combine_launch(const void* w, const void* U, const void* alpha,
                              void* out, int K, long long n, int u_bf16,
                              int w_bf16, int max_blocks, void* stream) {
  if (K < 1 || K > kMaxK || n < 1 || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(alpha);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (u_bf16 && w_bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(w, U, a, out, K, n, max_blocks, st);
  else if (u_bf16)
    err = launch<__nv_bfloat16, float>(w, U, a, out, K, n, max_blocks, st);
  else if (w_bf16)
    err = launch<float, __nv_bfloat16>(w, U, a, out, K, n, max_blocks, st);
  else
    err = launch<float, float>(w, U, a, out, K, n, max_blocks, st);
  return static_cast<int>(err);
}
