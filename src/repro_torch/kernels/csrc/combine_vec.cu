// combine, second body: out = w + Σ_k α_k U[k, :], f32 accumulation, out in
// w's dtype, for calls whose rows all start 16-byte aligned.
//
// Replaces the same Pallas TPU kernel as combine.cu,
// repro/kernels/combine.py::combine_pallas (_combine_kernel).  combine.cu
// keeps every call this body does not take (rows that are not 16-byte
// aligned: odd n, 31 400-byte f32 rows, views a few bytes in).
//
// What bounds it on the H100: bytes only — read U (K·n) and w (n), write out
// (n) — against 3.35 TB/s; the 2·K·n flops are ~1 per byte, far below the
// ~20 flops a byte where the f32 CUDA cores would limit.  So no tensor cores
// and no shared-memory staging: the aim is full 16-byte loads, enough of
// them in flight, and enough blocks to fill 132 SMs.
//
// Layout.  A lane owns one 16-byte vector of U per row: VEC = 8 bf16 or 4
// f32 columns, so a warp reads 512 contiguous bytes of a row per load.  A
// block of 8 warps is WC column groups x WK row slices (WC·WK = 8): warp
// (cg, ks) sums rows [ks·K/WK, (ks+1)·K/WK) of the columns of group cg, in
// ascending k, loading four rows before their FMAs (64 bytes in flight a
// lane).  WK = 1 where whole columns fill the card; there each column is one
// fmaf a row from 0 in k order, then w is added — combine.cu's arithmetic,
// so the two bodies are bitwise equal.  WK > 1 where n is too small for
// that (K = 100, n = 7 840: 62 blocks instead of 8): the WK - 1 upper
// slices' partials go through shared memory and the ks = 0 warp adds them in
// slice order, then w — no atomics, so a call is bitwise repeatable.  The
// wrapper chooses WK from the shapes (kernels/combine.py
// combine_vec_split).
//
// w and out may alias (an update in place) and carry no __restrict__: each
// w vector is read once, by the lane that then writes the same out vector.
// U and α are read-only (ld.global.nc; α staged in shared memory).  The
// grid is at most one resident wave (the occupancy query); blocks stride
// over the chunks, so their chunk counts differ by at most one.  n is a
// whole number of vectors, so only whole vectors past n are masked.

#include "common.cuh"

namespace {

using repro_torch::from_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 4096;
constexpr int kRowsInFlight = 4;
// Blocks an SM at least: <= 64 registers a thread for bf16 U (8
// accumulators), <= 40 for f32 U (4), where 6 blocks read faster than 4
// and 8 spill.
constexpr int kMinBlocksBf16 = 4, kMinBlocksF32 = 6;

// 16 bytes of U: read-only, no line kept in L1 (each byte is read once).
__device__ __forceinline__ uint4 load_stream16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// A 32-bit word of two bf16 as floats (bf16 -> f32 is exact: a shift).
__device__ __forceinline__ float bf16_lo(unsigned x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf16_hi(unsigned x) { return __uint_as_float(x & 0xffff0000u); }

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(from_f32<__nv_bfloat16>(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(from_f32<__nv_bfloat16>(hi))) << 16);
}

// acc[c] = fmaf(a, U[k, j + c], acc[c]) for the VEC columns of one vector.
template <typename TU>
__device__ __forceinline__ void fma_vec(float (&acc)[16 / sizeof(TU)], float a,
                                        const uint4& v) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(TU) == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = fmaf(a, bf16_lo(u[i]), acc[2 * i]);
      acc[2 * i + 1] = fmaf(a, bf16_hi(u[i]), acc[2 * i + 1]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = fmaf(a, __uint_as_float(u[i]), acc[i]);
  }
}

// VEC entries of w (16, 32 or 8 bytes, aligned to their size) as floats.
template <typename TW, int VEC>
__device__ __forceinline__ void load_w(const TW* p, float (&f)[VEC]) {
  if constexpr (sizeof(TW) == 4) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      f[i] = v.x; f[i + 1] = v.y; f[i + 2] = v.z; f[i + 3] = v.w;
    }
  } else if constexpr (VEC == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) { f[2 * i] = bf16_lo(u[i]); f[2 * i + 1] = bf16_hi(u[i]); }
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    f[0] = bf16_lo(v.x); f[1] = bf16_hi(v.x); f[2] = bf16_lo(v.y); f[3] = bf16_hi(v.y);
  }
}

// VEC floats into out in its dtype (bf16 rounded to nearest even).
template <typename TW, int VEC>
__device__ __forceinline__ void store_out(TW* p, const float (&f)[VEC]) {
  if constexpr (sizeof(TW) == 4) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  } else if constexpr (VEC == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                                              pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
  }
}

template <typename TU, typename TW, int WK>
__global__ void __launch_bounds__(kThreads,
                                  sizeof(TU) == 4 ? kMinBlocksF32 : kMinBlocksBf16)
combine_vec_kernel(const TW* w, const TU* __restrict__ U,
                   const float* __restrict__ alpha, TW* out, int K, int64_t n) {
  constexpr int VEC = 16 / sizeof(TU);
  constexpr int WC = kWarps / WK;
  constexpr int64_t kChunk = (int64_t)WC * 32 * VEC;  // columns of a block's chunk
  extern __shared__ float alpha_s[];
  // the partials of row slices 1..WK-1, [slice][group][column][lane]
  __shared__ float part[WK > 1 ? (WK - 1) * WC * VEC * 32 : 1];
  for (int k = threadIdx.x; k < K; k += kThreads) alpha_s[k] = __ldg(alpha + k);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cg = warp % WC, ks = warp / WC;
  const int k0 = static_cast<int>((int64_t)ks * K / WK);
  const int k1 = static_cast<int>((int64_t)(ks + 1) * K / WK);
  for (int64_t base = (int64_t)blockIdx.x * kChunk; base < n;
       base += (int64_t)gridDim.x * kChunk) {
    const int64_t j = base + ((int64_t)cg * 32 + lane) * VEC;
    const bool live = j < n;
    float acc[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[c] = 0.f;
    if (live) {
      const TU* col = U + j;
      int k = k0;
      for (; k + kRowsInFlight <= k1; k += kRowsInFlight) {
        uint4 v[kRowsInFlight];
#pragma unroll
        for (int r = 0; r < kRowsInFlight; ++r)
          v[r] = load_stream16(col + (int64_t)(k + r) * n);
#pragma unroll
        for (int r = 0; r < kRowsInFlight; ++r) fma_vec<TU>(acc, alpha_s[k + r], v[r]);
      }
      for (; k < k1; ++k) fma_vec<TU>(acc, alpha_s[k], load_stream16(col + (int64_t)k * n));
    }
    if constexpr (WK > 1) {
      if (ks > 0) {
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          part[(((ks - 1) * WC + cg) * VEC + c) * 32 + lane] = acc[c];
      }
      __syncthreads();
      if (ks == 0) {
#pragma unroll
        for (int s = 1; s < WK; ++s)
#pragma unroll
          for (int c = 0; c < VEC; ++c)
            acc[c] += part[(((s - 1) * WC + cg) * VEC + c) * 32 + lane];
      }
    }
    if (ks == 0 && live) {
      float x[VEC];
      load_w<TW, VEC>(w + j, x);
#pragma unroll
      for (int c = 0; c < VEC; ++c) x[c] = x[c] + acc[c];
      store_out<TW, VEC>(out + j, x);
    }
    if constexpr (WK > 1) __syncthreads();  // part is rewritten by the next chunk
  }
}

template <typename TU, typename TW>
const void* kernel_for_wk(int wk) {
  switch (wk) {
    case 1: return reinterpret_cast<const void*>(combine_vec_kernel<TU, TW, 1>);
    case 2: return reinterpret_cast<const void*>(combine_vec_kernel<TU, TW, 2>);
    case 4: return reinterpret_cast<const void*>(combine_vec_kernel<TU, TW, 4>);
    case 8: return reinterpret_cast<const void*>(combine_vec_kernel<TU, TW, 8>);
    default: return nullptr;
  }
}

// The instance for (U dtype, w dtype, WK), or nullptr for a WK it lacks.
const void* kernel_for(int u_bf16, int w_bf16, int wk) {
  if (u_bf16 && w_bf16) return kernel_for_wk<__nv_bfloat16, __nv_bfloat16>(wk);
  if (u_bf16) return kernel_for_wk<__nv_bfloat16, float>(wk);
  if (w_bf16) return kernel_for_wk<float, __nv_bfloat16>(wk);
  return kernel_for_wk<float, float>(wk);
}

}  // namespace

// Blocks of the (U dtype, w dtype, WK) instance resident per SM with K
// floats of α in shared memory.
extern "C" int combine_vec_launch_config(int u_bf16, int w_bf16, int wk, int K,
                                         int* blocks_per_sm) {
  const void* fn = kernel_for(u_bf16, w_bf16, wk);
  if (fn == nullptr || K < 1 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, kThreads, K * sizeof(float)));
}

// w (n,), U (K, n) row-major, each f32 or bf16, every row of U and w and out
// 16-byte aligned (n a whole number of 16-byte vectors of U); alpha (K,)
// f32; out (n,) in w's dtype, possibly w itself.  wk in {1, 2, 4, 8} row
// slices; `blocks` blocks stride over the chunks.  Returns
// cudaGetLastError() after the launch on `stream`.
extern "C" int combine_vec_launch(const void* w, const void* U, const void* alpha,
                                  void* out, int K, long long n, int u_bf16,
                                  int w_bf16, int wk, int blocks, void* stream) {
  const void* fn = kernel_for(u_bf16, w_bf16, wk);
  const long long vec = u_bf16 ? 8 : 4;
  if (fn == nullptr || K < 1 || K > kMaxK || n < 1 || n % vec != 0 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(U) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  int64_t n64 = n;
  void* args[] = {(void*)&w, (void*)&U, (void*)&alpha, (void*)&out, (void*)&K,
                  (void*)&n64};
  cudaError_t err = cudaLaunchKernel(fn, dim3(blocks), dim3(kThreads), args,
                                     K * sizeof(float),
                                     static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
