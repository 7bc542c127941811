// The counter-based sign hash shared by sign_sketch and its adjoint.
//
// R[i, j] = 1 - 2 * msb(mix32(j ^ mix32(i ^ seed))), with mix32 the murmur3
// finalizer in uint32 arithmetic (multiplies wrap mod 2^32), exactly as
// repro/kernels/rng_sketch.py::_mix32 / sign_tile compute it.  One source of
// the hash for both kernels, so encode and decode see the same matrix.
#pragma once

#include <stdint.h>

namespace repro_torch {

// murmur3 finalizer: 8 integer operations (3 shifts, 3 xors, 2 multiplies)
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The row's share of the hash, mix32(i ^ seed): once per row, not per entry.
__device__ __forceinline__ uint32_t row_hash(uint32_t row, uint32_t seed) {
  return mix32(row ^ seed);
}

// x * R[i, j] for the row hash of i: R is ±1, so the product flips x's sign
// bit when the hash's top bit is set (exact; no multiply).  Only the top bit
// of the hash is used, which mix32's last xor-shift leaves unchanged, so the
// compiler can drop that step.
__device__ __forceinline__ float apply_sign(float x, uint32_t row_h, uint32_t col) {
  const uint32_t h = mix32(col ^ row_h);
  return __uint_as_float(__float_as_uint(x) ^ (h & 0x80000000u));
}

}  // namespace repro_torch
