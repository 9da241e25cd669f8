// Fixed-point requantization shared by the int8 CNN kernels.
//
// The arithmetic is the JAX reference's (src/repro/kernels/ref.py):
// round-half-up arithmetic right shift, optional ReLU, clip to int8.
// JAX adds in int32 and wraps two's complement; signed overflow is
// undefined in C++, so every add that could wrap runs in uint32_t and is
// cast back.
#pragma once

#include <cstdint>

// (v + 2^(s-1)) >> s for s > 0; the identity for s == 0.  The wrappers
// hold every shift in [0, 31].
__device__ __forceinline__ int32_t round_shift(int32_t v, int s) {
  if (s <= 0) return v;
  const uint32_t t = static_cast<uint32_t>(v) + (1u << (s - 1));
  return static_cast<int32_t>(t) >> s;
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t clip_s8(int32_t v) {
  return min(max(v, -128), 127);
}

// int32 accumulator -> int8: bias, round-half-up shift, ReLU, clip.
__device__ __forceinline__ int32_t requant(int32_t acc, int32_t bias, int s,
                                           bool relu) {
  int32_t v = round_shift(wrap_add(acc, bias), s);
  if (relu) v = max(v, 0);
  return clip_s8(v);
}
