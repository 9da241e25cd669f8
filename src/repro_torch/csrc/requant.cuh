// Fixed-point requantization shared by the int8 CNN kernels.
//
// The arithmetic is the JAX reference's (src/repro/kernels/ref.py):
// round-half-up arithmetic right shift, optional ReLU, clip to int8, with
// one addition: a fused ReLU-n (ONNX Clip(0, n), such as ReLU6) lowers the
// clip's upper end to the stage's clamp code hi = min(127, floor(n * 2^m_y))
// (DESIGN.md, "ReLU-n fixed-point rule").
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

// int32 accumulator -> int8: bias, round-half-up shift, then one clamp to
// [lo, hi]: lo is 0 under a ReLU and -128 otherwise, hi the clamp code of a
// ReLU-n and 127 otherwise.
__device__ __forceinline__ int32_t requant(int32_t acc, int32_t bias, int s,
                                           int lo, int hi) {
  return min(max(round_shift(wrap_add(acc, bias), s), lo), hi);
}

// The per-value epilogue of the conv kernels (qconv.cu, qdwconv.cu).
struct Epilogue {
  const int32_t* bias;       // (Cout,) or null
  const int32_t* shift_vec;  // (Cout,) per-lane shifts, or null: `shift`
  const int8_t* skip;        // (N, Ho, Wo, Cout) residual operand, or null
  int shift, lo, hi;  // requant's clamp: lo 0 under a ReLU, hi <= 127
  int a_conv, a_skip, merge_shift, merge_relu;
  int concat_shift, concat_relu;
};

// The int8 value of output channel c from its int32 conv sum, in the JAX
// package's _band_epilogue order (src/repro/kernels/qconv.py):
//   v = clamp(round_shift(acc + b[c], s[c]), lo, hi)              conv
//   v = clip(merge_relu(round_shift(round_shift(v, a_conv)
//            + round_shift(skip, a_skip), merge_shift)))           skip
//   v = clip(round_shift(v, concat_shift)); v = concat_relu(v)     concat
// `skip_at` indexes the same conv pixel and channel in the skip operand
// (unused without one).  A fused max-pool reduces these values after.
__device__ __forceinline__ int32_t epilogue(const Epilogue& e, int32_t acc,
                                            int c, long long skip_at) {
  int32_t v = requant(acc, e.bias ? e.bias[c] : 0,
                      e.shift_vec ? e.shift_vec[c] : e.shift, e.lo, e.hi);
  if (e.skip != nullptr) {
    v = round_shift(v, e.a_conv) + round_shift(e.skip[skip_at], e.a_skip);
    v = round_shift(v, e.merge_shift);
    if (e.merge_relu) v = max(v, 0);
    v = clip_s8(v);
  }
  if (e.concat_shift) v = clip_s8(round_shift(v, e.concat_shift));
  if (e.concat_relu) v = max(v, 0);
  return v;
}
