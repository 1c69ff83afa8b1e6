// The hist statistic's window arithmetic, shared by the window-operand
// kernel (row_gather.cu) and the fused window-contraction kernel
// (window_clr.cu), so both compute the same operand values bit for bit.
//
// For one lane of one candidate and cell, with prefix rows at the run
// bounds of side 0 (walking left, sign -1) and side 1 (right, sign +1):
//
//   h_s = float((cur_s - prev_s) * sign_s)   in the prefix dtype
//   w0  = h0 * (1 - f0) + h1 * (1 - f1)
//   w1  = h0 * f0       + h1 * f1
//
// The int16 difference and sign product wrap mod 2^16 as torch's int16
// arithmetic does (the JAX package's mod-2^16 prefixes rely on it), and
// every float operation is a separately rounded __fsub_rn / __fmul_rn /
// __fadd_rn, so nvcc cannot contract the lerp into an FMA.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace fscl {

// Row `row` of a [n_rows, row_elems] table.  An index outside
// [0, n_rows) is a fault, as torch's own indexing asserts on the card:
// the kernel traps and the launch fails.
template <typename T>
__device__ __forceinline__ const T* table_row(const T* table, int32_t row,
                                              int64_t n_rows,
                                              int64_t row_elems) {
  if (row < 0 || (int64_t)row >= n_rows) __trap();
  return table + (int64_t)row * row_elems;
}

// Signed adjacent difference h = (cur - prev) * sign in the prefix
// dtype, as float; neg selects sign -1 (the left side).
__device__ __forceinline__ float side_diff(int16_t cur, int16_t prev,
                                           bool neg) {
  const int16_t d = (int16_t)(cur - prev);  // wraps mod 2^16
  return (float)(neg ? (int16_t)(-d) : d);  // -(-32768) wraps to -32768
}

__device__ __forceinline__ float side_diff(int32_t cur, int32_t prev,
                                           bool neg) {
  const uint32_t d = (uint32_t)cur - (uint32_t)prev;  // wraps mod 2^32
  return (float)(int32_t)(neg ? 0u - d : d);
}

__device__ __forceinline__ float side_diff(float cur, float prev, bool neg) {
  const float d = __fsub_rn(cur, prev);
  return neg ? -d : d;  // d * -1.0f, exactly
}

// The fbar lerp of one lane's two side differences (h0 left, h1 right).
__device__ __forceinline__ void window_lerp(float h0, float h1, float f0,
                                            float f1, float& w0,
                                            float& w1) {
  w0 = __fadd_rn(__fmul_rn(h0, __fsub_rn(1.0f, f0)),
                 __fmul_rn(h1, __fsub_rn(1.0f, f1)));
  w1 = __fadd_rn(__fmul_rn(h0, f0), __fmul_rn(h1, f1));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace fscl
