// Copies shared by the two fused window-contraction kernels
// (window_clr.cu, bfloat16; window_clr_f32.cu, float32): cp.async of
// 16-byte pack chunks into shared memory, and 8 consecutive prefix values
// of one bound row as 16-byte vector loads; the 4-byte cp.async for
// clr_grid.cu's staged sites.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace fscl {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; bytes = 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// 4 bytes global -> shared, asynchronously (any 4-byte aligned source).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 8 consecutive prefix values (16 or 32 bytes, 16-byte aligned)
template <typename T>
__device__ __forceinline__ void load8(const T* p, T (&v)[8]) {
  constexpr int kVec = (int)sizeof(T) / 2;  // uint4 loads: 1 or 2
  uint4 u[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    u[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  memcpy(v, u, sizeof(u));
}

}  // namespace fscl
