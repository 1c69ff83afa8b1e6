// The row id of a site of a permuted segment, shared by the segmented
// prefix-sum kernels (prefix_sums.cu, weighted_prefix_sums.cu): the i16
// row-id group table gathered at a group-level sigma,
//
//   id(s, p, k) = table[sig[p, j8] * pg + k % pg]
//   j8 = seg_g0[s] + k / pg - 1,  a negative j8 reads column n_sig - 1
//
// (the sentinel column).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fscl {

// id(pe, kk): site k0 + kk of the segment whose slab starts at group
// j8_base + 1, replicate pe counted from sig's first row
struct SegmentIds {
  const int16_t* table;
  const int32_t* sig;
  int n_sig, pg, j8_base, k0;
  __device__ __forceinline__ int operator()(int pe, int kk) const {
    const int k = k0 + kk;
    int j8 = j8_base + k / pg;
    if (j8 < 0) j8 = n_sig - 1;
    const int sel = __ldg(sig + (size_t)pe * n_sig + j8);
    return __ldg(table + (size_t)sel * pg + k % pg);
  }
};

}  // namespace fscl
