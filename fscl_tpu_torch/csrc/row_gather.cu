// Row gathers for Hopper: a plain row gather, and the hist statistic's
// gather -> difference -> lerp chain as one kernel.
//
// fscl_row_gather replaces the TPU kernel bench/micro_pallas_gather.py:40
// pallas_gather (body :32-34), a row gather from a table held in VMEM:
//
//   out[i, :] = table[idx[i], :]
//
// for rows of any element type and width, indices in any order.  On the
// port's path it carries the two large gathers of the RDP tail
// (ops/histclr.py:rdp_clr_reps).
//
// fscl_window_operand replaces the chain that fscl_tpu/ops/histclr.py:
// 1116-1126 leaves to XLA in hist_clr_reps_ps (one_chunk without its
// dot_general; no Pallas kernel): gather the prefix rows ps[bounds], take
// the signed adjacent difference in the prefix dtype, cast to float32,
// split it by the fbar lerp, and lay it out as the contraction operand.
// For candidate c, side s (sign -1, +1), cell j < NC, replicate p, row r
// (L = P*R lanes, l = p*R + r):
//
//   h[s, j]  = float((ps[b[c,s,j+1], l] - ps[b[c,s,j], l]) * sign[s])
//   w0[j]    = h[0,j] * (1 - f[c,0,j]) + h[1,j] * (1 - f[c,1,j])
//   w1[j]    = h[0,j] * f[c,0,j]       + h[1,j] * f[c,1,j]
//   k[c*P + p, (s'*NC + j)*R + r] = w_s'[j]          (s' = 0 -> w0, 1 -> w1)
//
// rounded to bfloat16 and back when mm_bf16.  Bitwise equal to the plain
// PyTorch chain: the arithmetic is window_lerp.cuh's (wrapping int16
// differences, separately rounded float operations), which the fused
// window-contraction kernel (window_clr.cu) shares.
//
// What bounds both on the H100: bytes.  Neither does more than a few
// float operations per byte it moves.  The gather moves each gathered
// row once in and once out.  The window operand reads the 2*(NC+1)
// bound rows of each candidate (L elements each) and writes the
// 2*NC*L-float operand once.  The plain chain writes and rereads the
// gathered [c, 2, NC+1, L] rows, the difference, its float copy, the two
// lerp products, w0, w1 and their concatenation: about 3-4x the bytes of
// the operand.  Here none of those intermediates reaches HBM.
//
// Design: one shared row-load helper (table_row: 64-bit row offsets, an
// index outside the table traps, never clamped).  Threads take flat
// (row, unit) or (candidate, lane) slots, consecutive threads on
// consecutive addresses, so rows of any width (a thin P=1 scan row of 56
// lanes, a 224-byte RDP row) fill whole warps: no block is tied to one
// row or one candidate.  The gather copies 16-byte vectors when the row
// bytes and both base pointers allow it, else whole elements.  A window
// thread walks its candidate's cells in order and keeps the previous
// bound row's value in a register, so each bound row is read once per
// side, as the gather reads it.  No wgmma, no TMA: the simple version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_lerp.cuh"

namespace {

using fscl::bf16_round;
using fscl::side_diff;
using fscl::table_row;
using fscl::window_lerp;

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;  // grid-stride past this

int blocks_for(int64_t total) {
  const int64_t b = (total + kThreads - 1) / kThreads;
  return (int)(b < kMaxBlocks ? b : kMaxBlocks);
}

// out[i, v] = table[idx[i], v], in copy units U (uint4, or one element);
// n_idx * row_units < 2^31 (the wrapper checks)
template <typename U>
__global__ void gather_rows(const U* __restrict__ table,
                            const int32_t* __restrict__ idx,
                            U* __restrict__ out, int64_t n_idx,
                            int64_t n_rows, uint32_t row_units) {
  const int64_t total = n_idx * row_units;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       t < total; t += (int64_t)gridDim.x * blockDim.x) {
    const uint32_t i = (uint32_t)t / row_units;
    const uint32_t v = (uint32_t)t - i * row_units;
    out[t] = table_row(table, __ldg(idx + i), n_rows, row_units)[v];
  }
}

template <typename U>
int launch_gather(const void* table, const void* idx, void* out,
                  int64_t n_idx, int64_t n_rows, int row_bytes,
                  cudaStream_t st) {
  const uint32_t units = (uint32_t)(row_bytes / sizeof(U));
  gather_rows<U><<<blocks_for(n_idx * units), kThreads, 0, st>>>(
      (const U*)table, (const int32_t*)idx, (U*)out, n_idx, n_rows, units);
  return (int)cudaGetLastError();
}

// One thread per (candidate, lane); C * L < 2^31 (the wrapper checks).
template <typename T>
__global__ void window_operand_kernel(const T* __restrict__ ps,
                                      const int32_t* __restrict__ bounds,
                                      const float* __restrict__ fbar,
                                      float* __restrict__ out, int C, int NC,
                                      int P, int R, int64_t n_rows,
                                      bool mm_bf16) {
  const uint32_t L = (uint32_t)P * R;
  const int64_t total = (int64_t)C * L;
  const int64_t out_row = 2LL * NC * R;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       t < total; t += (int64_t)gridDim.x * blockDim.x) {
    const uint32_t c = (uint32_t)t / L;
    const uint32_t l = (uint32_t)t - c * L;
    const uint32_t p = l / R;
    const uint32_t r = l - p * R;
    const int32_t* b0 = bounds + (int64_t)c * 2 * (NC + 1);
    const int32_t* b1 = b0 + NC + 1;
    const float* f0 = fbar + (int64_t)c * 2 * NC;
    const float* f1 = f0 + NC;
    float* o = out + ((int64_t)c * P + p) * out_row + r;
    T prev0 = table_row(ps, __ldg(b0), n_rows, L)[l];
    T prev1 = table_row(ps, __ldg(b1), n_rows, L)[l];
#pragma unroll 4
    for (int j = 0; j < NC; ++j) {
      const T cur0 = table_row(ps, __ldg(b0 + j + 1), n_rows, L)[l];
      const T cur1 = table_row(ps, __ldg(b1 + j + 1), n_rows, L)[l];
      const float h0 = side_diff(cur0, prev0, true);
      const float h1 = side_diff(cur1, prev1, false);
      const float g0 = __ldg(f0 + j);
      const float g1 = __ldg(f1 + j);
      float w0, w1;
      window_lerp(h0, h1, g0, g1, w0, w1);
      if (mm_bf16) {
        w0 = bf16_round(w0);
        w1 = bf16_round(w1);
      }
      o[(int64_t)j * R] = w0;
      o[(int64_t)(NC + j) * R] = w1;
      prev0 = cur0;
      prev1 = cur1;
    }
  }
}

template <typename T>
int launch_window(const void* ps, const void* bounds, const void* fbar,
                  void* out, int C, int NC, int P, int R, int64_t n_rows,
                  bool mm_bf16, cudaStream_t st) {
  window_operand_kernel<T>
      <<<blocks_for((int64_t)C * P * R), kThreads, 0, st>>>(
          (const T*)ps, (const int32_t*)bounds, (const float*)fbar,
          (float*)out, C, NC, P, R, n_rows, mm_bf16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table [n_rows, row_bytes / elem_bytes] of 2- or 4-byte elements; idx
// [n_idx] int32; out [n_idx, same width].  n_idx * (row units) < 2^31.
// Returns the launch's CUDA error (0 = success); nothing to gather is
// success without a launch.
int fscl_row_gather(const void* table, const void* idx, void* out,
                    int64_t n_idx, int64_t n_rows, int row_bytes,
                    int elem_bytes, void* stream) {
  if (n_idx == 0 || row_bytes == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = row_bytes % 16 == 0 && (uintptr_t)table % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  if (vec) return launch_gather<uint4>(table, idx, out, n_idx, n_rows,
                                       row_bytes, st);
  if (elem_bytes == 4) return launch_gather<uint32_t>(table, idx, out, n_idx,
                                                      n_rows, row_bytes, st);
  if (elem_bytes == 2) return launch_gather<uint16_t>(table, idx, out, n_idx,
                                                      n_rows, row_bytes, st);
  return (int)cudaErrorInvalidValue;
}

// ps [n_rows, P*R] of dtype_code 0 = int16, 1 = int32, 2 = float32;
// bounds [C, 2, NC+1] int32 rows of ps; fbar [C, 2, NC] f32; out
// [C*P, 2*NC*R] f32.  C * P * R < 2^31.  Returns the launch's CUDA error.
int fscl_window_operand(const void* ps, const void* bounds, const void* fbar,
                        void* out, int C, int NC, int P, int R,
                        int64_t n_rows, int dtype_code, int mm_bf16,
                        void* stream) {
  if ((int64_t)C * P * R == 0 || NC == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype_code) {
    case 0:
      return launch_window<int16_t>(ps, bounds, fbar, out, C, NC, P, R,
                                    n_rows, mm_bf16 != 0, st);
    case 1:
      return launch_window<int32_t>(ps, bounds, fbar, out, C, NC, P, R,
                                    n_rows, mm_bf16 != 0, st);
    case 2:
      return launch_window<float>(ps, bounds, fbar, out, C, NC, P, R,
                                  n_rows, mm_bf16 != 0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
