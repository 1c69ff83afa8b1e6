// The hist statistic's window operand and its bfloat16 contraction in one
// tensor-core kernel for Hopper (sm_90a).
//
// fscl_window_clr replaces fscl_tpu/ops/histclr.py:1116-1131, the chunk
// body of hist_clr_reps_ps with mm_bf16=True, which XLA fuses on the TPU
// (no Pallas kernel there): gather the prefix rows at the run bounds,
// difference and lerp them into the operand, round it to bfloat16, and
// contract it with the bfloat16 pack t3b, accumulating in float32.  With
// L = P*R lanes, flat row m = c*P + p and k = (s*NC + j)*R + r:
//
//   out[c, p, a] = 2 * sum_{s, j, r} bf16(w_s[c, j, p*R + r]) * t3b[k, a]
//
// where w_s are the values fscl_window_operand (row_gather.cu) writes:
// the same window_lerp.cuh arithmetic, then __float2bfloat16_rn.  A
// product of two bfloat16 values is exact in float32, so this computes
// the JAX package's numbers; only the order of the float32 sums differs.
//
// What bounds it on the H100: bytes, and most of them from L2.  The
// unfused route writes the operand [c*P, 2*NC*R] f32 to HBM and a
// float32 matmul reads it back; here it never leaves shared memory.
// What is left is the bound-row reads (2*(NC+1) rows of P*R lanes per
// candidate, mostly L2 hits: neighbouring candidates share rows), the
// pack (1-6 MB, L2-resident, reread by every block) and 2*c*P*K*A MMA
// operations, which the tensor cores finish far sooner than the reads.
//
// Design.  A block of 256 threads (8 warps) takes BM = 64 flat rows m
// (64 candidates at the scan's P = 1, 4 at P = 16, 2 at P = 32) and BN
// output columns (32, or 128 with a second grid row per further 128).
// Its K loop walks the cells j: one K tile holds both sides of one cell,
// 2 x R16 k values (R rounded up to 16; the lanes r >= R and their pack
// rows stay zero), so w0 and w1 of a lane come from the same two
// differences.  Each thread owns up to UPT units of 8 consecutive lanes
// of one row m for the whole loop, loads them as 16-byte vectors from
// the bound rows, and keeps the previous bound row per side in
// registers, so every bound row is read once per side.  The bound
// indices are fetched one cell ahead of their rows, so a row load never
// waits on its index.  Per cell:
//   1. cp.async brings the next cell's pack tile [2*R16, BN] bf16 into
//      the other half of a two-stage ring, and each thread issues the
//      loads of the next cell's bound rows and fbar into registers;
//   2. the warps run this cell's MMAs from shared memory;
//   3. the loaded rows are differenced, lerped, rounded and stored as
//      the next operand tile in the other half of a double buffer;
//   4. one barrier.
// So the loads of tile t+1 are in flight during the MMAs of tile t.
// Both tiles' rows are padded by 16 bytes, so ldmatrix reads them
// without bank conflicts.  The MMA is mma.sync.m16n8k16 (bf16 in, f32
// accumulate) on the tensor cores, fed by ldmatrix: warp w takes rows
// 16*(w%4) and half of BN.  wgmma would need the operand in its own
// shared-memory layout and a 128-thread warpgroup per 64 rows; at these
// A (32 and 128) the MMA is a small part of the work next to the row
// reads and the lerp, so the simpler mma.sync register fragments do.
// The epilogue writes 2 * acc for a < A.  No atomics: the sums run in
// one fixed order, so a launch is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "tile_copy.cuh"
#include "window_lerp.cuh"

namespace {

using fscl::cp_async16;
using fscl::cp_async_commit;
using fscl::cp_async_wait_all;
using fscl::load8;
using fscl::side_diff;
using fscl::smem_addr;
using fscl::table_row;
using fscl::window_lerp;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 64;        // flat rows m per block
constexpr int kPad = 8;        // bf16 row padding of both tiles (16 bytes)

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a * b, m16n8k16, bf16 inputs, f32 accumulators (tensor cores)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One unit: 8 lanes of one flat row m, owned by one thread for the whole
// K loop.
struct Unit {
  const int32_t* b0;  // bounds of side 0; side 1 follows at + NC + 1
  const float* f0;    // fbar of side 0; side 1 follows at + NC
  int64_t lane;       // first lane p*R + 8*g in a prefix row
  int tile;           // its element offset in an operand tile buffer
  bool live;
};

template <typename T, int BN, int UPT>
__global__ void __launch_bounds__(kThreads)
    window_clr_kernel(const T* __restrict__ ps,
                      const int32_t* __restrict__ bounds,
                      const float* __restrict__ fbar,
                      const __nv_bfloat16* __restrict__ pack,
                      float* __restrict__ out, int C, int NC, int P, int R,
                      int64_t n_rows, int A, int A_pack) {
  constexpr int kNT8 = BN / 16;  // n8 tiles per warp: a warp takes BN/2
  extern __shared__ __align__(16) unsigned char smem[];
  const int R16 = (R + 15) & ~15;
  const int KT = 2 * R16;       // k values of one cell's tile
  const int lda = KT + kPad;    // operand tile row stride (bf16)
  constexpr int ldb = BN + kPad;  // pack tile row stride (bf16)
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BM][lda]
  __nv_bfloat16* sB = sA + 2 * kBM * lda;                      // [2][KT][ldb]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t M = (int64_t)C * P;
  const int64_t L = (int64_t)P * R;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;

  // zeros that stay: rows past M, lanes r >= R, pack rows r >= R and
  // pack columns past A_pack
  {
    const int n16 = (2 * kBM * lda + 2 * KT * ldb) / 8;
    for (int i = tid; i < n16; i += kThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  }

  const int G8 = R >> 3;  // 8-lane groups per row m
  Unit u[UPT];
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    const int q = tid + i * kThreads;
    const int ml = q / G8;
    const int g = q - ml * G8;
    const int64_t m = m0 + ml;
    u[i].live = ml < kBM && m < M;
    const int64_t c = u[i].live ? m / P : 0;
    const int64_t p = u[i].live ? m - c * P : 0;
    u[i].b0 = bounds + c * 2 * (NC + 1);
    u[i].f0 = fbar + c * 2 * NC;
    u[i].lane = p * R + 8 * g;
    u[i].tile = ml * lda + 8 * g;
  }

  // the pack tile of cell j: rows (s*NC + j)*R + r for r < R, columns
  // n0 .. n0 + BN (zero past A_pack, a multiple of 8)
  auto load_pack = [&](int j, int buf) {
    constexpr int kChunks = BN / 8;  // 16-byte chunks per row
    __nv_bfloat16* dst0 = sB + buf * KT * ldb;
    for (int i = tid; i < 2 * R * kChunks; i += kThreads) {
      const int row = i / kChunks;
      const int ch = i - row * kChunks;
      const int s = row >= R;
      const int r = row - s * R;
      const int col = n0 + 8 * ch;
      const bool in = col < A_pack;
      const __nv_bfloat16* src =
          in ? pack + ((int64_t)(s * NC + j) * R + r) * A_pack + col : pack;
      cp_async16(dst0 + (s * R16 + r) * ldb + 8 * ch, src, in ? 16 : 0);
    }
    cp_async_commit();
  };

  T prev0[UPT][8], prev1[UPT][8], cur0[UPT][8], cur1[UPT][8];
  int32_t nb0[UPT], nb1[UPT];  // bound indices that close the next cell
  float g0[UPT], g1[UPT];      // fbar of the cell in cur
  // the bound rows that close cell j (b[j + 1], indices already in nb)
  // and its fbar into registers; then the indices that close cell j + 1
  auto load_rows = [&](int j) {
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      if (!u[i].live) continue;
      load8(table_row(ps, nb0[i], n_rows, L) + u[i].lane, cur0[i]);
      load8(table_row(ps, nb1[i], n_rows, L) + u[i].lane, cur1[i]);
      g0[i] = __ldg(u[i].f0 + j);
      g1[i] = __ldg(u[i].f0 + NC + j);
      if (j + 2 <= NC) {
        nb0[i] = __ldg(u[i].b0 + j + 2);
        nb1[i] = __ldg(u[i].b0 + NC + 1 + j + 2);
      }
    }
  };
  // operand tile of the cell in cur into buffer buf; prev = cur
  auto build = [&](int buf) {
    __nv_bfloat16* dst0 = sA + buf * kBM * lda;
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      if (!u[i].live) continue;
      __nv_bfloat16 w0b[8], w1b[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float h0 = side_diff(cur0[i][e], prev0[i][e], true);
        const float h1 = side_diff(cur1[i][e], prev1[i][e], false);
        float w0, w1;
        window_lerp(h0, h1, g0[i], g1[i], w0, w1);
        w0b[e] = __float2bfloat16_rn(w0);
        w1b[e] = __float2bfloat16_rn(w1);
        prev0[i][e] = cur0[i][e];
        prev1[i][e] = cur1[i][e];
      }
      uint4 v0, v1;
      memcpy(&v0, w0b, 16);
      memcpy(&v1, w1b, 16);
      *reinterpret_cast<uint4*>(dst0 + u[i].tile) = v0;
      *reinterpret_cast<uint4*>(dst0 + u[i].tile + R16) = v1;
    }
  };

  // prologue: prev = rows b[0], cur = rows b[1]; tile 0 in buffer 0
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    if (!u[i].live) continue;
    const int32_t* b0 = u[i].b0;
    load8(table_row(ps, __ldg(b0), n_rows, L) + u[i].lane, prev0[i]);
    load8(table_row(ps, __ldg(b0 + NC + 1), n_rows, L) + u[i].lane,
          prev1[i]);
    nb0[i] = __ldg(b0 + 1);
    nb1[i] = __ldg(b0 + NC + 2);
  }
  load_rows(0);
  __syncthreads();  // the zero fill is done before any tile lands
  load_pack(0, 0);
  build(0);
  cp_async_wait_all();
  __syncthreads();

  float acc[kNT8][4];
#pragma unroll
  for (int t = 0; t < kNT8; ++t)
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
  const int wm = (warp & 3) * 16;        // the warp's rows in the tile
  const int wn = (warp >> 2) * (BN / 2);  // and its columns
  const int a_off = (wm + (lane & 15)) * lda + (lane >> 4) * 8;
  const int b_off = (lane & 15) * ldb + wn + (lane >> 4) * 8;

  for (int j = 0; j < NC; ++j) {
    const int buf = j & 1;
    const bool more = j + 1 < NC;
    if (more) {
      load_pack(j + 1, buf ^ 1);
      load_rows(j + 1);
    }
    const __nv_bfloat16* a_base = sA + buf * kBM * lda + a_off;
    const __nv_bfloat16* b_base = sB + buf * KT * ldb + b_off;
    for (int k0 = 0; k0 < KT; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, a_base + k0);
#pragma unroll
      for (int t = 0; t < kNT8; t += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, b_base + k0 * ldb + t * 8);
        mma_bf16(acc[t], a, b[0], b[1]);
        mma_bf16(acc[t + 1], a, b[2], b[3]);
      }
    }
    if (more) build(buf ^ 1);
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: accumulator (row lane/4 (+8), columns 2*(lane%4) + {0,1})
#pragma unroll
  for (int t = 0; t < kNT8; ++t) {
    const int col = n0 + wn + t * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + wm + (lane >> 2) + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (col + e < A) out[m * A + col + e] = 2.0f * acc[t][2 * h + e];
    }
  }
}

size_t smem_bytes(int R, int BN) {
  const int R16 = (R + 15) & ~15;
  return (size_t)2 * (2 * kBM * (2 * R16 + kPad) + 2 * R16 * 2 * (BN + kPad));
}

template <typename T, int BN, int UPT>
int launch(const void* ps, const void* bounds, const void* fbar,
           const void* pack, void* out, int C, int NC, int P, int R,
           int64_t n_rows, int A, int A_pack, cudaStream_t st) {
  auto kern = window_clr_kernel<T, BN, UPT>;
  const size_t smem = smem_bytes(R, BN);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t M = (int64_t)C * P;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((A + BN - 1) / BN));
  kern<<<grid, kThreads, smem, st>>>(
      (const T*)ps, (const int32_t*)bounds, (const float*)fbar,
      (const __nv_bfloat16*)pack, (float*)out, C, NC, P, R, n_rows, A,
      A_pack);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* ps, const void* bounds, const void* fbar,
             const void* pack, void* out, int C, int NC, int P, int R,
             int64_t n_rows, int A, int A_pack, cudaStream_t st) {
  // units of 8 lanes: 8*R per block over 256 threads
  const bool wide = R > 64;
  if (A <= 32)
    return wide ? launch<T, 32, 4>(ps, bounds, fbar, pack, out, C, NC, P, R,
                                   n_rows, A, A_pack, st)
                : launch<T, 32, 2>(ps, bounds, fbar, pack, out, C, NC, P, R,
                                   n_rows, A, A_pack, st);
  return wide ? launch<T, 128, 4>(ps, bounds, fbar, pack, out, C, NC, P, R,
                                  n_rows, A, A_pack, st)
              : launch<T, 128, 2>(ps, bounds, fbar, pack, out, C, NC, P, R,
                                  n_rows, A, A_pack, st);
}

}  // namespace

extern "C" {

// ps [n_rows, P*R] of dtype_code 0 = int16, 1 = int32, 2 = float32,
// 16-byte aligned; bounds [C, 2, NC+1] int32 rows of ps; fbar [C, 2, NC]
// f32; pack [2*NC*R, A_pack] bf16, 16-byte aligned, A_pack >= A a
// multiple of 8; out [C, P, A] f32.  R a multiple of 8, at most 128;
// NC >= 1.  Returns the launch's CUDA error (0 = success); nothing to
// compute is success without a launch.
int fscl_window_clr(const void* ps, const void* bounds, const void* fbar,
                    const void* pack, void* out, int C, int NC, int P, int R,
                    int64_t n_rows, int dtype_code, int A, int A_pack,
                    void* stream) {
  if ((int64_t)C * P == 0 || A == 0) return 0;
  if (NC < 1 || R < 8 || R > 128 || R % 8 || A_pack < A || A_pack % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype_code) {
    case 0:
      return dispatch<int16_t>(ps, bounds, fbar, pack, out, C, NC, P, R,
                               n_rows, A, A_pack, st);
    case 1:
      return dispatch<int32_t>(ps, bounds, fbar, pack, out, C, NC, P, R,
                               n_rows, A, A_pack, st);
    case 2:
      return dispatch<float>(ps, bounds, fbar, pack, out, C, NC, P, R,
                             n_rows, A, A_pack, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
