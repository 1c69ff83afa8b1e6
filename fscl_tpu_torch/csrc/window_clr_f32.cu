// The hist statistic's window operand and its float32 contraction in one
// tensor-core kernel for Hopper (sm_90a), split over cells where the grid
// would not fill the card.
//
// fscl_window_clr_f32 replaces fscl_tpu/ops/histclr.py:1116-1131, the
// chunk body of hist_clr_reps_ps with mm_bf16=False, which XLA fuses on
// the TPU (no Pallas kernel there): gather the prefix rows at the run
// bounds, difference and lerp them into the operand, and contract it with
// the float32 pack.  With L = P*R lanes, flat row m = c*P + p and
// k = (s*NC + j)*R + r:
//
//   out[c, p, a] = 2 * sum_{s, j, r} w_s[c, j, p*R + r] * t3[k, a]
//
// where w_s are the values fscl_window_operand (row_gather.cu) writes,
// unrounded: the same window_lerp.cuh arithmetic.  This route's CLRs are
// the ones the scan reports (its tie stage), so the products are float32
// accurate ("3xTF32"): each operand x is split in registers into
// x_hi = tf32(x) and x_lo = tf32(x - x_hi) (round to nearest), and
// a*t ~ a_lo*t_hi + a_hi*t_lo + a_hi*t_hi on the TF32 tensor cores
// (mma.sync.m16n8k8, float32 sums); only a_lo*t_lo, about 2^-22 of the
// product, is dropped.  The tensor cores' own float32 sums are not
// rounded to nearest, so a cell's products are summed on them from zero
// and then added to the running sum by one float32 add, rounded to
// nearest: a chain of tensor-core sums is at most 3 R / 4 MMAs long.
// The three MMAs of a k step run term by term over the warp's tiles, so
// consecutive MMAs feed different accumulators.
//
// What bounds it on the H100.  The two-step route it replaces writes the
// operand [c*P, 2*NC*R] f32 to HBM and an FFMA matmul (the float32 pipe,
// 67 TFLOP/s at most) reads it back; here the operand lives
// only in shared memory, and the products run on the tensor cores at up
// to 495 TFLOP/s, a third of that for three MMAs a product.  What is left
// is the bound-row reads (mostly L2 hits), the pack (K*A*4 bytes: 37 MB at
// the genome tie stage, reread from L2 by every block of rows), the lerp,
// the splits and the fragment loads.  On the card the kernel takes three to
// five times the larger of its byte and operation bounds (PERF.md), and
// dropping any one of the MMAs, the splits, the pack reads or the row
// reads and lerp leaves most of its time: they do not overlap well with
// one 8-warp block per SM.
//
// Design.  As window_clr.cu: a block of 256 threads (8 warps) takes BM =
// 64 flat rows m and BN output columns, and walks the cells j; a K tile is
// one cell, both sides (2R k values, R a multiple of 8).  Each thread owns
// units of 8 lanes of one row m for the whole loop, keeps the previous
// bound row per side in registers, fetches bound indices and fbar one cell
// ahead of their rows; cp.async brings the next cell's pack tile [2R, BN]
// f32 into a two-stage ring, and the operand tile is double-buffered, so
// the loads of cell j+1 are in flight during the MMAs of cell j.  Shared
// memory holds each tile once, in f32: the split runs in registers after
// each fragment load.  (Splitting the pack once per table would save a
// third of the split instructions but double the pack's bytes in L2 and
// in shared memory, which is the tighter resource: at R = 56 and BN = 128
// the two rings already take 181 KB.)  The fragments are 32-bit loads:
// the operand rows are padded to 2R + 4 floats (4 x an odd number, mod 32
// banks) and the pack rows to BN + 8 (8 mod 32), so a warp's fragment load
// touches 32 distinct banks.  BN is the widest of 128, 64, 32 whose two
// rings fit in 227 KB at this R (32 when A <= 32): 128 up to R = 64, 64 up
// to R = 104, else 32; a grid column per further BN.  Warps tile the block
// 2 x 4 (32 rows x BN/4 columns each) at BN >= 64, 4 x 2 at BN = 32.
//
// Split over cells.  The scan's tie stage calls one chromosome at a time
// at P = 1: 1,600-3,700 candidates, 25-58 blocks of 64 rows for 132 SMs,
// each walking 700+ cells.  Where the grid has fewer than two waves'
// blocks, blockIdx.z takes a contiguous range of cells (at least
// kMinCells) and writes its float32 partial sums [splits, c*P, A]; a
// second launch adds them in split order and doubles.  The split count
// (splits_for) makes whole waves, counting one block per SM (a block
// takes 95-229 KB): 49 blocks split 6 ways would run 294 blocks in three
// waves of 132, 5 ways 245 blocks in two: 2 x 151 cells walked end to
// end against 3 x 126.  It is a pure function of (c*P, NC, R, A, SM count)
// (fscl_window_clr_f32_splits).  No atomics: a launch is deterministic.
//
// Wide variant, 128 < R <= 256 (window_clr_f32_kernel_wide: the tie stage
// on the exact one-hot tables of one large depth).  As window_clr.cu's:
// each cell is walked in two K steps of up to 128 lanes (2R k values would
// take 353 KB of rings at R = 216 and BN = 32), each step loads both bound
// rows of its cell, and each step's products are summed on the tensor
// cores from zero and added to the running sum, so a tensor-core chain
// stays at most 3 x 128 / 4 MMAs long.  A separate template
// instantiation: the R <= 128 kernels keep their code.
//
// wgmma is not used.  It needs the operand in its own swizzled shared
// layout and 128-thread warpgroups per 64 rows, and with a float32
// operand split three ways it would have to take the split tiles from
// shared memory (twice the bytes) or registers; the mma.sync fragments
// keep the split in registers.  And the MMAs are one share of the time
// among several (above), so a faster MMA alone would not move it far.

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
using fscl::table_row;
using fscl::window_lerp;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 64;        // flat rows m per block
constexpr int kPadA = 4;       // operand row padding (floats)
constexpr int kPadB = 8;       // pack row padding (floats)
constexpr int kMinCells = 16;  // fewest cells a split walks
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100

// x rounded to TF32 (10-bit mantissa, to nearest, ties away from zero),
// as the b32 register the MMA takes: for finite x the bits of
// cvt.rna.tf32.f32, in two integer operations where nvcc lowers the cvt
// to four (it also tests for infinity and NaN, which the operand and the
// pack never hold)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (a remainder of about 2^-22 x)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a * b, m16n8k8, TF32 inputs, f32 accumulators (tensor cores); not
// volatile, so the compiler may interleave independent MMAs
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One unit: 8 lanes of one flat row m, owned by one thread for the whole
// K loop.
struct Unit {
  const int32_t* b0;  // bounds of side 0; side 1 follows at + NC + 1
  const float* f0;    // fbar of side 0; side 1 follows at + NC
  int64_t lane;       // first lane p*R + 8*g in a prefix row
  int tile;           // its element offset in an operand tile buffer
  bool live;
  bool live1;  // wide: the unit also has lanes in a cell's second step
};

template <typename T, int BN, int UPT, bool kWide = false>
__device__ __forceinline__ void window_clr_f32_tile(
    const T* __restrict__ ps, const int32_t* __restrict__ bounds,
    const float* __restrict__ fbar, const float* __restrict__ pack,
    float* __restrict__ out, float* __restrict__ part, int C, int NC, int P,
    int R, int64_t n_rows, int A, int A_pack, int splits) {
  constexpr int kWM = BN >= 64 ? 2 : 4;  // warps along m
  constexpr int kWN = 8 / kWM;           // and along n
  constexpr int kMT = kBM / kWM / 16;    // m16 tiles per warp
  constexpr int kNT = BN / kWN / 8;      // n8 tiles per warp
  constexpr int ldb = BN + kPadB;        // pack tile row stride (floats)
  extern __shared__ __align__(16) unsigned char smem[];
  const int G8 = R >> 3;  // 8-lane groups per row m
  // 8-lane groups of one K step: all, or (wide) a cell's first half
  const int GS = kWide ? (G8 + 1) / 2 : G8;
  const int RS = kWide ? 8 * GS : R;  // lanes of one K step
  const int KT = 2 * RS;       // k values of one step's tile
  const int lda = KT + kPadA;  // operand tile row stride (floats)
  float* sA = reinterpret_cast<float*>(smem);  // [2][BM][lda]
  float* sB = sA + 2 * kBM * lda;              // [2][KT][ldb]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t M = (int64_t)C * P;
  const int64_t L = (int64_t)P * R;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int z = blockIdx.z;
  const int j0 = (int)((int64_t)NC * z / splits);
  const int j1 = (int)((int64_t)NC * (z + 1) / splits);

  // zeros that stay: rows past M and pack columns past A_pack
  {
    const int n16 = (2 * kBM * lda + 2 * KT * ldb) / 4;
    for (int i = tid; i < n16; i += kThreads)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  }

  Unit u[UPT];
#pragma unroll
  for (int i = 0; i < UPT; ++i) {
    const int q = tid + i * kThreads;
    const int ml = q / GS;
    const int g = q - ml * GS;
    const int64_t m = m0 + ml;
    u[i].live = ml < kBM && m < M;
    if constexpr (kWide) u[i].live1 = u[i].live && GS + g < G8;
    const int64_t c = u[i].live ? m / P : 0;
    const int64_t p = u[i].live ? m - c * P : 0;
    u[i].b0 = bounds + c * 2 * (NC + 1);
    u[i].f0 = fbar + c * 2 * NC;
    u[i].lane = p * R + 8 * g;
    u[i].tile = ml * lda + 8 * g;
  }

  // the pack tile of step h of cell j: rows (s*NC + j)*R + r0 + r for
  // r < rh (all R rows, or wide the step's), columns n0 .. n0 + BN (zero
  // past A_pack, a multiple of 4)
  auto load_pack = [&](int j, int h, int buf) {
    constexpr int kChunks = BN / 4;  // 16-byte chunks per row
    const int r0 = kWide ? RS * h : 0;
    const int rh = kWide ? min(RS, R - r0) : R;
    float* dst0 = sB + buf * KT * ldb;
    for (int i = tid; i < 2 * rh * kChunks; i += kThreads) {
      const int row = i / kChunks;
      const int ch = i - row * kChunks;
      const int s = row >= rh;
      const int r = row - s * rh;
      const int col = n0 + 4 * ch;
      const bool in = col < A_pack;
      const float* src =
          in ? pack + ((int64_t)(s * NC + j) * R + r0 + r) * A_pack + col
             : pack;
      cp_async16(dst0 + (s * RS + r) * ldb + 4 * ch, src, in ? 16 : 0);
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
  // wide: both bound rows of step h of cell j and its fbar
  auto load_rows_wide = [&](int j, int h) {
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      if (!(h ? u[i].live1 : u[i].live)) continue;
      const int32_t* b0 = u[i].b0 + j;
      const int64_t ln = u[i].lane + RS * h;
      load8(table_row(ps, __ldg(b0), n_rows, L) + ln, prev0[i]);
      load8(table_row(ps, __ldg(b0 + NC + 1), n_rows, L) + ln, prev1[i]);
      load8(table_row(ps, __ldg(b0 + 1), n_rows, L) + ln, cur0[i]);
      load8(table_row(ps, __ldg(b0 + NC + 2), n_rows, L) + ln, cur1[i]);
      g0[i] = __ldg(u[i].f0 + j);
      g1[i] = __ldg(u[i].f0 + NC + j);
    }
  };
  // operand tile of the cell (wide: its step h) in cur into buffer buf;
  // prev = cur
  auto build = [&](int buf, int h) {
    float* dst0 = sA + buf * kBM * lda;
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      if (!(kWide && h ? u[i].live1 : u[i].live)) continue;
      float w0[8], w1[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float h0 = side_diff(cur0[i][e], prev0[i][e], true);
        const float h1 = side_diff(cur1[i][e], prev1[i][e], false);
        window_lerp(h0, h1, g0[i], g1[i], w0[e], w1[e]);
        if constexpr (!kWide) {
          prev0[i][e] = cur0[i][e];
          prev1[i][e] = cur1[i][e];
        }
      }
      float4* d0 = reinterpret_cast<float4*>(dst0 + u[i].tile);
      float4* d1 = reinterpret_cast<float4*>(dst0 + u[i].tile + RS);
      d0[0] = make_float4(w0[0], w0[1], w0[2], w0[3]);
      d0[1] = make_float4(w0[4], w0[5], w0[6], w0[7]);
      d1[0] = make_float4(w1[0], w1[1], w1[2], w1[3]);
      d1[1] = make_float4(w1[4], w1[5], w1[6], w1[7]);
    }
  };

  // prologue: prev = rows b[j0], cur = rows b[j0 + 1]; tile j0 (wide:
  // its first step) in buffer 0
  if constexpr (kWide) {
    load_rows_wide(j0, 0);
  } else {
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      if (!u[i].live) continue;
      const int32_t* b0 = u[i].b0;
      load8(table_row(ps, __ldg(b0 + j0), n_rows, L) + u[i].lane, prev0[i]);
      load8(table_row(ps, __ldg(b0 + NC + 1 + j0), n_rows, L) + u[i].lane,
            prev1[i]);
      nb0[i] = __ldg(b0 + j0 + 1);
      nb1[i] = __ldg(b0 + NC + 1 + j0 + 1);
    }
    load_rows(j0);
  }
  __syncthreads();  // the zero fill is done before any tile lands
  load_pack(j0, 0, 0);
  build(0, 0);
  cp_async_wait_all();
  __syncthreads();

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
  const int gq = lane >> 2;  // fragment row (A, C) / column (B)
  const int tq = lane & 3;   // fragment k (A, B) / column pair (C)
  const int wm = (warp % kWM) * (kBM / kWM);  // the warp's rows
  const int wn = (warp / kWM) * (BN / kWN);   // and its columns

  // this K step's products, summed on the tensor cores from zero, then
  // added to acc by one float32 add each
  auto mma_step = [&](int buf) {
    const float* a_base = sA + buf * kBM * lda + (wm + gq) * lda + tq;
    const float* b_base = sB + buf * KT * ldb + tq * ldb + wn + gq;
    float cell[kMT][kNT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) cell[mt][nt][e] = 0.0f;
#pragma unroll 2
    for (int k0 = 0; k0 < KT; k0 += 8) {
      uint32_t ahi[kMT][4], alo[kMT][4], bhi[kNT][2], blo[kNT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const float* a = a_base + mt * 16 * lda + k0;
        split(a[0], ahi[mt][0], alo[mt][0]);
        split(a[8 * lda], ahi[mt][1], alo[mt][1]);
        split(a[4], ahi[mt][2], alo[mt][2]);
        split(a[8 * lda + 4], ahi[mt][3], alo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float* b = b_base + k0 * ldb + nt * 8;
        split(b[0], bhi[nt][0], blo[nt][0]);
        split(b[4 * ldb], bhi[nt][1], blo[nt][1]);
      }
      // term by term, so consecutive MMAs feed different accumulators
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_tf32(cell[mt][nt], alo[mt], bhi[nt]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_tf32(cell[mt][nt], ahi[mt], blo[nt]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_tf32(cell[mt][nt], ahi[mt], bhi[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], cell[mt][nt][e]);
  };
  if constexpr (kWide) {
    // steps t: cell j0 + t/2, its half h = t%2 in buffer h
    const int n_steps = 2 * (j1 - j0);
    for (int t = 0; t < n_steps; ++t) {
      const int j = j0 + (t >> 1), h = t & 1;
      const bool more = t + 1 < n_steps;
      if (more) {
        load_pack(j + h, h ^ 1, h ^ 1);
        load_rows_wide(j + h, h ^ 1);
      }
      mma_step(h);
      if (more) build(h ^ 1, h ^ 1);
      cp_async_wait_all();
      __syncthreads();
    }
  } else {
    for (int j = j0; j < j1; ++j) {
      const int buf = (j - j0) & 1;
      const bool more = j + 1 < j1;
      if (more) {
        load_pack(j + 1, 0, buf ^ 1);
        load_rows(j + 1);
      }
      mma_step(buf);
      if (more) build(buf ^ 1, 0);
      cp_async_wait_all();
      __syncthreads();
    }
  }

  // epilogue: accumulator (row gq (+8), columns 2*tq + {0,1}); 2 * acc
  // into out, or the split's partial sums
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = n0 + wn + nt * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t m = m0 + wm + mt * 16 + gq + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= A) continue;
          const float v = acc[mt][nt][2 * h + e];
          if (splits == 1)
            out[m * A + col + e] = 2.0f * v;
          else
            part[((int64_t)z * M + m) * A + col + e] = v;
        }
      }
    }
}

#define FSCL_WINDOW_CLR_F32_PARAMS                                           \
  const T *__restrict__ ps, const int32_t *__restrict__ bounds,             \
      const float *__restrict__ fbar, const float *__restrict__ pack,       \
      float *__restrict__ out, float *__restrict__ part, int C, int NC,     \
      int P, int R, int64_t n_rows, int A, int A_pack, int splits
#define FSCL_WINDOW_CLR_F32_ARGS \
  ps, bounds, fbar, pack, out, part, C, NC, P, R, n_rows, A, A_pack, splits

template <typename T, int BN, int UPT>
__global__ void __launch_bounds__(kThreads)
    window_clr_f32_kernel(FSCL_WINDOW_CLR_F32_PARAMS) {
  window_clr_f32_tile<T, BN, UPT>(FSCL_WINDOW_CLR_F32_ARGS);
}

// The wide variant, 128 < R <= 256: two K steps a cell (above).
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    window_clr_f32_kernel_wide(FSCL_WINDOW_CLR_F32_PARAMS) {
  window_clr_f32_tile<T, BN, 4, true>(FSCL_WINDOW_CLR_F32_ARGS);
}
#undef FSCL_WINDOW_CLR_F32_PARAMS
#undef FSCL_WINDOW_CLR_F32_ARGS

// out[i] = 2 * (part[0][i] + part[1][i] + ...), in split order
__global__ void reduce_splits(const float* __restrict__ part,
                              float* __restrict__ out, int64_t n,
                              int splits) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int z = 1; z < splits; ++z) s = __fadd_rn(s, part[z * n + i]);
    out[i] = 2.0f * s;
  }
}

constexpr int kWideR = 128;  // the widest R walked in one K step a cell

// lanes of one K step: R, or past kWideR the first half of its 8-lane
// groups
int step_r(int R) { return R <= kWideR ? R : 8 * ((R / 8 + 1) / 2); }

size_t smem_bytes(int R, int BN) {
  const int RS = step_r(R);
  return (size_t)4 * (2 * kBM * (2 * RS + kPadA) + 2 * 2 * RS * (BN + kPadB));
}

int pick_bn(int R, int A) {
  if (A <= 32) return 32;
  if (R <= 64) return 128;
  return smem_bytes(R, 64) <= (size_t)kSmemMax ? 64 : 32;
}

// The split count: 1 from two waves of blocks (one block per SM) up;
// below, the count s that makes the fewest waves per cell walked,
// ceil(blocks * s / n_sm) / s, within 10% of the least (the smallest such
// s), with each split walking at least kMinCells cells and the grid held
// to four waves.
int splits_for(int64_t M, int NC, int R, int A, int n_sm) {
  const int BN = pick_bn(R, A);
  const int64_t blocks = (M + kBM - 1) / kBM * ((A + BN - 1) / BN);
  if (blocks >= 2 * (int64_t)n_sm) return 1;
  int64_t cap = (4 * (int64_t)n_sm + blocks - 1) / blocks;
  if (cap > NC / kMinCells) cap = NC / kMinCells;
  auto cost = [&](int64_t s) {
    return (double)((blocks * s + n_sm - 1) / n_sm) / (double)s;
  };
  double best = cost(1);
  for (int64_t s = 2; s <= cap; ++s)
    if (cost(s) < best) best = cost(s);
  for (int64_t s = 1; s <= cap; ++s)
    if (cost(s) <= 1.1 * best) return (int)s;
  return 1;
}

template <typename T, int BN, int UPT, bool kWide = false>
int launch(const void* ps, const void* bounds, const void* fbar,
           const void* pack, void* out, void* part, int C, int NC, int P,
           int R, int64_t n_rows, int A, int A_pack, int splits,
           cudaStream_t st) {
  void (*kern)(const T*, const int32_t*, const float*, const float*, float*,
               float*, int, int, int, int, int64_t, int, int, int);
  if constexpr (kWide)
    kern = window_clr_f32_kernel_wide<T, BN>;
  else
    kern = window_clr_f32_kernel<T, BN, UPT>;
  const size_t smem = smem_bytes(R, BN);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t M = (int64_t)C * P;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM),
                  (unsigned)((A + BN - 1) / BN), (unsigned)splits);
  kern<<<grid, kThreads, smem, st>>>(
      (const T*)ps, (const int32_t*)bounds, (const float*)fbar,
      (const float*)pack, (float*)out, (float*)part, C, NC, P, R, n_rows, A,
      A_pack, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const int64_t n = M * A;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  reduce_splits<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16),
                  kThreads, 0, st>>>((const float*)part, (float*)out, n,
                                     splits);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* ps, const void* bounds, const void* fbar,
             const void* pack, void* out, void* part, int C, int NC, int P,
             int R, int64_t n_rows, int A, int A_pack, int splits,
             cudaStream_t st) {
  // units of 8 lanes: 8*R per block over 256 threads
#define FSCL_LAUNCH(BN, UPT)                                                \
  launch<T, BN, UPT>(ps, bounds, fbar, pack, out, part, C, NC, P, R, n_rows, \
                     A, A_pack, splits, st)
  const int bn = pick_bn(R, A);
  if (R > kWideR)
    return bn == 32 ? launch<T, 32, 4, true>(ps, bounds, fbar, pack, out,
                                             part, C, NC, P, R, n_rows, A,
                                             A_pack, splits, st)
                    : launch<T, 64, 4, true>(ps, bounds, fbar, pack, out,
                                             part, C, NC, P, R, n_rows, A,
                                             A_pack, splits, st);
  if (R <= 64) return bn == 32 ? FSCL_LAUNCH(32, 2) : FSCL_LAUNCH(128, 2);
  return bn == 32 ? FSCL_LAUNCH(32, 4) : FSCL_LAUNCH(64, 4);
#undef FSCL_LAUNCH
}

}  // namespace

extern "C" {

// The split over cells that fscl_window_clr_f32 takes for c*P = M rows
// (1 = none; the caller allocates [splits, M, A] f32 partial sums when
// more).  n_sm: the card's SM count.
int fscl_window_clr_f32_splits(int64_t M, int NC, int R, int A, int n_sm) {
  if (M <= 0 || A <= 0 || NC < 1 || R < 8 || n_sm < 1) return 1;
  return splits_for(M, NC, R, A, n_sm);
}

// ps [n_rows, P*R] of dtype_code 0 = int16, 1 = int32, 2 = float32,
// 16-byte aligned; bounds [C, 2, NC+1] int32 rows of ps; fbar [C, 2, NC]
// f32; pack [2*NC*R, A_pack] f32, 16-byte aligned, A_pack >= A a multiple
// of 4; out [C, P, A] f32; part [splits, C*P, A] f32 when splits > 1
// (unused at 1).  R a multiple of 8, at most 256 (past 128 the wide
// variant); 1 <= splits <= NC.
// Launches the kernel, and the reduction of its partial sums when
// splits > 1.  Returns the first CUDA error (0 = success); nothing to
// compute is success without a launch.
int fscl_window_clr_f32(const void* ps, const void* bounds, const void* fbar,
                        const void* pack, void* out, void* part, int C,
                        int NC, int P, int R, int64_t n_rows, int dtype_code,
                        int A, int A_pack, int splits, void* stream) {
  if ((int64_t)C * P == 0 || A == 0) return 0;
  if (NC < 1 || R < 8 || R > 2 * kWideR || R % 8 || A_pack < A ||
      A_pack % 4 ||
      splits < 1 || splits > NC || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype_code) {
    case 0:
      return dispatch<int16_t>(ps, bounds, fbar, pack, out, part, C, NC, P,
                               R, n_rows, A, A_pack, splits, st);
    case 1:
      return dispatch<int32_t>(ps, bounds, fbar, pack, out, part, C, NC, P,
                               R, n_rows, A, A_pack, splits, st);
    case 2:
      return dispatch<float>(ps, bounds, fbar, pack, out, part, C, NC, P, R,
                             n_rows, A, A_pack, splits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
