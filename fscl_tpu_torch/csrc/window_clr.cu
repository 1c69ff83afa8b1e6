// The hist statistic's window operand and its bfloat16 contraction in one
// tensor-core kernel for Hopper (sm_90a), split over cells across a
// thread-block cluster where the grid would not fill the card.
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
//
// What bounds a launch that does not fill the card: the cell walk.  Each
// cell costs a barrier and a round of dependent row loads, so a block's
// time is about its cells times that latency, whatever the grid.  The
// permutation tail calls the kernel once a stack of chromosomes and
// replicate slice, about 490 times a chunk: c*P = 224-672 rows, 4-11
// blocks for 132 SMs, each walking 208 cells, 0.30 ms a launch unsplit
// and 0.06 ms split 7 ways (PERF.md).
//
// Split over cells, for tiles of BN = 32 columns (the permutations' 32
// alphas).  Where the grid has fewer than two waves' blocks, blockIdx.z
// takes a contiguous range of the cells, and the splits of one tile run
// as one thread-block cluster along z.  Each block walks its cells with
// its own prologue and keeps the sums of its runs of kCellChunk cells in
// its shared memory; after a cluster barrier, block z adds a slice of the
// 64 x BN tile over every rank's runs through distributed shared memory,
// in rank and run order, doubles and writes it; a second barrier keeps
// every rank's shared memory until all have read it.  One launch: no
// partial sums in HBM, no atomics.  The split count (splits_for) walks
// the fewest runs of cells end to end, counting the blocks the card
// holds at once (registers, the slots' shared memory, whole clusters a
// GPC) and a run more a split for its prologue and reduction, with at
// least kMinCells cells a split and at most kClusterMax = 8 splits, the
// portable cluster size.  Clusters of 16 schedule on the H100, but at one
// block an SM only one cluster of 9-16 fits a GPC, against two of up to
// 8: at the tail's int32 launches of 11 tiles 9 splits took 0.103 ms and
// 7 took 0.066, and over a tail pass 16 gained under 2% (PERF.md).  The
// count is a pure function of (c*P, NC, R, A, SM count)
// (fscl_window_clr_splits).
//
// An entry's bits do not depend on its launch.  At BN = 32 the MMAs sum
// each run of kCellChunk cells from zero, and the runs' sums are added to
// a total from zero, one by one in cell order (rounded to nearest): in
// the block's shared memory where it walks every cell, in the cluster's
// reduction where it does not; the same float32 adds in the same order
// for any M, grid or split count.  The total stays out of registers, and
// this kernel is held to 128 registers, two blocks an SM (below).  At BN
// = 128 (the scan's 128 alphas, whose launches are a chromosome's
// candidates, over two waves) the MMAs sum every cell in one chain and
// never split: a total there would take 32 KB of shared memory or 32
// registers, and the int16 kernel is at 128 registers already.
//
// Wide variant, 128 < R <= 256 (window_clr_kernel_wide: the exact
// one-hot tables of one large depth, 216 haplotypes: R = 216).  One cell's
// K tile at R = 216 would take 2 x 224 k values: 114 KB of operand ring
// and, at BN = 128, 238 KB of pack ring, past a block's shared memory;
// and its units would take twice the registers.  So it walks each cell in
// two K steps, the first ceil(R/16) 8-lane groups and the rest, each laid
// out and contracted as a cell of up to 128 lanes is above (the rings and
// UPT = 4 of R = 128).  A step cannot keep the previous bound row in
// registers (its lanes were last read two steps back), so it loads both
// bound rows of its cell, once more from L2.  Steps alternate between the
// halves of the double buffers, so a buffer holds one half's tiles only
// and the lanes and pack rows past the second half's stay zero.  Runs of
// cells, the split and the reduction are as above.  A separate template
// instantiation: the R <= 128 kernels keep their code.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

#include "tile_copy.cuh"
#include "window_lerp.cuh"

namespace {

namespace cg = cooperative_groups;
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
constexpr int kCellChunk = 8;  // cells the MMAs sum from zero
constexpr int kMinCells = 16;  // fewest cells a split walks
constexpr int kClusterMax = 8;  // the portable cluster size
constexpr int kSmemMax = 232448;  // a block's shared memory on the H100
constexpr int kSmemSM = 233472;   // an SM's, 1 KB of it reserved a block
constexpr int kGpcSMs = 16;       // SMs of a GPC, which holds a cluster

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
  bool live1;  // wide: the unit also has lanes in a cell's second step
};

// One block's 64 x BN tile of out (split: its share of it).
template <typename T, int BN, int UPT, bool kWide = false>
__device__ __forceinline__ void window_clr_tile(
    const T* __restrict__ ps, const int32_t* __restrict__ bounds,
    const float* __restrict__ fbar, const __nv_bfloat16* __restrict__ pack,
    float* __restrict__ out, int C, int NC, int P, int R, int64_t n_rows,
    int A, int A_pack, int splits) {
  constexpr int kNT8 = BN / 16;  // n8 tiles per warp: a warp takes BN/2
  constexpr int kFrag = kNT8 * kThreads;  // float4 fragments of a tile
  constexpr bool kRuns = BN == 32;  // summed by runs of cells, splittable
  extern __shared__ __align__(16) unsigned char smem[];
  const int G8 = R >> 3;  // 8-lane groups per row m
  // 8-lane groups of one K step: all, or (wide) a cell's first half
  const int GS = kWide ? (G8 + 1) / 2 : G8;
  const int R16 = ((kWide ? 8 * GS : R) + 15) & ~15;
  const int KT = 2 * R16;       // k values of one cell's tile
  const int lda = KT + kPad;    // operand tile row stride (bf16)
  constexpr int ldb = BN + kPad;  // pack tile row stride (bf16)
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BM][lda]
  __nv_bfloat16* sB = sA + 2 * kBM * lda;                      // [2][KT][ldb]
  // kRuns: the running total of the runs of kCellChunk cells, or, split,
  // each run's sum: [runs][kNT8][kThreads] float4 after the rings
  float4* slots = reinterpret_cast<float4*>(sB + 2 * KT * ldb);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t M = (int64_t)C * P;
  const int64_t L = (int64_t)P * R;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  // this split's runs of cells [q_lo, q_hi) and its cells [j_lo, j_hi)
  const int NQ = (NC + kCellChunk - 1) / kCellChunk;
  const int z = blockIdx.z;
  const int q_lo = kRuns ? (int)((int64_t)z * NQ / splits) : 0;
  const int q_hi = kRuns ? (int)((int64_t)(z + 1) * NQ / splits) : NQ;
  const int j_lo = q_lo * kCellChunk;
  const int j_hi = kRuns ? min(NC, q_hi * kCellChunk) : NC;

  // zeros that stay: rows past M, lanes r >= R, pack rows r >= R and
  // pack columns past A_pack; and the running total (split, the runs'
  // slots are written before they are read)
  {
    const int n16 = (2 * kBM * lda + 2 * KT * ldb) / 8 +
                    (kRuns && splits == 1 ? kFrag : 0);
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
  // past A_pack, a multiple of 8)
  auto load_pack = [&](int j, int h, int buf) {
    constexpr int kChunks = BN / 8;  // 16-byte chunks per row
    const int r0 = kWide ? 8 * GS * h : 0;
    const int rh = kWide ? min(8 * GS, R - r0) : R;
    __nv_bfloat16* dst0 = sB + buf * KT * ldb;
    for (int i = tid; i < 2 * rh * kChunks; i += kThreads) {
      const int row = i / kChunks;
      const int ch = i - row * kChunks;
      const int s = row >= rh;
      const int r = row - s * rh;
      const int col = n0 + 8 * ch;
      const bool in = col < A_pack;
      const __nv_bfloat16* src =
          in ? pack + ((int64_t)(s * NC + j) * R + r0 + r) * A_pack + col
             : pack;
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
  // wide: both bound rows of step h of cell j and its fbar
  auto load_rows_wide = [&](int j, int h) {
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      if (!(h ? u[i].live1 : u[i].live)) continue;
      const int32_t* b0 = u[i].b0 + j;
      const int64_t ln = u[i].lane + 8 * GS * h;
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
    __nv_bfloat16* dst0 = sA + buf * kBM * lda;
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      if (!(kWide && h ? u[i].live1 : u[i].live)) continue;
      __nv_bfloat16 w0b[8], w1b[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float h0 = side_diff(cur0[i][e], prev0[i][e], true);
        const float h1 = side_diff(cur1[i][e], prev1[i][e], false);
        float w0, w1;
        window_lerp(h0, h1, g0[i], g1[i], w0, w1);
        w0b[e] = __float2bfloat16_rn(w0);
        w1b[e] = __float2bfloat16_rn(w1);
        if constexpr (!kWide) {
          prev0[i][e] = cur0[i][e];
          prev1[i][e] = cur1[i][e];
        }
      }
      uint4 v0, v1;
      memcpy(&v0, w0b, 16);
      memcpy(&v1, w1b, 16);
      *reinterpret_cast<uint4*>(dst0 + u[i].tile) = v0;
      *reinterpret_cast<uint4*>(dst0 + u[i].tile + R16) = v1;
    }
  };

  // prologue: prev = rows b[j_lo], cur = rows b[j_lo + 1]; the tile of
  // cell j_lo (wide: its first step) in buffer 0
  if constexpr (kWide) {
    load_rows_wide(j_lo, 0);
  } else {
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      if (!u[i].live) continue;
      const int32_t* b0 = u[i].b0 + j_lo;
      load8(table_row(ps, __ldg(b0), n_rows, L) + u[i].lane, prev0[i]);
      load8(table_row(ps, __ldg(b0 + NC + 1), n_rows, L) + u[i].lane,
            prev1[i]);
      nb0[i] = __ldg(b0 + 1);
      nb1[i] = __ldg(b0 + NC + 2);
    }
    load_rows(j_lo);
  }
  __syncthreads();  // the zero fill is done before any tile lands
  load_pack(j_lo, 0, 0);
  build(0, 0);
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

  float4* run = slots + tid;  // the total, or split this run's slot
  // this K step's MMAs from buffer buf
  auto mma_step = [&](int buf) {
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
  };
  // after cell j's MMAs: where a run of cells ends, add its sum to the
  // total, or keep it for the cluster's reduction; the next run starts
  // from zero
  auto end_cell = [&](int j) {
    if (kRuns && ((j + 1) % kCellChunk == 0 || j + 1 == NC)) {
#pragma unroll
      for (int t = 0; t < kNT8; ++t) {
        float4 v = make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
        if (splits == 1) {
          const float4 o = run[t * kThreads];
          v = make_float4(__fadd_rn(o.x, v.x), __fadd_rn(o.y, v.y),
                          __fadd_rn(o.z, v.z), __fadd_rn(o.w, v.w));
        }
        run[t * kThreads] = v;
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
      }
      if (splits > 1) run += kFrag;
    }
  };
  if constexpr (kWide) {
    // steps t: cell j_lo + t/2, its half h = t%2 in buffer h
    const int n_steps = 2 * (j_hi - j_lo);
    for (int t = 0; t < n_steps; ++t) {
      const int j = j_lo + (t >> 1), h = t & 1;
      const bool more = t + 1 < n_steps;
      if (more) {
        load_pack(j + h, h ^ 1, h ^ 1);
        load_rows_wide(j + h, h ^ 1);
      }
      mma_step(h);
      if (h) end_cell(j);
      if (more) build(h ^ 1, h ^ 1);
      cp_async_wait_all();
      __syncthreads();
    }
  } else {
    for (int j = j_lo; j < j_hi; ++j) {
      const int buf = (j - j_lo) & 1;
      const bool more = j + 1 < j_hi;
      if (more) {
        load_pack(j + 1, 0, buf ^ 1);
        load_rows(j + 1);
      }
      mma_step(buf);
      end_cell(j);
      if (more) build(buf ^ 1, 0);
      cp_async_wait_all();
      __syncthreads();
    }
  }

  // epilogue: fragment element e of tile t of thread (warp, lane) is row
  // wm + lane/4 + 8*(e/2), column wn + 8*t + 2*(lane%4) + e%2
  auto store = [&](int t, int thread, const float (&v)[4]) {
    const int ln = thread & 31, wp = thread >> 5;
    const int col = n0 + (wp >> 2) * (BN / 2) + t * 8 + 2 * (ln & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + (wp & 3) * 16 + (ln >> 2) + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (col + e < A) out[m * A + col + e] = 2.0f * v[2 * h + e];
    }
  };
  if (!kRuns) {
#pragma unroll
    for (int t = 0; t < kNT8; ++t) store(t, tid, acc[t]);
    return;
  }
  if (splits == 1) {
#pragma unroll
    for (int t = 0; t < kNT8; ++t) {
      const float4 x = slots[t * kThreads + tid];
      const float v[4] = {x.x, x.y, x.z, x.w};
      store(t, tid, v);
    }
    return;
  }
  // split: block z adds fragments [f_lo, f_hi) of the tile over every
  // rank's runs from zero, in rank and run order (the cells' order), the
  // adds of the unsplit total
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every rank's slots are written
  const int f_lo = z * kFrag / splits, f_hi = (z + 1) * kFrag / splits;
  for (int f = f_lo + tid; f < f_hi; f += kThreads) {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < splits; ++r) {
      const float4* rs = cluster.map_shared_rank(slots, r);
      const int nq = (int)((int64_t)(r + 1) * NQ / splits) -
                     (int)((int64_t)r * NQ / splits);
      for (int q = 0; q < nq; ++q) {
        const float4 x = rs[q * kFrag + f];
        v[0] = __fadd_rn(v[0], x.x), v[1] = __fadd_rn(v[1], x.y);
        v[2] = __fadd_rn(v[2], x.z), v[3] = __fadd_rn(v[3], x.w);
      }
    }
    store(f / kThreads, f % kThreads, v);
  }
  cluster.sync();  // no rank leaves while another reads its slots
}

#define FSCL_WINDOW_CLR_PARAMS                                               \
  const T *__restrict__ ps, const int32_t *__restrict__ bounds,             \
      const float *__restrict__ fbar,                                       \
      const __nv_bfloat16 *__restrict__ pack, float *__restrict__ out,      \
      int C, int NC, int P, int R, int64_t n_rows, int A, int A_pack,       \
      int splits
#define FSCL_WINDOW_CLR_ARGS \
  ps, bounds, fbar, pack, out, C, NC, P, R, n_rows, A, A_pack, splits

// The kernel, as many registers a thread as the compiler takes ...
template <typename T, int BN, int UPT>
__global__ void __launch_bounds__(kThreads)
    window_clr_kernel(FSCL_WINDOW_CLR_PARAMS) {
  window_clr_tile<T, BN, UPT>(FSCL_WINDOW_CLR_ARGS);
}

// ... but two blocks an SM at BN = 32 and R <= 64, the permutations'
// tiles: 128 registers a thread.  The int32 kernel took 160 unbounded,
// one block an SM, and a 1,750-block launch 4.99 ms against 3.20 before
// the split; held to 128 it spills 4 bytes and takes 3.27 (PERF.md).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    window_clr_kernel(FSCL_WINDOW_CLR_PARAMS) {
  window_clr_tile<T, 32, 2>(FSCL_WINDOW_CLR_ARGS);
}

// The wide variant, 128 < R <= 256: two K steps a cell (above).
template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
    window_clr_kernel_wide(FSCL_WINDOW_CLR_PARAMS) {
  window_clr_tile<T, BN, 4, true>(FSCL_WINDOW_CLR_ARGS);
}
#undef FSCL_WINDOW_CLR_PARAMS
#undef FSCL_WINDOW_CLR_ARGS

int cell_chunks(int NC) { return (NC + kCellChunk - 1) / kCellChunk; }

int pick_bn(int A) { return A <= 32 ? 32 : 128; }

constexpr int kWideR = 128;  // the widest R walked in one K step a cell

// lanes of one K step, rounded up to 16: R's, or past kWideR the first
// half of its 8-lane groups'
int step_r16(int R) {
  const int lanes = R <= kWideR ? R : 8 * ((R / 8 + 1) / 2);
  return (lanes + 15) & ~15;
}

// the rings and, at BN = 32, a slot of 64 x BN float32 sums: the running
// total, or, split, one for each run of cells a split walks
size_t smem_bytes(int R, int BN, int NC, int splits) {
  const int R16 = step_r16(R);
  const int slots =
      BN != 32 ? 0 : splits > 1 ? (cell_chunks(NC) + splits - 1) / splits : 1;
  return (size_t)2 * (2 * kBM * (2 * R16 + kPad) +
                      2 * R16 * 2 * (BN + kPad)) +
         (size_t)slots * kBM * BN * 4;
}

// The split count, at BN = 32 only: 1 from two waves of blocks up;
// below, the count s that walks the fewest runs of cells end to end:
// waves of ceil(NQ / s) runs and, split, one run more for the prologue
// and the cluster's reduction (the smallest such s), at most kClusterMax,
// with each split walking at least kMinCells cells.  A wave is the blocks
// the SMs hold: b an SM, two by registers at R <= 64 (one above) or fewer
// where the slots' shared memory does not fit two; split, whole clusters
// of s blocks a GPC, floor(16 b / s) of them (the H100's cudaOccupancy-
// MaxActiveClusters reads 224-248 blocks at b = 2, s = 3-8).
int splits_for(int64_t M, int NC, int R, int A, int n_sm) {
  const int BN = pick_bn(A);
  const int64_t blocks = (M + kBM - 1) / kBM * ((A + BN - 1) / BN);
  auto wave = [&](int s) {
    const int64_t b = std::min<int64_t>(
        R <= 64 ? 2 : 1, kSmemSM / (smem_bytes(R, BN, NC, s) + 1024));
    return s == 1 ? n_sm * b : n_sm / kGpcSMs * (kGpcSMs * b / s) * s;
  };
  if (BN != 32 || blocks >= 2 * wave(1)) return 1;
  const int NQ = cell_chunks(NC);
  auto cost = [&](int s) {
    const int64_t w = wave(s);
    return (blocks * s + w - 1) / w * ((NQ + s - 1) / s + (s > 1));
  };
  int best = 1;
  for (int s = 2; s <= kClusterMax && s <= NC / kMinCells && s <= NQ; ++s)
    if (smem_bytes(R, BN, NC, s) <= (size_t)kSmemMax && wave(s) > 0 &&
        cost(s) < cost(best))
      best = s;
  return best;
}

template <typename T, int BN, int UPT, bool kWide = false>
int launch(const void* ps, const void* bounds, const void* fbar,
           const void* pack, void* out, int C, int NC, int P, int R,
           int64_t n_rows, int A, int A_pack, int splits, cudaStream_t st) {
  void (*kern)(const T*, const int32_t*, const float*, const __nv_bfloat16*,
               float*, int, int, int, int, int64_t, int, int, int);
  if constexpr (kWide)
    kern = window_clr_kernel_wide<T, BN>;
  else if constexpr (BN == 32 && UPT == 2)
    kern = window_clr_kernel<T>;
  else
    kern = window_clr_kernel<T, BN, UPT>;
  const size_t smem = smem_bytes(R, BN, NC, splits);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t M = (int64_t)C * P;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((M + kBM - 1) / kBM),
                     (unsigned)((A + BN - 1) / BN), (unsigned)splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = (unsigned)splits;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, (const T*)ps, (const int32_t*)bounds,
                         (const float*)fbar, (const __nv_bfloat16*)pack,
                         (float*)out, C, NC, P, R, n_rows, A, A_pack, splits);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* ps, const void* bounds, const void* fbar,
             const void* pack, void* out, int C, int NC, int P, int R,
             int64_t n_rows, int A, int A_pack, int splits, cudaStream_t st) {
  // units of 8 lanes: 8*R per block over 256 threads
#define FSCL_LAUNCH(BN, UPT)                                                 \
  launch<T, BN, UPT>(ps, bounds, fbar, pack, out, C, NC, P, R, n_rows, A,   \
                     A_pack, splits, st)
  const bool wide = R > 64;
  if (R > kWideR)
    return pick_bn(A) == 32
               ? launch<T, 32, 4, true>(ps, bounds, fbar, pack, out, C, NC, P,
                                        R, n_rows, A, A_pack, splits, st)
               : launch<T, 128, 4, true>(ps, bounds, fbar, pack, out, C, NC,
                                         P, R, n_rows, A, A_pack, splits, st);
  if (pick_bn(A) == 32) return wide ? FSCL_LAUNCH(32, 4) : FSCL_LAUNCH(32, 2);
  return wide ? FSCL_LAUNCH(128, 4) : FSCL_LAUNCH(128, 2);
#undef FSCL_LAUNCH
}

}  // namespace

extern "C" {

// The split over cells that fscl_window_clr takes for c*P = M rows
// (1 = none).  n_sm: the card's SM count.
int fscl_window_clr_splits(int64_t M, int NC, int R, int A, int n_sm) {
  if (M <= 0 || A <= 0 || NC < 1 || R < 8 || R > 2 * kWideR || n_sm < 1)
    return 1;
  return splits_for(M, NC, R, A, n_sm);
}

// ps [n_rows, P*R] of dtype_code 0 = int16, 1 = int32, 2 = float32,
// 16-byte aligned; bounds [C, 2, NC+1] int32 rows of ps; fbar [C, 2, NC]
// f32; pack [2*NC*R, A_pack] bf16, 16-byte aligned, A_pack >= A a
// multiple of 8; out [C, P, A] f32.  R a multiple of 8, at most 256 (past
// 128 the wide variant);
// NC >= 1; 1 <= splits <= min(ceil(NC / 8), 8), the blocks of a tile's
// splits one cluster, their slots within a block's shared memory.
// Returns the launch's CUDA error (0 = success); nothing to compute is
// success without a launch.
int fscl_window_clr(const void* ps, const void* bounds, const void* fbar,
                    const void* pack, void* out, int C, int NC, int P, int R,
                    int64_t n_rows, int dtype_code, int A, int A_pack,
                    int splits, void* stream) {
  if ((int64_t)C * P == 0 || A == 0) return 0;
  if (NC < 1 || R < 8 || R > 2 * kWideR || R % 8 || A_pack < A ||
      A_pack % 8 ||
      splits < 1 || splits > kClusterMax || splits > cell_chunks(NC) ||
      (splits > 1 && pick_bn(A) != 32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype_code) {
    case 0:
      return dispatch<int16_t>(ps, bounds, fbar, pack, out, C, NC, P, R,
                               n_rows, A, A_pack, splits, st);
    case 1:
      return dispatch<int32_t>(ps, bounds, fbar, pack, out, C, NC, P, R,
                               n_rows, A, A_pack, splits, st);
    case 2:
      return dispatch<float>(ps, bounds, fbar, pack, out, C, NC, P, R,
                             n_rows, A, A_pack, splits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
