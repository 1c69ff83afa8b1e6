// The CLR of every (candidate, alpha) pair at arbitrary sweep strengths,
// for Hopper: one launch per call.
//
// Replaces fscl_tpu/ops/clr.py:88-166 clr_grid, which the JAX package
// leaves to XLA (a lax.scan over candidate chunks, each a [C, W, A]
// masked interpolation of the table over all W sites, summed; no Pallas
// kernel).  For candidate p and alpha a (lalpha[a] shared, or lalpha[p, a]
// paired):
//
//   d    = max(|pos[w] - cand[p]|, 1)
//   x    = logf(d) + lalpha[., a]
//   u    = (x - LOG_AD_MIN) * inv_step
//   i    = clamp((int)u, 0, G-2);  frac = clamp(u - i, 0, 1)
//   y    = fma(v0, 1 - frac, v1 * frac),  v0, v1 = table[row[w]*G + i (+1)]
//   out[p, a] = 2 * sum_{w = lo[p]..hi[p], x <= LOG_AD_MAX} (y - null[w])
//
// in float32, y one fused multiply-add (XLA's CPU build fuses
// fscl_tpu's v0 * (1 - frac) + v1 * frac so; the plain PyTorch version
// rounds the exact float64 value once), every other operation rounded on
// its own (__fadd_rn and friends, so nvcc contracts nothing else), logf
// and not __logf: a term is the plain version's bit for bit; only the
// order of the sums differs.  The JAX package evaluates all W sites of a
// candidate and masks the ones outside its window; here only the windows
// are walked, the same set of terms (lo > hi gives exactly 0).
//
// What bounds it on the H100.  A (candidate, site) pair costs one logf
// and about 8 lane operations; a term (pair, alpha) inside the mask about
// 17 and two 4-byte table reads at an address that depends on the term,
// one outside it 2.  The table ([R*G] float32: 0.5 MB at 56 rows and G =
// 2048, 13 MB at mixed100k's 1,589 rows) stays in L2; what the L1 can
// serve is the limit if the 32 lanes of a warp read 32 different lines.
// This version runs at 9-20% of its operation bound at whole-chromosome
// windows (PERF.md §6), and far below it where the grid has few blocks.
//
// Design (a simple kernel first; no tuning yet):
//  (a) Lanes are candidates.  A warp holds C consecutive candidates (C =
//      32, or 1 for checks), one a lane, and walks a site at a time: the
//      site's pos, row and null are one broadcast load a warp, and
//      neighbouring candidates (1 kb apart on the scan grid) read nearly
//      the same log distance at a far site, so the warp's table reads of
//      one alpha fall on one or two lines.
//  (b) Sites split over the block's kWarps warps: site w goes to warp w
//      mod kWarps, whatever C, the block or the grid; each warp sums its
//      sites of a window in increasing order, and the kWarps partial sums
//      add in warp order at the end.  An entry's float32 sum depends only
//      on its window and the data in it, not on C, P, the other
//      candidates of its block or the alpha tile; no atomics, so launches
//      repeat bitwise.
//  (c) Register accumulators.  A lane keeps up to kTileA = 16 alphas and
//      their sums in registers; A > 16 runs as gridDim.y alpha tiles of
//      16 (the last one partial), each walking the windows again.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileA = 16;
constexpr float kLogAdMin = -20.0f;  // fscl_tpu_torch LOG_AD_MIN
constexpr float kLogAdMax = 4.0f;    // LOG_AD_MAX

// grid: (ceil(P / C), ceil(A / kTileA))
__global__ void __launch_bounds__(kThreads)
    clr_grid_kernel(const float* __restrict__ table,
                    const int32_t* __restrict__ row,
                    const int32_t* __restrict__ pos,
                    const float* __restrict__ null,
                    const int32_t* __restrict__ cand,
                    const int32_t* __restrict__ lo,
                    const int32_t* __restrict__ hi,
                    const float* __restrict__ lalpha,
                    float* __restrict__ out, int P, int A, int paired, int G,
                    float inv_step, int C) {
  // the warps' partial sums [kWarps][32][kTileA], padded against bank
  // conflicts; the block's window span
  __shared__ float part[kWarps][32][kTileA + 1];
  __shared__ int span[2];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * C + lane;
  const bool mine = lane < C && p < P;
  const int a0 = blockIdx.y * kTileA;
  const int na = min(kTileA, A - a0);
  const int c_pos = mine ? __ldg(cand + p) : 0;
  const int c_lo = mine ? __ldg(lo + p) : 1;
  const int c_hi = mine ? __ldg(hi + p) : 0;

  // the union of the live windows (warp 0: one candidate a lane)
  if (warp == 0) {
    int first = c_lo <= c_hi ? c_lo : INT_MAX;
    int last = c_lo <= c_hi ? c_hi : -1;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      first = min(first, __shfl_xor_sync(0xffffffffu, first, s));
      last = max(last, __shfl_xor_sync(0xffffffffu, last, s));
    }
    if (lane == 0) {
      span[0] = first;
      span[1] = last;
    }
  }

  float la[kTileA], acc[kTileA];
  const float* my_la = lalpha + (paired ? (int64_t)p * A : 0) + a0;
#pragma unroll
  for (int a = 0; a < kTileA; ++a) {
    la[a] = (mine && a < na) ? __ldg(my_la + a) : 0.0f;
    acc[a] = 0.0f;
  }
  __syncthreads();
  const int first = span[0], last = span[1];

  // this warp's sites: w = warp (mod kWarps), from the first at or past
  // the span's start (no site where every window is empty)
  const int start =
      first <= last ? first + ((warp - first) % kWarps + kWarps) % kWarps
                    : 1;
  for (int w = start; w <= last; w += kWarps) {
    const int pw = __ldg(pos + w);
    const int base = __ldg(row + w) * G;
    const float nl = __ldg(null + w);
    if (w < c_lo || w > c_hi) continue;
    int d = pw - c_pos;
    d = d < 0 ? -d : d;
    d = d < 1 ? 1 : d;
    const float logd = logf((float)d);
#pragma unroll
    for (int a = 0; a < kTileA; ++a) {
      if (a < na) {
        const float x = __fadd_rn(logd, la[a]);
        if (x <= kLogAdMax) {
          const float u = __fmul_rn(__fsub_rn(x, kLogAdMin), inv_step);
          int i = (int)u;
          i = i < 0 ? 0 : (i > G - 2 ? G - 2 : i);
          const float frac =
              fminf(fmaxf(__fsub_rn(u, (float)i), 0.0f), 1.0f);
          const float v0 = __ldg(table + base + i);
          const float v1 = __ldg(table + base + i + 1);
          const float y = __fmaf_rn(v0, __fsub_rn(1.0f, frac),
                                    __fmul_rn(v1, frac));
          acc[a] = __fadd_rn(acc[a], __fsub_rn(y, nl));
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kTileA; ++a) part[warp][lane][a] = acc[a];
  __syncthreads();
  for (int x = threadIdx.x; x < C * kTileA; x += kThreads) {
    const int l = x / kTileA, a = x - l * kTileA;
    const int q = blockIdx.x * C + l;
    if (q < P && a < na) {
      float s = part[0][l][a];
#pragma unroll
      for (int g = 1; g < kWarps; ++g) s = __fadd_rn(s, part[g][l][a]);
      out[(int64_t)q * A + a0 + a] = __fmul_rn(2.0f, s);
    }
  }
}

}  // namespace

extern "C" {

// table [R*G] f32 (R*G + 1 < 2^31); row [W] int32 table rows; pos [W]
// int32; null [W] f32; cand, lo, hi [P] int32 (windows inside [0, W));
// lalpha [A] f32 (paired = 0) or [P, A] (paired = 1); out [P, A] f32;
// G >= 2; inv_step = (G-1) / (LOG_AD_MAX - LOG_AD_MIN) rounded to
// float32; cands (1 to 32) candidates a warp.  Returns the launch's CUDA
// error (0 = success).
int fscl_clr_grid(const void* table, const void* row, const void* pos,
                  const void* null, const void* cand, const void* lo,
                  const void* hi, const void* lalpha, void* out, int P,
                  int A, int paired, int G, float inv_step, int cands,
                  void* stream) {
  if ((int64_t)P * A == 0) return 0;
  if (cands < 1 || cands > 32 || G < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((P + cands - 1) / cands),
                  (unsigned)((A + kTileA - 1) / kTileA));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  clr_grid_kernel<<<grid, kThreads, 0, st>>>(
      (const float*)table, (const int32_t*)row, (const int32_t*)pos,
      (const float*)null, (const int32_t*)cand, (const int32_t*)lo,
      (const int32_t*)hi, (const float*)lalpha, (float*)out, P, A, paired,
      G, inv_step, cands);
  return (int)cudaGetLastError();
}

}  // extern "C"
