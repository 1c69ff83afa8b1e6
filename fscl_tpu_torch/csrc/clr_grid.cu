// The CLR of every (candidate, alpha) pair at arbitrary sweep strengths,
// for Hopper: one call is two launches, the sums of site slices and their
// sum in slice order.
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
// 17 and a table gather at an address that depends on the term, one
// outside it 2.  The table ([R*G] float32: 0.5 MB at 56 rows and G =
// 2048) stays in L1 and L2.  At whole-chromosome windows the kernel is
// bound by the issue of its dependent per-term chain, not by the lanes'
// rate; where the grid has few blocks, by the length of one warp's chain
// of sites.  PR 12's first version (tools/clr_grid_baseline.cu) ran at
// 9-19% of its operation bound at whole-chromosome windows and at 0.1% at
// the C-parity oracle's 200-point call (7 blocks).
//
// Design (tools/clr_grid_variants.py builds each lever out):
//  (a) Site slices.  The site index space is cut into slices of kSlice =
//      1,024 sites at multiples of kSlice.  A block takes (32 consecutive
//      candidates, one lane each; one slice of their windows; a tile of
//      up to 16 alphas), so the grid has groups x slices x tiles blocks
//      at any P and A.  It writes its candidates' slice sums to part
//      [slices, P, A] (slice k of p is absolute slice lo[p] / kSlice +
//      k); the second launch adds them in slice order.  Inside a slice,
//      site w is in stream w mod 32; a stream's terms add in increasing
//      w, the 32 stream sums in stream order; a block has 32 warps, one
//      a stream (FSCL_CLR_GRID_WARPS = 8 or 16 gives a warp 4 or 2
//      streams in turn, the same sums).  So an entry's float32 sum
//      depends only on its window, its alpha and the data: not on P, A,
//      the other candidates of its group, the tile or the warps, and
//      repeat launches are bitwise equal.  No atomics.
//  (c) The site stream staged.  The sites of the block's walk (the union
//      of its lanes' windows in the slice, at most a slice: pos, row and
//      null, 12 bytes a site) come into shared memory by cp.async, all
//      in flight at once, before the walk; the 32 warps then read them
//      there, and only the table reads stay in the dependent chain.
//  (g) The alpha loop cut short.  Where a tile's alphas ascend (the
//      coarse grid, every fine grid), fl(logf(d) + lalpha) does too, so a
//      pair's terms are inside the mask up to its first alpha outside it
//      and outside from there on: the loop stops there, the same terms.
//  Alpha tiles: 16 alphas and their sums in registers, at any A.
//  Tried and left out: the walk cut to the smallest alpha's reach (a
//  bisection of pos per lane; with (g) in place it cost more than it
//  saved at most shapes), lanes as the sites of one candidate (another
//  sum order; slower at whole-chromosome windows), the floor without
//  conversions (same bits, no faster: the conversions do not set the
//  pace), 8-byte pair reads, two sites a step, several slices a block.
//
// Measured (tools/clr_grid_variants.py, NVIDIA H100 80GB HBM3, 700 W;
// PERF.md section 6): against the first version, about 2x faster at the
// 20k dense grid (36% of the operation bound at the coarse alphas), 4x
// at genome1m's 10,010 points, 39-45x at the oracle's 200 points and
// 4-5x on the flagship problem.  Taken out one at a time: (a) costs
// 6-54% at the big calls and 12-13x at the oracle, (c) 3-14% at the big
// calls, (g) 26-44%; 8 warps a block 1.4-1.6x at the big calls and
// 2.6-2.8x on the flagship problem.  A tile of one alpha at A = 1 was
// no faster than the tile of 16.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "tile_copy.cuh"

#ifndef FSCL_CLR_GRID_SLICE
#define FSCL_CLR_GRID_SLICE 1024
#endif
#ifndef FSCL_CLR_GRID_WARPS  // warps a block: 8, 16 or 32
#define FSCL_CLR_GRID_WARPS 32
#endif
#ifndef FSCL_CLR_GRID_ASCENDING
#define FSCL_CLR_GRID_ASCENDING 1
#endif
#ifndef FSCL_CLR_GRID_STAGED
#define FSCL_CLR_GRID_STAGED 1
#endif

namespace {

using fscl::cp_async4;
using fscl::cp_async_commit;
using fscl::cp_async_wait_all;

constexpr int kSlice = FSCL_CLR_GRID_SLICE;
constexpr int kStreams = 32;  // a slice's streams: site w in w mod 32
constexpr int kGroup = 32;  // candidates a block, one a lane
constexpr int kTileA = 16;
constexpr int kWarps = FSCL_CLR_GRID_WARPS;
constexpr float kLogAdMin = -20.0f;  // fscl_tpu_torch LOG_AD_MIN
constexpr float kLogAdMax = 4.0f;    // LOG_AD_MAX
static_assert(kSlice >= kStreams && kSlice % kStreams == 0,
              "slices of whole streams");
static_assert(kStreams % kWarps == 0, "whole streams a warp");

// y - null of one term inside the mask (x <= LOG_AD_MAX); G >= 2
__device__ __forceinline__ float term(const float* __restrict__ table,
                                      int base, float x, float inv_step,
                                      int G, float nl) {
  const float u = __fmul_rn(__fsub_rn(x, kLogAdMin), inv_step);
  int i = (int)u;
  i = i < 0 ? 0 : (i > G - 2 ? G - 2 : i);
  const float frac = fminf(fmaxf(__fsub_rn(u, (float)i), 0.0f), 1.0f);
  const float v0 = __ldg(table + base + i);
  const float v1 = __ldg(table + base + i + 1);
  const float y =
      __fmaf_rn(v0, __fsub_rn(1.0f, frac), __fmul_rn(v1, frac));
  return __fsub_rn(y, nl);
}

// The candidate's alphas of a block's tile, la[0, na), and whether they
// ascend, (g) (NaN: no).
template <int TA>
__device__ __forceinline__ void tile_alphas(const float* __restrict__ lalpha,
                                            int p, int A, int paired, int a0,
                                            int na, bool mine,
                                            float (&la)[TA], bool& ascending) {
  const float* my_la = lalpha + (paired ? (int64_t)p * A : 0) + a0;
#pragma unroll
  for (int t = 0; t < TA; ++t)
    la[t] = (mine && t < na) ? __ldg(my_la + t) : 0.0f;
  ascending = FSCL_CLR_GRID_ASCENDING;
#pragma unroll
  for (int t = 1; t < TA; ++t)
    if (t < na) ascending = ascending && la[t - 1] <= la[t];
}

// A (candidate, site) pair's terms into acc[t], alpha by alpha, stopping
// at the first alpha outside the mask where the alphas ascend (g).
template <int TA>
__device__ __forceinline__ void add_pair(
    float (&acc)[TA], const float (&la)[TA], int na, bool ascending,
    int pw, int c_pos, int base, float nl, const float* __restrict__ table,
    float inv_step, int G) {
  int d = pw - c_pos;
  d = d < 0 ? -d : d;
  d = d < 1 ? 1 : d;
  const float logd = logf((float)d);
#pragma unroll
  for (int t = 0; t < TA; ++t) {
    if (t < na) {
      const float x = __fadd_rn(logd, la[t]);
      if (x <= kLogAdMax)
        acc[t] = __fadd_rn(acc[t], term(table, base, x, inv_step, G, nl));
      else if (ascending)
        break;
    }
  }
}

// The sites [wa, wb] (at most a slice, block-uniform) for the walk: from
// shared memory, copied there first by cp.async, (c); else (built with
// FSCL_CLR_GRID_STAGED = 0) from global memory.
struct SiteStream {
#if FSCL_CLR_GRID_STAGED
  const int* s_pos;
  const int* s_row;
  const float* s_null;
  int wa;
  __device__ int pos(int w) const { return s_pos[w - wa]; }
  __device__ int row(int w) const { return s_row[w - wa]; }
  __device__ float null(int w) const { return s_null[w - wa]; }
#else
  const int32_t* p;
  const int32_t* r;
  const float* n;
  __device__ int pos(int w) const { return __ldg(p + w); }
  __device__ int row(int w) const { return __ldg(r + w); }
  __device__ float null(int w) const { return __ldg(n + w); }
#endif
};

__device__ __forceinline__ SiteStream site_stream(
    const int32_t* __restrict__ pos, const int32_t* __restrict__ row,
    const float* __restrict__ null, int wa, int wb, int threads) {
#if FSCL_CLR_GRID_STAGED
  __shared__ int s_pos[kSlice];
  __shared__ int s_row[kSlice];
  __shared__ float s_null[kSlice];
  if (wa <= wb) {
    for (int w = wa + (int)threadIdx.x; w <= wb; w += threads) {
      cp_async4(s_pos + (w - wa), pos + w);
      cp_async4(s_row + (w - wa), row + w);
      cp_async4(s_null + (w - wa), null + w);
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  return SiteStream{s_pos, s_row, s_null, wa};
#else
  (void)wa;
  (void)wb;
  (void)threads;
  return SiteStream{pos, row, null};
#endif
}

// grid: (ceil(P / 32), group slices, alpha tiles), W warps a block; lanes
// are candidates, warp g walks the streams g, g + W, ... of the slice
template <int TA, int W>
__global__ void __launch_bounds__(32 * W)
    clr_grid_partials(const float* __restrict__ table,
                      const int32_t* __restrict__ row,
                      const int32_t* __restrict__ pos,
                      const float* __restrict__ null,
                      const int32_t* __restrict__ cand,
                      const int32_t* __restrict__ lo,
                      const int32_t* __restrict__ hi,
                      const float* __restrict__ lalpha,
                      float* __restrict__ part, int P, int A, int paired,
                      int G, float inv_step) {
  // the stream sums [kStreams][32][TA + 1] (dynamic, 70 KB at TA = 16),
  // padded against bank conflicts; each lane's candidate's slice index k
  // (-1: not in this slice)
  extern __shared__ float red_smem[];
  auto red = reinterpret_cast<float(*)[32][TA + 1]>(red_smem);
  __shared__ int slot[32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * 32 + lane;
  const int c_lo = p < P ? __ldg(lo + p) : 1;
  const int c_hi = p < P ? __ldg(hi + p) : 0;
  const bool live = c_lo <= c_hi;
  // the group's slices (every warp holds the same 32 candidates)
  int s_first = live ? c_lo / kSlice : INT_MAX;
  int s_last = live ? c_hi / kSlice : -1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s_first = min(s_first, __shfl_xor_sync(0xffffffffu, s_first, o));
    s_last = max(s_last, __shfl_xor_sync(0xffffffffu, s_last, o));
  }
  const int s = s_first + (int)blockIdx.y;
  if (s_first > s_last || s > s_last) return;  // block-uniform
  const int w0 = s * kSlice;
  // the lane's sites of this slice, [a, b] (a > b: none; so too where
  // the lane's window is padded, as c_lo = 1 > c_hi = 0 then)
  const int a = max(c_lo, w0), b = min(c_hi, w0 + kSlice - 1);
  const bool in_slice = a <= b;

  const int a0 = blockIdx.z * TA;
  const int na = min(TA, A - a0);
  float la[TA];
  bool ascending;
  tile_alphas(lalpha, p, A, paired, a0, na, in_slice, la, ascending);
  const int c_pos = in_slice ? __ldg(cand + p) : 0;
  // the block's walk: the union of its lanes' sites of the slice
  int wa = in_slice ? a : INT_MAX, wb = in_slice ? b : -1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wa = min(wa, __shfl_xor_sync(0xffffffffu, wa, o));
    wb = max(wb, __shfl_xor_sync(0xffffffffu, wb, o));
  }
  if (warp == 0) slot[lane] = in_slice ? s - c_lo / kSlice : -1;

  const SiteStream site = site_stream(pos, row, null, wa, wb, 32 * W);
#pragma unroll 1
  for (int j = warp; j < kStreams; j += W) {
    float acc[TA];
#pragma unroll
    for (int t = 0; t < TA; ++t) acc[t] = 0.0f;
    if (wa <= wb) {
      for (int w = wa + ((j - wa) & (kStreams - 1)); w <= wb; w += kStreams)
        if (w >= a && w <= b)
          add_pair(acc, la, na, ascending, site.pos(w), c_pos,
                   site.row(w) * G, site.null(w), table, inv_step, G);
    }
#pragma unroll
    for (int t = 0; t < TA; ++t) red[j][lane][t] = acc[t];
  }
  __syncthreads();
  for (int x = threadIdx.x; x < 32 * TA; x += 32 * W) {
    const int l = x / TA, t = x - l * TA;
    const int k = slot[l];
    if (k >= 0 && t < na) {
      float sum = red[0][l][t];
#pragma unroll
      for (int j = 1; j < kStreams; ++j) sum = __fadd_rn(sum, red[j][l][t]);
      part[((int64_t)k * P + blockIdx.x * 32 + l) * A + a0 + t] = sum;
    }
  }
}

// out[p, a] = 2 * (the slice sums of p's window, in slice order); 0 where
// lo > hi
__global__ void clr_grid_reduce(const float* __restrict__ part,
                                const int32_t* __restrict__ lo,
                                const int32_t* __restrict__ hi,
                                float* __restrict__ out, int P, int A) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)P * A) return;
  const int p = (int)(e / A);
  const int l = __ldg(lo + p), h = __ldg(hi + p);
  float s = 0.0f;
  if (l <= h) {
    const int n = h / kSlice - l / kSlice + 1;
    for (int k = 0; k < n; ++k)
      s = __fadd_rn(s, __ldg(part + (int64_t)k * P * A + e));
  }
  out[e] = __fmul_rn(2.0f, s);
}

template <int TA = kTileA, int W = kWarps>
cudaError_t launch_partials(dim3 grid, cudaStream_t st, const void* table,
                            const void* row, const void* pos,
                            const void* null,
                            const void* cand, const void* lo, const void* hi,
                            const void* lalpha, void* part, int P, int A,
                            int paired, int G, float inv_step) {
  constexpr int kThreads = 32 * W;
  constexpr int kSmem = kStreams * 32 * (TA + 1) * (int)sizeof(float);
  const cudaError_t opt_in = cudaFuncSetAttribute(
      clr_grid_partials<TA, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (opt_in != cudaSuccess) return opt_in;
  clr_grid_partials<TA, W><<<grid, kThreads, kSmem, st>>>(
      (const float*)table, (const int32_t*)row,
      (const int32_t*)pos, (const float*)null, (const int32_t*)cand,
      (const int32_t*)lo, (const int32_t*)hi, (const float*)lalpha,
      (float*)part, P, A, paired, G, inv_step);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The slice width in sites and the candidates a block, for the slice plan
// (ops/clr.py clr_grid_plan).
int fscl_clr_grid_slice_sites() { return kSlice; }
int fscl_clr_grid_group() { return kGroup; }

// table [R*G] f32 (R*G + 1 < 2^31); row [W] int32 table rows; pos [W]
// int32; null [W] f32; cand, lo, hi [P] int32 (windows inside [0, W));
// lalpha [A] f32 (paired = 0) or [P, A] (paired = 1); part [slices_max,
// P, A] f32 scratch, slices_max the most slices one window meets; out
// [P, A] f32; 2 <= G <= 2^22; inv_step = (G-1) / (LOG_AD_MAX -
// LOG_AD_MIN) rounded to float32; group_slices the most slices the
// windows of one group of fscl_clr_grid_group() candidates meet (0: no
// live window).  Returns the launches' CUDA error (0 = success).
int fscl_clr_grid(const void* table, const void* row, const void* pos,
                  const void* null, const void* cand, const void* lo,
                  const void* hi, const void* lalpha,
                  void* part, void* out, int P, int A, int paired, int G,
                  float inv_step, int group_slices, void* stream) {
  if ((int64_t)P * A == 0) return 0;
  if (G < 2 || G > (1 << 22) || group_slices < 0 || group_slices > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((P + kGroup - 1) / kGroup),
                  (unsigned)group_slices,
                  (unsigned)((A + kTileA - 1) / kTileA));
  if (grid.z > 65535) return (int)cudaErrorInvalidValue;
  if (group_slices > 0) {
    const cudaError_t err =
        launch_partials(grid, st, table, row, pos, null, cand, lo, hi,
                        lalpha, part, P, A, paired, G, inv_step);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t n = (int64_t)P * A;
  clr_grid_reduce<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const float*)part, (const int32_t*)lo, (const int32_t*)hi,
      (float*)out, P, A);
  return (int)cudaGetLastError();
}

}  // extern "C"
