// The per-site lattice CLR for Hopper: every (replicate, candidate,
// lattice offset) of one alpha stage in one launch.
//
// Replaces fscl_tpu/ops/lattice.py:94-155 clr_lattice, which the JAX
// package leaves to XLA (a lax.scan over candidate chunks, each a [C, W,
// 2A] gather of lerp pairs, masked and summed; no Pallas kernel).  For
// replicate r, candidate p and offset a (pack rows of 2A floats, the
// lerp pair of offset a at 2a, 2a+1):
//
//   u    = logf(max(|pos[w] - cand[p]|, 1)) * inv_step + m_base[r, p]
//   i0   = clamp((int)u, 0, G-1);  frac = clamp(u - i0, 0, 1)
//   y    = v0 + (v1 - v0) * frac,  (v0, v1) = pack[row[r, w]*G + i0, 2a..]
//   out[r, p, a] = 2 * sum_{w = lo[p]..hi[p], u + m_rel[a] <= G-1}
//                  (y - null[r, w])
//
// all in float32, u and the lerp each one fused multiply-add (XLA fuses
// fscl_tpu's expressions so; the plain PyTorch version rounds the exact
// float64 values once), every other operation rounded on its own
// (__fadd_rn and friends, so nvcc contracts nothing else), logf and not
// __logf: a site's contribution is the plain version's bit for bit; only
// the order of the sums differs.  The JAX package computes all W sites of a
// candidate and masks the ones outside its window; here only the windows
// are walked, the same set of contributions (a dummy candidate, lo = 1
// and hi = 0, gives exactly 0).
//
// What bounds it on the H100 (no hardware counters on the card used: a
// reckoning from the instruction mix and tools/lattice_variants.py's
// ablations).  A (candidate, site) pair does one logf, reads one pack row
// of 2A floats at an address that depends on the pair, and spends about
// 6 lane operations an offset on the lerp, the mask and the sum: about 5
// warp instructions a pair in all, 1.3 SM clocks at the card's 4 a clock,
// and a 96- or 128-byte row through the L1, which returns 128 bytes a
// clock.  Issue and the L1 share the limit; this kernel runs at about 2
// SM clocks a pair.  The first version read a row in one thread, so one
// warp-wide load touched up to 32 rows, 8-11 loads a pair (6.5-8 SM
// clocks a pair).
//
// Design:
//  (a) Whole rows read by a lane group.  A kernel pack row holds AP
//      offsets (the coarse pack padded from 11 to AP = 12 by the wrapper,
//      so a row is 96 bytes and 16-byte aligned; 16 offsets are 128
//      bytes).  At AP = 12, 6 lanes each load one float4 (two offsets),
//      5 rows a warp-wide load; at AP = 16, 4 lanes each load two, 8
//      rows.  A lane keeps one sum an offset and candidate.
//  (b) Site values once a pair.  Each tile, the block stages u, frac and
//      the pack row of every (candidate, site) pair in shared memory, one
//      thread a pair (one logf), and a lane group reads them with one
//      broadcast 16-byte shared load.
//  (c) Neighbouring candidates share a site.  A block takes C consecutive
//      candidates of one replicate and walks the union of their windows,
//      a tile of sites at a time; a lane group takes a site for all C
//      candidates in turn, a candidate outside its window masked (u =
//      +inf: every mask fails).  Candidates 1 kb apart mostly read the
//      same pack row (a far site's log distance barely moves), and a
//      group keeps the row it holds where the next candidate's pair reads
//      the same.  The wrapper takes C = 4 where that still gives 8 blocks
//      an SM, else 1.
//  The mask u + m_rel <= G-1 is tested as u <= the largest float t with
//  fl(t + m_rel) <= G-1 (mask_limit, once a block): the same bits, one
//  compare where there were an add and a compare.
//
// Sums.  Site w goes to lane group w mod NG (NG lane groups a block,
// fixed for a row width), whatever the tile, the block or C; each group
// sums its sites of the window in increasing order, and the NG partial
// sums add in group order at the end.  An entry's float32 sum depends
// only on its window and the attributes in it, not on Rr, P, C, the other
// candidates of its block or the grid; no atomics, so launches repeat
// bitwise.
//
// Ablations (tools/lattice_variants.py rebuilds with them):
// FSCL_LATTICE_STAGED=0 takes lever (b) out (every lane computes its
// pair's values); FSCL_LATTICE_COARSE_ROW=16 pads the coarse pack to 16
// offsets; FSCL_LATTICE_VARIANTS also builds C = 8 and 16.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#ifndef FSCL_LATTICE_STAGED
#define FSCL_LATTICE_STAGED 1
#endif
#ifndef FSCL_LATTICE_COARSE_ROW
#define FSCL_LATTICE_COARSE_ROW 12
#endif

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// Lane groups of a row of AP offsets: AP / kLaneOffsets lanes, kVec
// float4 (two offsets each) a lane: two at AP = 16 (4 lanes a row), one
// at AP = 12 (6 lanes); a tile holds kGroupSites sites a group, 128 or
// 160 sites.
template <int AP>
struct Layout {
  static constexpr int kVec = AP == 16 ? 2 : 1;
  static constexpr int kLaneOffsets = 2 * kVec;
  static_assert(AP % kLaneOffsets == 0, "whole float4 a lane");
  static constexpr int kLanes = AP / kLaneOffsets;
  static constexpr int kGroupsPerWarp = 32 / kLanes;
  static constexpr int kGroups = kWarps * kGroupsPerWarp;
  static constexpr int kGroupSites = 8 / kVec;
  static constexpr int kTile = kGroups * kGroupSites;
};

// (u, frac, pack row, -) of one (candidate, site) pair, the plain
// version's float32 values bit for bit.
__device__ __forceinline__ float4 pair_value(int p, int rw, int c, float mb,
                                             int G, float inv_step) {
  int d = p - c;
  d = d < 0 ? -d : d;
  d = d < 1 ? 1 : d;
  const float u = __fmaf_rn(logf((float)d), inv_step, mb);
  int i0 = (int)u;
  i0 = i0 < 0 ? 0 : (i0 > G - 1 ? G - 1 : i0);
  const float frac = fminf(fmaxf(__fsub_rn(u, (float)i0), 0.0f), 1.0f);
  return make_float4(u, frac, __int_as_float(rw * G + i0), 0.0f);
}

// The largest float t with __fadd_rn(t, m) <= gmax: the rounded sum
// grows with t, so the mask u + m <= G-1 is u <= t.  A binary search over
// the floats in value order (keys), from gmax - m - 2 (holds) to
// gmax - m + 2 (fails); m and gmax are integers below 2^24, so both ends
// are exact.
__device__ float mask_limit(float m, float gmax) {
  auto key = [](float x) -> long long {
    const int b = __float_as_int(x);
    return b >= 0 ? b : (long long)INT_MIN - b;
  };
  auto value = [](long long k) {
    return __int_as_float((int)(k >= 0 ? k : (long long)INT_MIN - k));
  };
  const float edge = __fsub_rn(gmax, m);
  long long lo = key(__fsub_rn(edge, 2.0f)), hi = key(__fadd_rn(edge, 2.0f));
  while (hi - lo > 1) {
    const long long mid = lo + (hi - lo) / 2;
    if (__fadd_rn(value(mid), m) <= gmax) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return value(lo);
}

// a pair outside its candidate's window: every mask fails, row 0 is read
__device__ __forceinline__ float4 outside() {
  return make_float4(INFINITY, 0.0f, __int_as_float(0), 0.0f);
}

// grid: Rr * ceil(P / C) blocks, blockIdx.x = r * ceil(P / C) + tile
template <int A, int AP, int C, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    lattice_clr_kernel(const float4* __restrict__ pack,
                       const int32_t* __restrict__ row,
                       const int32_t* __restrict__ pos,
                       const float* __restrict__ null,
                       const int32_t* __restrict__ cand,
                       const int32_t* __restrict__ lo,
                       const int32_t* __restrict__ hi,
                       const int32_t* __restrict__ m_base,
                       const int32_t* __restrict__ m_rel,
                       float* __restrict__ out, int P, int W, int G,
                       float inv_step) {
  using L = Layout<AP>;
  constexpr int kT = L::kTile, kVec = L::kVec;
  constexpr int kLaneOffsets = L::kLaneOffsets;
  constexpr int kGroupSites = L::kGroupSites;
  // sites a lane group's loads cover at once: 8 float4 in flight a lane
  constexpr int kSitesAtOnce = C >= kGroupSites ? 1 : kGroupSites / C;
  // the tile's pairs [C][kT]; at the end the groups' sums [NG][C][AP]
  __shared__ float4 buf[C * kT];
  __shared__ float site_null[kT];
  __shared__ int c_pos[C], c_lo[C], c_hi[C], span[2];
  __shared__ float c_mb[C];
  static_assert(L::kGroups * C * AP <= 4 * C * kT, "sums fit in buf");

  const int n_blk = (P + C - 1) / C;
  const int64_t r = blockIdx.x / n_blk;
  const int p0 = (int)(blockIdx.x - r * n_blk) * C;
  const int tid = threadIdx.x;
  if (tid < C) {
    const int p = p0 + tid;
    const bool ok = p < P;
    c_pos[tid] = ok ? __ldg(cand + p) : 0;
    c_lo[tid] = ok ? __ldg(lo + p) : 1;
    c_hi[tid] = ok ? __ldg(hi + p) : 0;
    c_mb[tid] = ok ? (float)__ldg(m_base + r * P + p) : 0.0f;
  }
  __syncthreads();
  if (tid == 0) {  // the union of the live windows
    int first = INT_MAX, last = -1;
    for (int k = 0; k < C; ++k) {
      if (c_lo[k] <= c_hi[k]) {
        first = min(first, c_lo[k]);
        last = max(last, c_hi[k]);
      }
    }
    span[0] = first;
    span[1] = last;
  }
  __syncthreads();
  const int first = span[0], last = span[1];

  const int lane = tid & 31, warp = tid >> 5;
  const int gw = lane / L::kLanes;
  const int j = lane - gw * L::kLanes;  // offsets kLaneOffsets * j + o
  const bool busy = gw < L::kGroupsPerWarp;
  const int g = warp * L::kGroupsPerWarp + gw;
  const float gmax = (float)(G - 1);
  float lim[kLaneOffsets];
#pragma unroll
  for (int o = 0; o < kLaneOffsets; ++o) {
    const int a = kLaneOffsets * j + o;
    lim[o] = mask_limit(a < A ? (float)__ldg(m_rel + a) : 0.0f, gmax);
  }
  const int32_t* rrow = row + r * W;
  const float* rnull = null + r * W;
  const float4* packj = pack + kVec * j;

  float acc[C][kLaneOffsets];
#pragma unroll
  for (int k = 0; k < C; ++k) {
#pragma unroll
    for (int o = 0; o < kLaneOffsets; ++o) acc[k][o] = 0.0f;
  }

  for (int base = first / kT * kT; base <= last; base += kT) {
    for (int e = tid; e < kT; e += kThreads) {
      const int w = base + e;
      site_null[e] = (w >= first && w <= last) ? __ldg(rnull + w) : 0.0f;
    }
    if constexpr (kStaged) {
      for (int x = tid; x < C * kT; x += kThreads) {
        const int k = x / kT, w = base + x - k * kT;
        buf[x] = (w >= c_lo[k] && w <= c_hi[k])
                     ? pair_value(__ldg(pos + w), __ldg(rrow + w), c_pos[k],
                                  c_mb[k], G, inv_step)
                     : outside();
      }
    }
    __syncthreads();
    if (busy) {
#pragma unroll 1
      for (int i0 = 0; i0 < kGroupSites; i0 += kSitesAtOnce) {
#pragma unroll
        for (int di = 0; di < kSitesAtOnce; ++di) {
          const int e = g + L::kGroups * (i0 + di);
          const int w = base + e;
          const float nl = site_null[e];
          float4 q[kVec];
          int q_row = -1;  // the pack row q holds
#pragma unroll
          for (int k = 0; k < C; ++k) {
            float4 v;
            if constexpr (kStaged) {
              v = buf[k * kT + e];
            } else {
              v = (w >= c_lo[k] && w <= c_hi[k])
                      ? pair_value(__ldg(pos + w), __ldg(rrow + w), c_pos[k],
                                   c_mb[k], G, inv_step)
                      : outside();
            }
            // the previous candidate's row where the pair reads the same
            const int pr = __float_as_int(v.z);
            if (pr != q_row) {
#pragma unroll
              for (int t = 0; t < kVec; ++t) {
                q[t] = __ldg(packj + (int64_t)pr * (AP / 2) + t);
              }
              q_row = pr;
            }
#pragma unroll
            for (int o = 0; o < kLaneOffsets; ++o) {
              const float v0 = o % 2 ? q[o / 2].z : q[o / 2].x;
              const float v1 = o % 2 ? q[o / 2].w : q[o / 2].y;
              const float y = __fmaf_rn(__fsub_rn(v1, v0), v.y, v0);
              if (v.x <= lim[o]) {
                acc[k][o] = __fadd_rn(acc[k][o], __fsub_rn(y, nl));
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  float* sums = reinterpret_cast<float*>(buf);
  if (busy) {
#pragma unroll
    for (int k = 0; k < C; ++k) {
#pragma unroll
      for (int o = 0; o < kLaneOffsets; ++o) {
        sums[(g * C + k) * AP + kLaneOffsets * j + o] = acc[k][o];
      }
    }
  }
  __syncthreads();
  for (int x = tid; x < C * A; x += kThreads) {
    const int k = x / A, a = x - k * A;
    if (p0 + k < P) {
      float s = sums[k * AP + a];
      for (int gg = 1; gg < L::kGroups; ++gg) {
        s = __fadd_rn(s, sums[(gg * C + k) * AP + a]);
      }
      out[(r * P + p0 + k) * A + a] = __fmul_rn(2.0f, s);
    }
  }
}

template <int A, int AP, int C>
int launch(const void* pack, const int32_t* row, const int32_t* pos,
           const float* null, const int32_t* cand, const int32_t* lo,
           const int32_t* hi, const int32_t* m_base, const int32_t* m_rel,
           float* out, int Rr, int P, int W, int G, float inv_step,
           cudaStream_t st) {
  const int64_t blocks = (int64_t)Rr * ((P + C - 1) / C);
  lattice_clr_kernel<A, AP, C, FSCL_LATTICE_STAGED>
      <<<(unsigned)blocks, kThreads, 0, st>>>(
          (const float4*)pack, row, pos, null, cand, lo, hi, m_base, m_rel,
          out, P, W, G, inv_step);
  return (int)cudaGetLastError();
}

template <int A, int AP>
int launch_cands(int cands, const void* pack, const int32_t* row,
                 const int32_t* pos, const float* null, const int32_t* cand,
                 const int32_t* lo, const int32_t* hi, const int32_t* m_base,
                 const int32_t* m_rel, float* out, int Rr, int P, int W,
                 int G, float inv_step, cudaStream_t st) {
#define FSCL_LATTICE_CANDS(N)                                               \
  case N:                                                                   \
    return launch<A, AP, N>(pack, row, pos, null, cand, lo, hi, m_base,    \
                            m_rel, out, Rr, P, W, G, inv_step, st);
  switch (cands) {
    FSCL_LATTICE_CANDS(1)
    FSCL_LATTICE_CANDS(4)
#ifdef FSCL_LATTICE_VARIANTS
    FSCL_LATTICE_CANDS(8)
    FSCL_LATTICE_CANDS(16)
#endif
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FSCL_LATTICE_CANDS
}

}  // namespace

extern "C" {

// pack [n_rows*G, 2*AP] f32, 16-byte aligned, the lerp pairs of the A
// offsets first (ops/lattice.py kernel_pack); AP = row_width is
// FSCL_LATTICE_COARSE_ROW at A = 11 and 16 at A = 16; n_rows*G < 2^31.
// row [Rr, W] int32 pack-row ids; pos [W] int32; null [Rr, W] f32; cand,
// lo, hi [P] int32 (windows inside [0, W)); m_base [Rr, P] int32; m_rel
// [A] int32; out [Rr, P, A] f32; cands (1 or 4; 8 and 16 too in a
// FSCL_LATTICE_VARIANTS build) candidates a block; Rr * P
// < 2^31; inv_step = (G-1) / (LOG_AD_MAX - LOG_AD_MIN)
// rounded to float32.  Returns the launch's CUDA error (0 = success).
int fscl_lattice_clr(const void* pack, const void* row, const void* pos,
                     const void* null, const void* cand, const void* lo,
                     const void* hi, const void* m_base, const void* m_rel,
                     void* out, int Rr, int P, int W, int A, int row_width,
                     int G, float inv_step, int cands, void* stream) {
  if ((int64_t)Rr * P == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define FSCL_LATTICE_ARGS                                                   \
  cands, pack, (const int32_t*)row, (const int32_t*)pos,                   \
      (const float*)null, (const int32_t*)cand, (const int32_t*)lo,        \
      (const int32_t*)hi, (const int32_t*)m_base, (const int32_t*)m_rel,   \
      (float*)out, Rr, P, W, G, inv_step, st
  if (A == 11 && row_width == FSCL_LATTICE_COARSE_ROW) {
    return launch_cands<11, FSCL_LATTICE_COARSE_ROW>(FSCL_LATTICE_ARGS);
  }
  if (A == 16 && row_width == 16) {
    return launch_cands<16, 16>(FSCL_LATTICE_ARGS);
  }
#undef FSCL_LATTICE_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
