// Segmented prefix sums of weight channels along the permuted row-id
// stream, for Hopper.
//
// Replaces the TPU kernel fscl_tpu/ops/pallas_ps.py:onehot_prefix_sums in
// its f32 mode (c) (compressed mixed-depth weight channels, two-limb
// carry, :97-110) together with the fat gather of
// fscl_tpu/engine/permute.py:_stack_stat (:822-830) that fed it: the i16
// row-id group table is gathered at sigma and each id is expanded through
// the [n_ids, R] f32 weight table inside the kernel, so the [S*w, P*R]
// f32 weight stream never reaches device memory.
//
// What it computes, for segment s, site k < w, replicate p, channel r:
//
//   ps[s*w + k, p*R + r] = sum_{k' <= k} weights[id(s, p, k') * R + r]
//   id(s, p, k) = table[sig[p, j8] * pg + k % pg]
//   j8 = seg_g0[s] + k / pg - 1,  a negative j8 reads column n_sig - 1
//
// (the sentinel column).  The sentinel id n_ids - 1 reads the all-zero
// last weight row; an id outside [0, n_ids) is read as the sentinel.
//
// What bounds it on the H100: the f32 bytes written, S*w*P*R*4 -- 403 MB
// per 32-replicate slice at the mixed-depth headline shape (S=4,
// w=24576, P=32, R=32).  The weight table (203 KB there, at most 3.4 MB)
// is read through the read-only cache: consecutive threads own
// consecutive channels of one replicate, so each site's row is one
// coalesced line.  It is not staged whole in shared memory.
//
// Design.  One launch: a chained scan with decoupled look-back over
// kTile-site tiles (chained_scan.cuh), as csrc/prefix_sums.cu.  A block
// owns kLanes lanes (one a thread of each warp) and one tile, which its
// kWarps warps cut into slices of kSub sites.  It takes its (tile,
// segment, lane block) from a ticket, tile-major, then:
//   1. stages the tile's ids of its replicates in shared memory, once;
//   2. each warp sums its slice's weights (float64, site order); the
//      slices' sums, in slice order, are the tile's totals;
//   3. stores those totals and releases them with the tile's flag;
//   4. waits for the chain's earlier tiles' flags and sums their totals
//      in tile order, 0, 1, ..., t-1: the carry; each slice starts from
//      the carry plus the slices before it, in slice order;
//   5. each warp walks its slice again from its start, storing the
//      running value rounded to float32.
// No sum's order depends on timing (no atomics, no INCLUSIVE shortcut: where
// a walk back stopped would change the order), so two launches give the
// same bits, and the error is one float32 rounding of a value that is
// exact to float64 -- the Pallas kernel's compensated carry kept about the
// same.  Tiles publish their totals before they wait, so no block waits on
// a serial chain.  The host zeroes the flags and the ticket before the
// kernel, on the same stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chained_scan.cuh"
#include "segment_ids.cuh"

namespace {

constexpr int kTile = 1024;  // sites per tile
constexpr int kWarps = 8;   // warps per block, one slice of the tile each
constexpr int kSub = kTile / kWarps;  // sites per slice
constexpr int kThreads = 32 * kWarps;
constexpr int kLanes = 32;  // lanes per block, one a thread of each warp
constexpr int kBatch = 8;   // earlier tiles' totals loaded at once

// scratch: the ticket (8 bytes), the tile flags [S][n_lb][n_tiles] u32
// (rounded up to 8 bytes), then the tile totals [S][n_tiles][L] float64
struct Scratch {
  unsigned* ticket;
  unsigned* flags;
  double* totals;
};

int n_tiles_of(int w) { return (w + kTile - 1) / kTile; }
int n_lb_of(int L) { return (L + kLanes - 1) / kLanes; }

size_t flag_bytes(int S, int w, int L) {
  return ((size_t)S * n_lb_of(L) * n_tiles_of(w) * 4 + 7) / 8 * 8;
}

Scratch scratch_layout(void* base, int S, int w, int L) {
  char* p = (char*)base;
  return {(unsigned*)p, (unsigned*)(p + 8),
          (double*)(p + 8 + flag_bytes(S, w, L))};
}

// a segment's ids, those outside [0, n_ids) read as the sentinel n_ids - 1
struct WeightIds {
  fscl::SegmentIds at;
  int n_ids;
  __device__ __forceinline__ int operator()(int pe, int kk) const {
    const int id = at(pe, kk);
    return id < 0 || id >= n_ids ? n_ids - 1 : id;
  }
};

// replicates the lane block starting at lane l0 covers
__host__ __device__ inline int rep_count(int l0, int P, int R) {
  const int p_hi = (l0 + kLanes - 1) / R;
  return (p_hi < P - 1 ? p_hi : P - 1) - l0 / R + 1;
}

__global__ void __launch_bounds__(kThreads)
    weighted_chained_scan(const int16_t* __restrict__ table,
                          const float* __restrict__ weights,
                          const int32_t* __restrict__ sig,
                          const int32_t* __restrict__ seg_g0,
                          float* __restrict__ out, Scratch sc, int S, int w,
                          int P, int R, int n_ids, int n_sig, int pg,
                          int n_tiles, int n_lb) {
  extern __shared__ int16_t ids[];  // [kTile][n_rep]
  __shared__ double part[kWarps][kLanes];  // slice sums, then slice starts
  const int b = fscl::take_ticket(sc.ticket);
  const int t = b / (S * n_lb);
  const int s = b % (S * n_lb) / n_lb;
  const int lb = b % n_lb;
  const int L = P * R;
  const int l0 = lb * kLanes;
  const int p_lo = l0 / R;
  const int n_rep = rep_count(l0, P, R);
  const int k0 = t * kTile;
  const int n = min(kTile, w - k0);

  // 1. the tile's ids of this block's replicates
  const WeightIds id_at{{table, sig + (size_t)p_lo * n_sig, n_sig, pg,
                         seg_g0[s] - 1, k0},
                        n_ids};
  fscl::stage_tile_ids<kThreads>(ids, n, n_rep, id_at);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int l = l0 + lane;
  const bool live = l < L;
  const int pl = live ? l / R - p_lo : 0;
  const float* wr = weights + (live ? l % R : 0);
  const int kk0 = warp * kSub;
  const int m = max(0, min(kSub, n - kk0));  // sites of this warp's slice
  const int16_t* slice = ids + kk0 * n_rep + pl;

  // 2. the slice's sum, in site order
  double sum = 0.0;
#pragma unroll 8
  for (int i = 0; i < m; ++i)
    sum += (double)__ldg(wr + (size_t)slice[i * n_rep] * R);
  part[warp][lane] = sum;
  __syncthreads();

  // 3. the tile's totals, the slices' sums in slice order, published
  double* totals = sc.totals + (size_t)s * n_tiles * L + l;
  if (warp == 0 && live) {
    double tot = 0.0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) tot += part[i][lane];
    __stcg(totals + (size_t)t * L, tot);
  }
  unsigned* flags = sc.flags + ((size_t)s * n_lb + lb) * n_tiles;
  fscl::publish_tile(flags + t);

  // 4. the carry: earlier tiles' totals in tile order; then each slice's
  // start, the carry plus the slices before it
  fscl::wait_tiles(flags, t);
  if (warp == 0 && live) {
    double run = 0.0;
    for (int j0 = 0; j0 < t; j0 += kBatch) {
      double c[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        c[i] = j0 + i < t ? __ldcg(totals + (size_t)(j0 + i) * L) : 0.0;
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (j0 + i < t) run += c[i];
    }
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const double sub = part[i][lane];
      part[i][lane] = run;
      run += sub;
    }
  }
  __syncthreads();

  // 5. the running values
  if (!live) return;
  double run = part[warp][lane];
  float* dst = out + ((size_t)s * w + k0 + kk0) * L + l;
#pragma unroll 8
  for (int i = 0; i < m; ++i) {
    run += (double)__ldg(wr + (size_t)slice[i * n_rep] * R);
    dst[(size_t)i * L] = (float)run;
  }
}

}  // namespace

extern "C" {

// Sites per tile: the chains' step, and the largest w one tile covers.
int fscl_wps_tile() { return kTile; }

// Bytes of scratch fscl_weighted_prefix_sums needs (ticket, flags, tile
// totals).
int64_t fscl_wps_scratch_bytes(int S, int w, int P, int R) {
  const int L = P * R;
  return (int64_t)(8 + flag_bytes(S, w, L) +
                   (size_t)S * n_tiles_of(w) * L * sizeof(double));
}

// table   [*, pg] int16    row-id group table (row = group, sentinel last)
// weights [n_ids, R] f32   weight channels per row id (last row zero)
// sig     [P, n_sig] int32 group-level sigma of one replicate slice
// seg_g0  [S] int32        first genome group of each segment
// out     [S*w, P*R] f32
// scratch                  fscl_wps_scratch_bytes(S, w, P, R) bytes,
//                          8-aligned
// One memset and one kernel on stream; returns cudaGetLastError() after
// the launch (0 = success).
int fscl_weighted_prefix_sums(const void* table, const void* weights,
                              const void* sig, const void* seg_g0, void* out,
                              void* scratch, int S, int w, int P, int R,
                              int n_ids, int n_sig, int pg, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int L = P * R;
  const int n_tiles = n_tiles_of(w);
  const int n_lb = n_lb_of(L);
  int n_rep = 0;
  for (int lb = 0; lb < n_lb; ++lb)
    if (rep_count(lb * kLanes, P, R) > n_rep)
      n_rep = rep_count(lb * kLanes, P, R);
  const size_t smem = (size_t)kTile * n_rep * sizeof(int16_t);
  cudaError_t err = cudaSuccess;
  if (smem + sizeof(double) * kWarps * kLanes > 48 * 1024)  // opt in
    err = cudaFuncSetAttribute(weighted_chained_scan,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(scratch, 0, 8 + flag_bytes(S, w, L), st);
  if (err != cudaSuccess) return (int)err;
  weighted_chained_scan<<<n_tiles * S * n_lb, kThreads, smem, st>>>(
      (const int16_t*)table, (const float*)weights, (const int32_t*)sig,
      (const int32_t*)seg_g0, (float*)out, scratch_layout(scratch, S, w, L),
      S, w, P, R, n_ids, n_sig, pg, n_tiles, n_lb);
  return (int)cudaGetLastError();
}

}  // extern "C"
