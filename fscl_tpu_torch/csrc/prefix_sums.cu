// Segmented one-hot prefix sums of the permuted row-id stream, for Hopper.
//
// Replaces the TPU kernel fscl_tpu/ops/pallas_ps.py:onehot_prefix_sums
// (input mode (b), segmented by reset_every) together with the
// gather -> expand steps of fscl_tpu/engine/permute.py:_stack_stat that
// fed it: the i16 row-id group table is gathered at sigma and compared
// against the row index inside the kernel, so the [S*w, P*R] one-hot
// stream never reaches device memory.
//
// What it computes, for segment s, site k < w, replicate p, row r:
//
//   ps[s*w + k, p*R + r] = #{k' <= k : id(s, p, k') == r}
//   id(s, p, k) = table[sig[p, j8] * pg + k % pg]
//   j8 = seg_g0[s] + k / pg - 1,  a negative j8 reads column n_sig - 1
//
// (the sentinel column).  An id >= R matches no lane.
//
// What bounds it on the H100: the bytes written, S*w*P*R*sizeof(out) --
// 73 MB at the 20k shape (S=1, w=20480, P=32, R=56, int16) -- against P
// ids read per site, R times fewer bytes.
//
// Design.  The TPU version walked the sites in order, carrying a running
// row across its sequential grid with a tril matmul per tile.  Blocks on
// the GPU run in no order, so the site axis is cut into kTile-site tiles
// and each (segment, lane block) is one chain of tiles, scanned in one
// launch by a chained scan with decoupled look-back (chained_scan.cuh).
// A block owns kLanes lanes (kVec adjacent ones a thread of each warp)
// and one tile, which its kWarps warps cut into slices of kSub sites.  It
// takes its (tile, segment, lane block) from a ticket, tile-major, then:
//   1. stages the tile's ids in shared memory, once, for only the
//      replicates its lanes cover;
//   2. each warp walks its slice for its lanes: the slice's counts; their
//      sum is the tile's;
//   3. publishes the tile's counts (flag and count in one 64-bit word per
//      lane), looks back for its carry, publishes carry + counts; each
//      slice starts from the carry plus the slices before it;
//   4. each warp walks the staged ids of its slice again from its start,
//      storing the running counts.
// A warp's lanes are adjacent, so it stores whole 128-byte lines (int16:
// 4 bytes a thread a site), and a staged id is a broadcast.  The host
// zeroes the flags and the ticket before the kernel, on the same stream.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "chained_scan.cuh"
#include "segment_ids.cuh"

namespace {

constexpr int kTile = 512;  // sites per tile
constexpr int kWarps = 8;   // warps per block, one slice of the tile each
constexpr int kSub = kTile / kWarps;  // sites per slice
constexpr int kThreads = 32 * kWarps;
constexpr int kVec = 2;     // adjacent lanes per thread
constexpr int kLanes = 32 * kVec;  // lanes per block

// scratch: [S][n_tiles][L] packed words, then the ticket
struct Scratch {
  uint64_t* words;
  unsigned* ticket;
};

size_t scratch_words(int S, int w, int L) {
  return (size_t)S * ((w + kTile - 1) / kTile) * L;
}

// replicates lane block lb covers: [p_lo, p_lo + n_rep)
__host__ __device__ inline int rep_lo(int lb, int R) {
  return lb * kLanes / R;
}
__host__ __device__ inline int rep_count(int lb, int P, int R) {
  const int p_hi = (lb * kLanes + kLanes - 1) / R;
  return (p_hi < P - 1 ? p_hi : P - 1) - rep_lo(lb, R) + 1;
}

// kVec counts of type OutT as one vector store
template <typename OutT>
__device__ __forceinline__ void store_vec(OutT* dst,
                                          const uint32_t (&v)[kVec]) {
  OutT o[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) o[i] = (OutT)v[i];
  if constexpr (sizeof(o) == 4) {
    uint32_t u;
    memcpy(&u, o, 4);
    *reinterpret_cast<uint32_t*>(dst) = u;
  } else if constexpr (sizeof(o) == 8) {
    uint2 u;
    memcpy(&u, o, 8);
    *reinterpret_cast<uint2*>(dst) = u;
  } else {
    uint4 u;
    memcpy(&u, o, 16);
    *reinterpret_cast<uint4*>(dst) = u;
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    onehot_chained_scan(const int16_t* __restrict__ table,
                        const int32_t* __restrict__ sig,
                        const int32_t* __restrict__ seg_g0,
                        OutT* __restrict__ out, Scratch sc, int S, int w,
                        int P, int R, int n_sig, int pg, int n_tiles,
                        int n_lb) {
  extern __shared__ int16_t ids[];  // [kTile][n_rep]
  // slice counts, then slice starts, of each lane
  __shared__ uint32_t part[kWarps][kLanes];
  const int b = fscl::take_ticket(sc.ticket);
  const int t = b / (S * n_lb);
  const int s = b % (S * n_lb) / n_lb;
  const int lb = b % n_lb;
  const int L = P * R;
  const int p_lo = rep_lo(lb, R);
  const int n_rep = rep_count(lb, P, R);
  const int k0 = t * kTile;
  const int n = min(kTile, w - k0);

  // 1. the tile's ids of this block's replicates
  const fscl::SegmentIds id_at{table, sig + (size_t)p_lo * n_sig, n_sig,
                               pg, seg_g0[s] - 1, k0};
  fscl::stage_tile_ids<kThreads>(ids, n, n_rep, id_at);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int l = lb * kLanes + lane * kVec;
  bool live[kVec];
  int pl[kVec], r[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    live[v] = l + v < L;
    pl[v] = live[v] ? (l + v) / R - p_lo : 0;
    r[v] = live[v] ? (l + v) % R : -0x10000;  // matches no int16 id
  }
  const int kk0 = warp * kSub;
  const int m = max(0, min(kSub, n - kk0));  // sites of this warp's slice
  const int16_t* slice = ids + kk0 * n_rep;

  // 2. the slice's counts
  uint32_t cnt[kVec] = {};
#pragma unroll 8
  for (int i = 0; i < m; ++i) {
    const int16_t* row = slice + i * n_rep;
#pragma unroll
    for (int v = 0; v < kVec; ++v) cnt[v] += row[pl[v]] == r[v];
  }
#pragma unroll
  for (int v = 0; v < kVec; ++v) part[warp][lane * kVec + v] = cnt[v];
  __syncthreads();

  // 3. warp 0: the tile's counts; publish, look back, publish the
  // inclusive counts; each slice's start
  if (warp == 0) {
    uint32_t tot[kVec] = {}, run[kVec];
#pragma unroll
    for (int i = 0; i < kWarps; ++i)
#pragma unroll
      for (int v = 0; v < kVec; ++v) tot[v] += part[i][lane * kVec + v];
    fscl::lookback_counts<kVec>(sc.words + (size_t)s * n_tiles * L + l,
                                (size_t)L, t, live, tot, run);
#pragma unroll
    for (int i = 0; i < kWarps; ++i)
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const uint32_t c = part[i][lane * kVec + v];
        part[i][lane * kVec + v] = run[v];
        run[v] += c;
      }
  }
  __syncthreads();

  // 4. the running counts, kVec lanes a store where the row layout keeps
  // them aligned (L a multiple of kVec), else lane by lane
  uint32_t run[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) run[v] = part[warp][lane * kVec + v];
  OutT* dst = out + ((size_t)s * w + k0 + kk0) * L + l;
  if (L % kVec == 0) {
    if (!live[0]) return;
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      const int16_t* row = slice + i * n_rep;
#pragma unroll
      for (int v = 0; v < kVec; ++v) run[v] += row[pl[v]] == r[v];
      store_vec(dst + (size_t)i * L, run);
    }
  } else {
    for (int i = 0; i < m; ++i) {
      const int16_t* row = slice + i * n_rep;
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        run[v] += row[pl[v]] == r[v];
        if (live[v]) dst[(size_t)i * L + v] = (OutT)run[v];
      }
    }
  }
}

template <typename OutT>
int launch(const int16_t* tab, const int32_t* sg, const int32_t* g0,
           OutT* out, const Scratch& sc, int S, int w, int P, int R,
           int n_sig, int pg, cudaStream_t st) {
  const int n_tiles = (w + kTile - 1) / kTile;
  const int n_lb = (P * R + kLanes - 1) / kLanes;
  int n_rep = 0;
  for (int lb = 0; lb < n_lb; ++lb)
    if (rep_count(lb, P, R) > n_rep) n_rep = rep_count(lb, P, R);
  const size_t smem = (size_t)kTile * n_rep * sizeof(int16_t);
  cudaError_t err = cudaSuccess;
  if (smem + sizeof(uint32_t) * kWarps * kLanes > 48 * 1024)  // opt in
    err = cudaFuncSetAttribute(onehot_chained_scan<OutT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(sc.words, 0,
                        (scratch_words(S, w, P * R) + 1) * sizeof(uint64_t),
                        st);
  if (err != cudaSuccess) return (int)err;
  onehot_chained_scan<OutT><<<n_tiles * S * n_lb, kThreads, smem, st>>>(
      tab, sg, g0, out, sc, S, w, P, R, n_sig, pg, n_tiles, n_lb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Sites per tile: the chains' step, and the largest w one tile covers.
int fscl_ps_tile() { return kTile; }

// Bytes of scratch fscl_onehot_prefix_sums needs (flags and ticket).
int64_t fscl_ps_scratch_bytes(int S, int w, int P, int R) {
  return (int64_t)(scratch_words(S, w, P * R) + 1) * sizeof(uint64_t);
}

// table  [*, pg] int16   row-id group table (row = group, sentinel last)
// sig    [P, n_sig] int32 group-level sigma of one replicate slice
// seg_g0 [S] int32       first genome group of each segment
// out    [S*w, P*R]      int16 (out_bytes 2) or int32 (out_bytes 4)
// scratch                fscl_ps_scratch_bytes(S, w, P, R) bytes, 8-aligned
// One memset and one kernel on stream; returns cudaGetLastError() after
// the launch (0 = success).
int fscl_onehot_prefix_sums(const void* table, const void* sig,
                            const void* seg_g0, void* out, void* scratch,
                            int S, int w, int P, int R, int n_sig, int pg,
                            int out_bytes, void* stream) {
  uint64_t* words = (uint64_t*)scratch;
  const Scratch sc = {words, (unsigned*)(words + scratch_words(S, w, P * R))};
  const int16_t* tab = (const int16_t*)table;
  const int32_t* sg = (const int32_t*)sig;
  const int32_t* g0 = (const int32_t*)seg_g0;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bytes == 2)
    return launch(tab, sg, g0, (int16_t*)out, sc, S, w, P, R, n_sig, pg, st);
  return launch(tab, sg, g0, (int32_t*)out, sc, S, w, P, R, n_sig, pg, st);
}

const char* fscl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
