// One-hot prefix sums of row-id streams, for Hopper: one chained-scan
// kernel body for the three one-hot modes of the TPU prefix-sum kernel.
//
// Replaces the TPU kernel fscl_tpu/ops/pallas_ps.py:onehot_prefix_sums in
//   (b)   its segmented one-hot mode (reset_every), together with the
//         gather -> expand steps of fscl_tpu/engine/permute.py:_stack_stat
//         that fed it: the i16 row-id group table is gathered at sigma and
//         compared against the row index inside the kernel, so the
//         [S*w, P*R] one-hot stream never reaches device memory;
//   (a)   its row-id mode (n_rows), fed by build_prefix_sums
//         (fscl_tpu/ops/histclr.py:873, the hist_clr_reps statistic).  JAX
//         repeats each replicate's id column R times into a [W, P*R] i32
//         stream; here the kernel reads row_rep[p, k] itself;
//   (b')  its unsegmented one-hot mode, fed by build_prefix_sums_oh
//         (:811) from _perm_ps (fscl_tpu/engine/permute.py:648), which
//         gathers the fat i8 one-hot group table at sigma, shifts it to
//         the chromosome's first site and zeroes sites past its end.  Here
//         the i16 row-id group table is gathered at sigma in the kernel.
//
// What it computes, for replicate p, row r (L = P*R lanes):
//
//   (b)   ps[s*w + k, p*R + r] = #{k' <= k : id(s, p, k') == r}, k < w
//         id(s, p, k) = table[sig[p, j8] * pg + k % pg]
//         j8 = seg_g0[s] + k / pg - 1, a negative j8 reads column n_sig - 1
//         (the sentinel column)
//   (a), (b')  ps[0, p*R + r] = 0,
//         ps[k + 1, p*R + r] = #{k' <= k : id(p, k') == r}, k < W
//   (a)   id(p, k) = row_rep[p * W + k]
//   (b')  id(p, k) = table[sig[p, g0 + j / pg] * pg + j % pg], j = off + k,
//         for k < n; no id for k >= n
//
// An id outside [0, R) matches no lane.  Output is int16 or int32 (the
// wrappers' rule: int16 up to 32767 sites); the count is cast at the
// store, as the plain versions cast their int32 cumsum.
//
// What bounds it on the H100: the bytes written, rows*P*R*sizeof(out) --
// 73 MB at the 20k shapes (w=20480 or W=20000, P=32, R=56, int16) --
// against P ids read per site, R times fewer bytes.
//
// Design.  The TPU version walked the sites in order, carrying a running
// row across its sequential grid with a tril matmul per tile.  Blocks on
// the GPU run in no order, so the site axis is cut into kTile-site tiles
// and each (segment, lane block) is one chain of tiles, scanned in one
// launch by a chained scan with decoupled look-back (chained_scan.cuh).
// The modes differ only in where a site's id comes from (an id source,
// which builds a block's id functor from its segment, first replicate and
// first site) and in the output's first row (kRow0: row s*w + k, or row
// k + 1 under a zero row).  A block owns kLanes lanes (kVec adjacent ones
// a thread of each warp) and one tile, which its kWarps warps cut into
// slices of kSub sites.  It takes its (tile, segment, lane block) from a
// ticket, tile-major, then:
//   1. stages the tile's ids in shared memory, once, for only the
//      replicates its lanes cover (ids outside [0, R) as -1, so int16
//      holds every id);
//   2. each warp walks its slice for its lanes: the slice's counts; their
//      sum is the tile's;
//   3. publishes the tile's counts (flag and count in one 64-bit word per
//      lane), looks back for its carry, publishes carry + counts; each
//      slice starts from the carry plus the slices before it;
//   4. each warp walks the staged ids of its slice again from its start,
//      storing the running counts.
// A warp's lanes are adjacent, so it stores whole 128-byte lines (int16:
// 4 bytes a thread a site), and a staged id is a broadcast.  The host
// zeroes the flags and the ticket before the kernel, on the same stream;
// the zero row of (a) and (b') is written by the blocks of tile 0.

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
// the zero row of (a) and (b'): written by the blocks of tile 0 (true) or
// by a memset before the kernel (false)
constexpr bool kRow0InKernel = true;

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

// ---- id sources: at(s, p_lo, k0) is the id functor of a block whose
// replicates start at p_lo and whose tile starts at site k0 of segment s;
// its (pe, kk) is the id of replicate p_lo + pe at site k0 + kk.

// (b): the segment's slab of the group table gathered at sigma
struct SegmentSource {
  static constexpr int kRow0 = 0;
  const int16_t* table;
  const int32_t* sig;
  const int32_t* seg_g0;
  int n_sig, pg;
  __device__ fscl::SegmentIds at(int s, int p_lo, int k0) const {
    return {table, sig + (size_t)p_lo * n_sig, n_sig, pg, seg_g0[s] - 1, k0};
  }
};

// (a): a [P, W] int32 row-id matrix; an id outside [0, R) reads as -1
// before the int16 staging can alias it (65536 + r would stage as r)
struct RowRepIds {
  static constexpr int kRow0 = 1;
  const int32_t* rows;
  int W, R;
  __device__ RowRepIds at(int, int p_lo, int k0) const {
    return {rows + (size_t)p_lo * W + k0, W, R};
  }
  __device__ __forceinline__ int operator()(int pe, int kk) const {
    const int id = __ldg(rows + (size_t)pe * W + kk);
    return (unsigned)id < (unsigned)R ? id : -1;
  }
};

// (b'): the chromosome starting at group g0, site off of it, gathered at
// sigma; no id (-1) at sites k >= n, whose sigma columns are not read
struct PermIds {
  static constexpr int kRow0 = 1;
  const int16_t* table;
  const int32_t* sig;
  int n_sig, g0, off, n, pg, R, k0;
  __device__ PermIds at(int, int p_lo, int k0_) const {
    return {table, sig + (size_t)p_lo * n_sig, n_sig, g0, off, n, pg, R,
            k0_};
  }
  __device__ __forceinline__ int operator()(int pe, int kk) const {
    const int k = k0 + kk;
    if (k >= n) return -1;
    const int j = off + k;
    const int sel = __ldg(sig + (size_t)pe * n_sig + g0 + j / pg);
    const int id = __ldg(table + (size_t)sel * pg + j % pg);
    return (unsigned)id < (unsigned)R ? id : -1;
  }
};

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

template <typename Src, typename OutT>
__global__ void __launch_bounds__(kThreads)
    onehot_chained_scan(Src src, OutT* __restrict__ out, Scratch sc, int S,
                        int w, int P, int R, int n_tiles, int n_lb) {
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
  fscl::stage_tile_ids<kThreads>(ids, n, n_rep, src.at(s, p_lo, k0));

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
    if (Src::kRow0 && kRow0InKernel && t == 0) {  // the zero row
#pragma unroll
      for (int v = 0; v < kVec; ++v)
        if (live[v]) out[l + v] = (OutT)0;
    }
  }
  __syncthreads();

  // 4. the running counts, kVec lanes a store where the row layout keeps
  // them aligned (L a multiple of kVec), else lane by lane
  uint32_t run[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) run[v] = part[warp][lane * kVec + v];
  OutT* dst = out + ((size_t)s * w + Src::kRow0 + k0 + kk0) * L + l;
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

// One flag memset and one kernel on st (and the zero row's memset where
// the kernel does not write it); w == 0 launches no kernel.
template <typename Src, typename OutT>
int launch(const Src& src, OutT* out, void* scratch, int S, int w, int P,
           int R, cudaStream_t st) {
  const int L = P * R;
  cudaError_t err = cudaSuccess;
  if (Src::kRow0 && (!kRow0InKernel || w == 0))
    err = cudaMemsetAsync(out, 0, (size_t)L * sizeof(OutT), st);
  if (err != cudaSuccess || w == 0) return (int)err;
  const int n_tiles = (w + kTile - 1) / kTile;
  const int n_lb = (L + kLanes - 1) / kLanes;
  int n_rep = 0;
  for (int lb = 0; lb < n_lb; ++lb)
    if (rep_count(lb, P, R) > n_rep) n_rep = rep_count(lb, P, R);
  const size_t smem = (size_t)kTile * n_rep * sizeof(int16_t);
  if (smem + sizeof(uint32_t) * kWarps * kLanes > 48 * 1024)  // opt in
    err = cudaFuncSetAttribute(onehot_chained_scan<Src, OutT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  uint64_t* words = (uint64_t*)scratch;
  const size_t n_words = scratch_words(S, w, L);
  err = cudaMemsetAsync(words, 0, (n_words + 1) * sizeof(uint64_t), st);
  if (err != cudaSuccess) return (int)err;
  const Scratch sc = {words, (unsigned*)(words + n_words)};
  onehot_chained_scan<Src, OutT><<<n_tiles * S * n_lb, kThreads, smem, st>>>(
      src, out, sc, S, w, P, R, n_tiles, n_lb);
  return (int)cudaGetLastError();
}

template <typename Src>
int launch_as(int out_bytes, const Src& src, void* out, void* scratch,
              int S, int w, int P, int R, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bytes == 2)
    return launch(src, (int16_t*)out, scratch, S, w, P, R, st);
  return launch(src, (int32_t*)out, scratch, S, w, P, R, st);
}

}  // namespace

extern "C" {

// Sites per tile: the chains' step, and the largest w one tile covers.
int fscl_ps_tile() { return kTile; }

// Bytes of scratch a kernel of this file needs (flags and ticket): S
// segments of w sites, or S = 1 and w = W for (a) and (b').
int64_t fscl_ps_scratch_bytes(int S, int w, int P, int R) {
  return (int64_t)(scratch_words(S, w, P * R) + 1) * sizeof(uint64_t);
}

// Each entry point: one memset of scratch, fscl_ps_scratch_bytes bytes,
// 8-aligned, and one kernel, on stream; returns cudaGetLastError() after
// the launch (0 = success).  out_bytes 2: int16 output, 4: int32.

// (b) table [*, pg] int16 row-id group table (row = group, sentinel
// last); sig [P, n_sig] int32 group-level sigma of one replicate slice;
// seg_g0 [S] int32 first genome group of each segment; out [S*w, P*R].
int fscl_onehot_prefix_sums(const void* table, const void* sig,
                            const void* seg_g0, void* out, void* scratch,
                            int S, int w, int P, int R, int n_sig, int pg,
                            int out_bytes, void* stream) {
  const SegmentSource src{(const int16_t*)table, (const int32_t*)sig,
                          (const int32_t*)seg_g0, n_sig, pg};
  return launch_as(out_bytes, src, out, scratch, S, w, P, R, stream);
}

// (a) row_rep [P, W] int32; out [W+1, P*R].
int fscl_rowid_prefix_sums(const void* row_rep, void* out, void* scratch,
                           int W, int P, int R, int out_bytes,
                           void* stream) {
  const RowRepIds src{(const int32_t*)row_rep, W, R};
  return launch_as(out_bytes, src, out, scratch, 1, W, P, R, stream);
}

// (b') table [*, pg] int16 row-id group table; sig [P, n_sig] int32 group
// sigma, sentinel-padded so columns g0 .. g0 + (off + n - 1) / pg exist;
// out [w_pad+1, P*R].
int fscl_perm_prefix_sums(const void* table, const void* sig, void* out,
                          void* scratch, int w_pad, int P, int R, int n_sig,
                          int g0, int off, int n, int pg, int out_bytes,
                          void* stream) {
  const PermIds src{(const int16_t*)table, (const int32_t*)sig, n_sig, g0,
                    off, n, pg, R, 0};
  return launch_as(out_bytes, src, out, scratch, 1, w_pad, P, R, stream);
}

const char* fscl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
