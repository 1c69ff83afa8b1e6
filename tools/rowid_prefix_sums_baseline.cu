// The first, three-pass version of the row-id prefix-sum kernels (modes
// (a) and (b') of fscl_tpu_torch/csrc/prefix_sums.cu), kept as the
// baseline that tools/prefix_scan_variants.py times the chained scan
// against (the package does not build it).  Same functions and C
// signatures; its scratch, ceil(W / 256) * P * R int32, fits in the
// chained scan's fscl_ps_scratch_bytes(1, W, P, R).
//
// Unsegmented one-hot prefix sums of per-replicate row-id streams, for
// Hopper: the row-id modes of the TPU prefix-sum kernel.
//
// Replaces the TPU kernel fscl_tpu/ops/pallas_ps.py:onehot_prefix_sums in
// two of its unsegmented modes:
//   (a)  rowid: row ids compared with lane % R, fed by build_prefix_sums
//        (fscl_tpu/ops/histclr.py:873, the hist_clr_reps statistic).  JAX
//        repeats each replicate's id column R times into a [W, P*R] i32
//        stream; here each thread reads row_rep[p, k] itself, so that
//        stream never exists.
//   (b')  perm: a prebuilt one-hot, fed by build_prefix_sums_oh (:811)
//        from _perm_ps (fscl_tpu/engine/permute.py:648), which gathers the
//        fat i8 one-hot group table at sigma, shifts it to the
//        chromosome's first site and zeroes sites past its end.  Here the
//        i16 row-id group table is gathered at sigma inside the kernel.
//
// What it computes, for site k < W, replicate p, row r (L = P*R lanes):
//
//   ps[0, p*R + r]     = 0
//   ps[k + 1, p*R + r] = #{k' <= k : id(p, k') == r}
//   (a)   id(p, k) = row_rep[p * W + k]
//   (b')  id(p, k) = table[sig[p, g0 + j / pg] * pg + j % pg], j = off + k,
//                    for k < n; no id for k >= n
//
// An id outside [0, R) matches no lane.  Output is int16 or int32 (the
// wrapper's rule: int16 when W <= 32767); the count is cast at the store,
// as the plain version casts its int32 cumsum.
//
// What bounds it on the H100: the bytes written, (W+1)*P*R*sizeof(out) --
// 73 MB at the 20k shape (W=20480, P=32, R=56, int16) -- against P ids
// read per site, R times fewer bytes.
//
// Design.  Three passes over 256-site tiles, as csrc/prefix_sums.cu:
//   1. rtile_hist:  one block per tile histograms the tile's ids per
//      replicate with shared-memory atomics (integers: order-free);
//   2. rtile_scan:  one thread per lane turns the tile totals into
//      exclusive carries, in place;
//   3. rtile_write: one block per (tile, lane block) stages the tile's
//      ids in shared memory (clamped to [-1, R), so int16 holds them);
//      each thread walks the tile for its lane from its carry and stores
//      the running count.  Consecutive threads own consecutive rows r of
//      one replicate, so a staged id is one broadcast per warp and each
//      site's output row is written by coalesced stores.
// Nothing assumes the Pallas layout (W a multiple of 512, lanes a multiple
// of 128): any W, any L up to the wrapper's limit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;          // sites per tile
constexpr int kHistThreads = 256;
constexpr int kWriteThreads = 128;  // lanes per write block
constexpr int kStage = 64;          // sites staged per shared-memory round

// (a): a [P, W] int32 row-id matrix
struct RowRepIds {
  const int32_t* rows;
  int W;
  __device__ __forceinline__ int operator()(int p, int k) const {
    return rows[(size_t)p * W + k];
  }
};

// (b'): the i16 row-id group table gathered at a group sigma
struct PermIds {
  const int16_t* table;
  const int32_t* sig;
  int n_sig, g0, off, n, pg;
  __device__ __forceinline__ int operator()(int p, int k) const {
    if (k >= n) return -1;
    const int j = off + k;
    const int sel = sig[(size_t)p * n_sig + g0 + j / pg];
    return table[(size_t)sel * pg + j % pg];
  }
};

template <typename Ids>
__device__ __forceinline__ int lane_row(const Ids& ids, int p, int k, int R) {
  const int id = ids(p, k);
  return (id >= 0 && id < R) ? id : -1;
}

template <typename Ids>
__global__ void rtile_hist(Ids ids, int32_t* __restrict__ tile_cnt, int W,
                           int P, int R) {
  extern __shared__ int hist[];
  const int t = blockIdx.x;
  const int L = P * R;
  for (int l = threadIdx.x; l < L; l += blockDim.x) hist[l] = 0;
  __syncthreads();
  const int k0 = t * kTile;
  const int n = min(kTile, W - k0);
  for (int e = threadIdx.x; e < n * P; e += blockDim.x) {
    const int p = e / n;
    const int r = lane_row(ids, p, k0 + e % n, R);
    if (r >= 0) atomicAdd(&hist[p * R + r], 1);
  }
  __syncthreads();
  int32_t* dst = tile_cnt + (size_t)t * L;
  for (int l = threadIdx.x; l < L; l += blockDim.x) dst[l] = hist[l];
}

__global__ void rtile_scan(int32_t* __restrict__ tile_cnt, int L,
                           int n_tiles) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  int run = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int c = tile_cnt[(size_t)t * L + l];
    tile_cnt[(size_t)t * L + l] = run;
    run += c;
  }
}

template <typename Ids, typename OutT>
__global__ void rtile_write(Ids ids, const int32_t* __restrict__ carry,
                            OutT* __restrict__ out, int W, int P, int R) {
  extern __shared__ int16_t staged[];  // [kStage][P]
  const int t = blockIdx.x;
  const int L = P * R;
  const int l = blockIdx.y * kWriteThreads + threadIdx.x;
  const bool live = l < L;
  const int p = live ? l / R : 0;
  const int r = live ? l % R : 0;
  const int k0 = t * kTile;
  const int n = min(kTile, W - k0);
  int run = live ? carry[(size_t)t * L + l] : 0;
  // row k + 1 holds the count through site k (row 0 is zero)
  OutT* dst = out + ((size_t)k0 + 1) * L + l;
  for (int c0 = 0; c0 < n; c0 += kStage) {
    const int m = min(kStage, n - c0);
    __syncthreads();  // the previous round's reads are done
    for (int e = threadIdx.x; e < m * P; e += blockDim.x) {
      const int pe = e / m;
      const int kk = e % m;
      staged[kk * P + pe] = (int16_t)lane_row(ids, pe, k0 + c0 + kk, R);
    }
    __syncthreads();
    if (live) {
      for (int kk = 0; kk < m; ++kk) {
        run += (staged[kk * P + p] == r);
        dst[(size_t)(c0 + kk) * L] = (OutT)run;
      }
    }
  }
}

template <typename Ids>
int launch(const Ids& ids, void* out, void* scratch, int W, int P, int R,
           int out_bytes, cudaStream_t st) {
  const int L = P * R;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)L * out_bytes, st);  // row 0
  if (err != cudaSuccess || W == 0) return (int)err;
  const int n_tiles = (W + kTile - 1) / kTile;
  int32_t* cnt = (int32_t*)scratch;

  rtile_hist<Ids><<<n_tiles, kHistThreads, (size_t)L * sizeof(int), st>>>(
      ids, cnt, W, P, R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  rtile_scan<<<(L + 255) / 256, 256, 0, st>>>(cnt, L, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dim3 grid(n_tiles, (L + kWriteThreads - 1) / kWriteThreads);
  const size_t smem = (size_t)kStage * P * sizeof(int16_t);
  if (out_bytes == 2) {
    rtile_write<Ids, int16_t><<<grid, kWriteThreads, smem, st>>>(
        ids, cnt, (int16_t*)out, W, P, R);
  } else {
    rtile_write<Ids, int32_t><<<grid, kWriteThreads, smem, st>>>(
        ids, cnt, (int32_t*)out, W, P, R);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile length of the scratch layout: scratch holds ceil(W / tile) * P * R
// int32.
int fscl_rps_tile() { return kTile; }

// row_rep [P, W] int32; out [W+1, P*R] int16 (out_bytes 2) or int32 (4).
// Returns the first CUDA error of the launches (0 = success).
int fscl_rowid_prefix_sums(const void* row_rep, void* out, void* scratch,
                           int W, int P, int R, int out_bytes,
                           void* stream) {
  RowRepIds ids{(const int32_t*)row_rep, W};
  return launch(ids, out, scratch, W, P, R, out_bytes, (cudaStream_t)stream);
}

// table [*, pg] int16 row-id group table; sig [P, n_sig] int32 group
// sigma, sentinel-padded so columns g0 .. g0 + (off + n - 1) / pg exist;
// out [w_pad+1, P*R] int16 (out_bytes 2) or int32 (4).
int fscl_perm_prefix_sums(const void* table, const void* sig, void* out,
                          void* scratch, int w_pad, int P, int R, int n_sig,
                          int g0, int off, int n, int pg, int out_bytes,
                          void* stream) {
  PermIds ids{(const int16_t*)table, (const int32_t*)sig, n_sig, g0, off, n,
              pg};
  return launch(ids, out, scratch, w_pad, P, R, out_bytes,
                (cudaStream_t)stream);
}

}  // extern "C"
