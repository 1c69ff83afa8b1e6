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
// Design.  Three passes over 256-site tiles, as csrc/prefix_sums.cu:
//   1. wtile_pass<false>: one block per (tile, segment, lane block)
//      stages the tile's ids of its replicates in shared memory; each
//      thread sums its lane over the tile in site order;
//   2. wtile_scan: one thread per (segment, lane) turns the tile totals
//      into exclusive carries, in place;
//   3. wtile_pass<true>: the same walk from the carry, storing the
//      running value.
// Every sum (tile totals, carries, running values) is float64 in a fixed
// order, rounded to float32 only at the store: no atomics, so two runs
// give the same bits, and the error is one float32 rounding of a value
// that is exact to float64 -- the Pallas kernel's compensated carry kept
// about the same.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;     // sites per tile
constexpr int kThreads = 128;  // lanes per block
constexpr int kStage = 64;     // sites staged per shared-memory round

template <bool kWrite>
__global__ void wtile_pass(const int16_t* __restrict__ table,
                           const float* __restrict__ weights,
                           const int32_t* __restrict__ sig,
                           const int32_t* __restrict__ seg_g0,
                           double* __restrict__ tile_acc,
                           float* __restrict__ out, int w, int P, int R,
                           int n_ids, int n_sig, int pg, int n_tiles) {
  // ids of the replicates this block's lanes cover: at most kThreads
  __shared__ int16_t ids[kStage * kThreads];
  const int t = blockIdx.x;
  const int s = blockIdx.y;
  const int L = P * R;
  const int l0 = blockIdx.z * kThreads;
  const int l = l0 + threadIdx.x;
  const bool live = l < L;
  const int p_lo = l0 / R;
  const int n_rep = min(P - 1, (l0 + kThreads - 1) / R) - p_lo + 1;
  const int p_loc = live ? l / R - p_lo : 0;
  const int r = live ? l % R : 0;
  const int k0 = t * kTile;
  const int n = min(kTile, w - k0);
  const int j8_base = seg_g0[s] - 1;
  const size_t slot = ((size_t)s * n_tiles + t) * L + l;
  double run = (kWrite && live) ? tile_acc[slot] : 0.0;
  float* dst = out + ((size_t)s * w + k0) * L + l;
  for (int c0 = 0; c0 < n; c0 += kStage) {
    const int m = min(kStage, n - c0);
    __syncthreads();  // the previous round's reads are done
    for (int e = threadIdx.x; e < m * n_rep; e += kThreads) {
      const int pe = e / m;
      const int kk = e % m;
      const int k = k0 + c0 + kk;
      int j8 = j8_base + k / pg;
      if (j8 < 0) j8 = n_sig - 1;
      const int sel = sig[(size_t)(p_lo + pe) * n_sig + j8];
      int id = table[(size_t)sel * pg + k % pg];
      if (id < 0 || id >= n_ids) id = n_ids - 1;
      ids[kk * n_rep + pe] = (int16_t)id;
    }
    __syncthreads();
    if (live) {
      for (int kk = 0; kk < m; ++kk) {
        const int id = ids[kk * n_rep + p_loc];
        run += (double)__ldg(weights + (size_t)id * R + r);
        if (kWrite) dst[(size_t)(c0 + kk) * L] = (float)run;
      }
    }
  }
  if (!kWrite && live) tile_acc[slot] = run;
}

__global__ void wtile_scan(double* __restrict__ tile_acc, int S, int L,
                           int n_tiles) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)S * L) return;
  const int s = (int)(i / L);
  const int l = (int)(i % L);
  double* col = tile_acc + (size_t)s * n_tiles * L + l;
  double run = 0.0;
  for (int t = 0; t < n_tiles; ++t) {
    const double c = col[(size_t)t * L];
    col[(size_t)t * L] = run;
    run += c;
  }
}

}  // namespace

extern "C" {

// Tile length and scratch layout the wrapper must allocate for:
// scratch holds S * ceil(w / tile) * P * R float64.
int fscl_wps_tile() { return kTile; }

// table   [*, pg] int16    row-id group table (row = group, sentinel last)
// weights [n_ids, R] f32   weight channels per row id (last row zero)
// sig     [P, n_sig] int32 group-level sigma of one replicate slice
// seg_g0  [S] int32        first genome group of each segment
// out     [S*w, P*R] f32
// Returns cudaGetLastError() after the launches (0 = success).
int fscl_weighted_prefix_sums(const void* table, const void* weights,
                              const void* sig, const void* seg_g0, void* out,
                              void* scratch, int S, int w, int P, int R,
                              int n_ids, int n_sig, int pg, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = (w + kTile - 1) / kTile;
  const int L = P * R;
  const int16_t* tab = (const int16_t*)table;
  const float* wts = (const float*)weights;
  const int32_t* sg = (const int32_t*)sig;
  const int32_t* g0 = (const int32_t*)seg_g0;
  double* acc = (double*)scratch;
  float* o = (float*)out;

  dim3 grid(n_tiles, S, (L + kThreads - 1) / kThreads);
  wtile_pass<false><<<grid, kThreads, 0, st>>>(
      tab, wts, sg, g0, acc, o, w, P, R, n_ids, n_sig, pg, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int64_t lanes = (int64_t)S * L;
  wtile_scan<<<(unsigned)((lanes + 255) / 256), 256, 0, st>>>(acc, S, L,
                                                              n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  wtile_pass<true><<<grid, kThreads, 0, st>>>(
      tab, wts, sg, g0, acc, o, w, P, R, n_ids, n_sig, pg, n_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
