// The block-permutation stream for Hopper: fscl_tpu's threefry draw of a
// chunk's runs and group sigma.
//
// Replaces the chain that fscl_tpu/ops/permute.py:57-150 leaves to XLA
// (_one_replicate_runs under _replicates and _replicates_runs, jitted and
// vmapped over replicates; no Pallas kernel).  Replicate r of a chunk
// (ops/permute.py in the port has the plain PyTorch version):
//
//   key      = threefry2x32(seed key, (0, start + r))        fold_in
//   k_phase  = threefry2x32(key, (0, 0)), k_perm = (key, (0, 1))  split
//   phase    = (float(bits(k_phase, 0) >> 9 | 1.0f) - 1) * width
//   block(g) = int((g0f[g] + phase) * inv_width), clipped to [0, nb - 2],
//              the last group pinned to nb - 1
//   order    = jax.random.permutation(k_perm, B), B = nb - 1: `rounds`
//              stable sorts by 32-bit keys bits(sub, j), (k, sub) =
//              split(k) before each; while it is the identity (and B >
//              1) k_perm = fold_in(k_perm, 1) and draw again
//   runs     = src[j] = start of block order[j], sz[j] its group count,
//              dst[j] their exclusive prefix; the tail block last
//   sigma[s] = s - dst[j] + src[j], j the last run with dst[j] <= s
//
// Bit for bit what XLA's CPU computes: threefry2x32 with JAX's rotation
// constants and key schedule, split and random_bits as under
// jax_threefry_partitionable (counter (0, i)), the phase and block ids
// in separately rounded float32 operations (__fsub_rn, __fmul_rn,
// __fadd_rn; XLA rewrites the division by the constant width as a
// product with float32(1 / width), and so does this kernel).
//
// What bounds it on the H100: the sigma row's bytes where it is written
// (G int32 a replicate); otherwise lane operations: the threefry hashes
// and the sort, and the latency of one replicate's dependent steps.
// Design (the launch plan, ops/permute.py:plan_replicate_runs, picks
// the geometry from the chunk's shape):
//   * a work item is a (replicate, tile of its sigma row); a block takes
//     one (a loop over items where global scratch bounds the blocks), so
//     a chunk of 16 replicates still fills the card: each tile's block
//     draws its replicate's runs again (cheap next to the row) and writes
//     its own tile;
//   * block starts: block(g) is monotone in g and in the phase, which
//     lies in [0, width], so start_b(width) <= start_b(phase) <=
//     start_b(0); the wrapper computes both brackets once per genome and
//     each start is a binary search inside its bracket (about G / nb
//     groups) in place of one over all G;
//   * the shuffle: one 64-bit word a shuffled block, (key << 32 |
//     position), so one ascending sort is the stable sort by key and the
//     positions give the round's permutation; values of earlier rounds
//     are gathered through it.  The sort is an MSD radix sort: a
//     counting sort of the keys' top log2 P bits into P buckets, then an
//     insertion sort of each bucket (about one word: the keys are
//     uniform hashes), eight barriers a round; in shared memory up to
//     8,192 blocks, past that over global scratch (the wrapper's
//     torch.empty), so any B that the int32 outputs admit is drawn.
//     tools/replicate_runs_variants.cu holds the alternatives that were
//     timed and lost: a bitonic sort with words in registers, and the
//     radix sort over a cluster's distributed shared memory;
//   * sigma: a table from s >> shift to the last run starting at or
//     before it (one binary search an entry, about one entry a run), then
//     a short walk a position; rows written 16 bytes a store where
//     aligned.
// No wgmma, no TMA: there is no matrix product, and the reads (g0f, the
// brackets) stay in L1 and L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kSmemMax = 232448;  // shared memory a block can use (H100)
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// JAX's threefry2x32 (jax/_src/prng.py:_threefry2x32_lowering)
__device__ __forceinline__ uint2 threefry(uint2 k, uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k.x, k.y, k.x ^ k.y ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return make_uint2(x0, x1);
}

// key i of split(k) and fold_in(k, i): both hash the counter (0, i)
__device__ __forceinline__ uint2 fold(uint2 k, uint32_t i) {
  return threefry(k, 0u, i);
}

// random_bits(k, 32, (n,))[i]
__device__ __forceinline__ uint32_t bits32(uint2 k, uint32_t i) {
  const uint2 y = threefry(k, 0u, i);
  return y.x ^ y.y;
}

// block id of group g (monotone in g and in phase)
__device__ __forceinline__ int block_of(const float* __restrict__ g0f,
                                        int g, int G, int nb, float phase,
                                        float inv_w) {
  if (g == G - 1) return nb - 1;  // the pinned tail group
  const float v = __fmul_rn(__fadd_rn(__ldg(g0f + g), phase), inv_w);
  const int b = __float2int_rz(v);
  return min(max(b, 0), nb - 2);
}

// exclusive prefix of v over the block's threads, and the total; syncs
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sum,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int s = lane < nw ? warp_sum[lane] : 0;
    int x = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += u;
    }
    warp_sum[lane] = x - s;
    if (lane == 31) warp_sum[32] = x;
  }
  __syncthreads();
  const int ex = warp_sum[warp] + incl - v;
  total = warp_sum[32];
  __syncthreads();
  return ex;
}

// One round's stable sort by 32-bit keys as an MSD radix sort: a
// counting sort of the keys' top log2 P bits into P buckets (cnt, P
// ints), then an insertion sort of each bucket (one or two words on
// average: the keys are uniform hashes) by the whole word (key << 32 |
// position), which puts equal keys in position order.  The sorted words
// land in out[0, B); the keys wait in stash [B] between the count and
// the scatter.  out, cnt and stash lie in shared memory or global
// scratch.
__device__ __forceinline__ void radix_sort(uint2 sub, int B, int lgP,
                                           u64* out, int* cnt,
                                           uint32_t* stash, int* warp_sum) {
  const int T = blockDim.x, tid = threadIdx.x;
  const long long P = 1ll << lgP;
  const int shr = 32 - lgP;  // 5 <= lgP <= 31
  for (long long b = tid; b < P; b += T) cnt[b] = 0;
  __syncthreads();
  for (int i = tid; i < B; i += T) {
    const uint32_t k = bits32(sub, (uint32_t)i);
    stash[i] = k;
    atomicAdd(cnt + (k >> shr), 1);
  }
  __syncthreads();
  const long long per = (P + T - 1) / T;  // bucket offsets: exclusive
  const long long b0 = min(tid * per, P), b1 = min(b0 + per, P);  // prefix
  int sum = 0;
  for (long long b = b0; b < b1; ++b) sum += cnt[b];
  int total;
  int off = block_exclusive_scan(sum, warp_sum, total);
  for (long long b = b0; b < b1; ++b) {
    const int c = cnt[b];
    cnt[b] = off;
    off += c;
  }
  __syncthreads();
  for (int i = tid; i < B; i += T) {
    const uint32_t k = stash[i];
    out[atomicAdd(cnt + (k >> shr), 1)] = ((u64)k << 32) | (u64)i;
  }
  __syncthreads();
  for (long long b = tid; b < P; b += T) {  // cnt[b]: the end of bucket b
    const int s0 = b ? cnt[b - 1] : 0, s1 = cnt[b];
    for (int x = s0 + 1; x < s1; ++x) {
      const u64 v = out[x];
      int y = x - 1;
      while (y >= s0 && out[y] > v) {
        out[y + 1] = out[y];
        --y;
      }
      out[y + 1] = v;
    }
  }
  __syncthreads();
}

// starts[b] = first group with block id >= b, inside its bracket, for b
// = first, first + stride, ... <= nb (starts[nb] = G)
__device__ __forceinline__ void block_starts(
    const float* __restrict__ g0f, const int* __restrict__ lo_b,
    const int* __restrict__ hi_b, int G, int nb, float phase, float inv_w,
    int* starts, long long first, long long stride) {
  for (long long b = first; b <= nb; b += stride) {
    int lo = __ldg(lo_b + b), hi = __ldg(hi_b + b);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (block_of(g0f, mid, G, nb, phase, inv_w) < b) lo = mid + 1;
      else hi = mid;
    }
    starts[b] = lo;
  }
}

// sigma[s] of groups [s0, s1) of one row (out) from the runs (dst, src -
// dst): a table tbl from s >> sh to the last run with dst <= s (a binary
// search an entry), then a short walk a position; [s0, sa) and [sb, s1)
// one int a store, [sa, sb) four.  Syncs the block.
__device__ __forceinline__ void write_sigma(int* out, const int2* runs,
                                            int* tbl, int nb, int s0,
                                            int s1, int sh) {
  const int T = blockDim.x, tid = threadIdx.x;
  const int c0 = s0 >> sh, nc = ((s1 - 1) >> sh) - c0 + 1;
  for (int c = tid; c < nc; c += T) {
    const int pos = (c0 + c) << sh;
    int lo = 0, hi = nb;  // first run with dst > pos
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (runs[mid].x <= pos) lo = mid + 1;
      else hi = mid;
    }
    tbl[c] = lo - 1;
  }
  __syncthreads();
  const int mis = (int)(((uintptr_t)(out + s0) >> 2) & 3);
  const int sa = min(s1, s0 + ((4 - mis) & 3));
  const int sb = sa + ((s1 - sa) & ~3);
  if (tid < (sa - s0) + (s1 - sb)) {  // at most 3 + 3 groups
    const int s = tid < sa - s0 ? s0 + tid : sb + tid - (sa - s0);
    int j = tbl[(s >> sh) - c0];
    while (j + 1 < nb && runs[j + 1].x <= s) ++j;
    out[s] = s + runs[j].y;
  }
  for (int s = sa + 4 * tid; s < sb; s += 4 * T) {
    int j = tbl[(s >> sh) - c0];
    int v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      while (j + 1 < nb && runs[j + 1].x <= s + q) ++j;
      v[q] = s + q + runs[j].y;
    }
    *reinterpret_cast<int4*>(out + s) = make_int4(v[0], v[1], v[2], v[3]);
  }
}

enum { kShared = 0, kGlobal = 1 };  // where a block's arrays lie

struct Params {
  const float* g0f;
  const int* lo;  // [nb + 1] first group of each block at phase = width
  const int* hi;  // [nb + 1] the same at phase = 0
  int G, nb, B, rounds;
  long long P;  // the radix sort's buckets: a power of two >= max(B, 32)
  float width, inv_w;
  uint2 seed_key;
  uint32_t start;
  int n_rep, tiles, tile_len, shift, tbl_len;
  int *src_out, *dst_out, *sz_out, *sigma_out;
  unsigned char* scratch;  // kGlobal: a slot of slot_bytes a block
  long long slot_bytes;
};

__host__ __device__ inline long long align16(long long x) {
  return (x + 15) & ~15ll;
}

// One replicate's arrays: words [max(P, nb)] (u64; after the shuffle the
// runs [nb] int2), starts [nb + 1], xa [B] (the order), an int array of
// max(P, tbl_len) (the bucket counts, then the sigma table) and the
// radix sort's key stash [B].  Shared memory a block, or global scratch
// a block (kGlobal).
struct Layout {
  long long words, starts, xa, aux, stash, bytes;
  __host__ __device__ Layout(long long P, int nb, int tbl_len) {
    words = 0;
    starts = align16(8ll * (P > nb ? P : nb));
    xa = align16(starts + 4ll * (nb + 1));
    aux = align16(xa + 4ll * (nb - 1));
    stash = align16(aux + 4ll * (P > tbl_len ? P : tbl_len));
    bytes = align16(stash + 4ll * (nb - 1));
  }
};

// a block's pointers into its Layout at base
struct Arrays {
  u64* words;
  int* starts;
  int* xa;
  int* aux;  // the bucket counts, then the sigma table
  uint32_t* stash;
  int2* runs;  // over the words
  __device__ Arrays(unsigned char* base, const Layout& lay)
      : words(reinterpret_cast<u64*>(base + lay.words)),
        starts(reinterpret_cast<int*>(base + lay.starts)),
        xa(reinterpret_cast<int*>(base + lay.xa)),
        aux(reinterpret_cast<int*>(base + lay.aux)),
        stash(reinterpret_cast<uint32_t*>(base + lay.stash)),
        runs(reinterpret_cast<int2*>(base + lay.words)) {}
};

// replicate r's key (fold_in) and phase
__device__ __forceinline__ float replicate_phase(const Params& p, int r,
                                                 uint2& key) {
  key = fold(p.seed_key, p.start + (uint32_t)r);
  const uint32_t pb = bits32(fold(key, 0u), 0u);
  return __fmul_rn(
      __fsub_rn(__uint_as_float((pb >> 9) | 0x3F800000u), 1.0f), p.width);
}

// one round's radix_sort into the block's arrays, as shuffle_order calls
// it
struct RadixSort {
  int B, lgP;
  u64* out;
  int* cnt;
  uint32_t* stash;
  int* warp_sum;
  __device__ void operator()(uint2 sub) const {
    radix_sort(sub, B, lgP, out, cnt, stash, warp_sum);
  }
};

// The shuffle with its redraw loop: the order of the B shuffled blocks
// ends in xa (B = 1: no round, the identity).  sort(sub) sorts one
// round's words (key << 32 | position) into words[0, B) and syncs; the
// round's new order is xa[m] = xa_old[position of word m].  Syncs.
template <class Sort>
__device__ __forceinline__ void shuffle_order(uint2 key, int B, int rounds,
                                              u64* words, int* xa,
                                              const Sort& sort) {
  const int T = blockDim.x, tid = threadIdx.x;
  if (rounds == 0) {
    for (int m = tid; m < B; m += T) xa[m] = m;
    __syncthreads();
    return;
  }
  uint2 kp = fold(key, 1u);
  for (;;) {
    uint2 k = kp;
    for (int round = 0; round < rounds; ++round) {
      const uint2 sub = fold(k, 1u);
      k = fold(k, 0u);
      sort(sub);
      // the new order: for round > 0 first gathered into the words' high
      // halves (every read of xa before any write)
      if (round > 0) {
        for (int m = tid; m < B; m += T) {
          const unsigned pos = (unsigned)words[m];
          words[m] = ((u64)(unsigned)xa[pos] << 32) | pos;
        }
        __syncthreads();
      }
      for (int m = tid; m < B; m += T)
        xa[m] = (int)(round > 0 ? words[m] >> 32 : words[m]);
      __syncthreads();
    }
    int moved = 0;
    for (int m = tid; m < B; m += T) moved |= xa[m] != m;
    if (__syncthreads_or(moved) || B <= 1) break;
    kp = fold(kp, 1u);
  }
}

// Replicate r's runs from its starts and order: run m < B is block
// xa[m]; run B the tail block (its group G - 1 alone, at dst = src =
// starts[nb - 1], the head's total).  Sizes, their exclusive prefix over
// the block, then (dst, src - dst) into runs (over the words: every read
// of them is done) and, write_runs, the outputs' row r.  coalesced: the
// block takes runs T at a time (where the runs are written or lie in
// global scratch); else thread t takes runs [t per, t per + per) of one
// scan.  Syncs.
__device__ __forceinline__ void make_runs(const Params& p, int r,
                                          bool write_runs, bool coalesced,
                                          const int* starts, const int* xa,
                                          int2* runs, int* warp_sum) {
  const int T = blockDim.x, tid = threadIdx.x, B = p.B, nb = p.nb;
  const size_t row = (size_t)r * nb;
  const int per = coalesced ? 1 : (B + T - 1) / T;
  const int step = coalesced ? T : B;
  int carry = 0;
  for (int c0 = 0; c0 < B; c0 += step) {
    const int m0 = min(c0 + tid * per, B);
    const int m1 = min(m0 + per, min(c0 + step, B));
    int sum = 0;
    for (int m = m0; m < m1; ++m) {
      const int o = xa[m];
      sum += starts[o + 1] - starts[o];
    }
    int total;
    int dst = carry + block_exclusive_scan(sum, warp_sum, total);
    carry += total;
    for (int m = m0; m < m1; ++m) {
      const int o = xa[m], src = starts[o], sz = starts[o + 1] - src;
      runs[m] = make_int2(dst, src - dst);
      if (write_runs) {
        p.src_out[row + m] = src;
        p.dst_out[row + m] = dst;
        p.sz_out[row + m] = sz;
      }
      dst += sz;
    }
  }
  if (tid == 0) {
    const int tail = starts[nb - 1];
    runs[B] = make_int2(tail, 0);
    if (write_runs) {
      p.src_out[row + B] = tail;
      p.dst_out[row + B] = tail;
      p.sz_out[row + B] = p.G - tail;
    }
  }
  __syncthreads();
}

// A work item is a (replicate, tile of its sigma row); block i takes
// items i, i + grid, ...  32 registers a thread in shared memory, so
// that 2,048 threads an SM fit; 64 over global scratch.
template <int kMode>
__global__ void __launch_bounds__(1024, kMode == kGlobal ? 1 : 2)
    replicate_runs_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sum[33];
  const Arrays a(kMode == kGlobal
                     ? p.scratch + (long long)blockIdx.x * p.slot_bytes
                     : smem,
                 Layout(p.P, p.nb, p.tbl_len));
  const RadixSort sort{p.B, __ffsll(p.P) - 1, a.words, a.aux, a.stash,
                       warp_sum};
  for (int item = blockIdx.x; item < p.n_rep * p.tiles; item += gridDim.x) {
    const int r = item / p.tiles, tile = item - r * p.tiles;
    uint2 key;
    const float phase = replicate_phase(p, r, key);
    block_starts(p.g0f, p.lo, p.hi, p.G, p.nb, phase, p.inv_w, a.starts,
                 threadIdx.x, blockDim.x);
    shuffle_order(key, p.B, p.rounds, a.words, a.xa, sort);
    const bool write_runs = p.src_out != nullptr && tile == 0;
    make_runs(p, r, write_runs, kMode == kGlobal || write_runs, a.starts,
              a.xa, a.runs, warp_sum);
    // sigma of this tile's groups [s0, s1)
    const int s0 = tile * p.tile_len, s1 = min(p.G, s0 + p.tile_len);
    if (p.sigma_out != nullptr && s0 < s1)
      write_sigma(p.sigma_out + (size_t)r * p.G, a.runs, a.aux, p.nb, s0,
                  s1, p.shift);
    __syncthreads();  // the next item reuses every array
  }
}

// Params from the entry's arguments (see fscl_replicate_runs), or false
// where they are invalid
inline bool make_params(const void* g0f, const void* lo, const void* hi,
                        int G, int nb, int rounds, float width,
                        float inv_width, unsigned key0, unsigned key1,
                        unsigned start, int n_rep, int threads, int tiles,
                        int tile_len, int shift, void* scratch,
                        long long slot_bytes, void* src, void* dst,
                        void* sz, void* sigma, Params& p) {
  const int B = nb - 1;
  if (B < 1 || G < 1 || n_rep < 0 || rounds < 0 || threads < 32 ||
      threads > 1024 || threads % 32 || tiles < 1 || tile_len < 1 ||
      (long long)tiles * tile_len < G ||
      (long long)(tiles - 1) * tile_len >= G || shift < 0 || shift > 30)
    return false;
  long long P = 32;
  while (P < B) P <<= 1;
  p.g0f = (const float*)g0f;
  p.lo = (const int*)lo;
  p.hi = (const int*)hi;
  p.G = G;
  p.nb = nb;
  p.B = B;
  p.rounds = rounds;
  p.P = P;
  p.width = width;
  p.inv_w = inv_width;
  p.seed_key = make_uint2(key0, key1);
  p.start = start;
  p.n_rep = n_rep;
  p.tiles = tiles;
  p.tile_len = tile_len;
  p.shift = shift;
  p.tbl_len = (tile_len >> shift) + 2;
  p.src_out = (int*)src;
  p.dst_out = (int*)dst;
  p.sz_out = (int*)sz;
  p.sigma_out = (int*)sigma;
  p.scratch = (unsigned char*)scratch;
  p.slot_bytes = slot_bytes;
  return true;
}

// launch kern with smem bytes of dynamic shared memory; the CUDA error
template <class Kernel>
int launch(Kernel kern, const Params& p, int grid, int threads, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of one replicate's arrays (Layout): shared memory a block, or
// global scratch a block.  tbl_len = (tile_len >> shift) + 2.
long long fscl_replicate_runs_bytes(long long P, int nb, int tbl_len) {
  return Layout(P, nb, tbl_len).bytes;
}

// g0f [G] float32 group first positions; lo, hi [nb + 1] int32 the
// brackets of the block starts (phase = width and phase = 0); runs
// src/dst/sz [n_rep, nb] and sigma [n_rep, G] int32, each written unless
// null (the runs' three together).  The plan (ops/permute.py:
// plan_replicate_runs): threads a block, tiles of tile_len groups a
// sigma row, the table's shift, the blocks (grid); the arrays in shared
// memory where scratch is null, else over global scratch, grid slots of
// slot_bytes.  B = nb - 1 >= 1, G >= 1, n_rep x max(G, nb) < 2^31.
// Returns the launch's CUDA error (0 = success).
int fscl_replicate_runs(const void* g0f, const void* lo, const void* hi,
                        int G, int nb, int rounds, float width,
                        float inv_width, unsigned key0, unsigned key1,
                        unsigned start, int n_rep, int threads, int tiles,
                        int tile_len, int shift, int grid, void* scratch,
                        long long slot_bytes, void* src, void* dst,
                        void* sz, void* sigma, void* stream) {
  Params p;
  if (!make_params(g0f, lo, hi, G, nb, rounds, width, inv_width, key0,
                   key1, start, n_rep, threads, tiles, tile_len, shift,
                   scratch, slot_bytes, src, dst, sz, sigma, p))
    return (int)cudaErrorInvalidValue;
  if (n_rep == 0) return 0;
  if (grid < 1 || grid > (long long)n_rep * tiles)
    return (int)cudaErrorInvalidValue;
  const long long bytes = Layout(p.P, nb, p.tbl_len).bytes;
  const cudaStream_t s = (cudaStream_t)stream;
  if (scratch != nullptr) {
    if (slot_bytes < bytes) return (int)cudaErrorInvalidValue;
    return launch(replicate_runs_kernel<kGlobal>, p, grid, threads, 0, s);
  }
  if (bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  return launch(replicate_runs_kernel<kShared>, p, grid, threads,
                (size_t)bytes, s);
}

}  // extern "C"
