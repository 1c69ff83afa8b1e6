// The alternatives to fscl_tpu_torch/csrc/replicate_runs.cu's design
// that tools/stream_variants.py times, and its stages cut off, built on
// the package's own source (included below, so that every helper is the
// package's):
//
//   * variant_kernel: the package's work loop with each item cut after
//     the block starts, the shuffle or the runs (stop = 1, 2, 3), or with
//     up to 64 registers a thread in shared memory (min_blocks = 1; the
//     package caps them at 32), or with the shuffle as a bitonic sort in
//     shared memory, E = 1, 2, 4 or 8 words a thread in registers (E = 1
//     puts every stride from 32 on behind a barrier, as the first
//     version's sort);
//   * cluster_kernel: a replicate a thread-block cluster of 8 blocks, the
//     radix sort's words, counts and keys spread over the cluster's
//     distributed shared memory (8,192 < B <= 65,536), in place of global
//     scratch; cut as above.
//
// Both lost to the package's design on the H100 (PERF.md section 6):
// the bitonic sort at every E to the radix sort, the cluster to global
// scratch (2.964 against 2.943 ms at 256 replicates of 33,367 blocks).
// An early stop writes one value a replicate (the sigma row's first
// entry, else the runs' dst) so that the work it keeps is not optimised
// away.

#include <cooperative_groups.h>

#include "../fscl_tpu_torch/csrc/replicate_runs.cu"

namespace {

__device__ __forceinline__ u64 umin64(u64 a, u64 b) { return a < b ? a : b; }
__device__ __forceinline__ u64 umax64(u64 a, u64 b) { return a < b ? b : a; }

// One round's stable sort as an ascending bitonic sort of the P words
// (key << 32 | position, pads ~0 past B), thread t < P / E holding words
// t E .. t E + E - 1 in registers: strides below E in registers, below
// 32 E by warp shuffles, larger ones through shared memory (sw, P words)
// with a barrier a stage.  The sorted words land in sw[0, B).
template <int E>
__device__ __forceinline__ void bitonic_sort(uint2 sub, int B, int P,
                                             u64* sw) {
  const int t = threadIdx.x;
  const bool active = t < P / E;
  u64 w[E];
  if (active) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = t * E + e;
      w[e] = i < B ? ((u64)bits32(sub, (uint32_t)i) << 32) | (u64)i : ~0ull;
    }
  }
  for (int k = 2; k <= P; k <<= 1) {  // ascending where bit k is 0
    int j = k >> 1;
    if (j >= 32 * E) {
      if (active) {
#pragma unroll
        for (int e = 0; e < E; ++e) sw[t * E + e] = w[e];
      }
      __syncthreads();
      for (; j >= 32 * E; j >>= 1) {
        for (int q = threadIdx.x; q < (P >> 1); q += blockDim.x) {
          const int a = 2 * q - (q & (j - 1)), b = a + j;
          const u64 x = sw[a], y = sw[b];
          if ((x > y) == ((a & k) == 0)) {
            sw[a] = y;
            sw[b] = x;
          }
        }
        __syncthreads();
      }
      if (active) {
#pragma unroll
        for (int e = 0; e < E; ++e) w[e] = sw[t * E + e];
      }
    }
    if (!active) continue;
    for (; j >= E; j >>= 1) {  // partner in lane t ^ (j / E), same slot
      const int m = j / E;
      const bool lower = (t & m) == 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const u64 v = w[e];
        const u64 p = __shfl_xor_sync(kFull, v, m);
        w[e] = (lower == (((t * E + e) & k) == 0)) ? umin64(v, p)
                                                   : umax64(v, p);
      }
    }
#pragma unroll
    for (int jj = E / 2; jj >= 1; jj >>= 1) {  // partner in this thread
      if (jj <= j) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & jj) == 0) {
            const u64 x = w[e], y = w[e + jj];
            if ((x > y) == (((t * E + e) & k) == 0)) {
              w[e] = y;
              w[e + jj] = x;
            }
          }
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int e = 0; e < E; ++e) sw[t * E + e] = w[e];
  }
  __syncthreads();
}

template <int E>
struct BitonicSort {
  int B, P;
  u64* words;
  __device__ void operator()(uint2 sub) const {
    bitonic_sort<E>(sub, B, P, words);
  }
};

__device__ __forceinline__ int* stop_sink(const Params& p, int r) {
  return p.sigma_out ? p.sigma_out + (size_t)r * p.G
                     : p.dst_out + (size_t)r * p.nb;
}

// replicate_runs_kernel with a stop, a register cap and a sort (E = 0:
// the package's radix sort; else the bitonic sort, shared memory only)
template <int kMode, int kStop, int E, int kMinBlocks>
__global__ void __launch_bounds__(1024, kMinBlocks)
    variant_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sum[33];
  const Arrays a(kMode == kGlobal
                     ? p.scratch + (long long)blockIdx.x * p.slot_bytes
                     : smem,
                 Layout(p.P, p.nb, p.tbl_len));
  for (int item = blockIdx.x; item < p.n_rep * p.tiles; item += gridDim.x) {
    const int r = item / p.tiles, tile = item - r * p.tiles;
    uint2 key;
    const float phase = replicate_phase(p, r, key);
    block_starts(p.g0f, p.lo, p.hi, p.G, p.nb, phase, p.inv_w, a.starts,
                 threadIdx.x, blockDim.x);
    if constexpr (kStop == 1) {
      __syncthreads();
      if (threadIdx.x == 0 && tile == 0)
        *stop_sink(p, r) = a.starts[p.nb >> 1];
      continue;
    }
    if constexpr (E > 0) {
      const BitonicSort<E> sort{p.B, (int)p.P, a.words};
      shuffle_order(key, p.B, p.rounds, a.words, a.xa, sort);
    } else {
      const RadixSort sort{p.B, __ffsll(p.P) - 1, a.words, a.aux, a.stash,
                           warp_sum};
      shuffle_order(key, p.B, p.rounds, a.words, a.xa, sort);
    }
    if constexpr (kStop == 2) {
      if (threadIdx.x == 0 && tile == 0) *stop_sink(p, r) = a.xa[p.B >> 1];
      continue;
    }
    const bool write_runs = p.src_out != nullptr && tile == 0;
    make_runs(p, r, write_runs, kMode == kGlobal || write_runs, a.starts,
              a.xa, a.runs, warp_sum);
    if constexpr (kStop == 3) {
      if (threadIdx.x == 0 && tile == 0)
        *stop_sink(p, r) = a.runs[p.B >> 1].x;
      continue;
    }
    const int s0 = tile * p.tile_len, s1 = min(p.G, s0 + p.tile_len);
    if (p.sigma_out != nullptr && s0 < s1)
      write_sigma(p.sigma_out + (size_t)r * p.G, a.runs, a.aux, p.nb, s0,
                  s1, p.shift);
    __syncthreads();
  }
}

// ---- a replicate a thread-block cluster (8,192 < B <= 65,536) ----------
// The words, bucket counts and key stash of one replicate spread over
// the shared memory of a cluster's kCluster blocks, chunks of L = P /
// kCluster entries a block, reached through distributed shared memory;
// starts, the order and the runs in global scratch, a slot a cluster;
// cluster barriers between the phases; block q writes sigma tile q.

namespace cg = cooperative_groups;
constexpr int kCluster = 8;

// entry i of an array spread over the cluster in chunks of 2^lgL
template <typename T>
__device__ __forceinline__ T* dsm(cg::cluster_group& cl, T* local,
                                  long long i, int lgL) {
  return cl.map_shared_rank(local, (unsigned)(i >> lgL)) +
         (i & ((1ll << lgL) - 1));
}

// exclusive prefix of v over the cluster's threads (block rank major),
// and the total; syncs the cluster
__device__ __forceinline__ int cluster_exclusive_scan(cg::cluster_group& cl,
                                                      int v, int* warp_sum,
                                                      int* block_total,
                                                      int& total) {
  int mine;
  const int ex = block_exclusive_scan(v, warp_sum, mine);
  if (threadIdx.x == 0) *block_total = mine;
  cl.sync();
  const unsigned q = cl.block_rank();
  int base = 0, all = 0;
  for (unsigned r = 0; r < kCluster; ++r) {
    const int t = *cl.map_shared_rank(block_total, r);
    base += r < q ? t : 0;
    all += t;
  }
  cl.sync();  // every read of block_total done
  total = all;
  return base + ex;
}

// radix_sort over the cluster: the same counting sort and insertion sort
__device__ __forceinline__ void cluster_radix_sort(
    cg::cluster_group& cl, uint2 sub, int B, int lgP, int lgL, u64* words,
    int* cnt, uint32_t* stash, int* warp_sum, int* block_total) {
  const int T = blockDim.x, L = 1 << lgL, shr = 32 - lgP;
  const long long cid = (long long)cl.block_rank() * T + threadIdx.x;
  const long long CT = (long long)kCluster * T, P = 1ll << lgP;
  for (int b = threadIdx.x; b < L; b += T) cnt[b] = 0;
  cl.sync();
  for (long long i = cid; i < B; i += CT) {
    const uint32_t k = bits32(sub, (uint32_t)i);
    *dsm(cl, stash, i, lgL) = k;
    atomicAdd(dsm(cl, cnt, k >> shr, lgL), 1);
  }
  cl.sync();
  const int per = (L + T - 1) / T;  // this block's buckets' offsets
  const int b0 = min((int)threadIdx.x * per, L), b1 = min(b0 + per, L);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += cnt[b];
  int total;
  int off = cluster_exclusive_scan(cl, sum, warp_sum, block_total, total);
  for (int b = b0; b < b1; ++b) {
    const int c = cnt[b];
    cnt[b] = off;
    off += c;
  }
  cl.sync();
  for (long long i = cid; i < B; i += CT) {
    const uint32_t k = *dsm(cl, stash, i, lgL);
    const int at = atomicAdd(dsm(cl, cnt, k >> shr, lgL), 1);
    *dsm(cl, words, at, lgL) = ((u64)k << 32) | (u64)i;
  }
  cl.sync();
  for (long long b = cid; b < P; b += CT) {  // cnt[b]: the end of bucket b
    const int s0 = b ? *dsm(cl, cnt, b - 1, lgL) : 0;
    const int s1 = *dsm(cl, cnt, b, lgL);
    for (int x = s0 + 1; x < s1; ++x) {
      const u64 v = *dsm(cl, words, x, lgL);
      int y = x - 1;
      for (; y >= s0; --y) {
        const u64 w = *dsm(cl, words, y, lgL);
        if (w <= v) break;
        *dsm(cl, words, y + 1, lgL) = w;
      }
      *dsm(cl, words, y + 1, lgL) = v;
    }
  }
  cl.sync();
}

// global scratch of a cluster: starts [nb + 1], xa [B], runs [nb] int2
struct ClusterSlot {
  long long starts, xa, runs, bytes;
  __host__ __device__ ClusterSlot(int nb) {
    starts = 0;
    xa = align16(4ll * (nb + 1));
    runs = align16(xa + 4ll * (nb - 1));
    bytes = align16(runs + 8ll * nb);
  }
};

template <int kStop>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(1024, 1)
    cluster_kernel(const Params p) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sum[33];
  __shared__ int block_total, block_moved;
  const int T = blockDim.x, tid = threadIdx.x;
  const int q = (int)cl.block_rank();
  const long long cid = (long long)q * T + tid, CT = (long long)kCluster * T;
  const int G = p.G, nb = p.nb, B = p.B;
  const int lgP = __ffsll(p.P) - 1, lgL = lgP - 3, L = 1 << lgL;
  u64* words = reinterpret_cast<u64*>(smem);               // chunk [L]
  int* cnt = reinterpret_cast<int*>(smem + 8ll * L);       // chunk [L]
  uint32_t* stash = reinterpret_cast<uint32_t*>(smem + 12ll * L);
  int* tbl = reinterpret_cast<int*>(smem + 16ll * L);      // [tbl_len]
  const int cluster = blockIdx.x / kCluster;
  const int clusters = gridDim.x / kCluster;
  const ClusterSlot lay(nb);
  unsigned char* slot = p.scratch + (long long)cluster * p.slot_bytes;
  int* starts = reinterpret_cast<int*>(slot + lay.starts);
  int* xa = reinterpret_cast<int*>(slot + lay.xa);
  int2* runs = reinterpret_cast<int2*>(slot + lay.runs);

  for (int r = cluster; r < p.n_rep; r += clusters) {
    uint2 key;
    const float phase = replicate_phase(p, r, key);
    block_starts(p.g0f, p.lo, p.hi, G, nb, phase, p.inv_w, starts, cid, CT);
    cl.sync();
    if constexpr (kStop == 1) {
      if (cid == 0) *stop_sink(p, r) = starts[nb >> 1];
      cl.sync();
      continue;
    }

    uint2 kp = fold(key, 1u);  // B > 1: at least one round
    for (;;) {
      uint2 k = kp;
      for (int round = 0; round < p.rounds; ++round) {
        const uint2 sub = fold(k, 1u);
        k = fold(k, 0u);
        cluster_radix_sort(cl, sub, B, lgP, lgL, words, cnt, stash,
                           warp_sum, &block_total);
        if (round > 0) {
          for (long long m = cid; m < B; m += CT) {
            u64* w = dsm(cl, words, m, lgL);
            const unsigned pos = (unsigned)*w;
            *w = ((u64)(unsigned)xa[pos] << 32) | pos;
          }
          cl.sync();
        }
        for (long long m = cid; m < B; m += CT) {
          const u64 w = *dsm(cl, words, m, lgL);
          xa[m] = (int)(round > 0 ? w >> 32 : w);
        }
        cl.sync();
      }
      int moved = 0;
      for (long long m = cid; m < B; m += CT) moved |= xa[m] != (int)m;
      moved = __syncthreads_or(moved);
      if (tid == 0) block_moved = moved;
      cl.sync();
      int any = 0;
      for (unsigned rr = 0; rr < kCluster; ++rr)
        any |= *cl.map_shared_rank(&block_moved, rr);
      cl.sync();
      if (any) break;
      kp = fold(kp, 1u);
    }
    if constexpr (kStop == 2) {
      if (cid == 0) *stop_sink(p, r) = xa[B >> 1];
      cl.sync();
      continue;
    }

    // runs, T x kCluster at a time, coalesced (see the block kernel)
    const size_t row = (size_t)r * nb;
    const bool write_runs = p.src_out != nullptr;
    int carry = 0;
    for (long long c0 = 0; c0 < B; c0 += CT) {
      const long long m = c0 + cid;
      int src = 0, sz = 0;
      if (m < B) {
        const int o = xa[m];
        src = starts[o];
        sz = starts[o + 1] - src;
      }
      int total;
      const int dst = carry + cluster_exclusive_scan(cl, sz, warp_sum,
                                                     &block_total, total);
      carry += total;
      if (m < B) {
        runs[m] = make_int2(dst, src - dst);
        if (write_runs) {
          p.src_out[row + m] = src;
          p.dst_out[row + m] = dst;
          p.sz_out[row + m] = sz;
        }
      }
    }
    if (cid == 0) {
      const int tail = starts[nb - 1];
      runs[B] = make_int2(tail, 0);
      if (write_runs) {
        p.src_out[row + B] = tail;
        p.dst_out[row + B] = tail;
        p.sz_out[row + B] = G - tail;
      }
    }
    cl.sync();
    if constexpr (kStop == 3) {
      if (cid == 0) *stop_sink(p, r) = runs[B >> 1].x;
      cl.sync();
      continue;
    }

    const int s0 = q * p.tile_len, s1 = min(G, s0 + p.tile_len);
    if (p.sigma_out != nullptr && s0 < s1)
      write_sigma(p.sigma_out + (size_t)r * G, runs, tbl, nb, s0, s1,
                  p.shift);
    cl.sync();  // the next replicate reuses every array
  }
}

typedef int (*Go)(const Params&, int, int, size_t, cudaStream_t);

template <int kMode, int kStop, int E, int kMinBlocks>
int go(const Params& p, int grid, int threads, size_t smem,
       cudaStream_t s) {
  return launch(variant_kernel<kMode, kStop, E, kMinBlocks>, p, grid,
                threads, smem, s);
}

template <int kStop>
int go_cluster(const Params& p, int grid, int threads, size_t smem,
               cudaStream_t s) {
  return launch(cluster_kernel<kStop>, p, grid * kCluster, threads, smem,
                s);
}

}  // namespace

extern "C" {

// Global scratch bytes of a cluster (ClusterSlot).
long long fscl_rr_cluster_bytes(int nb) { return ClusterSlot(nb).bytes; }

// fscl_replicate_runs's arguments, then the variant: stop 0 (whole) or 1,
// 2, 3; E 0 (the radix sort) or 1, 2, 4, 8 (the bitonic sort, shared
// memory, threads >= P / E, P = max(B, 32 E) rounded up to a power of
// two); cluster (a replicate a cluster of 8 blocks, grid clusters,
// scratch slots of slot_bytes a cluster, tiles <= 8); min_blocks, the
// radix sort in shared memory: 2 (32 registers) or 1 (64, whole only);
// over global scratch 64 registers whatever it is.
int fscl_rr_variant(const void* g0f, const void* lo, const void* hi, int G,
                    int nb, int rounds, float width, float inv_width,
                    unsigned key0, unsigned key1, unsigned start, int n_rep,
                    int threads, int tiles, int tile_len, int shift,
                    int grid, void* scratch, long long slot_bytes,
                    void* src, void* dst, void* sz, void* sigma,
                    void* stream, int stop, int E, int cluster,
                    int min_blocks) {
  Params p;
  if (!make_params(g0f, lo, hi, G, nb, rounds, width, inv_width, key0,
                   key1, start, n_rep, threads, tiles, tile_len, shift,
                   scratch, slot_bytes, src, dst, sz, sigma, p) ||
      stop < 0 || stop > 3 || n_rep < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (cluster) {
    const Go f[4] = {go_cluster<0>, go_cluster<1>, go_cluster<2>,
                     go_cluster<3>};
    // chunks of P / kCluster words, counts and keys a block, the table
    const size_t smem = (size_t)16 * (p.P / kCluster) + (size_t)4 *
                        p.tbl_len;
    if (p.B < 2 * kCluster || tiles > kCluster || scratch == nullptr ||
        slot_bytes < ClusterSlot(nb).bytes || smem > (size_t)kSmemMax ||
        grid < 1 || grid > n_rep)
      return (int)cudaErrorInvalidValue;
    return f[stop](p, grid, threads, smem, s);
  }
  if (grid < 1 || grid > (long long)n_rep * tiles)
    return (int)cudaErrorInvalidValue;
  if (E > 0) {
    while (p.P < 32 * E) p.P <<= 1;
    const long long bytes = Layout(p.P, nb, p.tbl_len).bytes;
    if (scratch != nullptr || stop != 0 || p.P / E > threads ||
        bytes > kSmemMax)
      return (int)cudaErrorInvalidValue;
    const Go f = E == 1 ? go<kShared, 0, 1, 2> : E == 2 ? go<kShared, 0, 2, 2>
                 : E == 4 ? go<kShared, 0, 4, 2> : E == 8 ? go<kShared, 0, 8, 2>
                 : nullptr;
    return f ? f(p, grid, threads, (size_t)bytes, s)
             : (int)cudaErrorInvalidValue;
  }
  const long long bytes = Layout(p.P, nb, p.tbl_len).bytes;
  if (scratch != nullptr) {
    const Go f[4] = {go<kGlobal, 0, 0, 1>, go<kGlobal, 1, 0, 1>,
                     go<kGlobal, 2, 0, 1>, go<kGlobal, 3, 0, 1>};
    if (slot_bytes < bytes) return (int)cudaErrorInvalidValue;
    return f[stop](p, grid, threads, 0, s);
  }
  if (bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  if (min_blocks == 1) {
    if (stop != 0) return (int)cudaErrorInvalidValue;
    return go<kShared, 0, 0, 1>(p, grid, threads, (size_t)bytes, s);
  }
  const Go f[4] = {go<kShared, 0, 0, 2>, go<kShared, 1, 0, 2>,
                   go<kShared, 2, 0, 2>, go<kShared, 3, 0, 2>};
  return min_blocks == 2 ? f[stop](p, grid, threads, (size_t)bytes, s)
                         : (int)cudaErrorInvalidValue;
}

}  // extern "C"
