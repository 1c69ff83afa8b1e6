// Single-pass chained scan with decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016),
// shared by the prefix-sum kernels.
//
// A scan runs along chains of tiles; each block scans one tile of one
// chain.  It sums its tile, publishes that total, then finds its carry
// (the sum over the chain's earlier tiles) from what earlier blocks
// published, without waiting for them to finish their own writes.
//
// Tickets.  A block takes its tile from an atomic ticket, not from
// blockIdx, and the caller maps tickets to tiles so that a chain's earlier
// tiles have smaller tickets.  A block then waits only on blocks that took
// their tickets before it, so are resident and running, whatever order the
// hardware starts blocks in: no deadlock.
//
// Two ways to publish, both in the caller's scratch, which the host zeroes
// on the launch's stream before every launch (no state survives a launch):
//
//  * Packed words, for integer counts (sums exact in any order): one
//    64-bit word per (tile, lane) holds a flag (EMPTY = 0, AGGREGATE,
//    INCLUSIVE) and a 32-bit count, written by one release store, so a
//    reader never sees a flag without its count.  lookback_counts takes
//    the standard shortcut: it walks back until a predecessor's INCLUSIVE
//    value, adding AGGREGATE counts on the way, then publishes its own
//    INCLUSIVE value.
//
//  * Tile flags, for float64 sums whose order must not depend on timing:
//    each thread stores its lanes' tile totals, then one flag per tile
//    releases them all (publish_tile).  wait_tiles returns once every
//    earlier tile of the chain has published; the caller then sums the
//    totals of tiles 0, 1, ..., t-1 in that order.  No INCLUSIVE shortcut:
//    where the walk back stopped would change the order of the sum.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fscl {

enum : uint32_t { kEmpty = 0, kAggregate = 1, kInclusive = 2 };

// The block's ticket, the same in every thread.  Call once per block,
// before the block's first __syncthreads-separated phase.
__device__ __forceinline__ int take_ticket(unsigned* counter) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = (int)atomicAdd(counter, 1u);
  __syncthreads();
  return ticket;
}

__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ uint64_t pack_word(uint32_t flag, uint32_t count) {
  return ((uint64_t)flag << 32) | count;
}

// Stage a tile's ids in shared memory, site-major: ids[kk * n_rep + pe]
// = id(pe, kk) for sites kk < n of replicates pe < n_rep.  Consecutive
// threads take consecutive sites of one replicate.  Ends with
// __syncthreads().
template <int kThreads, typename Id>
__device__ __forceinline__ void stage_tile_ids(int16_t* ids, int n,
                                               int n_rep, const Id& id) {
  for (int e = threadIdx.x; e < n * n_rep; e += kThreads)
    ids[(e % n) * n_rep + e / n] = (int16_t)id(e / n, e % n);
  __syncthreads();
}

// Packed-word look-back for the V lanes a thread owns.  Lane v's word of
// tile j is chain[j * stride + v].  agg[v] is the lane's count over tile t;
// carry[v] comes back as its count over tiles 0..t-1.  Dead lanes publish
// nothing and get carry 0.  Predecessors are read kWindow at a time, so a
// long walk back costs a few round trips to L2, not one per tile.
template <int V, int kWindow = 4>
__device__ __forceinline__ void lookback_counts(uint64_t* chain,
                                                size_t stride, int t,
                                                const bool (&live)[V],
                                                const uint32_t (&agg)[V],
                                                uint32_t (&carry)[V]) {
  uint64_t* mine = chain + (size_t)t * stride;
  int next[V];  // next tile lane v reads; -1 once its carry is complete
#pragma unroll
  for (int v = 0; v < V; ++v) {
    carry[v] = 0;
    next[v] = live[v] ? t - 1 : -1;
    if (live[v])
      st_release(mine + v, pack_word(t ? kAggregate : kInclusive, agg[v]));
  }
  for (;;) {
    bool any = false;
#pragma unroll
    for (int v = 0; v < V; ++v) any |= next[v] >= 0;
    if (!any) break;
    uint64_t wd[V][kWindow];
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int i = 0; i < kWindow; ++i) {
        const int j = next[v] - i;
        wd[v][i] = (next[v] >= 0 && j >= 0)
                       ? ld_acquire(chain + (size_t)j * stride + v)
                       : 0;
      }
    // consume each lane's words in order up to its first EMPTY one (poll
    // that tile again) or its first INCLUSIVE one (done; tile 0 publishes
    // INCLUSIVE, so no walk passes it)
    bool waited = false;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      bool stop = next[v] < 0;
#pragma unroll
      for (int i = 0; i < kWindow; ++i) {
        const uint32_t flag = (uint32_t)(wd[v][i] >> 32);
        if (stop) continue;
        if (flag == kEmpty) {
          waited = stop = true;
          continue;
        }
        carry[v] += (uint32_t)wd[v][i];
        --next[v];
        if (flag == kInclusive) {
          next[v] = -1;
          stop = true;
        }
      }
    }
    if (waited) __nanosleep(64);
  }
  if (t) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (live[v])
        st_release(mine + v, pack_word(kInclusive, carry[v] + agg[v]));
  }
}

// Tile flags: after every thread of the block has stored its tile totals,
// release them with the tile's flag.  Call from every thread.
__device__ __forceinline__ void publish_tile(unsigned* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flag, 1u);
  }
}

// Return once flags[0..t) are all set; every thread of the block may then
// read the totals those tiles published (through L2: __ldcg).  Warp 0
// polls, 32 tiles at a time; the barrier passes its acquire on.
__device__ __forceinline__ void wait_tiles(const unsigned* flags, int t) {
  if (threadIdx.x < 32) {
    for (int j = threadIdx.x; j < t; j += 32)
      while (ld_acquire(flags + j) == 0) __nanosleep(64);
  }
  __syncthreads();
}

}  // namespace fscl
