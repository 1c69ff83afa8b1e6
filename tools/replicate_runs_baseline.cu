// The first version of fscl_tpu_torch/csrc/replicate_runs.cu, kept as
// written for tools/stream_variants.py to time against the redesign: one
// block a replicate, B <= 16,384 shuffled blocks.
//
// FSCL_RR_STOP (undefined: the whole kernel) ends each block early, for
// the ablation split: 1 after the block starts, 2 after the shuffle, 3
// after the runs (no sigma).  An early stop writes one value a block, to
// the sigma row's first entry (else the runs' dst) so that the work it
// keeps is not optimised away.
//
// The block-permutation stream for Hopper: fscl_tpu's threefry draw of a
// replicate's runs and group sigma, one block a replicate.
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
// (G int32 a replicate); otherwise lane operations: the shuffle's
// threefry hashes and its bitonic sort, O(P log^2 P) compare-exchanges
// for P = B rounded up to a power of two.  Design: a block holds its
// replicate's whole state in shared memory: one 64-bit word a shuffled
// block, (sort key << 32 | position << 16 | value), so one ascending
// sort of the words is the stable sort of (key, value) pairs and carries
// the values with it (B <= 16384 fits 16 bits each); then the same words
// hold (src << 32 | size), and the starts array holds the runs' dst
// offsets.  Block starts come from a binary search a block id over the
// monotone block ids (computed from g0f on the fly, read through L2);
// sigma entries from a binary search over the dst offsets, threads on
// consecutive groups, so the row is written coalesced.  No wgmma, no
// TMA: the simple version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlocksMax = 16384;  // shuffled blocks B (ops/permute.py)
constexpr int kThreadsMin = 256;
constexpr int kThreadsMax = 1024;

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

// block id of group g (monotone in g)
__device__ __forceinline__ int block_of(const float* __restrict__ g0f,
                                        int g, int G, int nb, float phase,
                                        float inv_w) {
  if (g == G - 1) return nb - 1;  // the pinned tail group
  const float v = __fmul_rn(__fadd_rn(__ldg(g0f + g), phase), inv_w);
  const int b = __float2int_rz(v);
  return min(max(b, 0), nb - 2);
}

// ascending bitonic sort of s[0, P), P a power of two
__device__ void bitonic_sort(unsigned long long* s, int P) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < (P >> 1); i += blockDim.x) {
        const int a = 2 * i - (i & (j - 1));
        const int b = a + j;
        const unsigned long long x = s[a], y = s[b];
        if ((x > y) == ((a & k) == 0)) {
          s[a] = y;
          s[b] = x;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void replicate_runs_kernel(
    const float* __restrict__ g0f, int G, int nb, int P, int rounds,
    float width, float inv_w, uint2 seed_key, uint32_t start,
    int* __restrict__ src_out, int* __restrict__ dst_out,
    int* __restrict__ sz_out, int* __restrict__ sigma_out) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* word = smem;                  // [P]
  int* starts = reinterpret_cast<int*>(smem + P);  // [nb + 1], then dst
  __shared__ int warp_sum[32];
  __shared__ uint2 perm_key;
  const int tid = threadIdx.x, T = blockDim.x;
  const int r = blockIdx.x, B = nb - 1;

  const uint2 key = fold(seed_key, start + (uint32_t)r);
  const uint2 k_phase = fold(key, 0u);
  const uint32_t pb = bits32(k_phase, 0u);
  const float phase = __fmul_rn(
      __fsub_rn(__uint_as_float((pb >> 9) | 0x3F800000u), 1.0f), width);

  // starts[b] = first group with block id >= b; starts[nb] = G
  for (int b = tid; b <= nb; b += T) {
    int lo = 0, hi = G;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (block_of(g0f, mid, G, nb, phase, inv_w) < b) lo = mid + 1;
      else hi = mid;
    }
    starts[b] = lo;
  }
  if (tid == 0) perm_key = fold(key, 1u);
  __syncthreads();
#if defined(FSCL_RR_STOP) && FSCL_RR_STOP == 1
  if (tid == 0)
    (sigma_out ? sigma_out + (size_t)r * G : dst_out + (size_t)r * nb)[0] =
        starts[nb >> 1];
  return;
#endif

  // the shuffle with its redraw loop (perm_key: the loop's key)
  for (;;) {
    for (int j = tid; j < P; j += T)
      word[j] = j < B ? ((unsigned long long)j << 16) | (unsigned)j : ~0ull;
    uint2 k = perm_key;
    for (int round = 0; round < rounds; ++round) {
      const uint2 next = fold(k, 0u), sub = fold(k, 1u);
      k = next;
      for (int j = tid; j < B; j += T)
        word[j] = ((unsigned long long)bits32(sub, (uint32_t)j) << 32) |
                  ((unsigned long long)j << 16) | (word[j] & 0xFFFFull);
      __syncthreads();
      bitonic_sort(word, P);
    }
    int moved = 0;
    for (int j = tid; j < B; j += T)
      moved |= (int)(word[j] & 0xFFFFull) != j;
    if (__syncthreads_or(moved) || B <= 1) break;
    if (tid == 0) perm_key = fold(perm_key, 1u);
    __syncthreads();
  }

#if defined(FSCL_RR_STOP) && FSCL_RR_STOP == 2
  if (tid == 0)
    (sigma_out ? sigma_out + (size_t)r * G : dst_out + (size_t)r * nb)[0] =
        (int)word[B >> 1];
  return;
#endif

  // runs: word[j] = src << 32 | size for the shuffled blocks; the tail
  // block (id nb - 1) is run B
  const int tail_src = starts[nb - 1], tail_sz = starts[nb] - tail_src;
  for (int j = tid; j < B; j += T) {
    const int o = (int)(word[j] & 0xFFFFull);
    word[j] = ((unsigned long long)(unsigned)starts[o] << 32) |
              (unsigned)(starts[o + 1] - starts[o]);
  }
  __syncthreads();

  // dst = exclusive prefix of the sizes over runs 0..nb-1, into starts
  const int per = (nb + T - 1) / T;
  const int j0 = min(tid * per, nb), j1 = min(j0 + per, nb);
  int sum = 0;
  for (int j = j0; j < j1; ++j)
    sum += j < B ? (int)(word[j] & 0xFFFFFFFFull) : tail_sz;
  const int lane = tid & 31, warp = tid >> 5;
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < (T >> 5) ? warp_sum[lane] : 0;
    int w = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += u;
    }
    warp_sum[lane] = w - v;
  }
  __syncthreads();
  int base = warp_sum[warp] + incl - sum;
  for (int j = j0; j < j1; ++j) {
    starts[j] = base;
    base += j < B ? (int)(word[j] & 0xFFFFFFFFull) : tail_sz;
  }
  __syncthreads();
  const int* dst = starts;

  const size_t row = (size_t)r * nb;
  if (src_out != nullptr) {
    for (int j = tid; j < nb; j += T) {
      const bool head = j < B;
      src_out[row + j] = head ? (int)(word[j] >> 32) : tail_src;
      dst_out[row + j] = dst[j];
      sz_out[row + j] = head ? (int)(word[j] & 0xFFFFFFFFull) : tail_sz;
    }
  }
#if defined(FSCL_RR_STOP) && FSCL_RR_STOP == 3
  if (tid == 0)
    (sigma_out ? sigma_out + (size_t)r * G : dst_out + (size_t)r * nb)[0] =
        dst[nb >> 1];
  return;
#endif
  if (sigma_out != nullptr) {
    int* out = sigma_out + (size_t)r * G;
    for (int s = tid; s < G; s += T) {
      int lo = 0, hi = nb;  // first run with dst > s
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (dst[mid] <= s) lo = mid + 1;
        else hi = mid;
      }
      const int j = lo - 1;
      const int src = j < B ? (int)(word[j] >> 32) : tail_src;
      out[s] = s - dst[j] + src;
    }
  }
}

}  // namespace

extern "C" {

// g0f [G] float32 group first positions; runs src/dst/sz [n_rep, nb] and
// sigma [n_rep, G] int32, each written unless null (the runs' three
// together).  1 <= nb - 1 <= 16384, G >= 1, n_rep x max(G, nb) < 2^31.
// Returns the launch's CUDA error (0 = success).
int fscl_replicate_runs(const void* g0f, int G, int nb, int rounds,
                        float width, float inv_width, unsigned key0,
                        unsigned key1, unsigned start, int n_rep, void* src,
                        void* dst, void* sz, void* sigma, void* stream) {
  const int B = nb - 1;
  if (B < 1 || B > kBlocksMax || G < 1) return (int)cudaErrorInvalidValue;
  if (n_rep == 0) return 0;
  int P = 1;
  while (P < B) P <<= 1;
  const int T = P / 2 < kThreadsMin   ? kThreadsMin
                : P / 2 > kThreadsMax ? kThreadsMax
                                      : P / 2;
  const size_t smem = (size_t)P * 8 + (size_t)(nb + 1) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        replicate_runs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  replicate_runs_kernel<<<n_rep, T, smem, (cudaStream_t)stream>>>(
      (const float*)g0f, G, nb, P, rounds, width, inv_width,
      make_uint2(key0, key1), start, (int*)src, (int*)dst, (int*)sz,
      (int*)sigma);
  return (int)cudaGetLastError();
}

}  // extern "C"
