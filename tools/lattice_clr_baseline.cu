// The first, simple version of fscl_tpu_torch/csrc/lattice_clr.cu, kept
// as the baseline that tools/lattice_variants.py times the kernel
// against (the package does not build it).  Same function and C
// signature as that kernel's, without the row width and the candidates a
// block: the pack is the plain [n_rows*G, 2A] one.
//
// For replicate r, candidate p and offset a (pack rows of 2A floats, the
// lerp pair of offset a at 2a, 2a+1):
//
//   u    = logf(max(|pos[w] - cand[p]|, 1)) * inv_step + m_base[r, p]
//   i0   = clamp((int)u, 0, G-1);  frac = clamp(u - i0, 0, 1)
//   y    = v0 + (v1 - v0) * frac,  (v0, v1) = pack[row[r, w]*G + i0, 2a..]
//   out[r, p, a] = 2 * sum_{w = lo[p]..hi[p], u + m_rel[a] <= G-1}
//                  (y - null[r, w])
//
// What bounds it on the H100 is not measured (no hardware counters on
// the card used); suspected: the pack-row reads.  Each (candidate, site)
// pair reads one 2A-float row (88 bytes at A = 11, 128 at A = 16) at an
// address that depends on the pair; the packs (table rows x G x 8A
// bytes, tens of MB) fit in the 50 MB L2, so the distinct bytes a launch
// must move from HBM are far fewer than pairs x 8A, a modeled upper
// estimate of the bytes the reads move through L2 (nearby sites that
// share a row or an L1 line move less).  The per-pair arithmetic (one
// logf, A lerps, compares and adds) is about 60-100 instructions.
//
// Design (the simple version): one block of 128 threads per (replicate,
// candidate); its threads stride over the window's sites, coalesced on
// pos, row and null, and each keeps the A partial sums in registers
// (A, a template parameter instantiated at the two offset-list lengths,
// 11 and 16, so the pack row is held in registers too: 16-byte vector
// loads at A = 16, 8-byte ones at A = 11, since an 88-byte row is 8- but
// not 16-byte aligned).  The sums reduce
// in a fixed order (a warp shuffle tree, then the warps in order), so
// repeat launches give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// One pack row as 2A floats: float4 loads for even A, float2 for odd A.
template <int A>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&v)[2 * A]) {
  if constexpr (A % 2 == 0) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int k = 0; k < A / 2; ++k) {
      const float4 t = __ldg(q + k);
      v[4 * k] = t.x;
      v[4 * k + 1] = t.y;
      v[4 * k + 2] = t.z;
      v[4 * k + 3] = t.w;
    }
  } else {
    const float2* q = reinterpret_cast<const float2*>(p);
#pragma unroll
    for (int k = 0; k < A; ++k) {
      const float2 t = __ldg(q + k);
      v[2 * k] = t.x;
      v[2 * k + 1] = t.y;
    }
  }
}

// grid: one block per (r, p), blockIdx.x = r * P + p
template <int A>
__global__ void __launch_bounds__(kThreads)
    lattice_clr_kernel(const float* __restrict__ pack,
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
  const int64_t rp = blockIdx.x;
  const int64_t r = rp / P;
  const int p = (int)(rp - r * P);
  const int c = __ldg(cand + p);
  const int first = __ldg(lo + p);
  const int last = __ldg(hi + p);
  const float mb = (float)__ldg(m_base + rp);
  const float gmax = (float)(G - 1);
  const int32_t* rrow = row + r * W;
  const float* rnull = null + r * W;

  float mrel[A];
  float acc[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    mrel[a] = (float)__ldg(m_rel + a);
    acc[a] = 0.0f;
  }

  for (int w = first + (int)threadIdx.x; w <= last; w += kThreads) {
    int d = __ldg(pos + w) - c;
    d = d < 0 ? -d : d;
    d = d < 1 ? 1 : d;
    const float logd = logf((float)d);
    const float u = __fmaf_rn(logd, inv_step, mb);
    int i0 = (int)u;
    i0 = i0 < 0 ? 0 : (i0 > G - 1 ? G - 1 : i0);
    const float frac = fminf(fmaxf(__fsub_rn(u, (float)i0), 0.0f), 1.0f);
    const float nl = __ldg(rnull + w);
    float v[2 * A];
    load_row<A>(pack + ((int64_t)__ldg(rrow + w) * G + i0) * (2 * A), v);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float y =
          __fmaf_rn(__fsub_rn(v[2 * a + 1], v[2 * a]), frac, v[2 * a]);
      if (__fadd_rn(u, mrel[a]) <= gmax) {
        acc[a] = __fadd_rn(acc[a], __fsub_rn(y, nl));
      }
    }
  }

  __shared__ float part[kWarps][A];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    float s = acc[a];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    }
    if (lane == 0) part[warp][a] = s;
  }
  __syncthreads();
  if (threadIdx.x < A) {
    float s = part[0][threadIdx.x];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) s = __fadd_rn(s, part[k][threadIdx.x]);
    out[rp * A + threadIdx.x] = __fmul_rn(2.0f, s);
  }
}

template <int A>
int launch(const float* pack, const int32_t* row, const int32_t* pos,
           const float* null, const int32_t* cand, const int32_t* lo,
           const int32_t* hi, const int32_t* m_base, const int32_t* m_rel,
           float* out, int Rr, int P, int W, int G, float inv_step,
           cudaStream_t st) {
  lattice_clr_kernel<A><<<(unsigned)((int64_t)Rr * P), kThreads, 0, st>>>(
      pack, row, pos, null, cand, lo, hi, m_base, m_rel, out, P, W, G,
      inv_step);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// pack [n_rows*G, 2A] f32 (16-byte aligned for even A, 8 for odd); row
// [Rr, W] int32 pack-row ids; pos [W] int32; null [Rr, W] f32; cand, lo,
// hi [P] int32 (windows inside [0, W)); m_base [Rr, P] int32; m_rel [A]
// int32; out [Rr, P, A] f32.  A is 11 (coarse) or 16 (fine, ultra), Rr *
// P < 2^31; inv_step = (G-1) / (LOG_AD_MAX - LOG_AD_MIN) rounded to
// float32.  Returns the launch's CUDA error (0 = success).
int fscl_lattice_clr(const void* pack, const void* row, const void* pos,
                     const void* null, const void* cand, const void* lo,
                     const void* hi, const void* m_base, const void* m_rel,
                     void* out, int Rr, int P, int W, int A, int G,
                     float inv_step, void* stream) {
  if ((int64_t)Rr * P == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define FSCL_LATTICE_CASE(N)                                                 \
  case N:                                                                    \
    return launch<N>((const float*)pack, (const int32_t*)row,              \
                     (const int32_t*)pos, (const float*)null,              \
                     (const int32_t*)cand, (const int32_t*)lo,             \
                     (const int32_t*)hi, (const int32_t*)m_base,           \
                     (const int32_t*)m_rel, (float*)out, Rr, P, W, G,      \
                     inv_step, st);
  switch (A) {
    FSCL_LATTICE_CASE(11)
    FSCL_LATTICE_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FSCL_LATTICE_CASE
}

}  // extern "C"
