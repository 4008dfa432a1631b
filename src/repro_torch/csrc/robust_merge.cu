// Byzantine-robust segment sum for Hopper (sm_90a).
//
// Replaces the TPU kernel robust_segment_sum_mix of
// src/repro/kernels/robust_merge.py (pallas_call :170, _robust_segsum_kernel
// :56). Per cluster c, over the cluster's contiguous run of devices d in
// ascending order, and per payload element e of x (D, E):
//   v       = x[d,e] · scale[d]                    (the clip factor, one rounding)
//   tot[c,e] += v · mask[d]                         (multiply and add rounded apart)
//   lo chain: each of TRIM registers does cur = r; r = min(cur, v'); v' = max(cur, v')
//             with v' = v, or +inf for a masked device;
//   hi chain: the same with max/min and −inf;
//   lo[c,e] = Σ_k r_k over the lo registers in register order, a register
//             still at ±inf (fewer than TRIM participants) taken as 0; hi alike.
// An empty cluster is written as zeros. The plain version in
// kernels/robust_merge.py does the same operations in the same order, so
// the two agree bit for bit; min and max propagate NaN as torch.minimum
// and torch.maximum do.
//
// Bound on an H100: bytes. At the har width (D = 256, E = Ñ·(Ñ+m) = 88 192)
// it reads x once (90.3 MB, 0.027 ms at 3.35 TB/s) and writes 3·C·E
// floats (1.06 MB on star, 33.9 MB at 32 clusters); about 4 + 4·TRIM
// simple operations per element read, far below the f32 rate. Design: one
// thread per (element, cluster), the chains in a compile-time array of
// registers up to TRIM = 4, neighbouring threads on neighbouring elements
// so every load and store is coalesced. A longer chain lives in the
// thread's own slots of shared memory (slot k at k·blockDim.x + thread),
// with fewer threads a block as trim grows (128 up to trim 113, 32 up to
// 454), and past that in a global workspace (slot k at k·C·E + (c, e)).
// The operations and their order are the same in all three. The device
// loop is unrolled by kUnroll with the loads issued first, so each thread
// has kUnroll loads in flight: on star the grid is only E threads (one
// cluster), too few to cover the memory latency with one load each.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "device.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

// min and max that return NaN when either operand is NaN (torch.minimum,
// torch.maximum); fminf/fmaxf would drop it
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// The 2·trim registers of the lo and hi insertion chains: slot k of lo
// at lo(k), of hi at hi(k). RegChains<TRIM> keeps them in registers;
// MemChains at base[k·stride] and base[(trim + k)·stride].
template <int TRIM>
struct RegChains {
  float mins[TRIM > 0 ? TRIM : 1], maxs[TRIM > 0 ? TRIM : 1];
  static constexpr int kTrim = TRIM;
  __device__ __forceinline__ RegChains(float*, long long, int) {}
  __device__ __forceinline__ float& lo(int k) { return mins[k]; }
  __device__ __forceinline__ float& hi(int k) { return maxs[k]; }
  __device__ __forceinline__ int trim() const { return TRIM; }
};

struct MemChains {
  float* base;
  long long stride;
  int n;
  static constexpr int kTrim = -1;
  __device__ __forceinline__ MemChains(float* b, long long s, int t) : base(b), stride(s), n(t) {}
  __device__ __forceinline__ float& lo(int k) { return base[k * stride]; }
  __device__ __forceinline__ float& hi(int k) { return base[(n + k) * stride]; }
  __device__ __forceinline__ int trim() const { return n; }
};

template <typename Chains>
__device__ __forceinline__ void insert(Chains& ch, float v, bool live) {
  float lo_v = live ? v : CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < ch.trim(); ++k) {
    const float cur = ch.lo(k);
    ch.lo(k) = min_nan(cur, lo_v);
    lo_v = max_nan(cur, lo_v);
  }
  float hi_v = live ? v : -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < ch.trim(); ++k) {
    const float cur = ch.hi(k);
    ch.hi(k) = max_nan(cur, hi_v);
    hi_v = min_nan(cur, hi_v);
  }
}

// kShared: MemChains in this block's dynamic shared memory (slot k of a
// thread at k·blockDim.x); else RegChains<TRIM>, or MemChains in ws (slot k
// at k·C·E) when TRIM < 0.
template <int TRIM, bool kShared = false>
__global__ void __launch_bounds__(kThreads)
robust_segsum_kernel(const float* __restrict__ x, const int* __restrict__ seg_start,
                     const float* __restrict__ mask, const float* __restrict__ scale,
                     float* __restrict__ tot, float* __restrict__ lo, float* __restrict__ hi,
                     long long E, float* __restrict__ ws, int trim) {
  extern __shared__ float chain_smem[];
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int c = blockIdx.y;
  const int d0 = seg_start[c], d1 = seg_start[c + 1];
  const size_t at = (size_t)c * E + e;
  float acc = 0.0f;
  using Chains = std::conditional_t<(TRIM >= 0), RegChains<TRIM>, MemChains>;
  Chains ch = kShared ? Chains(chain_smem + threadIdx.x, blockDim.x, trim)
                      : Chains(ws + at, (long long)gridDim.y * E, trim);
#pragma unroll
  for (int k = 0; k < ch.trim(); ++k) {
    ch.lo(k) = CUDART_INF_F;
    ch.hi(k) = -CUDART_INF_F;
  }
  int d = d0;
  for (; d + kUnroll <= d1; d += kUnroll) {
    float xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) xv[u] = __ldg(x + (size_t)(d + u) * E + e);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float m = mask[d + u];
      const float v = __fmul_rn(xv[u], scale[d + u]);
      acc = __fadd_rn(acc, __fmul_rn(v, m));
      insert(ch, v, m > 0.0f);
    }
  }
  for (; d < d1; ++d) {
    const float m = mask[d];
    const float v = __fmul_rn(__ldg(x + (size_t)d * E + e), scale[d]);
    acc = __fadd_rn(acc, __fmul_rn(v, m));
    insert(ch, v, m > 0.0f);
  }
  float lo_sum = 0.0f, hi_sum = 0.0f;
#pragma unroll
  for (int k = 0; k < ch.trim(); ++k) {
    lo_sum = __fadd_rn(lo_sum, isfinite(ch.lo(k)) ? ch.lo(k) : 0.0f);
    hi_sum = __fadd_rn(hi_sum, isfinite(ch.hi(k)) ? ch.hi(k) : 0.0f);
  }
  tot[at] = acc;
  lo[at] = lo_sum;
  hi[at] = hi_sum;
}

template <int TRIM, bool kShared = false>
cudaError_t launch(const float* x, const int* seg_start, const float* mask, const float* scale,
                   float* tot, float* lo, float* hi, int C, long long E, float* ws, int trim,
                   int threads, size_t smem, cudaStream_t stream) {
  auto kernel = robust_segsum_kernel<TRIM, kShared>;
  if (smem > 0) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)((E + threads - 1) / threads), C);
  kernel<<<grid, threads, smem, stream>>>(x, seg_start, mask, scale, tot, lo, hi, E, ws, trim);
  return cudaGetLastError();
}

constexpr int kRegTrim = 4;  // the longest chains kept in registers

// Threads a block when the chains live in shared memory (2·trim slots a
// thread), or 0 when even 32 threads' chains do not fit.
int chain_threads(int trim) {
  int threads = kThreads;
  while (threads >= 32 && 2LL * trim * threads * 4 > kMaxSmem) threads /= 2;
  return threads >= 32 ? threads : 0;
}

}  // namespace

extern "C" {

// Workspace floats repro_robust_segment_sum needs for C clusters of E
// elements at this trim (0 where the chains fit registers or shared memory).
long long repro_robust_ws(int trim, int C, long long E) {
  return trim > kRegTrim && chain_threads(trim) == 0 ? 2LL * trim * C * E : 0;
}

// x (D, E) f32, seg_start (C+1) int32, mask (D), scale (D), trim ≥ 0, ws
// repro_robust_ws(trim, C, E) floats or null → tot, lo, hi (C, E).
int repro_robust_segment_sum(const float* x, const int* seg_start, const float* mask,
                             const float* scale, float* tot, float* lo, float* hi, int C,
                             long long E, int trim, float* ws, void* stream) {
  if (E == 0 || C == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (trim) {
    case 0: return launch<0>(x, seg_start, mask, scale, tot, lo, hi, C, E, ws, 0, kThreads, 0, s);
    case 1: return launch<1>(x, seg_start, mask, scale, tot, lo, hi, C, E, ws, 1, kThreads, 0, s);
    case 2: return launch<2>(x, seg_start, mask, scale, tot, lo, hi, C, E, ws, 2, kThreads, 0, s);
    case 3: return launch<3>(x, seg_start, mask, scale, tot, lo, hi, C, E, ws, 3, kThreads, 0, s);
    case 4: return launch<4>(x, seg_start, mask, scale, tot, lo, hi, C, E, ws, 4, kThreads, 0, s);
    default: break;
  }
  if (trim < 0) return cudaErrorInvalidValue;
  const int threads = chain_threads(trim);
  if (threads > 0)
    return launch<-1, true>(x, seg_start, mask, scale, tot, lo, hi, C, E, nullptr, trim, threads,
                            2ULL * trim * threads * 4, s);
  if (ws == nullptr) return cudaErrorInvalidValue;
  return launch<-1>(x, seg_start, mask, scale, tot, lo, hi, C, E, ws, trim, kThreads, 0, s);
}

}  // extern "C"
