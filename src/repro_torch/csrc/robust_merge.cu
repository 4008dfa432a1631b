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
// thread per (element, cluster), the registers in a compile-time array
// (TRIM is a template parameter, 0..4, the MAX_TRIM of
// kernels/robust_merge.py), neighbouring threads on neighbouring elements
// so every load and store is coalesced. The device
// loop is unrolled by kUnroll with the loads issued first, so each thread
// has kUnroll loads in flight: on star the grid is only E threads (one
// cluster), too few to cover the memory latency with one load each.
#include <cuda_runtime.h>
#include <math_constants.h>

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

template <int TRIM>
__device__ __forceinline__ void insert(float (&mins)[TRIM > 0 ? TRIM : 1],
                                       float (&maxs)[TRIM > 0 ? TRIM : 1], float v, bool live) {
  float lo_v = live ? v : CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < TRIM; ++k) {
    const float cur = mins[k];
    mins[k] = min_nan(cur, lo_v);
    lo_v = max_nan(cur, lo_v);
  }
  float hi_v = live ? v : -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < TRIM; ++k) {
    const float cur = maxs[k];
    maxs[k] = max_nan(cur, hi_v);
    hi_v = min_nan(cur, hi_v);
  }
}

template <int TRIM>
__global__ void __launch_bounds__(kThreads)
robust_segsum_kernel(const float* __restrict__ x, const int* __restrict__ seg_start,
                     const float* __restrict__ mask, const float* __restrict__ scale,
                     float* __restrict__ tot, float* __restrict__ lo, float* __restrict__ hi,
                     long long E) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  const int c = blockIdx.y;
  const int d0 = seg_start[c], d1 = seg_start[c + 1];
  float acc = 0.0f;
  float mins[TRIM > 0 ? TRIM : 1], maxs[TRIM > 0 ? TRIM : 1];
#pragma unroll
  for (int k = 0; k < TRIM; ++k) {
    mins[k] = CUDART_INF_F;
    maxs[k] = -CUDART_INF_F;
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
      insert<TRIM>(mins, maxs, v, m > 0.0f);
    }
  }
  for (; d < d1; ++d) {
    const float m = mask[d];
    const float v = __fmul_rn(__ldg(x + (size_t)d * E + e), scale[d]);
    acc = __fadd_rn(acc, __fmul_rn(v, m));
    insert<TRIM>(mins, maxs, v, m > 0.0f);
  }
  float lo_sum = 0.0f, hi_sum = 0.0f;
#pragma unroll
  for (int k = 0; k < TRIM; ++k) {
    lo_sum = __fadd_rn(lo_sum, isfinite(mins[k]) ? mins[k] : 0.0f);
    hi_sum = __fadd_rn(hi_sum, isfinite(maxs[k]) ? maxs[k] : 0.0f);
  }
  const size_t at = (size_t)c * E + e;
  tot[at] = acc;
  lo[at] = lo_sum;
  hi[at] = hi_sum;
}

template <int TRIM>
cudaError_t launch(const float* x, const int* seg_start, const float* mask, const float* scale,
                   float* tot, float* lo, float* hi, int C, long long E, cudaStream_t stream) {
  const dim3 grid((unsigned)((E + kThreads - 1) / kThreads), C);
  robust_segsum_kernel<TRIM><<<grid, kThreads, 0, stream>>>(x, seg_start, mask, scale, tot, lo,
                                                            hi, E);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (D, E) f32, seg_start (C+1) int32, mask (D), scale (D) → tot, lo, hi (C, E).
int repro_robust_segment_sum(const float* x, const int* seg_start, const float* mask,
                             const float* scale, float* tot, float* lo, float* hi, int C,
                             long long E, int trim, void* stream) {
  if (E == 0 || C == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (trim) {
    case 0: return launch<0>(x, seg_start, mask, scale, tot, lo, hi, C, E, s);
    case 1: return launch<1>(x, seg_start, mask, scale, tot, lo, hi, C, E, s);
    case 2: return launch<2>(x, seg_start, mask, scale, tot, lo, hi, C, E, s);
    case 3: return launch<3>(x, seg_start, mask, scale, tot, lo, hi, C, E, s);
    case 4: return launch<4>(x, seg_start, mask, scale, tot, lo, hi, C, E, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
