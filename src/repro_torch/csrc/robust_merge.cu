// Byzantine-robust segment sum for Hopper (sm_90a).
//
// Replaces the TPU kernel robust_segment_sum_mix of
// src/repro/kernels/robust_merge.py (pallas_call :170, _robust_segsum_kernel
// :56). Per cluster c, over the cluster's contiguous run of devices d, and
// per payload element e of x (D, E):
//   v       = x[d,e] · scale[d]                    (the clip factor, one rounding)
//   tot[c,e] = Σ v · mask[d]                        (multiply and add rounded apart)
//   lo chain: each of TRIM registers does cur = r; r = min(cur, v'); v' = max(cur, v')
//             with v' = v, or +inf for a masked device;
//   hi chain: the same with max/min and −inf;
//   lo[c,e] = Σ_k r_k over the lo registers in register order, a register
//             still at ±inf (fewer than TRIM participants) taken as 0; hi alike.
// An empty cluster is written as zeros. min and max propagate NaN as
// torch.minimum and torch.maximum do.
//
// Which outputs keep the plain version's order (kernels/robust_merge.py):
//   - tot is bound to it: one chain of adds per element, taken from +0 in
//     ascending device order, each product rounded apart. Every plan keeps
//     it on one lane an element, in that order.
//   - lo and hi are free of it. After all insertions, register k of a chain
//     holds the (k+1)-th smallest live value (largest for hi), or the
//     sentinel; a NaN fills every register, which then sums as 0. So the
//     registers end with the same values whatever the order the devices
//     come in, or if the devices are split among several chains that are
//     merged by inserting one chain's registers into another. A tie of −0
//     and +0 can change only a zero's sign, and the sum starts at +0, so no
//     output bit moves. A masked device's sentinels (+inf into lo, −inf into
//     hi) change no register, NaN included, so both plans skip them.
//
// Bound on an H100: bytes, the payloads read once (D·E·4 B at 3.35 TB/s)
// and the three sums written once (0.027 ms at the har width); the
// 5 + 4·TRIM simple operations a device and element stay under it at
// 67 TFLOP/s (0.0125 ms at trim 8 there). The chains' min and max are one
// instruction each (PTX min.NaN/max.NaN: FMNMX.NAN; a compare and select
// ran the har star at trim 8 in twice the time). One cluster's tot is also
// a chain of D_c dependent adds:
// D_c × 4 cycles (8.3 µs at D_c = 4096 and 1.98 GHz) whatever the plan.
// Two launch plans, picked by the wrapper from the shape, the trim and the
// card's SMs (kernels/robust_merge.py::robust_streamed):
//
// * robust_segsum_kernel: one thread an element and a cluster, walking the
//   cluster's devices itself with kUnroll loads in flight, neighbouring
//   threads on neighbouring elements. It wins where clusters are short or
//   elements × clusters many (the har width: 689 blocks at C = 1). Chains
//   up to TRIM = 8 live in registers (16 of them at trim 8 beside the 8
//   loads in flight); from trim 9 in the thread's own slots of shared
//   memory (slot k at k·blockDim.x + thread), with fewer threads a block as
//   trim grows, and past what 32 threads' chains fit in a global workspace
//   (slot k at k·C·E + (c, e)).
//
// * robust_stream_kernel, for few long clusters, e.g. one cluster of 4096
//   devices on (32, 80) payloads, where the per-element grid is 20 blocks
//   whose threads each walk 4096 dependent loads (0.47 ms at trim 1). A
//   block takes a 32-element slice of a cluster through the segment sums'
//   ring (stream_ring.cuh) and its 12 warps specialise:
//     - warps 1-2 stream the slice's rows, the mask and the scale into the
//       ring's 4 stages of 256 rows (cp.async, mbarriers);
//     - warp 0 adds tot, one lane a column, over each stage's rows in device
//       order (16-byte loads of four rows' mask and scale);
//     - warps 3-11, the sorters, split each stage's rows, four at a time,
//       and insert v = x·scale into chains of their own;
//     - warp 0 and the sorters free the stage together.
//   At the end the sorters' chains meet in shared memory: one sorter
//   inserts the others' lo registers into its own, another the hi ones.
//   Trims up to 8 only (registers); the wrapper hands a wider trim to the
//   per-element plan. (Sorters that wrote v·mask back for warp 0 to add,
//   behind a third barrier, were 6 % faster at trims 1-2 of the star of
//   4096 and 2-15 % slower elsewhere.)

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "device.cuh"
#include "ptx.cuh"
#include "stream_ring.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;
constexpr int kRegTrim = 8;  // the longest chains kept in registers, on both plans

// The 2·trim registers of the lo and hi insertion chains: slot k of lo
// at lo(k), of hi at hi(k). RegChains<TRIM> keeps them in registers;
// MemChains at base[k·stride] and base[(trim + k)·stride].
template <int TRIM>
struct RegChains {
  float mins[TRIM > 0 ? TRIM : 1], maxs[TRIM > 0 ? TRIM : 1];
  __device__ __forceinline__ RegChains(float*, long long, int) {}
  __device__ __forceinline__ float& lo(int k) { return mins[k]; }
  __device__ __forceinline__ float& hi(int k) { return maxs[k]; }
  __device__ __forceinline__ int trim() const { return TRIM; }
};

struct MemChains {
  float* base;
  long long stride;
  int n;
  __device__ __forceinline__ MemChains(float* b, long long s, int t) : base(b), stride(s), n(t) {}
  __device__ __forceinline__ float& lo(int k) { return base[k * stride]; }
  __device__ __forceinline__ float& hi(int k) { return base[(n + k) * stride]; }
  __device__ __forceinline__ int trim() const { return n; }
};

template <typename Chains>
__device__ __forceinline__ void chains_init(Chains& ch) {
#pragma unroll
  for (int k = 0; k < ch.trim(); ++k) {
    ch.lo(k) = CUDART_INF_F;
    ch.hi(k) = -CUDART_INF_F;
  }
}

// v into the lo chain: each register keeps the smaller, the larger moves on
// (min and max that keep a NaN, one instruction each: ptx.cuh)
template <typename Chains>
__device__ __forceinline__ void insert_lo(Chains& ch, float v) {
#pragma unroll
  for (int k = 0; k < ch.trim(); ++k) {
    const float cur = ch.lo(k);
    ch.lo(k) = min_nan(cur, v);
    v = max_nan(cur, v);
  }
}

template <typename Chains>
__device__ __forceinline__ void insert_hi(Chains& ch, float v) {
#pragma unroll
  for (int k = 0; k < ch.trim(); ++k) {
    const float cur = ch.hi(k);
    ch.hi(k) = max_nan(cur, v);
    v = min_nan(cur, v);
  }
}

// A live device's value into both chains. A masked device's sentinels
// (+inf into lo, −inf into hi) leave every register as it is, NaN
// included, so the kernels skip them: the mask is one device's, the same
// in every lane, and the branch costs no divergence.
template <typename Chains>
__device__ __forceinline__ void insert(Chains& ch, float v) {
  insert_lo(ch, v);
  insert_hi(ch, v);
}

// a chain's registers summed from +0 in register order, a non-finite one as 0
template <typename Chains>
__device__ __forceinline__ float lo_sum(Chains& ch) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < ch.trim(); ++k) s = __fadd_rn(s, isfinite(ch.lo(k)) ? ch.lo(k) : 0.0f);
  return s;
}

template <typename Chains>
__device__ __forceinline__ float hi_sum(Chains& ch) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < ch.trim(); ++k) s = __fadd_rn(s, isfinite(ch.hi(k)) ? ch.hi(k) : 0.0f);
  return s;
}

// The per-element plan. kShared: MemChains in this block's dynamic shared
// memory (slot k of a thread at k·blockDim.x); else RegChains<TRIM>, or
// MemChains in ws (slot k at k·C·E) when TRIM < 0.
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
  chains_init(ch);
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
      if (m > 0.0f) insert(ch, v);
    }
  }
  for (; d < d1; ++d) {
    const float m = mask[d];
    const float v = __fmul_rn(__ldg(x + (size_t)d * E + e), scale[d]);
    acc = __fadd_rn(acc, __fmul_rn(v, m));
    if (m > 0.0f) insert(ch, v);
  }
  tot[at] = acc;
  lo[at] = lo_sum(ch);
  hi[at] = hi_sum(ch);
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

// Threads a block when the chains live in shared memory (2·trim slots a
// thread), or 0 when even 32 threads' chains do not fit.
int chain_threads(int trim) {
  int threads = kThreads;
  while (threads >= 32 && 2LL * trim * threads * 4 > kMaxSmem) threads /= 2;
  return threads >= 32 ? threads : 0;
}

// The streamed plan's warps: 0 adds, 1-2 copy, 3-11 sort.
constexpr int kStreamThreads = 384;
constexpr int kCopiers = 64;
constexpr int kFirstSorter = 1 + kCopiers / 32;
constexpr int kSorters = kStreamThreads / 32 - kFirstSorter;
constexpr int kGroup = 4;  // rows a sorter takes at a time

// The ring (rows, mask, scale), then each sorter's 2·TRIM registers of 32
// lanes for the merge.
template <int TRIM>
constexpr int stream_smem_bytes() {
  return ring_smem_bytes<2>() + 4 * kSorters * 2 * TRIM * kRingSlice;
}

// Block (x, c) takes elements [x·kRingSlice, +kRingSlice) of cluster c, VEC
// floats a copy (4 needs E % 4 == 0 and x on 16 bytes). The adder and the
// sorters read each stage once the copiers' copies land (full) and free it
// together (empty: the adder and each sorter warp).
template <int TRIM, int VEC>
__global__ void __launch_bounds__(kStreamThreads, 1)
robust_stream_kernel(const float* __restrict__ x, const int* __restrict__ seg_start,
                     const float* __restrict__ mask, const float* __restrict__ scale,
                     float* __restrict__ tot, float* __restrict__ lo, float* __restrict__ hi,
                     long long E) {
  extern __shared__ __align__(16) float stream_smem[];
  __shared__ uint64_t full[kRingStages], empty[kRingStages];
  const RingRows ring = ring_rows(stream_smem);
  const RingSide mk = ring_side(stream_smem, 0), sc = ring_side(stream_smem, 1);
  float* merge = stream_smem + ring_smem_bytes<2>() / 4;  // [sorter][2·TRIM][lane]
  const long long e0 = (long long)blockIdx.x * kRingSlice;
  const int c = blockIdx.y;
  const int d0 = seg_start[c], n = seg_start[c + 1] - d0;
  const int width = (int)min((long long)kRingSlice, E - e0);
  const int chunks = (n + kRingRows - 1) / kRingRows;
  const int warp = threadIdx.x / 32, t = threadIdx.x % 32;
  if (threadIdx.x < kRingStages) {
    mbar_init(&full[threadIdx.x], kCopiers);
    mbar_init(&empty[threadIdx.x], 1 + kSorters);
  }
  __syncthreads();
  const size_t at = (size_t)c * E + e0 + t;
  RegChains<TRIM> ch(nullptr, 0, 0);
  chains_init(ch);
  if (warp == 0) {
    float acc = 0.0f;
    for (int k = 0; k < chunks; ++k) {
      const int slot = k % kRingStages, rows = min(kRingRows, n - k * kRingRows);
      mbar_wait(&full[slot], ring_parity(k));
      if (rows == kRingRows) {
#pragma unroll 8
        for (int r = 0; r < kRingRows; r += 4) {
          const float4 m = *reinterpret_cast<const float4*>(&mk[slot][r]);
          const float4 s = *reinterpret_cast<const float4*>(&sc[slot][r]);
          acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(ring[slot][r][t], s.x), m.x));
          acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(ring[slot][r + 1][t], s.y), m.y));
          acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(ring[slot][r + 2][t], s.z), m.z));
          acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(ring[slot][r + 3][t], s.w), m.w));
        }
      } else {
        for (int r = 0; r < rows; ++r)
          acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(ring[slot][r][t], sc[slot][r]), mk[slot][r]));
      }
      __syncwarp();
      if (t == 0) mbar_arrive(&empty[slot]);
    }
    if (t < width) tot[at] = acc;
  } else if (warp < kFirstSorter) {
    const float* sides[2] = {mask, scale};
    ring_fill<VEC, 2>(stream_smem, full, empty, x, E, e0, width, d0, n, sides,
                      threadIdx.x - 32, kCopiers);
  } else {
    const int j = warp - kFirstSorter;
    for (int k = 0; k < chunks; ++k) {
      const int slot = k % kRingStages, rows = min(kRingRows, n - k * kRingRows);
      mbar_wait(&full[slot], ring_parity(k));
      for (int r = kGroup * j; r < rows; r += kGroup * kSorters) {
        if (r + kGroup <= rows) {
          const float4 m = *reinterpret_cast<const float4*>(&mk[slot][r]);
          const float4 s = *reinterpret_cast<const float4*>(&sc[slot][r]);
          const float x0 = ring[slot][r][t], x1 = ring[slot][r + 1][t];
          const float x2 = ring[slot][r + 2][t], x3 = ring[slot][r + 3][t];
          if (m.x > 0.0f) insert(ch, __fmul_rn(x0, s.x));
          if (m.y > 0.0f) insert(ch, __fmul_rn(x1, s.y));
          if (m.z > 0.0f) insert(ch, __fmul_rn(x2, s.z));
          if (m.w > 0.0f) insert(ch, __fmul_rn(x3, s.w));
        } else {
          for (int u = r; u < rows; ++u)
            if (mk[slot][u] > 0.0f) insert(ch, __fmul_rn(ring[slot][u][t], sc[slot][u]));
        }
      }
      __syncwarp();
      if (t == 0) mbar_arrive(&empty[slot]);
    }
#pragma unroll
    for (int k = 0; k < TRIM; ++k) {
      merge[(j * 2 * TRIM + k) * kRingSlice + t] = ch.lo(k);
      merge[(j * 2 * TRIM + TRIM + k) * kRingSlice + t] = ch.hi(k);
    }
  }
  __syncthreads();
  if (warp == kFirstSorter) {
    for (int i = 1; i < kSorters; ++i) {
#pragma unroll
      for (int k = 0; k < TRIM; ++k) insert_lo(ch, merge[(i * 2 * TRIM + k) * kRingSlice + t]);
    }
    if (t < width) lo[at] = lo_sum(ch);
  } else if (warp == kFirstSorter + 1) {
    for (int i = 0; i < kSorters; ++i) {
      if (i == 1) continue;
#pragma unroll
      for (int k = 0; k < TRIM; ++k)
        insert_hi(ch, merge[(i * 2 * TRIM + TRIM + k) * kRingSlice + t]);
    }
    if (t < width) hi[at] = hi_sum(ch);
  }
}

template <int TRIM>
cudaError_t launch_stream(const float* x, const int* seg_start, const float* mask,
                          const float* scale, float* tot, float* lo, float* hi, int C,
                          long long E, cudaStream_t stream) {
  const bool vec = E % 4 == 0 && reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  auto kernel = vec ? robust_stream_kernel<TRIM, 4> : robust_stream_kernel<TRIM, 1>;
  constexpr int smem = stream_smem_bytes<TRIM>();
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((E + kRingSlice - 1) / kRingSlice), C);
  kernel<<<grid, kStreamThreads, smem, stream>>>(x, seg_start, mask, scale, tot, lo, hi, E);
  return cudaGetLastError();
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
// streamed: 1 for the streamed plan (trim ≤ kRegTrim), 0 for the
// per-element one.
int repro_robust_segment_sum(const float* x, const int* seg_start, const float* mask,
                             const float* scale, float* tot, float* lo, float* hi, int C,
                             long long E, int trim, float* ws, int streamed, void* stream) {
  if (E == 0 || C == 0) return cudaSuccess;
  if (trim < 0 || (streamed && trim > kRegTrim)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_ROBUST_CASE(T)                                                              \
  case T:                                                                                 \
    return streamed ? launch_stream<T>(x, seg_start, mask, scale, tot, lo, hi, C, E, s)   \
                    : launch<T>(x, seg_start, mask, scale, tot, lo, hi, C, E, ws, T,      \
                                kThreads, 0, s);
  switch (trim) {
    REPRO_ROBUST_CASE(0)
    REPRO_ROBUST_CASE(1)
    REPRO_ROBUST_CASE(2)
    REPRO_ROBUST_CASE(3)
    REPRO_ROBUST_CASE(4)
    REPRO_ROBUST_CASE(5)
    REPRO_ROBUST_CASE(6)
    REPRO_ROBUST_CASE(7)
    REPRO_ROBUST_CASE(8)
    default: break;
  }
#undef REPRO_ROBUST_CASE
  const int threads = chain_threads(trim);
  if (threads > 0)
    return launch<-1, true>(x, seg_start, mask, scale, tot, lo, hi, C, E, nullptr, trim, threads,
                            2ULL * trim * threads * 4, s);
  if (ws == nullptr) return cudaErrorInvalidValue;
  return launch<-1>(x, seg_start, mask, scale, tot, lo, hi, C, E, ws, trim, kThreads, 0, s);
}

}  // extern "C"
