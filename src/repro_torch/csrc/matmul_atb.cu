// AᵀB with the sample axis contracted, for Hopper (sm_90a): the E²LM
// statistics U = HᵀH and V = Hᵀt, and the k=1 step's ph = P·h.
//
// Replaces the TPU kernel src/repro/kernels/matmul_atb.py::matmul_atb
// (pallas_call :58, inner kernel _atb_kernel :22), which reads A under two
// block views so that Aᵀ is never materialised and accumulates over the
// sample tiles in an f32 scratch. Here A (K, N1) is read in place,
// sample-major, so Aᵀ is never written anywhere. A leading batch axis runs
// independent products side by side, as a fleet's Eq. 13 boot does. Every
// output sums k = 0..K−1 in a fixed order, with no atomics, so U and V do
// not change from run to run.
//
// * N1 ≤ kSkinnyRows (the k=1 step's A = h of shape (Ñ, 1)): gemm.cuh's
//   skinny kernel, shared with hidden_proj.cu.
// * Otherwise the sample axis is split across blocks, which gemm.cuh's
//   tile kernel (one block walking all of K for a 64 × 64 tile) does not
//   do: at the har width its grids were 4 blocks (HᵀH) and 18 (HᵀX) on 132
//   SMs, and the serial loop over K set the time. atb_split_kernel gives a
//   block one 32 × 64 output tile and one slice of samples (the wrapper's
//   split_plan: slices of at least 64 samples, and as many as bring the
//   grid to about two blocks an SM: at K = 512, 8 slices, 64 blocks for
//   HᵀH and 288 for HᵀX). A block walks its slice 16 samples at a time
//   through two shared-memory stages (f32 by cp.async, the next 16 in
//   flight while these are summed; bf16 through registers, widened to f32,
//   since a row of an odd number of bf16 values is not 4-byte aligned and
//   cp.async copies no fewer than 4 bytes). 128 threads hold 4 × 4 outputs
//   each. A slice's sum goes to an f32 workspace the wrapper allocates, and
//   atb_reduce_kernel adds the slices in slice order into out; with one
//   slice the tile kernel writes out itself. The sum has three levels:
//   16 samples with one fused multiply-add each, the 16-sample sums of a
//   slice in order, then the slices in order.
//
// Bound on an H100 at the har width (Ñ = 128, m = 561): the k=1 product
// reads P once, 64 KB, 0.020 µs at 3.35 TB/s (bytes); U = HᵀH at 512
// samples is 16.8 MFLOP (0.25 µs) and V = HᵀX 73.5 MFLOP (1.10 µs) at
// 67 TFLOP/s f32 (operations; TF32 stays off). At these sizes two kernel
// launches and the first loads set the time, not the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm.cuh"
#include "ptx.cuh"

namespace {

constexpr int kAtbThreads = 128;
constexpr int ABM = 32, ABN = 64, ABK = 16;  // tile rows (of N1), columns (of N2), samples a stage

// Stage samples k0..k0+15 (those below k1) of A's columns m0.. and B's
// columns n0.. into at and bt; what lies past k1, M or N is zero.
template <typename T>
__device__ __forceinline__ void stage(float (*at)[ABM], float (*bt)[ABN], const T* a, const T* b,
                                      int k0, int k1, int m0, int n0, int M, int N) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = tid; i < ABK * ABM; i += kAtbThreads) {
    const int r = i / ABM, c = i % ABM, gk = k0 + r, gm = m0 + c;
    const bool in = gk < k1 && gm < M;
    const T* src = a + (in ? (size_t)gk * M + gm : 0);
    if constexpr (sizeof(T) == 4) cp_async<4>(&at[r][c], src, in ? 4 : 0);
    else at[r][c] = in ? to_f32(*src) : 0.0f;
  }
#pragma unroll
  for (int i = tid; i < ABK * ABN; i += kAtbThreads) {
    const int r = i / ABN, c = i % ABN, gk = k0 + r, gn = n0 + c;
    const bool in = gk < k1 && gn < N;
    const T* src = b + (in ? (size_t)gk * N + gn : 0);
    if constexpr (sizeof(T) == 4) cp_async<4>(&bt[r][c], src, in ? 4 : 0);
    else bt[r][c] = in ? to_f32(*src) : 0.0f;
  }
}

// a (batch, K, M), b (batch, K, N); grid (N tiles, M tiles, batch · slices),
// blockIdx.z = z · slices + slice. Slice s covers samples [s·L, min((s+1)·L, K)).
// part (batch, slices, M, N): each slice's sum (out itself when slices is 1).
template <typename T>
__global__ void __launch_bounds__(kAtbThreads)
atb_split_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ part,
                 int M, int K, int N, int L, int slices) {
  __shared__ __align__(16) float at[2][ABK][ABM];
  __shared__ __align__(16) float bt[2][ABK][ABN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * ABM, n0 = blockIdx.x * ABN;
  const size_t z = blockIdx.z / slices;
  const int sl = blockIdx.z % slices;
  a += z * K * M;
  b += z * K * N;
  part += (z * slices + sl) * M * N;
  const int k0 = sl * L, k1 = min(k0 + L, K);
  const int steps = (k1 - k0 + ABK - 1) / ABK;

  float acc[4][4] = {};
  stage(at[0], bt[0], a, b, k0, k1, m0, n0, M, N);
  cp_async_commit();
  for (int u = 0; u < steps; ++u) {
    if (u + 1 < steps) stage(at[(u + 1) % 2], bt[(u + 1) % 2], a, b, k0 + (u + 1) * ABK, k1,
                             m0, n0, M, N);
    cp_async_commit();
    cp_async_wait<1>();  // all but the stage just issued have landed
    __syncthreads();
    float p[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < ABK; ++kk) {
      const float4 ar = *reinterpret_cast<const float4*>(&at[u % 2][kk][ty * 4]);
      const float4 br = *reinterpret_cast<const float4*>(&bt[u % 2][kk][tx * 4]);
      const float av[4] = {ar.x, ar.y, ar.z, ar.w}, bv[4] = {br.x, br.y, br.z, br.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] = fmaf(av[i], bv[j], p[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += p[i][j];
    __syncthreads();  // this stage is consumed before the next iteration refills it
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) part[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

// out[z][i] = Σ_s part[z][s][i], s in order
__global__ void atb_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  long long MN, int slices, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long z = idx / MN, i = idx % MN;
  const float* p = part + z * slices * MN + i;
  float s = p[0];
  for (int k = 1; k < slices; ++k) s += p[k * MN];
  out[idx] = s;
}

template <typename T>
cudaError_t launch_atb(const T* a, const T* b, float* out, float* ws, int batch, int K, int M,
                       int N, int L, int slices, cudaStream_t s) {
  if (M <= kSkinnyRows) return launch_gemm<T, true>(a, b, nullptr, out, batch, M, K, N, 0, s);
  if (L <= 0 || (long long)L * slices < K || (slices > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((N + ABN - 1) / ABN, (M + ABM - 1) / ABM, batch * slices);
  atb_split_kernel<T><<<grid, kAtbThreads, 0, s>>>(a, b, slices > 1 ? ws : out, M, K, N, L,
                                                   slices);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || slices == 1) return e;
  const long long total = (long long)batch * M * N;
  atb_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(ws, out, (long long)M * N,
                                                                     slices, total);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a (batch, K, N1) and b (batch, K, N2) of one type (f32, or bf16 when
// bf16 is 1), device pointers to contiguous arrays; out (batch, N1, N2)
// f32. For N1 > 4, slices of L samples each (slices · L ≥ K) and, when
// slices > 1, ws (batch, slices, N1, N2) f32 scratch. Returns the launch's
// CUDA error, or 0.
int repro_matmul_atb(const void* a, const void* b, float* out, float* ws, int batch, int K,
                     int N1, int N2, int L, int slices, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return launch_atb(static_cast<const T*>(a), static_cast<const T*>(b), out, ws, batch, K, N1,
                      N2, L, slices, s);
  }
  return launch_atb(static_cast<const float*>(a), static_cast<const float*>(b), out, ws, batch,
                    K, N1, N2, L, slices, s);
}

}  // extern "C"
