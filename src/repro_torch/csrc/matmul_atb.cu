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
//   skinny kernel.
// * Otherwise the sample axis is split across blocks, which gemm.cuh's
//   tile kernel (one block walking all of K for a 64 × 64 tile) does not
//   do: at the har width its grids were 4 blocks (HᵀH) and 18 (HᵀX) on 132
//   SMs, and the serial loop over K set the time. atb_split_kernel (on
//   gemm.cuh's split_tile, shared with hidden_proj.cu) gives a
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

namespace {

// gemm.cuh's split product with a read in place, sample-major
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
atb_split_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ part,
                 int M, int K, int N, int L, int slices) {
  split_tile<T, true>(a, b, nullptr, 0, part, M, K, N, L, slices);
}

// out[z][i] = Σ_s part[z][s][i], s in order
__global__ void atb_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  long long MN, int slices, long long total) {
  reduce_slices<float>(part, out, MN, slices, total, nullptr, 1, 0);
}

template <typename T>
cudaError_t launch_atb(const T* a, const T* b, float* out, float* ws, int batch, int K, int M,
                       int N, int L, int slices, cudaStream_t s) {
  if (M <= kSkinnyRows) return launch_gemm<T, true>(a, b, nullptr, out, batch, M, K, N, 0, s);
  if (L <= 0 || (long long)L * slices < K || (slices > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((N + SBN - 1) / SBN, (M + SBM - 1) / SBM, batch * slices);
  atb_split_kernel<T><<<grid, kSplitThreads, 0, s>>>(a, b, slices > 1 ? ws : out, M, K, N, L,
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
