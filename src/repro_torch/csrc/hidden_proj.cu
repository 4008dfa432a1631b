// Hidden-layer projection H = G(x·α + b) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hidden_proj.py::hidden_proj
// (pallas_call :66, inner kernel _hidden_kernel :23): a tiled product with
// an f32 accumulator and the bias and activation applied once, on the last
// k step. Here the bias and G are applied once too, to the finished sum.
//
// Bound on an H100 at the har width (n = 561, Ñ = 128): the k=1 step
// (x 1 × 561) reads α once, 287 KB, 0.086 µs at 3.35 TB/s, and is bound by
// bytes; E²LM batch statistics at 512 samples do 73.5 MFLOP, 1.10 µs at
// 67 TFLOP/s f32, and are bound by operations. Neither shape fills 132 SMs
// with one block an output tile walking all of K (4 and 16 blocks), so both
// designs cut K across blocks and add the slices in a fixed order:
//
// * M > kSkinnyRows (E²LM statistics, the Eq. 13 boot): proj_split_kernel,
//   gemm.cuh's split product with x row-major (consecutive threads on
//   consecutive k), a 32 × 64 output tile and one slice of k per block (the
//   wrapper's split_plan; at 512 × 561 · 561 × 128, 9 slices of 64 and 288
//   blocks), each slice's sum to an f32 workspace; proj_reduce_kernel adds
//   the slices in slice order and applies the bias and G. With one slice
//   the split kernel applies them itself.
// * M ≤ kSkinnyRows (the k=1 step's single sample): proj_k1_kernel, one
//   launch. A cluster of kK1Cluster blocks takes 32 output columns, each
//   block one slice of K; in a block, warp w sums k = w, w+16, ... of its
//   slice with lanes on consecutive columns (each load of α a coalesced
//   128-byte row segment, four loads in flight a thread). The block adds
//   its 16 warps' partials in warp order into shared memory, and block 0 of
//   the cluster adds the 8 slices in slice order from its neighbours'
//   shared memory (distributed shared memory), so the partials never go to
//   device memory and no atomic or second launch is needed. At the har
//   width 4 × 8 = 32 blocks read α, 9 KB each, against 4 blocks before.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kK1Warps = 16;   // warps a block
constexpr int kK1Cluster = 8;  // blocks a cluster (the portable maximum): slices of K

// x (M, K) row-major with M ≤ kSkinnyRows, alpha (K, N); grid (N/32
// column groups, kK1Cluster), one cluster a column group; block r of a
// cluster sums k in [r·L, min((r+1)·L, K)).
template <typename T>
__global__ void __cluster_dims__(1, kK1Cluster, 1) __launch_bounds__(kK1Warps * 32)
proj_k1_kernel(const T* __restrict__ x, const T* __restrict__ alpha, const T* __restrict__ bias,
               float* __restrict__ h, int M, int K, int N, int L, int act) {
  __shared__ float part[kK1Warps][kSkinnyRows][32];
  __shared__ float slice[kSkinnyRows][32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + lane;
  const int k1 = min((rank + 1) * L, K);
  float acc[kSkinnyRows] = {};
  if (n < N) {
#pragma unroll 4
    for (int k = rank * L + warp; k < k1; k += kK1Warps) {
      const float av = to_f32(alpha[(size_t)k * N + n]);
#pragma unroll
      for (int m = 0; m < kSkinnyRows; ++m)
        if (m < M) acc[m] = fmaf(to_f32(x[(size_t)m * K + k]), av, acc[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < kSkinnyRows; ++m) part[warp][m][lane] = acc[m];
  __syncthreads();
  const int t = threadIdx.x, m = t / 32, l = t % 32;
  if (t < M * 32) {
    float s = part[0][m][l];
    for (int w = 1; w < kK1Warps; ++w) s += part[w][m][l];
    slice[m][l] = s;
  }
  cluster.sync();  // every block's slice sum is in its shared memory
  const int nn = blockIdx.x * 32 + l;
  if (rank == 0 && t < M * 32 && nn < N) {
    float s = slice[m][l];
    for (int r = 1; r < kK1Cluster; ++r) s += cluster.map_shared_rank(&slice[0][0], r)[t];
    h[(size_t)m * N + nn] = epilogue(s, bias, nn, act);
  }
  cluster.sync();  // no block leaves while block 0 reads its shared memory
}

// gemm.cuh's split product with x row-major
template <typename T>
__global__ void __launch_bounds__(kSplitThreads)
proj_split_kernel(const T* __restrict__ x, const T* __restrict__ alpha,
                  const T* __restrict__ bias, int act, float* __restrict__ part, int M, int K,
                  int N, int L, int slices) {
  split_tile<T, false>(x, alpha, bias, act, part, M, K, N, L, slices);
}

// h[i] = G(Σ_s part[s][i] + bias[i % N]), s in order
template <typename T>
__global__ void proj_reduce_kernel(const float* __restrict__ part, float* __restrict__ h,
                                   long long MN, int slices, const T* __restrict__ bias, int N,
                                   int act) {
  reduce_slices<T>(part, h, MN, slices, MN, bias, N, act);
}

template <typename T>
cudaError_t launch_proj(const T* x, const T* alpha, const T* bias, float* h, float* ws, int M,
                        int K, int N, int L, int slices, int act, cudaStream_t s) {
  if (M <= kSkinnyRows) {
    const int lk = K > 0 ? (K + kK1Cluster - 1) / kK1Cluster : 1;
    proj_k1_kernel<T><<<dim3((N + 31) / 32, kK1Cluster), kK1Warps * 32, 0, s>>>(
        x, alpha, bias, h, M, K, N, lk, act);
    return cudaGetLastError();
  }
  if (L <= 0 || (long long)L * slices < K || (slices > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  const dim3 grid((N + SBN - 1) / SBN, (M + SBM - 1) / SBM, slices);
  proj_split_kernel<T><<<grid, kSplitThreads, 0, s>>>(x, alpha, bias, act,
                                                      slices > 1 ? ws : h, M, K, N, L, slices);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || slices == 1) return e;
  const long long mn = (long long)M * N;
  proj_reduce_kernel<T><<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(ws, h, mn, slices, bias, N,
                                                                      act);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K), alpha (K, N), bias (N) of one type (f32, or bf16 when bf16 is
// 1), device pointers to contiguous arrays; h (M, N) f32. act is a code of
// ACTIVATION_CODES. For M > 4, slices of L columns of x each (slices · L ≥
// K) and, when slices > 1, ws (slices, M, N) f32 scratch. Returns the
// launch's CUDA error, or 0.
int repro_hidden_proj(const void* x, const void* alpha, const void* bias, float* h, float* ws,
                      int M, int K, int N, int L, int slices, int act, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return launch_proj(static_cast<const T*>(x), static_cast<const T*>(alpha),
                       static_cast<const T*>(bias), h, ws, M, K, N, L, slices, act, s);
  }
  return launch_proj(static_cast<const float*>(x), static_cast<const float*>(alpha),
                     static_cast<const float*>(bias), h, ws, M, K, N, L, slices, act, s);
}

}  // extern "C"
