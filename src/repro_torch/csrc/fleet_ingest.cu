// Fused fleet-tick ingest for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fleet_ingest.py::fleet_ingest_kernel
// (pallas_call at :284, inner kernel _ingest_kernel at :143). Per device d
// and a window of T samples:
//   H      = G(x·α + b)                                  (T, Ñ)
//   loss_d = mean((targets − H·β₀)²)   the pre-train drift score
//   then T sequential k=1 RLS steps with forgetting λ:
//     Pf = P/λ;  ph = Pf·h;  denom = 1 + h·ph;  P = Pf − ph·phᵀ/denom
//     gain = P·h;  err = t − h·β;  β = β + gain·errᵀ
//
// What bounds it on an H100: at the har width (D=256, T=32, n=m=561, Ñ=128)
// the work is about 5.5 GFLOP of f32 against 199 MB of traffic, so it is
// f32-compute bound (0.08 ms at 67 TFLOP/s). The TPU kernel keeps one
// device's P and β resident across the window; here one device's β
// (Ñ·m·4 = 287 KB) does not fit in the 227 KB of shared memory a block
// may use. The design follows from two facts of the recursion: the
// P/gain chain never reads β, and every column of β (and of the error)
// evolves on its own from the same gain sequence. So the tick runs as
// four launches on one stream:
//   1. the hidden projection — H for the whole window, the f32 GEMM of
//      gemm.cuh with the bias and activation in its epilogue;
//   2. ingest_gain_kernel  — one block per device keeps P (Ñ×Ñ, 64 KB) in
//      shared memory across the window and writes the T gain vectors;
//   3. ingest_beta_kernel  — one block per (device, 32-column tile of β)
//      keeps its β tile in shared memory, computes the tile's pre-train
//      squared errors, then applies the T rank-1 updates;
//   4. ingest_loss_kernel  — sums each device's per-tile partials in a
//      fixed order (no atomics), so the drift score is reproducible.
// The order of operations inside a step is the reference's, so the plain
// PyTorch version (repro_torch.kernels.fleet_ingest) mirrors it term by
// term. No padding: every loop masks its ragged edge.
#include <cuda_runtime.h>
#include <math.h>

#include "gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBetaTile = 32;  // columns of β per block

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// One block per device: the P chain over the window, P resident in shared
// memory (row stride N+1), writing gain_t = P_t·h_t for every step.
__global__ void __launch_bounds__(kThreads)
ingest_gain_kernel(const float* __restrict__ h_all, const float* __restrict__ p_in,
                   float* __restrict__ p_out, float* __restrict__ gains,
                   int T, int N, float forget) {
  extern __shared__ float smem[];
  const int ld = N + 1;
  float* P = smem;
  float* hv = P + N * ld;
  float* ph = hv + N;
  float* red = ph + N;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int d = blockIdx.x;
  const float* pin = p_in + (size_t)d * N * N;
  for (int i = tid; i < N * N; i += kThreads) P[(i / N) * ld + i % N] = pin[i];

  for (int t = 0; t < T; ++t) {
    const float* hrow = h_all + ((size_t)d * T + t) * N;
    for (int i = tid; i < N; i += kThreads) hv[i] = hrow[i];
    __syncthreads();
    // ph = (P/λ)·h, one warp per row
    for (int r = warp; r < N; r += kWarps) {
      float s = 0.0f;
      for (int k = lane; k < N; k += 32) s += (P[r * ld + k] / forget) * hv[k];
      s = warp_sum(s);
      if (lane == 0) ph[r] = s;
    }
    __syncthreads();
    if (warp == 0) {
      float s = 0.0f;
      for (int k = lane; k < N; k += 32) s += hv[k] * ph[k];
      s = warp_sum(s);
      if (lane == 0) red[0] = 1.0f + s;
    }
    __syncthreads();
    const float denom = red[0];
    for (int i = tid; i < N * N; i += kThreads) {
      const int r = i / N, c = i % N;
      P[r * ld + c] = P[r * ld + c] / forget - (ph[r] * ph[c]) / denom;
    }
    __syncthreads();
    // gain = P_new·h as a matvec, as the reference computes it
    float* grow = gains + ((size_t)d * T + t) * N;
    for (int r = warp; r < N; r += kWarps) {
      float s = 0.0f;
      for (int k = lane; k < N; k += 32) s += P[r * ld + k] * hv[k];
      s = warp_sum(s);
      if (lane == 0) grow[r] = s;
    }
    __syncthreads();
  }
  float* pout = p_out + (size_t)d * N * N;
  for (int i = tid; i < N * N; i += kThreads) pout[i] = P[(i / N) * ld + i % N];
}

// One block per (32-column tile of β, device). The tile lives transposed
// in shared memory, Bt[j][k] with row stride N+1, so the per-column dot
// products (lanes over k) and the rank-1 updates (threads over k) both
// walk consecutive banks.
__global__ void __launch_bounds__(kThreads)
ingest_beta_kernel(const float* __restrict__ h_all, const float* __restrict__ gains,
                   const float* __restrict__ targets, const float* __restrict__ beta_in,
                   float* __restrict__ beta_out, float* __restrict__ loss_part,
                   int T, int N, int M) {
  extern __shared__ float smem[];
  const int ld = N + 1;
  float* Bt = smem;
  float* hv = Bt + kBetaTile * ld;
  float* gv = hv + N;
  float* err = gv + N;
  float* red = err + kBetaTile;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tile = blockIdx.x, d = blockIdx.y;
  const int j0 = tile * kBetaTile;
  const int ncol = min(kBetaTile, M - j0);
  const float* bin = beta_in + (size_t)d * N * M;
  for (int i = tid; i < kBetaTile * N; i += kThreads) {
    const int k = i / kBetaTile, j = i % kBetaTile;
    Bt[j * ld + k] = j < ncol ? bin[(size_t)k * M + j0 + j] : 0.0f;
  }
  const float* tgt = targets + (size_t)d * T * M + j0;

  // pre-train squared errors of this tile under the tick-start β
  float sq = 0.0f;
  for (int t = 0; t < T; ++t) {
    __syncthreads();
    const float* hrow = h_all + ((size_t)d * T + t) * N;
    for (int i = tid; i < N; i += kThreads) hv[i] = hrow[i];
    __syncthreads();
    for (int j = warp; j < ncol; j += kWarps) {
      float s = 0.0f;
      for (int k = lane; k < N; k += 32) s += hv[k] * Bt[j * ld + k];
      s = warp_sum(s);
      const float e = tgt[(size_t)t * M + j] - s;
      sq += e * e;  // every lane holds the same value; lane 0's is kept
    }
  }
  if (lane == 0) red[warp] = sq;
  __syncthreads();
  if (tid == 0) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    loss_part[(size_t)d * gridDim.x + tile] = s;
  }

  // the T sequential rank-1 updates of this tile
  for (int t = 0; t < T; ++t) {
    __syncthreads();
    const float* hrow = h_all + ((size_t)d * T + t) * N;
    const float* grow = gains + ((size_t)d * T + t) * N;
    for (int i = tid; i < N; i += kThreads) {
      hv[i] = hrow[i];
      gv[i] = grow[i];
    }
    __syncthreads();
    for (int j = warp; j < kBetaTile; j += kWarps) {
      float s = 0.0f;
      for (int k = lane; k < N; k += 32) s += hv[k] * Bt[j * ld + k];
      s = warp_sum(s);
      if (lane == 0) err[j] = j < ncol ? tgt[(size_t)t * M + j] - s : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < kBetaTile * N; i += kThreads) {
      const int j = i / N, k = i % N;
      Bt[j * ld + k] += gv[k] * err[j];
    }
  }
  __syncthreads();
  float* bout = beta_out + (size_t)d * N * M;
  for (int i = tid; i < kBetaTile * N; i += kThreads) {
    const int k = i / kBetaTile, j = i % kBetaTile;
    if (j < ncol) bout[(size_t)k * M + j0 + j] = Bt[j * ld + k];
  }
}

// loss[d] = Σ_tiles part[d, tile] / (T·M), summed in tile order.
__global__ void ingest_loss_kernel(const float* __restrict__ part, float* __restrict__ loss,
                                   int D, int n_tiles, float count) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float s = 0.0f;
  for (int i = 0; i < n_tiles; ++i) s += part[(size_t)d * n_tiles + i];
  loss[d] = s / count;
}

}  // namespace

extern "C" {

// Shared memory the two resident-state kernels ask for, in bytes.
int repro_ingest_gain_smem(int N) { return (N * (N + 1) + 2 * N + 32) * 4; }
int repro_ingest_beta_smem(int N) {
  return (kBetaTile * (N + 1) + 2 * N + kBetaTile + kWarps) * 4;
}
int repro_ingest_beta_tile() { return kBetaTile; }

// All pointers are device pointers to contiguous f32 arrays:
// x (D,T,n), targets (D,T,m), alpha (n,N), bias (N), p_in/p_out (D,N,N),
// beta_in/beta_out (D,N,m), loss (D); workspaces h_ws and gain_ws (D,T,N),
// part_ws (D, ceil(m/32)). Returns the first CUDA error, or 0.
int repro_fleet_ingest(const float* x, const float* targets, const float* alpha,
                       const float* bias, const float* p_in, const float* beta_in,
                       float* p_out, float* beta_out, float* loss, float* h_ws,
                       float* gain_ws, float* part_ws, int D, int T, int n, int N,
                       int m, int act, float forget, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  e = launch_gemm<float, false>(x, alpha, bias, h_ws, 1, D * T, n, N, act, s);
  if (e != cudaSuccess) return e;

  const int gsmem = repro_ingest_gain_smem(N);
  e = cudaFuncSetAttribute(ingest_gain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, gsmem);
  if (e != cudaSuccess) return e;
  ingest_gain_kernel<<<D, kThreads, gsmem, s>>>(h_ws, p_in, p_out, gain_ws, T, N, forget);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const int n_tiles = (m + kBetaTile - 1) / kBetaTile;
  const int bsmem = repro_ingest_beta_smem(N);
  e = cudaFuncSetAttribute(ingest_beta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bsmem);
  if (e != cudaSuccess) return e;
  ingest_beta_kernel<<<dim3(n_tiles, D), kThreads, bsmem, s>>>(
      h_ws, gain_ws, targets, beta_in, beta_out, part_ws, T, N, m);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  ingest_loss_kernel<<<(D + 127) / 128, 128, 0, s>>>(part_ws, loss, D, n_tiles,
                                                     (float)T * (float)m);
  return cudaGetLastError();
}

}  // extern "C"
