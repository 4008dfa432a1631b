// f32-accumulating matrix products shared by hidden_proj.cu, matmul_atb.cu
// and fleet_ingest.cu (sm_90a).
//
//   out[z][m][n] = G(Σ_k a(z, m, k) · b[z][k][n] + bias[n])
//
// The left operand a(z, m, k) is read either from a row-major (M, K) array
// (kSamples = false: x·α of the hidden projection) or in place from a
// sample-major (K, M) array (kSamples = true: AᵀB with the sample axis
// contracted, so Aᵀ is never materialised). Inputs are f32 or bf16 and are
// widened to f32 on load; sums are f32. Every output element is summed in
// a fixed order, with no split of k across blocks and no atomics:
//
// * gemm_tile_kernel (M > kSkinnyRows): a 64 × 64 output tile per block of
//   256 threads, 4 × 4 outputs a thread in registers, k in 16-wide slices
//   through shared memory; each output sums a slice in order, one fused
//   multiply-add per k, and adds the slice sums in order. The two levels
//   keep the rounding error to that of about 16 + K/16 additions, not K:
//   with one running sum the error at K = 561 reached 1.03e-6 of the
//   largest output (NVIDIA H100, against a PyTorch product).
// * gemm_skinny_kernel (M ≤ kSkinnyRows, the k=1 step's 1 × K products):
//   a tile kernel would run two blocks through K/16 barrier-separated
//   slices. Here a block of 32 warps takes 32 output columns; warp w sums
//   k = w, w+32, ... with lanes on consecutive columns (each load of b a
//   coalesced 128-byte row segment), and the 32 partials of an output are
//   then summed in warp order.
//
// The bias and the activation G are applied once, to the finished sum
// (a fused epilogue: the pre-activation never goes to device memory).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// the codes of repro_torch.core.activations.ACTIVATION_CODES
__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case 1: return 1.0f / (1.0f + expf(-x));                       // sigmoid
    case 2: return tanhf(x);                                        // tanh
    case 3: return fmaxf(x, 0.0f);                                  // relu
    case 4: return 0.5f * x * (1.0f + tanhf(0.7978845608028654f *   // gelu
                                            (x + 0.044715f * x * x * x)));
    case 5: return x / (1.0f + expf(-x));                           // silu
    default: return x;                                              // identity
  }
}

constexpr int kGemmThreads = 256;
constexpr int PBM = 64, PBN = 64, PBK = 16;
constexpr int kSkinnyRows = 4;
constexpr int kSkinnyWarps = 32;

template <typename T, bool kSamples>
__device__ __forceinline__ float left(const T* a, int m, int k, int M, int K) {
  return to_f32(kSamples ? a[(size_t)k * M + m] : a[(size_t)m * K + k]);
}

template <typename T>
__device__ __forceinline__ float epilogue(float s, const T* bias, int n, int act) {
  return activate(bias != nullptr ? s + to_f32(bias[n]) : s, act);
}

template <typename T, bool kSamples>
__global__ void __launch_bounds__(kGemmThreads)
gemm_tile_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ bias,
                 float* __restrict__ out, int M, int K, int N, int act) {
  __shared__ float at[PBK][PBM + 4];
  __shared__ float bt[PBK][PBN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * PBM, n0 = blockIdx.x * PBN;
  const size_t z = blockIdx.z;
  a += z * M * K;
  b += z * K * N;
  out += z * M * N;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += PBK) {
    for (int i = tid; i < PBM * PBK; i += kGemmThreads) {
      // consecutive threads on consecutive addresses in either layout
      const int r = kSamples ? i % PBM : i / PBK, c = kSamples ? i / PBM : i % PBK;
      const int gm = m0 + r, gk = k0 + c;
      at[c][r] = (gm < M && gk < K) ? left<T, kSamples>(a, gm, gk, M, K) : 0.0f;
    }
    for (int i = tid; i < PBK * PBN; i += kGemmThreads) {
      const int r = i / PBN, c = i % PBN;
      const int gk = k0 + r, gn = n0 + c;
      bt[r][c] = (gk < K && gn < N) ? to_f32(b[(size_t)gk * N + gn]) : 0.0f;
    }
    __syncthreads();
    float part[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < PBK; ++kk) {
      float ar[4], br[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ar[i] = at[kk][ty * 4 + i];
        br[i] = bt[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(ar[i], br[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) out[(size_t)gm * N + gn] = epilogue(acc[i][j], bias, gn, act);
    }
  }
}

template <typename T, bool kSamples>
__global__ void __launch_bounds__(kSkinnyWarps * 32)
gemm_skinny_kernel(const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ bias,
                   float* __restrict__ out, int M, int K, int N, int act) {
  __shared__ float part[kSkinnyWarps][kSkinnyRows][33];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + lane;
  const size_t z = blockIdx.y;
  a += z * M * K;
  b += z * K * N;
  out += z * M * N;
  float acc[kSkinnyRows] = {};
  if (n < N) {
#pragma unroll 4
    for (int k = warp; k < K; k += kSkinnyWarps) {
      const float bv = to_f32(b[(size_t)k * N + n]);
#pragma unroll
      for (int m = 0; m < kSkinnyRows; ++m)
        if (m < M) acc[m] = fmaf(left<T, kSamples>(a, m, k, M, K), bv, acc[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < kSkinnyRows; ++m) part[warp][m][lane] = acc[m];
  __syncthreads();
  const int t = threadIdx.x;
  if (t < M * 32) {
    const int m = t / 32, l = t % 32, nn = blockIdx.x * 32 + l;
    if (nn < N) {
      float s = part[0][m][l];
      for (int w = 1; w < kSkinnyWarps; ++w) s += part[w][m][l];
      out[(size_t)m * N + nn] = epilogue(s, bias, nn, act);
    }
  }
}

// `batch` independent products of the same shape, contiguous one after
// the other; bias (N,) shared, or null. Returns the launch's error.
template <typename T, bool kSamples>
cudaError_t launch_gemm(const T* a, const T* b, const T* bias, float* out, int batch,
                        int M, int K, int N, int act, cudaStream_t s) {
  if (M <= kSkinnyRows) {
    gemm_skinny_kernel<T, kSamples><<<dim3((N + 31) / 32, batch), kSkinnyWarps * 32, 0, s>>>(
        a, b, bias, out, M, K, N, act);
  } else {
    dim3 grid((N + PBN - 1) / PBN, (M + PBM - 1) / PBM, batch);
    gemm_tile_kernel<T, kSamples><<<grid, kGemmThreads, 0, s>>>(a, b, bias, out, M, K, N, act);
  }
  return cudaGetLastError();
}

}  // namespace
