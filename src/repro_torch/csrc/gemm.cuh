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
// a fixed order, with no atomics, so two calls give the same bits.
//
// * gemm_tile_kernel (M > kSkinnyRows, row-major a only; the fleet ingest's
//   projection, whose 8 192 rows fill the card): a 64 × 64 output tile per
//   block of 256 threads, 4 × 4 outputs a thread in registers, k in
//   16-wide slices through shared memory; each output sums a slice in order,
//   one fused multiply-add per k, and adds the slice sums in order. The two levels
//   keep the rounding error to that of about 16 + K/16 additions, not K:
//   with one running sum the error at K = 561 reached 1.03e-6 of the
//   largest output (NVIDIA H100, against a PyTorch product).
// * gemm_skinny_kernel (M ≤ kSkinnyRows; matmul_atb's hᵀP): a block of 32
//   warps takes 32 output columns; warp w sums k = w, w+32, ... with lanes
//   on consecutive columns (each load of b a coalesced 128-byte row
//   segment), and the 32 partials of an output are then summed in warp
//   order.
// * split_tile and reduce_slices, the bodies of matmul_atb.cu's and
//   hidden_proj.cu's split products (M > kSkinnyRows): the contraction axis
//   is cut into slices across blocks (the wrappers' split_plan), each block
//   sums one 32 × 64 output tile over one slice through two shared-memory
//   stages, and a second kernel adds the slices in slice order. Either
//   layout of a; the bias and G, when given, are applied once, to the
//   finished sum.
//
// The bias and the activation G are applied once, to the finished sum
// (a fused epilogue: the pre-activation never goes to device memory).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ptx.cuh"

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

template <typename T>
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
      const int r = i / PBK, c = i % PBK;  // consecutive threads on consecutive addresses
      const int gm = m0 + r, gk = k0 + c;
      at[c][r] = (gm < M && gk < K) ? left<T, false>(a, gm, gk, M, K) : 0.0f;
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
// the other; bias (N,) shared, or null. Returns the launch's error; a
// sample-major a of more than kSkinnyRows rows is refused (matmul_atb.cu).
template <typename T, bool kSamples>
cudaError_t launch_gemm(const T* a, const T* b, const T* bias, float* out, int batch,
                        int M, int K, int N, int act, cudaStream_t s) {
  if (M <= kSkinnyRows) {
    gemm_skinny_kernel<T, kSamples><<<dim3((N + 31) / 32, batch), kSkinnyWarps * 32, 0, s>>>(
        a, b, bias, out, M, K, N, act);
  } else if constexpr (kSamples) {
    return cudaErrorInvalidValue;
  } else {
    dim3 grid((N + PBN - 1) / PBN, (M + PBM - 1) / PBM, batch);
    gemm_tile_kernel<T><<<grid, kGemmThreads, 0, s>>>(a, b, bias, out, M, K, N, act);
  }
  return cudaGetLastError();
}

constexpr int kSplitThreads = 128;
constexpr int SBM = 32, SBN = 64, SBK = 16;  // tile rows (of M), columns (of N), k a stage

// Column swizzle of the left operand's stage. A row-major a is read with
// consecutive threads on consecutive k, so without it the 16 k of one row
// would land in one bank; the xor moves whole float4s, so a thread's four
// rows stay one aligned 16-byte load. A sample-major a needs none.
template <bool kSamples>
__device__ __forceinline__ int swz(int k) { return kSamples ? 0 : (k & 7) << 2; }

// Stage k = k0..k0+15 (those below k1) of a's rows m0.. and b's columns
// n0.. into at[k][m] and bt[k][n]; what lies past k1, M or N is zero. f32
// by 4-byte cp.async; bf16 through registers, widened to f32, since a row
// of an odd number of bf16 values is not 4-byte aligned and cp.async
// copies no fewer than 4 bytes.
template <typename T, bool kSamples>
__device__ __forceinline__ void split_stage(float (*at)[SBM], float (*bt)[SBN], const T* a,
                                            const T* b, int k0, int k1, int m0, int n0, int M,
                                            int K, int N) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = tid; i < SBK * SBM; i += kSplitThreads) {
    // consecutive threads on consecutive addresses of a
    const int r = kSamples ? i / SBM : i % SBK, c = kSamples ? i % SBM : i / SBK;
    const int gk = k0 + r, gm = m0 + c;
    const bool in = gk < k1 && gm < M;
    const T* src = a + (in ? (kSamples ? (size_t)gk * M + gm : (size_t)gm * K + gk) : 0);
    float* dst = &at[r][c ^ swz<kSamples>(r)];
    if constexpr (sizeof(T) == 4) cp_async<4>(dst, src, in ? 4 : 0);
    else *dst = in ? to_f32(*src) : 0.0f;
  }
#pragma unroll
  for (int i = tid; i < SBK * SBN; i += kSplitThreads) {
    const int r = i / SBN, c = i % SBN, gk = k0 + r, gn = n0 + c;
    const bool in = gk < k1 && gn < N;
    const T* src = b + (in ? (size_t)gk * N + gn : 0);
    if constexpr (sizeof(T) == 4) cp_async<4>(&bt[r][c], src, in ? 4 : 0);
    else bt[r][c] = in ? to_f32(*src) : 0.0f;
  }
}

// The body of a split kernel: a (batch, M, K) row-major or (batch, K, M)
// sample-major, b (batch, K, N); grid (N tiles, M tiles, batch · slices),
// blockIdx.z = z · slices + slice. Slice s covers k in [s·L, min((s+1)·L, K)).
// part (batch, slices, M, N): each slice's sum; with one slice part is the
// output and takes the epilogue (bias may be null, act 0 is the identity).
// A block walks its slice 16 k at a time through two shared-memory stages,
// the next in flight while this one is summed; 128 threads hold 4 × 4
// outputs each. The sum has three levels: 16 k with one fused multiply-add
// each, the 16-k sums of a slice in order, then (reduce_slices) the slices
// in order.
template <typename T, bool kSamples>
__device__ __forceinline__ void split_tile(const T* __restrict__ a, const T* __restrict__ b,
                                           const T* __restrict__ bias, int act,
                                           float* __restrict__ part, int M, int K, int N, int L,
                                           int slices) {
  __shared__ __align__(16) float at[2][SBK][SBM];
  __shared__ __align__(16) float bt[2][SBK][SBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * SBM, n0 = blockIdx.x * SBN;
  const size_t z = blockIdx.z / slices;
  const int sl = blockIdx.z % slices;
  a += z * K * M;
  b += z * K * N;
  part += (z * slices + sl) * M * N;
  const int k0 = sl * L, k1 = min(k0 + L, K);
  const int steps = (k1 - k0 + SBK - 1) / SBK;

  float acc[4][4] = {};
  split_stage<T, kSamples>(at[0], bt[0], a, b, k0, k1, m0, n0, M, K, N);
  cp_async_commit();
  for (int u = 0; u < steps; ++u) {
    if (u + 1 < steps) split_stage<T, kSamples>(at[(u + 1) % 2], bt[(u + 1) % 2], a, b,
                                                k0 + (u + 1) * SBK, k1, m0, n0, M, K, N);
    cp_async_commit();
    cp_async_wait<1>();  // all but the stage just issued have landed
    __syncthreads();
    float p[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      const float4 ar =
          *reinterpret_cast<const float4*>(&at[u % 2][kk][(ty * 4) ^ swz<kSamples>(kk)]);
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
      if (gn < N) part[(size_t)gm * N + gn] = slices == 1 ? epilogue(acc[i][j], bias, gn, act)
                                                          : acc[i][j];
    }
  }
}

// The body of a reduce kernel: out[z][i] = G(Σ_s part[z][s][i] + bias[i % N]),
// s in order, one thread an output.
template <typename T>
__device__ __forceinline__ void reduce_slices(const float* __restrict__ part,
                                              float* __restrict__ out, long long MN, int slices,
                                              long long total, const T* __restrict__ bias, int N,
                                              int act) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long z = idx / MN, i = idx % MN;
  const float* p = part + z * slices * MN + i;
  float s = p[0];
  for (int k = 1; k < slices; ++k) s += p[k * MN];
  out[idx] = epilogue(s, bias, (int)(i % N), act);
}

}  // namespace
