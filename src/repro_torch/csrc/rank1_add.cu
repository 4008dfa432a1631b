// Rank-1 update O = X + s·u vᵀ for Hopper (sm_90a), and the whole tail of
// the k=1 OS-ELM step in one launch.
//
// Replaces the TPU kernel src/repro/kernels/rank1_add.py::rank1_add
// (pallas_call :53, inner kernel _rank1_kernel :23). Bound on an H100:
// bytes, one read of X and one write of O with u and v riding along; at
// the har width (Ñ = 128, m = 561) 131 KB on P (0.039 µs at 3.35 TB/s) and
// 575 KB on β (0.172 µs): far under the few microseconds any launch takes.
//
// rank1_kernel (repro_rank1_add, one target): a thread takes four adjacent
// elements of the flat array, finding their row once (and moving to the
// next row where the four cross one), with 16-byte loads and stores of X
// and O where the arrays are 16-byte aligned (8-byte for bf16 X). The scale
// is read from device memory (s_ptr) when the caller has it there, else
// s_val is used.
//
// k1_kernel (repro_k1_update): the k=1 step after ph = P·h, from P (already
// divided by λ), β, h, ph and the target t, in one launch:
//   denom = 1 + h·ph,  err = t − hᵀβ,  P' = P + (−1/denom)·ph phᵀ,
//   β' = β + (1/denom)·ph errᵀ.
// Blocks [0, p_blocks) update P as rank1_kernel does; each of the others
// owns a strip of 32 columns of β over all Ñ rows: it loads the strip, h
// and ph into shared memory (rows up to kStripRows; past them it reads
// them again), sums err for its columns and updates the strip, so β is
// read once. Every warp takes denom itself, while its block's loads are in
// flight, so no launch waits on a memory latency twice before its
// updates. The two reductions keep one fixed
// order that the plain version repeats in a few vector operations: lane l
// adds the products of rows l, l + 32, ... (rows past Ñ as zeros, up to a
// multiple of 32) in order from zero, then a xor-butterfly (16, 8, 4, 2,
// 1) adds the lanes' sums, which is the halving of 32 sums; each product
// is one rounded multiply. −1/denom and 1/denom are IEEE divisions. No
// atomics. The step's glue (two dot products, a subtraction, two
// reciprocals) and its two rank1_add launches become this one launch.
//
// The updates' arithmetic, bit for bit with the reference as XLA compiles
// x + scale·u_col·v: the product s·u[i] rounded, then one fused
// multiply-add, __fmaf_rn(s·u[i], v[j], x[i][j]) (XLA contracts the
// product into the add; with the two roundings of a separate multiply and
// add 2 701 of 16 384 elements differ on a 128 × 128 case).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 32;      // β columns a strip block owns
constexpr int kStripRows = 256; // strip rows kept in shared memory (33.8 KB)
static_assert(kStripRows <= kThreads, "a strip's h and ph are loaded one a thread");

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}

// Elements 4q .. 4q + 3 (those below n = N1·N2) of out = x + s·u vᵀ, the
// row found once; vec: x and out may move four elements at a time. The
// scale comes from scale(), called by every thread of the warp after its
// loads are issued (so that a scale read from memory, or summed by the
// warp, overlaps them).
template <typename T, typename Scale>
__device__ __forceinline__ void rank1_vec(const T* __restrict__ x, const T* __restrict__ u,
                                          const T* __restrict__ v, Scale scale,
                                          float* __restrict__ out, int N2, long long n,
                                          long long q, bool vec) {
  const long long e = 4 * q;
  const bool any = e < n, whole = vec && e + 4 <= n;
  int i = 0, j = 0;
  if (any && n <= INT_MAX) {
    i = (int)((unsigned)e / (unsigned)N2);
    j = (int)e - i * N2;
  } else if (any) {
    i = (int)(e / N2);
    j = (int)(e - (long long)i * N2);
  }
  float xv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (whole) {
    const float4 a = load4(x + e);
    xv[0] = a.x, xv[1] = a.y, xv[2] = a.z, xv[3] = a.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (e + c < n) xv[c] = widen(x[e + c]);
  }
  const float ui = any ? widen(u[i]) : 0.0f;
  const float s = scale();
  if (!any) return;
  float o[4];
  float su = __fmul_rn(s, ui);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (e + c >= n) break;
    o[c] = __fmaf_rn(su, widen(v[j]), xv[c]);
    if (++j == N2 && e + c + 1 < n) {  // the next element starts a row
      j = 0;
      su = __fmul_rn(s, widen(u[++i]));
    }
  }
  if (whole) {
    *reinterpret_cast<float4*>(out + e) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (e + c < n) out[e + c] = o[c];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rank1_kernel(const T* __restrict__ x, const T* __restrict__ u, const T* __restrict__ v,
             const float* __restrict__ s_ptr, float s_val, float* __restrict__ out, int N2,
             long long n, bool vec) {
  rank1_vec(x, u, v, [&] { return s_ptr != nullptr ? *s_ptr : s_val; }, out, N2, n,
            (long long)blockIdx.x * kThreads + threadIdx.x, vec);
}

// The xor-butterfly that ends both of the step's sums: every lane returns
// the sum of the 32 lanes' s, their pairs halved (16, 8, 4, 2, 1).
__device__ __forceinline__ float butterfly(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// denom = 1 + h·ph in the fixed order, by one whole warp (every lane, every
// warp: the same bits).
__device__ __forceinline__ float warp_denom(const float* __restrict__ h,
                                            const float* __restrict__ ph, int n) {
  const int lane = threadIdx.x % 32, n32 = (n + 31) / 32 * 32;
  float s = 0.0f;
  for (int i = lane; i < n32; i += 32) s = __fadd_rn(s, i < n ? __fmul_rn(h[i], ph[i]) : 0.0f);
  return __fadd_rn(1.0f, butterfly(s));
}

__global__ void __launch_bounds__(kThreads)
k1_kernel(const float* __restrict__ p, const float* __restrict__ beta,
          const float* __restrict__ h, const float* __restrict__ ph, const float* __restrict__ t,
          float* __restrict__ p_out, float* __restrict__ beta_out, int N, int M, int p_blocks,
          bool vec) {
  __shared__ float strip[kStripRows][kStrip + 1];
  __shared__ float hs[kStripRows], phs[kStripRows], err[kStrip], ts[kStrip];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (blockIdx.x < p_blocks) {  // P: its loads, then each warp's own denom
    rank1_vec(p, ph, ph, [&] { return __fdiv_rn(-1.0f, warp_denom(h, ph, N)); }, p_out, N,
              (long long)N * N, (long long)blockIdx.x * kThreads + tid, vec);
    return;
  }
  // a strip of β: its rows (up to kStripRows), h, ph and t into shared
  // memory, every load out before the first use
  const int j0 = (blockIdx.x - p_blocks) * kStrip, ncol = min(kStrip, M - j0);
  const int keep = min(N, kStripRows);
  {
    constexpr int kLoads = kStripRows * kStrip / kThreads;  // a thread's strip elements
    float b[kLoads];
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int idx = tid + r * kThreads, i = idx / kStrip, c = idx % kStrip;
      b[r] = i < keep && c < ncol ? beta[(size_t)i * M + j0 + c] : 0.0f;
    }
    const float hv = tid < keep ? h[tid] : 0.0f, phv = tid < keep ? ph[tid] : 0.0f;
    const float tv = tid < ncol ? t[j0 + tid] : 0.0f;
#pragma unroll
    for (int r = 0; r < kLoads; ++r) {
      const int idx = tid + r * kThreads;
      strip[idx / kStrip][idx % kStrip] = b[r];
    }
    if (tid < keep) hs[tid] = hv, phs[tid] = phv;
    if (tid < ncol) ts[tid] = tv;
  }
  const float sb = __fdiv_rn(1.0f, warp_denom(h, ph, N));
  __syncthreads();
  // err for the strip's columns: warp w sums columns w, w + 8, w + 16 and
  // w + 24 side by side, each in the fixed order
  constexpr int kCols = kStrip / kWarps;
  const int n32 = (N + 31) / 32 * 32;
  float s[kCols] = {};
  for (int i = lane; i < n32; i += 32) {
    const float hv = i < keep ? hs[i] : i < N ? h[i] : 0.0f;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int c = warp + kWarps * k;
      float prod = 0.0f;
      if (i < keep) prod = __fmul_rn(hv, strip[i][c]);
      else if (i < N && c < ncol) prod = __fmul_rn(hv, beta[(size_t)i * M + j0 + c]);
      s[k] = __fadd_rn(s[k], prod);
    }
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) s[k] = butterfly(s[k]);
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int c = warp + kWarps * k;
    if (lane == 0 && c < ncol) err[c] = __fsub_rn(ts[c], s[k]);
  }
  __syncthreads();
  for (int idx = tid; idx < N * kStrip; idx += kThreads) {
    const int i = idx / kStrip, c = idx % kStrip;
    if (c >= ncol) continue;
    const size_t at = (size_t)i * M + j0 + c;
    const float b = i < keep ? strip[i][c] : beta[at];
    const float phi = i < keep ? phs[i] : ph[i];
    beta_out[at] = __fmaf_rn(__fmul_rn(sb, phi), err[c], b);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// x (N1, N2), u (N1), v (N2) of one type (f32, or bf16 when bf16 is 1),
// device pointers to contiguous arrays; s_ptr a device pointer to one f32,
// or null to use s_val; out (N1, N2) f32. Returns the launch's CUDA error,
// or 0.
int repro_rank1_add(const void* x, const void* u, const void* v, const float* s_ptr,
                    float s_val, float* out, int N1, int N2, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)N1 * N2;
  if (n == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((n + 4LL * kThreads - 1) / (4LL * kThreads));
  const bool vec = aligned(x, bf16 ? 8 : 16) && aligned(out, 16);
  if (bf16) {
    using T = __nv_bfloat16;
    rank1_kernel<T><<<blocks, kThreads, 0, st>>>(static_cast<const T*>(x),
                                                  static_cast<const T*>(u),
                                                  static_cast<const T*>(v), s_ptr, s_val, out,
                                                  N2, n, vec);
  } else {
    rank1_kernel<float><<<blocks, kThreads, 0, st>>>(static_cast<const float*>(x),
                                                      static_cast<const float*>(u),
                                                      static_cast<const float*>(v), s_ptr, s_val,
                                                      out, N2, n, vec);
  }
  return cudaGetLastError();
}

// The k=1 step's tail: p (N, N) already divided by λ, beta (N, M), h, ph
// (N), t (M), device pointers to contiguous f32 arrays → p_out (N, N),
// beta_out (N, M). Returns the launch's CUDA error, or 0.
int repro_k1_update(const float* p, const float* beta, const float* h, const float* ph,
                    const float* t, float* p_out, float* beta_out, int N, int M, void* stream) {
  if (N == 0) return cudaSuccess;
  const long long pn = (long long)N * N;
  const int p_blocks = (int)((pn + 4LL * kThreads - 1) / (4LL * kThreads));
  const int strips = (M + kStrip - 1) / kStrip;
  k1_kernel<<<p_blocks + strips, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, beta, h, ph, t, p_out, beta_out, N, M, p_blocks, aligned(p, 16) && aligned(p_out, 16));
  return cudaGetLastError();
}

}  // extern "C"
