// Rank-1 update O = X + s·u vᵀ for Hopper (sm_90a): the two updates of the
// k=1 OS-ELM step, P' = P − (Ph)(Ph)ᵀ/denom and β' = β + (Ph)·errᵀ/denom.
//
// Replaces the TPU kernel src/repro/kernels/rank1_add.py::rank1_add
// (pallas_call :53, inner kernel _rank1_kernel :23). Bound on an H100:
// bytes, one read of X and one write of O with u and v riding along; at
// the har width (Ñ = 128, m = 561) 131 KB on P (0.039 µs at 3.35 TB/s) and
// 575 KB on β (0.172 µs). One thread per element, four elements a thread
// with 16-byte loads and stores where the row length is a multiple of 4
// and the arrays are 16-byte aligned (P; β's 561 columns take the scalar
// path).
//
// The scale is read from device memory (s_ptr) when the caller has it
// there, as the k=1 step does with −1/denom and 1/denom: reading it back
// to pass it by value would stall the host on the card twice per sample.
// s_val is used when s_ptr is null.
//
// Arithmetic, bit for bit with the reference as XLA compiles
// x + scale·u_col·v: the product s·u[i] rounded, then one fused
// multiply-add, __fmaf_rn(s·u[i], v[j], x[i][j]) (XLA contracts the
// product into the add; with the two roundings of a separate multiply and
// add 2 701 of 16 384 elements differ on a 128 × 128 case).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
rank1_kernel(const T* __restrict__ x, const T* __restrict__ u, const T* __restrict__ v,
             const float* __restrict__ s_ptr, float s_val, float* __restrict__ out, int N1,
             int N2) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)N1 * N2) return;
  const float s = s_ptr != nullptr ? *s_ptr : s_val;
  const int i = (int)(idx / N2), j = (int)(idx % N2);
  out[idx] = __fmaf_rn(__fmul_rn(s, widen(u[i])), widen(v[j]), widen(x[idx]));
}

// f32 with N2 % 4 == 0: four consecutive elements of one row per thread
__global__ void __launch_bounds__(kThreads)
rank1_kernel_vec4(const float4* __restrict__ x, const float* __restrict__ u,
                  const float4* __restrict__ v, const float* __restrict__ s_ptr, float s_val,
                  float4* __restrict__ out, int N1, int N2) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int q = N2 / 4;
  if (idx >= (long long)N1 * q) return;
  const float s = s_ptr != nullptr ? *s_ptr : s_val;
  const int i = (int)(idx / q), j = (int)(idx % q);
  const float su = __fmul_rn(s, u[i]);
  const float4 xv = x[idx], vv = v[j];
  float4 o;
  o.x = __fmaf_rn(su, vv.x, xv.x);
  o.y = __fmaf_rn(su, vv.y, xv.y);
  o.z = __fmaf_rn(su, vv.z, xv.z);
  o.w = __fmaf_rn(su, vv.w, xv.w);
  out[idx] = o;
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

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
  if (bf16) {
    using T = __nv_bfloat16;
    rank1_kernel<T><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(u), static_cast<const T*>(v), s_ptr,
        s_val, out, N1, N2);
  } else if (N2 % 4 == 0 && aligned16(x) && aligned16(v) && aligned16(out)) {
    const long long nq = n / 4;
    rank1_kernel_vec4<<<(unsigned)((nq + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        static_cast<const float4*>(x), static_cast<const float*>(u),
        static_cast<const float4*>(v), s_ptr, s_val, reinterpret_cast<float4*>(out), N1, N2);
  } else {
    rank1_kernel<float><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(u),
        static_cast<const float*>(v), s_ptr, s_val, out, N1, N2);
  }
  return cudaGetLastError();
}

}  // extern "C"
