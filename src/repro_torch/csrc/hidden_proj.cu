// Hidden-layer projection H = G(x·α + b) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hidden_proj.py::hidden_proj
// (pallas_call :66, inner kernel _hidden_kernel :23): a tiled product with
// an f32 accumulator and the bias and activation applied once, on the last
// k step. Here the product is gemm.cuh's (shared with the fleet ingest's
// projection): the 64 × 64 tile kernel for batches of samples, the skinny
// kernel for the k=1 step's single sample, each with the bias and G fused
// into its epilogue, so the pre-activation never goes to device memory.
//
// Bound on an H100 at the har width (n = 561, Ñ = 128): the k=1 step
// (x 1 × 561) reads α once, 287 KB, 0.086 µs at 3.35 TB/s, and is bound by
// bytes; E²LM batch statistics at 512 samples do 73.5 MFLOP, 1.10 µs at
// 67 TFLOP/s f32, and are bound by operations. Both shapes are far too
// small to fill 132 SMs (2 to 16 blocks), so the launch and the serial k
// loop set the time; the design keeps the order of every sum fixed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm.cuh"

extern "C" {

// x (M, K), alpha (K, N), bias (N) of one type (f32, or bf16 when bf16 is
// 1), device pointers to contiguous arrays; h (M, N) f32. act is a code of
// ACTIVATION_CODES. Returns the launch's CUDA error, or 0.
int repro_hidden_proj(const void* x, const void* alpha, const void* bias, float* h, int M,
                      int K, int N, int act, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return launch_gemm<T, false>(static_cast<const T*>(x), static_cast<const T*>(alpha),
                                 static_cast<const T*>(bias), h, 1, M, K, N, act, s);
  }
  return launch_gemm<float, false>(static_cast<const float*>(x), static_cast<const float*>(alpha),
                                   static_cast<const float*>(bias), h, 1, M, K, N, act, s);
}

}  // extern "C"
