// AᵀB with the sample axis contracted, for Hopper (sm_90a): the E²LM
// statistics U = HᵀH and V = Hᵀt, and the k=1 step's ph = P·h.
//
// Replaces the TPU kernel src/repro/kernels/matmul_atb.py::matmul_atb
// (pallas_call :58, inner kernel _atb_kernel :22), which reads A under two
// block views so that Aᵀ is never materialised and accumulates over the
// sample tiles in an f32 scratch. Here gemm.cuh reads A (K, N1) in place,
// sample-major, as the left operand: the tile kernel stages a 16 × 64
// slice of A in shared memory with consecutive threads on consecutive
// columns, so Aᵀ is never written anywhere; the skinny kernel (N1 ≤ 4, the
// k=1 step's A = h of shape (Ñ, 1)) reads A's column directly. Every output
// sums k = 0..K−1 in a fixed order, so U and V do not change from run to
// run. A leading batch axis runs independent products side by side (one
// grid slice each), as a fleet's Eq. 13 boot does.
//
// Bound on an H100 at the har width (Ñ = 128, m = 561): the k=1 product
// reads P once, 64 KB, 0.020 µs at 3.35 TB/s (bytes); U = HᵀH at 512
// samples is 16.8 MFLOP (0.25 µs) and V = HᵀX 73.5 MFLOP (1.10 µs) at
// 67 TFLOP/s f32 (operations). As with hidden_proj.cu, the grids (2 to 18
// blocks) leave most of the card idle and the serial k loop sets the time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm.cuh"

extern "C" {

// a (batch, K, N1) and b (batch, K, N2) of one type (f32, or bf16 when
// bf16 is 1), device pointers to contiguous arrays; out (batch, N1, N2)
// f32. Returns the launch's CUDA error, or 0.
int repro_matmul_atb(const void* a, const void* b, float* out, int batch, int K, int N1,
                     int N2, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return launch_gemm<T, true>(static_cast<const T*>(a), static_cast<const T*>(b), nullptr, out,
                                batch, N1, K, N2, 0, s);
  }
  return launch_gemm<float, true>(static_cast<const float*>(a), static_cast<const float*>(b),
                                  nullptr, out, batch, N1, K, N2, 0, s);
}

}  // extern "C"
