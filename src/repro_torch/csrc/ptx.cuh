// Asynchronous copies and bf16 tensor-core products in inline PTX for
// Hopper (sm_90a), shared by flash_attn.cu and matmul_atb.cu.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy BYTES (4, 8 or 16) from device to shared memory without passing
// through registers; only the first src_bytes are read and the rest of the
// destination is zeroed, so src_bytes = 0 zero-fills a chunk past an edge
// (src must still be a valid, aligned address).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(BYTES), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Four 8 × 8 matrices of 16-bit elements from shared memory: lanes 8i to
// 8i + 7 give the addresses of matrix i's rows (16 bytes each); register i
// receives matrix i, lane l holding row l/4, elements 2(l%4) and 2(l%4)+1
// (with .trans, column l/4, rows 2(l%4) and 2(l%4)+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c (16 × 8, f32) += a (16 × 16, bf16, row-major) · b (16 × 8, bf16,
// column-major). With g = lane/4 and t = lane%4: a holds rows g and g+8 at
// columns 2t, 2t+1 (a[0], a[1]) and 2t+8, 2t+9 (a[2], a[3]); b holds column
// g at rows 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1); c holds rows g (c[0], c[1])
// and g+8 (c[2], c[3]) at columns 2t and 2t+1.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one instruction (MUFU.EX2): relative error about 2^-22, and
// subnormal results flushed to 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
