// The bf16 tensor-core tiles of the flash attention kernels, shared by the
// forward (csrc/flash_attn.cu) and the backward (csrc/flash_attn_bwd.cu), and
// by the GLA backward's (csrc/gla_scan_bwd.cu), so that the tile layout is
// decided in one place: blocks of four warps; rows
// of a (·, H, dim) bf16 array copied by cp.async into a row-major tile of
// HD columns padded by 16 bytes (the 8 rows an ldmatrix reads then fall in
// 8 bank groups); the operand fragments of mma.sync m16n8k16 read from such
// tiles by ldmatrix; a warp's 16 rows of f32 accumulators stored back to
// device memory in 16-byte chunks through shared memory.
#pragma once
#include <cstdint>
#include <cuda_bf16.h>

#include "ptx.cuh"

namespace {

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr float kLog2e = 1.4426950408889634f;

// Copy rows row0..row0+R−1 (those below n; the rest zero-filled) of a
// (·, H, dim) array, rs elements between rows, into a padded tile of
// R × HD. Thread t copies the 16 bytes at column 8·(t % (HD/8)) of rows
// t / (HD/8), then every kMmaThreads / (HD/8) rows on (zeros at a column
// past dim). An unmasked instance copies a tile wholly below n with no
// predicate at all; a masked one checks every copy anyway, and there that
// second loop only costs registers (the backward's masked dq kernel under
// hd 64 spilled) and time (4 % in the forward at hd 80 and 96, H100).
template <int R, int HD, bool kMasked>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long rs, int row0, int n, int dim) {
  constexpr int CH = HD / 8, RSTEP = kMmaThreads / CH, LD = HD + 8;
  static_assert(R % RSTEP == 0, "whole row steps");
  const int lr = threadIdx.x / CH, lc = (threadIdx.x % CH) * 8;
  const bool col_in = !kMasked || lc < dim;
  dst += lr * LD + lc;
  const __nv_bfloat16* src = base + (row0 + lr) * rs + lc;
  if (!kMasked && row0 + R <= n) {
#pragma unroll
    for (int i = 0; i < R / RSTEP; ++i)
      cp_async<16>(dst + i * RSTEP * LD, src + i * RSTEP * rs, 16);
    return;
  }
#pragma unroll
  for (int i = 0; i < R / RSTEP; ++i) {
    const bool in = col_in && row0 + lr + i * RSTEP < n;
    cp_async<16>(dst + i * RSTEP * LD, in ? src + i * RSTEP * rs : base, in ? 16 : 0);
  }
}

// The A fragment (16 rows from r0, depth step ks) of a padded tile whose
// rows are the product's rows (q for S, dout for dP, k for Sᵀ, v for dPᵀ).
template <int LD>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const __nv_bfloat16* t, int r0, int ks,
                                       int lane) {
  ldmatrix_x4(a, t + (r0 + lane % 16) * LD + 16 * ks + (lane / 16) * 8);
}

// The A fragment (16 rows from r0, depth step ks) of a padded tile whose
// rows are the depth and whose columns are the product's rows (the GLA
// backward's q ⊙ e^{cum} for ΔG = (q ⊙ e^{cum})ᵀ·dy, its gated dSᵀ for
// dS·k), through ldmatrix.trans.
template <int LD>
__device__ __forceinline__ void a_frag_trans(uint32_t (&a)[4], const __nv_bfloat16* t, int r0,
                                             int ks, int lane) {
  ldmatrix_x4_trans(a, t + (16 * ks + lane % 8 + (lane / 16) * 8) * LD + r0
                           + ((lane / 8) % 2) * 8);
}

// The B fragments of column tiles j and j+1 at depth step ks, from a tile
// whose rows are the product's columns (k for S; v for dP; q and dout for
// Sᵀ and dPᵀ): b[0], b[1] for tile j, b[2], b[3] for j+1.
template <int LD>
__device__ __forceinline__ void b_frag_rows(uint32_t (&b)[4], const __nv_bfloat16* t, int j,
                                            int ks, int lane) {
  ldmatrix_x4(b, t + (8 * j + lane % 8 + (lane / 16) * 8) * LD + 16 * ks + ((lane / 8) % 2) * 8);
}

// The B fragments of column tiles j and j+1 at depth step kk, from a tile
// whose rows are the depth (v for O; k for dQ; dout and q for dV and dK),
// through ldmatrix.trans.
template <int LD>
__device__ __forceinline__ void b_frag_trans(uint32_t (&b)[4], const __nv_bfloat16* t, int j,
                                             int kk, int lane) {
  ldmatrix_x4_trans(b, t + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * LD + 8 * j
                           + (lane / 16) * 8);
}

// A warp's 16 rows × HD of f32 accumulators (lane (g, t) holds rows g and
// g+8 at columns 8j + 2t, 8j + 2t + 1), rounded to bf16, to the (·, H, dim)
// rows row0.. (those below n, columns below dim), through 16 padded rows of
// shared memory that only this warp uses, for 16-byte stores.
template <int HD, bool kMasked>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 8][4], __nv_bfloat16* stage,
                                           __nv_bfloat16* base, long long rs, int row0, int n,
                                           int dim, int lane) {
  constexpr int LD = HD + 8, CH = HD / 8;
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8 * r) * LD + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
  __syncwarp();
#pragma unroll
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, col = (c % CH) * 8, s = row0 + r;
    if (s < n && (!kMasked || col < dim))
      *reinterpret_cast<uint4*>(base + s * rs + col) =
          *reinterpret_cast<const uint4*>(stage + r * LD + col);
  }
}

}  // namespace
