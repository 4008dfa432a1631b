// The ring that streams a cluster's rows through shared memory, shared by
// the segment sums' and the robust sum's plans for few long clusters
// (segsum_stream_kernel in topology_merge.cu, robust_stream_kernel in
// robust_merge.cu).
//
// A block owns a slice of kRingSlice elements of one cluster (128-byte row
// segments). Its copier threads stream the cluster's rows of that slice
// into a ring of kRingStages stages of kRingRows rows with cp.async (16
// bytes with an L2 prefetch hint where every row's slice starts on 16
// bytes, else 4), together with NSIDE per-device vectors (the mask, the
// clip scale) for the same rows, and arrive on the stage's full barrier
// when their copies land. The consumers wait on it, read the stage, and
// arrive on its empty barrier, which the copiers wait for before they
// refill the stage. Stage k of a cluster lies in slot k % kRingStages and
// is the (k / kRingStages)-th use of that slot, whose parity the barriers
// are waited on with.
#pragma once
#include <cstdint>

#include "ptx.cuh"

namespace {

constexpr int kRingSlice = 32;   // elements a block: 128-byte rows
constexpr int kRingRows = 256;   // device rows a stage
constexpr int kRingStages = 4;   // stages of the ring

// Dynamic shared memory of a ring whose stages carry NSIDE vectors.
template <int NSIDE>
__host__ __device__ constexpr int ring_smem_bytes() {
  return 4 * kRingStages * kRingRows * (kRingSlice + NSIDE);
}

using RingRows = float (*)[kRingRows][kRingSlice];  // [slot][row][element]
using RingSide = float (*)[kRingRows];              // [slot][row] of one vector

__device__ __forceinline__ RingRows ring_rows(float* smem) {
  return reinterpret_cast<RingRows>(smem);
}

// vector s (0 ≤ s < NSIDE) of the ring in smem
__device__ __forceinline__ RingSide ring_side(float* smem, int s) {
  return reinterpret_cast<RingSide>(smem + kRingStages * kRingRows * (kRingSlice + s));
}

// The parity of stage k's use of its slot.
__device__ __forceinline__ uint32_t ring_parity(int k) { return (k / kRingStages) & 1; }

// The copiers' loop: copier p of `copiers` copies elements [e0, e0 + width)
// of rows d0 .. d0 + n − 1 of w (rows E floats apart), VEC floats a copy
// (4 needs E % 4 == 0 and w on 16 bytes), and sides[0 .. NSIDE) at the same
// rows, stage by stage. full[slot] counts one arrival of each copier, empty
// the consumers'.
template <int VEC, int NSIDE>
__device__ __forceinline__ void ring_fill(float* smem, uint64_t* full, uint64_t* empty,
                                          const float* __restrict__ w, long long E,
                                          long long e0, int width, int d0, int n,
                                          const float* const* sides, int p, int copiers) {
  RingRows ring = ring_rows(smem);
  // copier p takes copy j of rows r_first, r_first + r_step, ... of a stage
  // (copiers past r_step·per_row copy only the side vectors)
  const int per_row = (width + VEC - 1) / VEC;  // copies a row
  const int r_step = copiers / per_row;
  const int j = (p % per_row) * VEC, r_first = p < r_step * per_row ? p / per_row : kRingRows;
  const int chunks = (n + kRingRows - 1) / kRingRows;
  bool side16[NSIDE > 0 ? NSIDE : 1];
#pragma unroll
  for (int s = 0; s < NSIDE; ++s)
    side16[s] = reinterpret_cast<std::uintptr_t>(sides[s] + d0) % 16 == 0;
  for (int k = 0; k < chunks; ++k) {
    const int slot = k % kRingStages, r0 = k * kRingRows, rows = min(kRingRows, n - r0);
    if (k >= kRingStages) mbar_wait(&empty[slot], ring_parity(k) ^ 1);
    const float* src = w + (size_t)(d0 + r0 + r_first) * E + e0 + j;
    for (int r = r_first; r < rows; r += r_step, src += (size_t)r_step * E) {
      if constexpr (VEC == 4) {
        cp_async16_l2_256(&ring[slot][r][j], src);
      } else {
        cp_async<4>(&ring[slot][r][j], src, 4);
      }
    }
#pragma unroll
    for (int s = 0; s < NSIDE; ++s) {
      float* dst = ring_side(smem, s)[slot];
      const float* m = sides[s] + d0 + r0;
      if (side16[s]) {
        for (int q = p; 4 * q < rows; q += copiers)
          cp_async<16>(dst + 4 * q, m + 4 * q, 4 * min(4, rows - 4 * q));
      } else {
        for (int r = p; r < rows; r += copiers) cp_async<4>(dst + r, m + r, 4);
      }
    }
    cp_async_mbar_arrive(&full[slot]);
  }
}

}  // namespace
