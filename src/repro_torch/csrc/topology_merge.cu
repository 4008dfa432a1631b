// Eq. 8 merge kernels for Hopper (sm_90a).
//
// Replaces eight TPU kernels of src/repro/kernels/topology_merge.py:
//
// * masked_segment_sum_mix (pallas_call :242, _masked_segsum_kernel :181)
//   and segment_sum_mix (pallas_call :172, _segsum_kernel :123):
//     out[c] = Σ_{d: cid[d]=c} mask[d]·w[d] over the stacked payloads
//     w = [U | V] of shape (D, Ñ, Ñ+m); the unmasked form reads no mask.
//     Bound on an H100: bytes. At the har width it reads 90 MB (0.027 ms at
//     3.35 TB/s) and does one add (and, masked, one multiply) per element
//     read. One thread owns one element of the payload for one cluster and
//     walks the cluster's members in ascending device order from zero
//     (cluster offsets from the sorted ids, checked on the host), so the
//     sum has a fixed order and needs no atomics: the order of the Pallas
//     accumulator. The multiply and the add are rounded separately, as the
//     plain version rounds them. One kernel source, the mask a template
//     parameter.
//
// * segment_broadcast (pallas_call :269, _gather_kernel :251):
//     out[d] = sums[cid[d]], (C, Ñ, Ñ+m) → (D, Ñ, Ñ+m). Bound: bytes, the
//     C cluster sums read (from L2 after the first member) and D payloads
//     written, 90 MB at the har width with C = 32 (0.030 ms). One thread
//     per four elements with 16-byte loads and stores where the row length
//     is a multiple of 4 and both arrays are 16-byte aligned, else one per
//     element; a block reads its device's cluster id once.
//
// * banded_mix (pallas_call :106, _banded_kernel :83): the open ring's
//     neighbour sum out[d] = Σ_{o=−hops..hops} x[(d+o) mod D], summed from
//     zero in that order, the order of the Pallas accumulator. Bound: bytes;
//     each payload read once and each sum written once is 181 MB at the har
//     width and D = 256 (0.054 ms); with no reuse between neighbouring
//     devices the 2·hops+1 reads make it 542 MB at hops = 2 (0.16 ms). One
//     thread per element and device; blocks of neighbouring devices run
//     together, so most of the repeated reads come from L2. The (d+o) mod D
//     indexing is shared with banded_merge_solve (ring_src).
//
// * from_uv_solve (pallas_call :411, _solve_kernel :371, _gj_sweep :356):
//     Gauss-Jordan without pivoting on [U+εI | I | V] per system, giving
//     P = (U+εI)⁻¹ and β = PV (U+εI is SPD, so no pivoting, as in the
//     reference). The augmented system at the har width is 128 × 817 × 4 B
//     = 418 KB, more than the 227 KB of shared memory a block may use. So
//     the right-hand side [I | V] is cut into 64-column tiles across
//     blocks; each block holds A = U+εI (64 KB) and its own tile in shared
//     memory and repeats the elimination of A. Bound: at one system
//     (star, all_to_all) the 27 MFLOP run on a handful of SMs and the time
//     is set by the n sequential elimination steps (latency), far above the
//     FLOP bound.
//
// * banded_merge_solve (pallas_call :491, _banded_solve_kernel :425):
//     the open ring. Each block sums its device's 2·hops+1 neighbour
//     payloads at (d+o) mod D — the U part into A, the V columns of its own
//     tile — and runs the same elimination, so the merged (U, V) never goes
//     to device memory. Bound: f32 operations, about 6.9 GFLOP at D = 256
//     (0.10 ms); the repeated elimination of A per tile adds to that.
//
// * dense_mix (pallas_call :314, _dense_kernel :281): out = M @ flatten(x)
//     for any (D, D) mask M and x (D, Ñ, Ñ+m), the route of a dense topology
//     that is not fully connected. Bound on an H100: operations, 2·D²·Ñ(Ñ+m)
//     = 11.6 GFLOP at D = 256 and the har width (0.173 ms at 67 TFLOP/s f32;
//     181 MB of traffic, 0.054 ms). A register-blocked SIMT product (no
//     tensor cores: TF32 would change the bits): transpose_kernel writes
//     Mᵀ (D × D, 256 KB at D = 256) to a scratch array once, then each
//     block of dense_mix_kernel holds a 16 × 128 tile of Mᵀ and one of x,
//     both copied as they lie by cp.async in two stages, and each thread
//     keeps 8 × 8 outputs in registers, four 16-byte shared loads for 64
//     fused multiply-adds. (Copying M's tile transposed into shared
//     memory, 4 bytes a copy, set the time of the first design; reading
//     M's rows four k at a time instead spilled at the 128 registers that
//     two blocks an SM allow.) Every output accumulates
//     k = 0..D−1 in order, one fused multiply-add per step, exactly as the
//     plain version does, so the two agree bit for bit (no TF32, no split
//     over k: RLS parity degrades as κ(P)² with a looser product).
//
// The elimination step is the reference's: row_k = w[k,:]/w[k,k],
// w ← w − (w[:,k] − e_k)·row_k. Columns j < k of A are already e_j and
// row_k is 0 there, so only the columns j > k of A are updated; the
// right-hand side is updated in full.
#include <cuda_runtime.h>

#include <cstdint>

#include "ptx.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSolveTile = 64;  // right-hand-side columns per block

// kMasked: each member's payload is scaled by mask[d] first (the masked
// merge); otherwise the mask is never read (mask may be null).
template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const float* __restrict__ w, const int* __restrict__ seg_start,
              const float* __restrict__ mask, float* __restrict__ out, long long E) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  const int c = blockIdx.y;
  const int d0 = seg_start[c], d1 = seg_start[c + 1];
  float acc = 0.0f;
#pragma unroll 8
  for (int d = d0; d < d1; ++d) {
    const float x = w[(size_t)d * E + e];
    acc = __fadd_rn(acc, kMasked ? __fmul_rn(x, mask[d]) : x);
  }
  out[(size_t)c * E + e] = acc;
}

// One block row per device d (blockIdx.y): out[d, :] = sums[cid[d], :].
__global__ void __launch_bounds__(kThreads)
segment_broadcast_kernel(const float* __restrict__ sums, const int* __restrict__ cids,
                         float* __restrict__ out, long long E) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  const int d = blockIdx.y;
  out[(size_t)d * E + e] = sums[(size_t)cids[d] * E + e];
}

// The same with four elements a thread: E4 = E / 4 float4s per row.
__global__ void __launch_bounds__(kThreads)
segment_broadcast_kernel_vec4(const float4* __restrict__ sums, const int* __restrict__ cids,
                              float4* __restrict__ out, long long E4) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= E4) return;
  const int d = blockIdx.y;
  out[(size_t)d * E4 + e] = sums[(size_t)cids[d] * E4 + e];
}

// The device o places from d around a ring of D devices, for |o| < D.
__device__ __forceinline__ int ring_src(int d, int o, int D) { return ((d + o) % D + D) % D; }

// One block row per device d (blockIdx.y), one thread per element.
__global__ void __launch_bounds__(kThreads)
banded_mix_kernel(const float* __restrict__ x, float* __restrict__ out, int D, long long E,
                  int hops) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  const int d = blockIdx.y;
  float acc = 0.0f;
  for (int o = -hops; o <= hops; ++o) acc = __fadd_rn(acc, x[(size_t)ring_src(d, o, D) * E + e]);
  out[(size_t)d * E + e] = acc;
}

// Eliminate A (n×n, row stride n+1) against the tile R (n×tc, row stride
// tc+1), both in shared memory. rowbuf holds n+tc floats, colbuf n.
__device__ void gj_sweep(float* A, float* R, float* rowbuf, float* colbuf, int n, int tc) {
  const int lda = n + 1, ldr = tc + 1;
  const int tid = threadIdx.x;
  for (int k = 0; k < n; ++k) {
    const float pivot = A[k * lda + k];
    for (int i = tid; i < n + tc; i += kThreads)
      rowbuf[i] = (i < n ? A[k * lda + i] : R[k * ldr + (i - n)]) / pivot;
    for (int i = tid; i < n; i += kThreads)
      colbuf[i] = A[i * lda + k] - (i == k ? 1.0f : 0.0f);
    __syncthreads();
    const int wa = n - k - 1;
    for (int idx = tid; idx < n * wa; idx += kThreads) {
      const int i = idx / wa, j = k + 1 + idx % wa;
      A[i * lda + j] -= colbuf[i] * rowbuf[j];
    }
    for (int idx = tid; idx < n * tc; idx += kThreads) {
      const int i = idx / tc, j = idx % tc;
      R[i * ldr + j] -= colbuf[i] * rowbuf[n + j];
    }
    __syncthreads();
  }
}

// Write the solved tile: column c < n of [P | β] goes to P, the rest to β.
__device__ void store_tile(const float* R, float* p, float* beta, int n, int m, int c0,
                           int tc) {
  const int ldr = tc + 1;
  for (int idx = threadIdx.x; idx < n * tc; idx += kThreads) {
    const int i = idx / tc, j = idx % tc, c = c0 + j;
    if (c < n) p[(size_t)i * n + c] = R[i * ldr + j];
    else if (c < n + m) beta[(size_t)i * m + (c - n)] = R[i * ldr + j];
  }
}

// One block per (tile, system s). u and v have unit column stride; their
// system and row strides are given, so slices of a packed [U | V] work.
__global__ void __launch_bounds__(kThreads)
uv_solve_kernel(const float* __restrict__ u, long long u_ss, long long u_rs,
                const float* __restrict__ v, long long v_ss, long long v_rs,
                float* __restrict__ p, float* __restrict__ beta, int n, int m, float ridge) {
  extern __shared__ float smem[];
  const int tc = kSolveTile, lda = n + 1, ldr = tc + 1;
  float* A = smem;
  float* R = A + n * lda;
  float* rowbuf = R + n * ldr;
  float* colbuf = rowbuf + n + tc;
  const int s = blockIdx.y, c0 = blockIdx.x * tc;
  const float* us = u + s * u_ss;
  const float* vs = v + s * v_ss;
  for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx % n;
    A[i * lda + j] = us[i * u_rs + j] + (i == j ? ridge : 0.0f);
  }
  for (int idx = threadIdx.x; idx < n * tc; idx += kThreads) {
    const int i = idx / tc, j = idx % tc, c = c0 + j;
    float val = 0.0f;
    if (c < n) val = (i == c) ? 1.0f : 0.0f;
    else if (c < n + m) val = vs[i * v_rs + (c - n)];
    R[i * ldr + j] = val;
  }
  __syncthreads();
  gj_sweep(A, R, rowbuf, colbuf, n, tc);
  store_tile(R, p + (size_t)s * n * n, beta + (size_t)s * n * m, n, m, c0, tc);
}

// One block per (tile, device d): sum the payloads of devices
// (d − hops .. d + hops) mod D in that order, then solve.
__global__ void __launch_bounds__(kThreads)
banded_solve_kernel(const float* __restrict__ w, float* __restrict__ p,
                    float* __restrict__ beta, int D, int n, int m, int hops, float ridge) {
  extern __shared__ float smem[];
  const int tc = kSolveTile, lda = n + 1, ldr = tc + 1, ldw = n + m;
  float* A = smem;
  float* R = A + n * lda;
  float* rowbuf = R + n * ldr;
  float* colbuf = rowbuf + n + tc;
  const int d = blockIdx.y, c0 = blockIdx.x * tc;
  const size_t per = (size_t)n * ldw;
  for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
    const int i = idx / n, j = idx % n;
    float acc = 0.0f;
    for (int o = -hops; o <= hops; ++o) acc += w[ring_src(d, o, D) * per + (size_t)i * ldw + j];
    A[i * lda + j] = acc + (i == j ? ridge : 0.0f);
  }
  for (int idx = threadIdx.x; idx < n * tc; idx += kThreads) {
    const int i = idx / tc, j = idx % tc, c = c0 + j;
    float val = 0.0f;
    if (c < n) {
      val = (i == c) ? 1.0f : 0.0f;
    } else if (c < n + m) {
      for (int o = -hops; o <= hops; ++o) val += w[ring_src(d, o, D) * per + (size_t)i * ldw + c];
    }
    R[i * ldr + j] = val;
  }
  __syncthreads();
  gj_sweep(A, R, rowbuf, colbuf, n, tc);
  store_tile(R, p + (size_t)d * n * n, beta + (size_t)d * n * m, n, m, c0, tc);
}

constexpr int kDenseBM = 128;  // rows of M (and of the output) per block
constexpr int kDenseBN = 128;  // payload columns per block
constexpr int kDenseBK = 16;   // devices k per shared-memory stage
constexpr int kDensePad = 4;   // Mᵀ tile row padding, as in the layout timed on the H100
constexpr int kTile = 32;      // transpose tile

// mt[k][i] = M[i][k], D × D, through a padded 32 × 32 shared tile so that
// both the reads and the writes are coalesced; block (32, 8).
__global__ void transpose_kernel(const float* __restrict__ M, float* __restrict__ mt, int D) {
  __shared__ float t[kTile][kTile + 1];
  const int i0 = blockIdx.y * kTile, k0 = blockIdx.x * kTile;
  const int c = threadIdx.x;
  for (int r = threadIdx.y; r < kTile; r += blockDim.y)
    if (i0 + r < D && k0 + c < D) t[r][c] = M[(size_t)(i0 + r) * D + k0 + c];
  __syncthreads();
  for (int r = threadIdx.y; r < kTile; r += blockDim.y)
    if (k0 + r < D && i0 + c < D) mt[(size_t)(k0 + r) * D + i0 + c] = t[c][r];
}

// Stage devices k0..k0+15 of Mᵀ's columns i0.. (ms[k][i] = M[i0 + i, k0 + k])
// and of x's columns j0.. (xs[k][j] = x[k0 + k, j0 + j]) by cp.async, with
// consecutive threads on consecutive addresses of both; what lies past D
// or F is zero. kVec: 16 bytes a copy (D and F multiples of 4, the arrays
// 16-byte aligned), else 4.
template <bool kVec>
__device__ __forceinline__ void dense_stage(float (*ms)[kDenseBM + kDensePad],
                                            float (*xs)[kDenseBN], const float* mt,
                                            const float* X, int k0, int i0, long long j0, int D,
                                            long long F) {
  constexpr int kW = kVec ? 4 : 1;  // floats a copy
  const int tid = threadIdx.x;
#pragma unroll
  for (int idx = tid; idx < kDenseBK * kDenseBM / kW; idx += kThreads) {
    const int k = idx / (kDenseBM / kW), i = idx % (kDenseBM / kW) * kW;
    const int gk = k0 + k, gi = i0 + i;
    const bool in = gk < D && gi < D;  // with kVec, D % 4 == 0: all four or none
    cp_async<4 * kW>(&ms[k][i], mt + (in ? (size_t)gk * D + gi : 0), in ? 4 * kW : 0);
  }
#pragma unroll
  for (int idx = tid; idx < kDenseBK * kDenseBN / kW; idx += kThreads) {
    const int k = idx / (kDenseBN / kW), j = idx % (kDenseBN / kW) * kW, gk = k0 + k;
    const long long gj = j0 + j;
    const bool in = gk < D && gj < F;  // with kVec, F % 4 == 0: all four or none
    cp_async<4 * kW>(&xs[k][j], X + (in ? (size_t)gk * F + gj : 0), in ? 4 * kW : 0);
  }
}

// out[i][j] += M[i][k]·x[k][j] for the 8 × 8 outputs of thread (tx, ty), one device k
__device__ __forceinline__ void dense_step(float (&acc)[8][8], const float* mk, const float* xk,
                                           int tx, int ty) {
  const float4 a0 = *reinterpret_cast<const float4*>(mk + ty * 4);
  const float4 a1 = *reinterpret_cast<const float4*>(mk + 64 + ty * 4);
  const float4 b0 = *reinterpret_cast<const float4*>(xk + tx * 4);
  const float4 b1 = *reinterpret_cast<const float4*>(xk + 64 + tx * 4);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
}

// One block per (128-row, 128-column) output tile, 1-D grid with the row
// tiles of a column tile adjacent, so that they run together and read
// their x tile once from device memory. M comes in as mt = Mᵀ
// (transpose_kernel), so both tiles are copied as they lie. Thread (tx, ty)
// owns rows 4·ty + {0..3, 64..67} and columns 4·tx + {0..3, 64..67}, a warp
// 4 × 8 threads: each device k costs four 16-byte shared loads for 64
// fused multiply-adds. Two stages: the next 16 devices are in flight while
// these are summed. Every output accumulates k = 0..D−1 in order from
// zero, one fmaf a step.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
dense_mix_kernel(const float* __restrict__ mt, const float* __restrict__ X,
                 float* __restrict__ out, int D, long long F, int row_tiles) {
  __shared__ __align__(16) float Ms[2][kDenseBK][kDenseBM + kDensePad];
  __shared__ __align__(16) float Xs[2][kDenseBK][kDenseBN];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tx = lane % 8 + 8 * (warp % 2), ty = lane / 8 + 4 * (warp / 2);
  const int i0 = (int)(blockIdx.x % row_tiles) * kDenseBM;
  const long long j0 = (long long)(blockIdx.x / row_tiles) * kDenseBN;
  const int steps = (D + kDenseBK - 1) / kDenseBK;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  dense_stage<kVec>(Ms[0], Xs[0], mt, X, 0, i0, j0, D, F);
  cp_async_commit();
  for (int u = 0; u < steps; ++u) {
    if (u + 1 < steps)
      dense_stage<kVec>(Ms[(u + 1) % 2], Xs[(u + 1) % 2], mt, X, (u + 1) * kDenseBK, i0, j0, D,
                        F);
    cp_async_commit();
    cp_async_wait<1>();  // all but the stage just issued have landed
    __syncthreads();
    const int kmax = min(kDenseBK, D - u * kDenseBK);
    if (kmax == kDenseBK) {  // no per-k test on a full stage
#pragma unroll
      for (int k = 0; k < kDenseBK; ++k) dense_step(acc, Ms[u % 2][k], Xs[u % 2][k], tx, ty);
    } else {
#pragma unroll
      for (int k = 0; k < kDenseBK; ++k)
        if (k < kmax) dense_step(acc, Ms[u % 2][k], Xs[u % 2][k], tx, ty);
    }
    __syncthreads();  // this stage is consumed before the next iteration refills it
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = i0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (gi >= D) continue;
    float* row = out + (size_t)gi * F;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long gj = j0 + h * 64 + tx * 4;
      if constexpr (kVec) {
        if (gj < F)
          *reinterpret_cast<float4*>(row + gj) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (gj + c < F) row[gj + c] = acc[i][4 * h + c];
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

int solve_smem(int n) { return (n * (n + 1) + n * (kSolveTile + 1) + 2 * n + kSolveTile) * 4; }

}  // namespace

extern "C" {

const char* repro_error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

int repro_solve_smem(int n) { return solve_smem(n); }
int repro_solve_tile() { return kSolveTile; }

// w (D, E) with E = Ñ·(Ñ+m), seg_start (C+1) int32, mask (D) → out (C, E).
int repro_masked_segment_sum(const float* w, const int* seg_start, const float* mask,
                             float* out, int C, long long E, void* stream) {
  if (C == 0 || E == 0) return cudaSuccess;
  const dim3 grid((unsigned)((E + kThreads - 1) / kThreads), C);
  segsum_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, seg_start, mask, out, E);
  return cudaGetLastError();
}

// w (D, E), seg_start (C+1) int32 → out (C, E): the unmasked cluster sums.
int repro_segment_sum(const float* w, const int* seg_start, float* out, int C, long long E,
                      void* stream) {
  if (C == 0 || E == 0) return cudaSuccess;
  const dim3 grid((unsigned)((E + kThreads - 1) / kThreads), C);
  segsum_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, seg_start, nullptr, out, E);
  return cudaGetLastError();
}

// sums (C, E), cids (D) int32 in [0, C) → out (D, E) with out[d] = sums[cids[d]].
int repro_segment_broadcast(const float* sums, const int* cids, float* out, int D, long long E,
                            void* stream) {
  if (D == 0 || E == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E % 4 == 0 && aligned16(sums) && aligned16(out)) {
    const long long e4 = E / 4;
    const dim3 grid((unsigned)((e4 + kThreads - 1) / kThreads), D);
    segment_broadcast_kernel_vec4<<<grid, kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(sums), cids, reinterpret_cast<float4*>(out), e4);
  } else {
    const dim3 grid((unsigned)((E + kThreads - 1) / kThreads), D);
    segment_broadcast_kernel<<<grid, kThreads, 0, st>>>(sums, cids, out, E);
  }
  return cudaGetLastError();
}

// x (D, E) contiguous, 2·hops+1 <= D → out (D, E), the circular ±hops sums.
int repro_banded_mix(const float* x, float* out, int D, long long E, int hops, void* stream) {
  if (D == 0 || E == 0) return cudaSuccess;
  const dim3 grid((unsigned)((E + kThreads - 1) / kThreads), D);
  banded_mix_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, D, E, hops);
  return cudaGetLastError();
}

// S systems: u (S,n,n) and v (S,n,m) with the given strides → p (S,n,n),
// beta (S,n,m), both contiguous.
int repro_uv_solve(const float* u, long long u_ss, long long u_rs, const float* v,
                   long long v_ss, long long v_rs, float* p, float* beta, int S, int n,
                   int m, float ridge, void* stream) {
  const int smem = solve_smem(n);
  cudaError_t e = cudaFuncSetAttribute(uv_solve_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + m + kSolveTile - 1) / kSolveTile, S);
  uv_solve_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u, u_ss, u_rs, v, v_ss, v_rs, p, beta, n, m, ridge);
  return cudaGetLastError();
}

// w (D, n, n+m) contiguous → p (D,n,n), beta (D,n,m).
int repro_banded_merge_solve(const float* w, float* p, float* beta, int D, int n, int m,
                             int hops, float ridge, void* stream) {
  const int smem = solve_smem(n);
  cudaError_t e = cudaFuncSetAttribute(banded_solve_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + m + kSolveTile - 1) / kSolveTile, D);
  banded_solve_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      w, p, beta, D, n, m, hops, ridge);
  return cudaGetLastError();
}

// M (D, D) and x (D, F) contiguous f32, mt (D, D) f32 scratch → out (D, F) = M @ x.
int repro_dense_mix(const float* M, float* mt, const float* X, float* out, int D, long long F,
                    void* stream) {
  if (D == 0 || F == 0) return cudaSuccess;
  const int row_tiles = (D + kDenseBM - 1) / kDenseBM;
  const long long blocks = (F + kDenseBN - 1) / kDenseBN * row_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int t = (D + kTile - 1) / kTile;
  transpose_kernel<<<dim3(t, t), dim3(kTile, 8), 0, st>>>(M, mt, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (D % 4 == 0 && F % 4 == 0 && aligned16(mt) && aligned16(X) && aligned16(out)) {
    dense_mix_kernel<true><<<(unsigned)blocks, kThreads, 0, st>>>(mt, X, out, D, F, row_tiles);
  } else {
    dense_mix_kernel<false><<<(unsigned)blocks, kThreads, 0, st>>>(mt, X, out, D, F, row_tiles);
  }
  return cudaGetLastError();
}

}  // extern "C"
