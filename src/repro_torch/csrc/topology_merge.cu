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
//     width and D = 256 (0.054 ms at 3.35 TB/s). A thread owns four adjacent
//     elements (16-byte loads and stores where the row length is a multiple
//     of 4 and both arrays are 16-byte aligned, else one element) and walks
//     a run of consecutive devices around the ring, keeping the 2·hops+1
//     neighbour values it sums in a rolling window: each step loads the one
//     payload that enters the band, so a payload is read (run + 2·hops)/run
//     times (about 1.1 at D = 256 and the har width, where 7 runs of 37
//     devices fill the card once at the 5 blocks an SM that the kernel's
//     48 registers a thread allow; the plan reads the occupancy from the
//     runtime). Bands up to ±kMixRegHops keep the window in registers (hops
//     a template parameter); a wider band keeps it in a shared-memory ring,
//     a thread's own slots, with fewer threads a block as it widens; a band
//     wider than one block's shared memory takes (hops > kMixMaxHops = 226)
//     is read straight from global memory, one thread an element and a
//     device, the band summed from zero in the same order.
//
// * from_uv_solve (pallas_call :411, _solve_kernel :371, _gj_sweep :356):
//     Gauss-Jordan without pivoting on [U+εI | I | V] per system, giving
//     P = (U+εI)⁻¹ and β = PV (U+εI is SPD, so no pivoting, as in the
//     reference). Bound: the n elimination steps are sequential, so at one
//     system (star, all_to_all: 27 MFLOP at the har width, 0.4 µs at 67
//     TFLOP/s) latency sets the time; at S = 256 (the stale runtime's
//     per-device solves, ~7 GFLOP) f32 operations do. The augmented system
//     at the har width is 128 × 817 × 4 B = 418 KB, more than one SM holds,
//     so uv_solve_cluster_kernel keeps one system in a cluster of blocks
//     and eliminates A once:
//       - in place: column k of A is spent after step k, and I's column k
//         is still e_k until then, so one slot holds A's column k up to step
//         k and I's column k after it (the owner puts e_k there when it
//         publishes A's column k). The system is n + m slots, 689 at the
//         har width, every slot live at every step;
//       - each block of the cluster owns a contiguous run of slots (loaded
//         and stored through shared memory as row segments), dealt to its
//         warps cyclically (slot j to warp j % 8), so the publishing moves
//         from warp to warp; lane l of a warp keeps rows l, l+32, ... of
//         each of its slots in registers for the whole elimination (Q rows
//         × at most 64/Q slots a thread);
//       - step k: the owner of slot k published that column (raw, with
//         its pivot at row k) into every block's shared memory through
//         distributed shared memory, double-buffered, so one cluster
//         barrier a step suffices. Each warp takes row k of its slots from
//         the lane that holds it, divides it by the pivot once a slot (IEEE
//         division, one lane a slot) and updates its registers,
//         w = __fmaf_rn(−(col − δ), row, w); the owner of slot k+1 updates
//         that slot first and publishes it before the rest of its work.
//     Per element the operations are the reference's and the plain
//     version's (row_k = w[k,:]/pivot, col = w[:,k] − δ, one fused
//     multiply-add, which the plain version also rounds once), so the two
//     agree bit for bit. The C entry sizes the cluster from S, n and m: 8 blocks while
//     the systems fit one wave (two blocks an SM), else the fewest that
//     hold a system; a system wider than 8 blocks' registers splits its V
//     columns across clusters, each eliminating A itself. Q ≤ 10 row
//     registers take Ñ ≤ 320 (past about Ñ = 362 A alone would not fit one
//     8-block cluster's registers).
//     Past Ñ = 320 (the wide solve) [A | V] stays in global memory, where L2
//     holds it (768 × 1 552 × 4 B = 4.8 MB a system at Ñ = 768, m = 784),
//     and the elimination is blocked into panels of kPanel = 32 pivots, two
//     launches a panel after one that loads the systems into P and β:
//       - uv_wide_panel_kernel: every block first eliminates the panel's
//         32 × 32 diagonal block in step order in one warp (a lane a slot),
//         which gives the panel's pivots, its row factors on the panel's
//         slots and its column values on the panel's rows. Then, each thread
//         on its own, the blocks of the column panel take one row each
//         through the 32 steps (the slot of step k published, replaced by
//         e_k and updated like the others), writing the row's final panel
//         values and its 32 column values −(w[i,k] − δ); the blocks of the
//         row panel take one slot outside the panel each through the same
//         steps on the panel's rows, writing its 32 row factors
//         w[k,j]/pivot_k;
//       - uv_wide_update_kernel: each 64 × 64 tile of [P | β] takes the
//         panel's 32 updates in step order, w = __fmaf_rn(−(col − δ), row,
//         w), from the column values and row factors in shared memory (the
//         panel's rows included: their column values carry the −δ); the
//         panel's own slots take the column panel's values.
//     Each element meets the same operations in the same order as in the
//     unblocked sweep, so this path too is the plain version's bit for bit.
//
// * banded_merge_solve (pallas_call :491, _banded_solve_kernel :425):
//     the open ring: device d solves the sum of the payloads of devices
//     (d − hops .. d + hops) mod D. As the Pallas kernel sums the
//     neighbour blocks in VMEM so that the merged (U, V) never touches
//     HBM, uv_solve_cluster_kernel's loader sums them into the cluster's
//     slots as it reads them (ring_src, in that order, onto the first; the
//     plain version's order), adds the ridge on A's diagonal and runs the
//     same elimination: A eliminated once a device, one cluster a device
//     (the port's first design eliminated A again in each of a device's 11
//     tiles of 64 right-hand-side columns, ~7.1 ms at D = 256). Bound: f32
//     operations, the 2·hops adds of every element of a band plus the
//     solve's least work (solve_flops in chip_smoke.py),
//     D·(2·hops·Ñ(Ñ+m) + Ñ³ + 2·Ñ²·m) = 5.33 GFLOP at D = 256, hops = 2 and
//     the har width, 0.0796 ms at 67 TFLOP/s; 90 MB of payloads read once
//     and 90 MB of (P, β) written (0.054 ms at 3.35 TB/s). The 2·hops
//     repeated reads of a neighbour come mostly from L2: neighbouring
//     devices' clusters run in the same wave.
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "device.cuh"
#include "ptx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

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

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}
template <typename V>
__device__ __forceinline__ V zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ float4 zero_of<float4>() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

constexpr int kMixRegHops = 4;  // bands up to ±4 keep their window in registers

// Thread e of a row of n values V (float4 or float) walks devices
// [blockIdx.y·run, +run) ∩ [0, D). HOPS ≥ 0: the band's window in registers;
// HOPS < 0: hops at run time, the window in this thread's slots of a
// shared-memory ring (slot k at ring[k·blockDim.x + threadIdx.x]).
template <int HOPS, typename V>
__global__ void __launch_bounds__(kThreads)
banded_mix_kernel(const V* __restrict__ x, V* __restrict__ out, int D, long long n, int hops,
                  int run) {
  extern __shared__ __align__(16) unsigned char mix_ring[];
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int d0 = blockIdx.y * run, d1 = min(d0 + run, D);
  const int h = HOPS >= 0 ? HOPS : hops;
  int src = ring_src(d0, h + 1, D);  // the device whose payload enters the band next
  if constexpr (HOPS >= 0) {
    constexpr int W = 2 * HOPS + 1;
    V win[W];  // x[(d + o) mod D] at o + HOPS, o = −HOPS..HOPS
#pragma unroll
    for (int o = -HOPS; o <= HOPS; ++o) win[o + HOPS] = x[(size_t)ring_src(d0, o, D) * n + e];
    for (int d = d0; d < d1; ++d) {
      V next = zero_of<V>();
      if (d + 1 < d1) next = x[(size_t)src * n + e];  // in flight while d is summed
      V acc = zero_of<V>();
#pragma unroll
      for (int k = 0; k < W; ++k) acc = add_rn(acc, win[k]);
      out[(size_t)d * n + e] = acc;
#pragma unroll
      for (int k = 0; k + 1 < W; ++k) win[k] = win[k + 1];
      win[W - 1] = next;
      if (++src == D) src = 0;
    }
  } else {
    const int W = 2 * h + 1, B = blockDim.x;
    V* ring = reinterpret_cast<V*>(mix_ring) + threadIdx.x;
    for (int o = -h; o <= h; ++o) ring[(o + h) * B] = x[(size_t)ring_src(d0, o, D) * n + e];
    int head = 0;  // the slot of x[(d − h) mod D]
    for (int d = d0; d < d1; ++d) {
      V next = zero_of<V>();
      if (d + 1 < d1) next = x[(size_t)src * n + e];
      V acc = zero_of<V>();
      for (int k = 0, at = head; k < W; ++k, at = at + 1 == W ? 0 : at + 1)
        acc = add_rn(acc, ring[at * B]);
      out[(size_t)d * n + e] = acc;
      ring[head * B] = next;  // x[d − h] leaves the band, x[d + 1 + h] enters
      if (++head == W) head = 0;
      if (++src == D) src = 0;
    }
  }
}

// The widest band the shared-memory ring takes: 2·hops+1 slots of 16 bytes
// for each of 32 threads.
constexpr int kMixMaxHops = (kMaxSmem / (32 * 16) - 1) / 2;

// A band past kMixMaxHops: thread e of device blockIdx.y reads its band
// straight from x, summed from zero for o = −hops..hops.
template <typename V>
__global__ void __launch_bounds__(kThreads)
banded_mix_wide_kernel(const V* __restrict__ x, V* __restrict__ out, int D, long long n,
                       int hops) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const int d = blockIdx.y;
  V acc = zero_of<V>();
  for (int o = -hops; o <= hops; ++o) acc = add_rn(acc, x[(size_t)ring_src(d, o, D) * n + e]);
  out[(size_t)d * n + e] = acc;
}

template <typename V>
cudaError_t launch_banded_mix(const V* x, V* out, int D, long long n, int hops, cudaStream_t st) {
  if (hops > kMixMaxHops) {
    banded_mix_wide_kernel<V><<<dim3((unsigned)((n + kThreads - 1) / kThreads), D), kThreads, 0,
                                 st>>>(x, out, D, n, hops);
    return cudaGetLastError();
  }
  auto kernel = hops > kMixRegHops ? banded_mix_kernel<-1, V>
              : hops == 0          ? banded_mix_kernel<0, V>
              : hops == 1          ? banded_mix_kernel<1, V>
              : hops == 2          ? banded_mix_kernel<2, V>
              : hops == 3          ? banded_mix_kernel<3, V>
                                   : banded_mix_kernel<4, V>;
  int threads = kThreads;
  size_t smem = 0;
  if (hops > kMixRegHops) {  // the ring: halve the block until 2·hops+1 slots a thread fit
    const size_t slots = 2 * (size_t)hops + 1;
    while (threads > 32 && slots * threads * sizeof(V) > (size_t)kMaxSmem) threads /= 2;
    smem = slots * threads * sizeof(V);
    if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  // runs of devices: as long as the grid still fills the card once, so
  // each payload is read as few times as that allows
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  const long long bx = (n + threads - 1) / threads;
  const long long fill = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  const long long most = fill / bx < D ? fill / bx : D;
  const int runs = most > 1 ? (int)most : 1;
  const int run = (D + runs - 1) / runs;
  kernel<<<dim3((unsigned)bx, (D + run - 1) / run), threads, smem, st>>>(x, out, D, n, hops, run);
  return cudaGetLastError();
}

constexpr int kSolveWarps = 8;
constexpr int kSolveThreads = kSolveWarps * 32;
constexpr int kSolveTileRegs = 64;  // floats of the system a thread keeps in registers
constexpr int kSolveMaxQ = 10;      // row registers a slot: Ñ ≤ 320
constexpr int kSolveMaxCluster = 8; // the portable cluster size

// Write one slot's raw column (rows lane + 32q < n) into buf of every
// block of the cluster.
template <int Q>
__device__ __forceinline__ void publish_column(const float (&col)[Q], float* buf, int n,
                                               cg::cluster_group& cluster, int lane) {
  const int cs = (int)cluster.num_blocks();
  for (int r = 0; r < cs; ++r) {
    float* dst = cluster.map_shared_rank(buf, r);
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if (lane + 32 * q < n) dst[lane + 32 * q] = col[q];
  }
}

// One system a cluster (grid (cluster size · groups, S)); group g of a
// system takes the A|I slots 0..n−1 and V columns [g·mg, (g+1)·mg), and
// block `rank` of the cluster the slots [rank·cb, (rank+1)·cb). Q = ⌈n/32⌉
// row registers a slot, at most CW slots a thread. u and v have unit
// column stride; their system and row strides are given, so slices of a
// packed [U | V] work. System s is the sum of the inputs of systems
// (s − hops .. s + hops) mod S, added in that order to the first of them
// (hops = 0: system s's own input, read as it is), then ridge on A's
// diagonal.
template <int Q, int CW>
__global__ void __launch_bounds__(kSolveThreads, 2)
uv_solve_cluster_kernel(const float* __restrict__ u, long long u_ss, long long u_rs,
                        const float* __restrict__ v, long long v_ss, long long v_rs,
                        float* __restrict__ p, float* __restrict__ beta, int n, int m, int mg,
                        int cb, float ridge, int hops) {
  static_assert(Q <= kSolveMaxQ && Q * CW <= kSolveTileRegs, "the tile must fit the registers");
  constexpr int kXW = (CW + 3) / 4 * 4;
  extern __shared__ __align__(16) float smem[];
  float* colbuf = smem;                   // [2][32·Q]: a published column, by row
  float* xs = colbuf + 2 * 32 * Q;        // [warps][kXW]: a warp's row k, then row k / pivot
  float* stage = xs + kSolveWarps * kXW;  // [n][ld]: this block's slots, loaded and stored
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = blockIdx.x / cs, sys = blockIdx.y, n_sys = gridDim.y;
  const int v0 = g * mg;
  const int nslot = n + min(mg, m - v0);
  const int j0 = rank * cb;
  const int cnt = max(0, min(cb, nslot - j0));              // this block's slots
  const int cntw = cnt > warp ? (cnt - warp + 7) / 8 : 0;  // this warp's: local slots warp + 8c
  const int ld = cb | 1;
  for (int i = warp; i < n; i += kSolveWarps)
    for (int j = lane; j < cnt; j += 32) {
      const int sl = j0 + j;
      const bool in_u = sl < n;
      const float* src = in_u ? u : v;
      const long long ss = in_u ? u_ss : v_ss;
      const long long at = in_u ? i * u_rs + sl : i * v_rs + v0 + (sl - n);
      float x = src[ring_src(sys, -hops, n_sys) * ss + at];
      for (int o = -hops + 1; o <= hops; ++o) x = __fadd_rn(x, src[ring_src(sys, o, n_sys) * ss + at]);
      stage[i * ld + j] = in_u ? x + (i == sl ? ridge : 0.0f) : x;
    }
  __syncthreads();
  float w[Q][CW];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int row = lane + 32 * q;
      w[q][c] = row < n && c < cntw ? stage[row * ld + warp + 8 * c] : 0.0f;
    }
  float* xw = xs + warp * kXW;

  cluster_arrive();  // every block of the cluster runs before any writes to its shared memory
  cluster_wait();
  if (rank == 0 && warp == 0 && cntw > 0) {  // slot 0: publish A's column 0, keep e_0
    float col[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      col[q] = w[q][0];
      w[q][0] = lane + 32 * q == 0 ? 1.0f : 0.0f;
    }
    publish_column<Q>(col, colbuf, n, cluster, lane);
  }
  int nrank = 0, nj = 0;  // the owner of slot k+1: block and local slot, kept without division
  if (++nj == cb) nj = 0, ++nrank;
  cluster_arrive();
#pragma unroll
  for (int q0 = 0; q0 < Q; ++q0) {
    const int kend = min(32, n - 32 * q0);
    for (int kl = 0; kl < kend; ++kl) {
      const int k = 32 * q0 + kl;
      const float* cur = colbuf + (k & 1) * 32 * Q;
      cluster_wait();  // column k is in cur; every block is done with the other buffer
      const float pivot = cur[k];
      float ncol[Q];  // −(w[:, k] − δ_k) at this lane's rows
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int row = lane + 32 * q;
        ncol[q] = row < n ? -__fsub_rn(cur[row], row == k ? 1.0f : 0.0f) : 0.0f;
      }
      if (lane == kl) {  // row k of this warp's slots lives in register q0 of lane kl
#pragma unroll
        for (int c = 0; c < kXW; c += 4)
          *reinterpret_cast<float4*>(xw + c) =
              make_float4(w[q0][min(c, CW - 1)], w[q0][min(c + 1, CW - 1)],
                          w[q0][min(c + 2, CW - 1)], w[q0][min(c + 3, CW - 1)]);
      }
      __syncwarp();
      for (int c = lane; c < cntw; c += 32) xw[c] = xw[c] / pivot;
      __syncwarp();
      const bool next_here = k + 1 < n && nrank == rank && (nj & 7) == warp;
      const int cn = nj >> 3;
      if (next_here) {  // slot k+1 first: update, publish, keep e_{k+1}
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          if (c != cn) continue;
          const float r = xw[c];
          float col[Q];
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            col[q] = __fmaf_rn(ncol[q], r, w[q][c]);
            w[q][c] = lane + 32 * q == k + 1 ? 1.0f : 0.0f;
          }
          publish_column<Q>(col, colbuf + ((k + 1) & 1) * 32 * Q, n, cluster, lane);
        }
      }
#pragma unroll
      for (int c4 = 0; c4 < kXW; c4 += 4) {
        if (c4 >= cntw) break;
        const float4 r4 = *reinterpret_cast<const float4*>(xw + c4);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c4 + e;
          if (c >= CW || c >= cntw || (next_here && c == cn)) continue;
#pragma unroll
          for (int q = 0; q < Q; ++q) w[q][c] = __fmaf_rn(ncol[q], rr[e], w[q][c]);
        }
      }
      if (++nj == cb) nj = 0, ++nrank;
      cluster_arrive();
    }
  }
  cluster_wait();

  // registers → shared memory → row segments of P (group 0) and β
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int row = lane + 32 * q;
      if (row < n && c < cntw) stage[row * ld + warp + 8 * c] = w[q][c];
    }
  __syncthreads();
  float* ps = p + (size_t)sys * n * n;
  float* bs = beta + (size_t)sys * n * m;
  for (int i = warp; i < n; i += kSolveWarps)
    for (int j = lane; j < cnt; j += 32) {
      const int sl = j0 + j;
      const float x = stage[i * ld + j];
      if (sl >= n) bs[(size_t)i * m + v0 + (sl - n)] = x;
      else if (g == 0) ps[(size_t)i * n + sl] = x;
    }
}

template <int Q, int CW>
cudaError_t launch_uv_solve(const float* u, long long u_ss, long long u_rs, const float* v,
                            long long v_ss, long long v_rs, float* p, float* beta, int S, int n,
                            int m, float ridge, int hops, cudaStream_t st) {
  const int cap = kSolveMaxCluster * kSolveWarps * CW;  // slots a cluster holds
  const int groups = n + m <= cap ? 1 : (m + (cap - n) - 1) / (cap - n);
  const int mg = (m + groups - 1) / groups;
  const int nslot = n + mg;
  int cs = 1;  // the fewest blocks that hold a system
  while (cs * kSolveWarps * CW < nslot) cs *= 2;
  if ((long long)S * groups * kSolveMaxCluster <= 2LL * sm_count()) cs = kSolveMaxCluster;
  const int cb = (nslot + cs - 1) / cs;
  const size_t smem = (2 * 32 * Q + kSolveWarps * ((CW + 3) / 4 * 4) + (size_t)n * (cb | 1)) * 4;
  return launch_clustered(uv_solve_cluster_kernel<Q, CW>, dim3(cs * groups, S), kSolveThreads,
                          smem, cs, st, u, u_ss, u_rs, v, v_ss, v_rs, p, beta, n, m, mg, cb,
                          ridge, hops);
}

constexpr int kPanel = 32;        // pivots a panel of the wide solve
constexpr int kPanelThreads = 128;  // rows or slots a block of the panel kernel
constexpr int kTileW = 64;        // rows and slots of an update tile

// Element (i, slot j) of the working system: A's slots in p (n × n), V's in
// beta (n × m).
template <typename F>
__device__ __forceinline__ F* wide_at(F* p, F* beta, int n, int m, int i, int j) {
  return j < n ? p + (size_t)i * n + j : beta + (size_t)i * m + (j - n);
}

// Load system `sys` (blockIdx.y) as uv_solve_cluster_kernel's loader does:
// the band's inputs summed in the plain version's order, the ridge on A's
// diagonal; A into p, V into beta.
__global__ void __launch_bounds__(kThreads)
uv_wide_load_kernel(const float* __restrict__ u, long long u_ss, long long u_rs,
                    const float* __restrict__ v, long long v_ss, long long v_rs,
                    float* __restrict__ p, float* __restrict__ beta, int n, int m, float ridge,
                    int hops) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int nm = n + m;
  if (e >= (long long)n * nm) return;
  const int sys = blockIdx.y, n_sys = gridDim.y;
  const int i = (int)(e / nm), sl = (int)(e - (long long)i * nm);
  const bool in_u = sl < n;
  const float* src = in_u ? u : v;
  const long long ss = in_u ? u_ss : v_ss;
  const long long at = in_u ? i * u_rs + sl : i * v_rs + (sl - n);
  float x = src[ring_src(sys, -hops, n_sys) * ss + at];
  for (int o = -hops + 1; o <= hops; ++o) x = __fadd_rn(x, src[ring_src(sys, o, n_sys) * ss + at]);
  *wide_at(p + (size_t)sys * n * n, beta + (size_t)sys * n * m, n, m, i, sl) =
      in_u ? x + (i == sl ? ridge : 0.0f) : x;
}

// The panel of pivots k0 .. k0 + kb − 1 (kb = min(32, n − k0)) of system
// blockIdx.y. Blocks [0, row_blocks) take the column panel, a row a thread;
// the rest the row panel, a slot outside the panel a thread. Writes, per
// system: nc (kPanel × n) the column values −(w[i,k] − δ_ik), pan (kPanel ×
// n) the panel slots' values after the panel, rf (kPanel × (n+m)) the row
// factors w[k,j]/pivot_k.
__global__ void __launch_bounds__(kPanelThreads)
uv_wide_panel_kernel(const float* __restrict__ p, const float* __restrict__ beta,
                     float* __restrict__ nc, float* __restrict__ pan, float* __restrict__ rf,
                     int n, int m, int k0, int row_blocks) {
  __shared__ float piv[kPanel];
  __shared__ float dnc[kPanel][kPanel];              // −(w[k0+r, k] − δ) of the diagonal block
  __shared__ float drf[kPanel][kPanel];              // row factors on the panel's slots
  __shared__ float tile[kPanelThreads][kPanel + 1];  // the column panel's rows, as loaded
  const int sys = blockIdx.y, nm = n + m, kb = min(kPanel, n - k0);
  const int tid = threadIdx.x, lane = tid % 32;
  const float* ps = p + (size_t)sys * n * n;
  const float* bs = beta + (size_t)sys * n * m;

  if (tid < 32) {  // the diagonal block, lane = slot k0 + lane, rows k0 .. k0 + 31
    float x[kPanel];
#pragma unroll
    for (int r = 0; r < kPanel; ++r)
      x[r] = r < kb && lane < kb ? ps[(size_t)(k0 + r) * n + k0 + lane] : 0.0f;
#pragma unroll
    for (int k = 0; k < kPanel; ++k) {
      if (k >= kb) break;
      if (lane == k) {  // publish slot k's column, then it holds e_k
#pragma unroll
        for (int r = 0; r < kPanel; ++r) dnc[k][r] = -(r == k ? __fsub_rn(x[r], 1.0f) : x[r]);
        piv[k] = x[k];
#pragma unroll
        for (int r = 0; r < kPanel; ++r) x[r] = r == k ? 1.0f : 0.0f;
      }
      __syncwarp();
      const float row = __fdiv_rn(x[k], piv[k]);
      drf[k][lane] = row;
#pragma unroll
      for (int r = 0; r < kPanel; ++r) x[r] = __fmaf_rn(dnc[k][r], row, x[r]);
      __syncwarp();
    }
  }

  float* ncs = nc + (size_t)sys * kPanel * n;
  if (blockIdx.x < row_blocks) {  // the column panel: row i through the panel's steps
    const int i0 = blockIdx.x * kPanelThreads;
    for (int idx = tid; idx < kPanelThreads * kPanel; idx += kPanelThreads) {
      const int r = idx / kPanel, j = idx % kPanel;
      tile[r][j] = i0 + r < n && j < kb ? ps[(size_t)(i0 + r) * n + k0 + j] : 0.0f;
    }
    __syncthreads();  // the tile, and the diagonal block's results
    const int i = i0 + tid;
    if (i >= n) return;
    float y[kPanel];
#pragma unroll
    for (int j = 0; j < kPanel; ++j) y[j] = tile[tid][j];
#pragma unroll
    for (int k = 0; k < kPanel; ++k) {
      if (k >= kb) break;
      const float c = -(i == k0 + k ? __fsub_rn(y[k], 1.0f) : y[k]);
      ncs[(size_t)k * n + i] = c;
      y[k] = i == k0 + k ? 1.0f : 0.0f;
#pragma unroll
      for (int j = 0; j < kPanel; ++j) y[j] = __fmaf_rn(c, drf[k][j], y[j]);
    }
    float* pans = pan + (size_t)sys * kPanel * n;
#pragma unroll
    for (int j = 0; j < kPanel; ++j)
      if (j < kb) pans[(size_t)j * n + i] = y[j];
  } else {  // the row panel: slot j (outside the panel) through the panel's rows
    __syncthreads();
    const int t = (blockIdx.x - row_blocks) * kPanelThreads + tid;
    if (t >= nm - kb) return;
    const int j = t < k0 ? t : t + kb;
    float y[kPanel];
#pragma unroll
    for (int r = 0; r < kPanel; ++r) y[r] = r < kb ? *wide_at(ps, bs, n, m, k0 + r, j) : 0.0f;
    float* rfs = rf + (size_t)sys * kPanel * nm;
#pragma unroll
    for (int k = 0; k < kPanel; ++k) {
      if (k >= kb) break;
      const float row = __fdiv_rn(y[k], piv[k]);
      rfs[(size_t)k * nm + j] = row;
#pragma unroll
      for (int r = k + 1; r < kPanel; ++r) y[r] = __fmaf_rn(dnc[k][r], row, y[r]);
    }
  }
}

// One 64 × 64 tile (blockIdx.x: row tile · col_tiles + slot tile) of system
// blockIdx.y after the panel at k0: every element outside the panel's slots
// takes the kb updates in step order; the panel's slots take pan. Thread
// (tx, ty) holds rows 4·ty .. 4·ty + 3 and slots tx + 16·c of the tile.
__global__ void __launch_bounds__(kThreads)
uv_wide_update_kernel(float* __restrict__ p, float* __restrict__ beta,
                      const float* __restrict__ nc, const float* __restrict__ pan,
                      const float* __restrict__ rf, int n, int m, int k0, int col_tiles) {
  __shared__ __align__(16) float snc[kPanel][kTileW];  // [k][row]
  __shared__ float srf[kPanel][kTileW];                // [k][slot]
  const int sys = blockIdx.y, nm = n + m, kb = min(kPanel, n - k0);
  const int i0 = (blockIdx.x / col_tiles) * kTileW, j0 = (blockIdx.x % col_tiles) * kTileW;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* ncs = nc + (size_t)sys * kPanel * n;
  const float* rfs = rf + (size_t)sys * kPanel * nm;
  for (int idx = tid; idx < kPanel * kTileW; idx += kThreads) {
    const int k = idx / kTileW, c = idx % kTileW;
    snc[k][c] = k < kb && i0 + c < n ? ncs[(size_t)k * n + i0 + c] : 0.0f;
    srf[k][c] = k < kb && j0 + c < nm ? rfs[(size_t)k * nm + j0 + c] : 0.0f;
  }
  __syncthreads();
  float* ps = p + (size_t)sys * n * n;
  float* bs = beta + (size_t)sys * n * m;
  float w[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + 4 * ty + r, j = j0 + tx + 16 * c;
      w[r][c] = i < n && j < nm ? *wide_at(ps, bs, n, m, i, j) : 0.0f;
    }
#pragma unroll 8
  for (int k = 0; k < kb; ++k) {
    const float4 c4 = *reinterpret_cast<const float4*>(&snc[k][4 * ty]);
    const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
    float rv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) rv[c] = srf[k][tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) w[r][c] = __fmaf_rn(cv[r], rv[c], w[r][c]);
  }
  const float* pans = pan + (size_t)sys * kPanel * n;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + 4 * ty + r, j = j0 + tx + 16 * c;
      if (i >= n || j >= nm) continue;
      const bool in_panel = j >= k0 && j < k0 + kb;
      *wide_at(ps, bs, n, m, i, j) = in_panel ? pans[(size_t)(j - k0) * n + i] : w[r][c];
    }
}

// Workspace floats of the wide solve for S systems (0 where the cluster
// solve takes them): the column values, the panel's values and the row
// factors of one panel.
long long uv_wide_ws(int S, int n, int m) {
  return n <= 32 * kSolveMaxQ ? 0 : (long long)S * kPanel * (2LL * n + n + m);
}

cudaError_t launch_uv_wide(const float* u, long long u_ss, long long u_rs, const float* v,
                           long long v_ss, long long v_rs, float* p, float* beta, int S, int n,
                           int m, float ridge, int hops, float* ws, cudaStream_t st) {
  const int nm = n + m;
  float* nc = ws;
  float* pan = nc + (size_t)S * kPanel * n;
  float* rf = pan + (size_t)S * kPanel * n;
  uv_wide_load_kernel<<<dim3((unsigned)(((long long)n * nm + kThreads - 1) / kThreads), S),
                        kThreads, 0, st>>>(u, u_ss, u_rs, v, v_ss, v_rs, p, beta, n, m, ridge,
                                           hops);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int row_blocks = (n + kPanelThreads - 1) / kPanelThreads;
  const int row_tiles = (n + kTileW - 1) / kTileW, col_tiles = (nm + kTileW - 1) / kTileW;
  for (int k0 = 0; k0 < n; k0 += kPanel) {
    const int kb = n - k0 < kPanel ? n - k0 : kPanel;
    const int col_blocks = (nm - kb + kPanelThreads - 1) / kPanelThreads;
    uv_wide_panel_kernel<<<dim3(row_blocks + col_blocks, S), kPanelThreads, 0, st>>>(
        p, beta, nc, pan, rf, n, m, k0, row_blocks);
    uv_wide_update_kernel<<<dim3(row_tiles * col_tiles, S), kThreads, 0, st>>>(
        p, beta, nc, pan, rf, n, m, k0, col_tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
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

// Row registers a slot, rounded up to one of six tiles (rows past n are
// zeros and are never stored). A thread keeps ⌊64/Q⌋ slots, so a cluster of
// 8 blocks holds 512 at Q = 8 (Ñ ≤ 256: 3 clusters split V at m = 561) and
// 384 at Q = 10 (Ñ ≤ 320: 9 clusters, each eliminating A again). Past
// Ñ = 320 the wide solve, in the workspace ws (uv_wide_ws floats).
cudaError_t uv_solve(const float* u, long long u_ss, long long u_rs, const float* v,
                     long long v_ss, long long v_rs, float* p, float* beta, int S, int n, int m,
                     float ridge, int hops, float* ws, cudaStream_t st) {
  if (S == 0 || n == 0) return cudaSuccess;
  if (uv_wide_ws(S, n, m) > 0)
    return ws == nullptr ? cudaErrorInvalidValue
                         : launch_uv_wide(u, u_ss, u_rs, v, v_ss, v_rs, p, beta, S, n, m, ridge,
                                          hops, ws, st);
  const int q = (n + 31) / 32;
  switch (q <= 2 ? q : q <= 4 ? 4 : q <= 7 ? 7 : q <= 8 ? 8 : q <= 10 ? 10 : 0) {
    case 1:
      return launch_uv_solve<1, 64>(u, u_ss, u_rs, v, v_ss, v_rs, p, beta, S, n, m, ridge, hops,
                                    st);
    case 2:
      return launch_uv_solve<2, 32>(u, u_ss, u_rs, v, v_ss, v_rs, p, beta, S, n, m, ridge, hops,
                                    st);
    case 4:
      return launch_uv_solve<4, 16>(u, u_ss, u_rs, v, v_ss, v_rs, p, beta, S, n, m, ridge, hops,
                                    st);
    case 7:
      return launch_uv_solve<7, 9>(u, u_ss, u_rs, v, v_ss, v_rs, p, beta, S, n, m, ridge, hops,
                                   st);
    case 8:
      return launch_uv_solve<8, 8>(u, u_ss, u_rs, v, v_ss, v_rs, p, beta, S, n, m, ridge, hops,
                                   st);
    case 10:
      return launch_uv_solve<10, 6>(u, u_ss, u_rs, v, v_ss, v_rs, p, beta, S, n, m, ridge, hops,
                                    st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// Workspace floats repro_uv_solve and repro_banded_merge_solve need for S
// systems of n rows and m right-hand sides (0 where none).
long long repro_uv_solve_ws(int S, int n, int m) { return uv_wide_ws(S, n, m); }

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

// x (D, E) contiguous, 0 ≤ hops, 2·hops+1 <= D → out (D, E), the circular
// ±hops sums.
int repro_banded_mix(const float* x, float* out, int D, long long E, int hops, void* stream) {
  if (D == 0 || E == 0) return cudaSuccess;
  if (hops < 0 || 2 * hops + 1 > D) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (E % 4 == 0 && aligned16(x) && aligned16(out))
    return launch_banded_mix(reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out),
                             D, E / 4, hops, st);
  return launch_banded_mix(x, out, D, E, hops, st);
}

// S systems: u (S,n,n) and v (S,n,m) with the given strides → p (S,n,n),
// beta (S,n,m), both contiguous; ws repro_uv_solve_ws(S, n, m) floats (or
// null when that is 0).
int repro_uv_solve(const float* u, long long u_ss, long long u_rs, const float* v,
                   long long v_ss, long long v_rs, float* p, float* beta, int S, int n,
                   int m, float ridge, float* ws, void* stream) {
  return uv_solve(u, u_ss, u_rs, v, v_ss, v_rs, p, beta, S, n, m, ridge, 0, ws,
                  static_cast<cudaStream_t>(stream));
}

// w (D, n, n+m) contiguous, 2·hops+1 ≤ D, ws repro_uv_solve_ws(D, n, m)
// floats → p (D,n,n), beta (D,n,m): the solve of each device's ±hops band
// sum.
int repro_banded_merge_solve(const float* w, float* p, float* beta, int D, int n, int m,
                             int hops, float ridge, float* ws, void* stream) {
  const long long per = (long long)n * (n + m);
  return uv_solve(w, per, n + m, w + n, per, n + m, p, beta, D, n, m, ridge, hops, ws,
                  static_cast<cudaStream_t>(stream));
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
