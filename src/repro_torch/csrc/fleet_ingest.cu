// Fused fleet-tick ingest for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fleet_ingest.py::fleet_ingest_kernel
// (pallas_call at :284, inner kernel _ingest_kernel at :143). Per device d
// and a window of T samples:
//   H      = G(x·α + b)                                  (T, Ñ)
//   loss_d = mean((targets − H·β₀)²)   the pre-train drift score
//   then T sequential k=1 RLS steps with forgetting λ:
//     Pf = P/λ;  ph = Pf·h;  denom = 1 + h·ph;  P = Pf − ph·phᵀ/denom
//     gain = P·h;  err = t − h·β;  β = β + gain·errᵀ
//
// What bounds it on an H100: at the har width (D=256, T=32, n=m=561, Ñ=128)
// the work is about 5.5 GFLOP of f32 against 199 MB of traffic, so it is
// f32-compute bound (0.08 ms at 67 TFLOP/s). The TPU kernel keeps one
// device's P and β resident across the window; here one device's β
// (Ñ·m·4 = 287 KB) does not fit in one SM. Two facts of the recursion
// shape the design: the P/gain chain never reads β, and every column of β
// evolves on its own from the same gains. With err_t = t_t − h_t·β_{t−1}
// unrolled, the window's errors are E = (I + L)⁻¹·E₀, where
// E₀ = targets − H·β₀ are the pre-train errors and L[t, s] = h_t·gain_s for
// s < t (zero elsewhere); then β_T = β₀ + Σ_s gain_s·e_sᵀ. So the sequential
// rank-1 updates become products, and the tick runs as four launches on one
// stream:
//   1. the hidden projection — H for the whole window, the f32 GEMM of
//      gemm.cuh with the bias and activation in its epilogue;
//   2. ingest_gain_kernel  — one block per device runs the P chain with P
//      in registers (a 16 × 4 micro-tile a thread at Ñ = 128: rows w + 8i,
//      columns lane + 32j), each element divided by λ once a step; the
//      matvecs reduce across lanes by a halving shuffle (16 shuffles for 16
//      rows), and ph and the warps' h·ph partials meet in shared memory
//      behind one block barrier a sample (double-buffered). It writes the
//      gains. For 128 < Ñ ≤ 320 one block cannot hold P (410 KB at Ñ = 320):
//      a cluster of 8 blocks a device splits P's rows (at most 40 a block,
//      a 5 × 10 micro-tile a thread, still in registers), each block writes
//      its rows' ph and its warps' partials into every block's shared
//      memory (distributed shared memory), and one cluster barrier a sample
//      takes the block barrier's place;
//   3. ingest_beta_kernel  — one block per (device, run of 64-column tiles
//      of β), as many runs as fill the card (one a device at D = 256, 9
//      tiles): the chunk's Hᵀ and gains arrive in shared memory by cp.async
//      and L = H·Gᵀ of the chunk is computed once for the run; each tile is
//      read once and written once, the next one arriving while this one is
//      worked on. E₀ on the tile is an outer-product SIMT product (4 rows ×
//      4 columns a thread, k split between the block's halves and the two
//      sums added), and its squares are the loss's partials, summed in a
//      fixed order; E = (I + L)⁻¹E₀ is substituted in registers, eight
//      threads a pair of columns, with no block barrier; then β += Σ_s
//      gain_s e_sᵀ, one fused multiply-add per sample in sample order, and
//      each thread stores its rows from registers. A window longer
//      than a chunk (64 samples, 32 where Ñ > 240 and 64 samples' H, gains
//      and L no longer fit in shared memory: ingest_chunk) is taken in
//      chunks: the β of one chunk is β₀ of the next, and the loss stays the
//      pre-train error under the tick-start β;
//   4. ingest_loss_kernel  — sums each device's partials, one a run of
//      tiles, in a fixed order (no atomics), so the drift score is
//      reproducible.
// Past Ñ = 320 (kMaxN) P no longer fits one 8-block cluster's registers
// (2.36 MB a device at Ñ = 768) and a tile of β no longer fits one block's
// shared memory beside a chunk (196 KB for 64 columns at Ñ = 768), so steps
// 2 and 3 take their wide kernels:
//   2. ingest_gain_wide_kernel — P stays in global memory (p_out), where
//      L2 holds it (38 MB for 16 devices at Ñ = 768); a cluster of 8 blocks
//      a device splits its rows, a warp a row at a time, and each sample
//      reads and writes each row once: the row's update by the last sample's
//      ph, its gain, and its part of the next sample's ph, which goes into
//      every block's shared memory with the warps' h·ph partials (one
//      cluster barrier a sample);
//   3. ingest_beta_wide_kernel — one block per (64-column tile, device)
//      streams the tile from global memory in runs of 32 rows (cp.async, two
//      stages), twice a chunk of 32 samples: first E₀ (and, past the first
//      chunk, the errors under the tick-start β for the loss) and L, then,
//      after the same substitution, β += Σ_s gain_s e_sᵀ in sample order.
// The P chain's arithmetic is the reference's; the β update follows the
// order above, which the plain PyTorch version
// (repro_torch.kernels.fleet_ingest) repeats: E₀, L, the substitution,
// then the ordered fused multiply-adds. No padding of the inputs: every
// loop masks its ragged edge.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "device.cuh"
#include "gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBetaTile = 64;   // columns of β per block, two a lane
constexpr int kMaxChunk = 64;   // samples of a chunk: H, the gains and L stay in shared memory
constexpr int kWideChunk = 32;  // the chunk where 64 samples' H, gains and L do not fit
constexpr int kGainCluster = 8; // blocks a device's P chain takes past Ñ = 128
constexpr int kMaxN = 320;      // 8 blocks of 40 rows in registers; past it the wide kernels
constexpr int kUpdateRows = 16; // rows of the β tile a thread updates at a time
constexpr int kWideThreads = 512;  // threads of a wide P-chain block
constexpr int kWideRows = 32;      // rows of β a wide β block stages at a time
constexpr int kWideRun = 16;       // elements of a row a lane loads before it stores any

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Sum each of H row partials over the warp's 32 lanes: at each xor offset a
// lane keeps one half of its values and adds its partner's copy of that
// half; after log2(R) halvings the offsets left sum whole values. Lane l
// ends with the full sum of row (l·R) >> 5 (every holder of a row has the
// same bits), in a fixed order.
template <int H, int OFF, int R>
__device__ __forceinline__ void halve_rows(float (&v)[R], int lane) {
  if constexpr (OFF >= 1) {
    if constexpr (H > 1) {
      constexpr int half = H / 2;
      const bool upper = lane & OFF;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = upper ? v[i] : v[i + half];
        const float keep = upper ? v[i + half] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      halve_rows<half, OFF / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      halve_rows<1, OFF / 2>(v, lane);
    }
  }
}

__host__ __device__ constexpr int pow2_at_least(int x) {
  return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2);
}

// One block per device (CS = 1), or a cluster of CS blocks per device, block
// `rank` holding rows [rank·rb, min((rank+1)·rb, Ñ)) of P: the P chain over
// the window, writing gain_t = P_t·h_t for every step. A thread keeps an
// RI × CJ micro-tile of its block's rows in registers (rows warp + 8i,
// columns lane + 32j); entries past Ñ stay 0.
template <int RI, int CJ, int CS>
__global__ void __launch_bounds__(kThreads, 2)
ingest_gain_kernel(const float* __restrict__ h_all, const float* __restrict__ p_in,
                   float* __restrict__ p_out, float* __restrict__ gains, int T, int N,
                   float forget) {
  constexpr int RP = pow2_at_least(RI);  // the halving shuffle's rows, RI padded with zeros
  constexpr int RED = CS * kWarps;       // h·ph partials a step: every warp of the cluster
  extern __shared__ __align__(16) float smem[];
  float* hbuf = smem;             // [2][N]: h_t, and h_{t+1} loaded a step ahead
  float* phbuf = hbuf + 2 * N;    // [2][N]: ph of the step, every block's rows
  float* red = phbuf + 2 * N;     // [2][RED]: the warps' h·ph partials, by block and warp
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int rank = 0;
  if constexpr (CS > 1) {
    cluster_arrive();  // every block runs before any writes to its shared memory
    rank = (int)cg::this_cluster().block_rank();
  }
  const int d = blockIdx.x / CS;
  const int rb = (N + CS - 1) / CS, row0 = rank * rb;
  const int nrow = max(0, min(rb, N - row0));  // this block's rows of P
  const float* pin = p_in + (size_t)d * N * N;
  float P[RI][CJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int r = warp + 8 * i, c = lane + 32 * j;
      P[i][j] = r < nrow && c < N ? pin[(size_t)(row0 + r) * N + c] : 0.0f;
    }
  for (int k = tid; k < N; k += kThreads) hbuf[k] = h_all[(size_t)d * T * N + k];
  __syncthreads();  // h_0 is in place (the cluster's arrive came before it was)
  if constexpr (CS > 1) cluster_wait();

  const int ri = (lane * RP) >> 5;  // the row whose sums this lane holds after halve_rows
  const int rloc = warp + 8 * ri, rrow = row0 + rloc;
  const bool writer = (lane & (32 / RP - 1)) == 0 && ri < RI && rloc < nrow;
  const bool scale = forget != 1.0f;  // x / 1 is x: skip the division when λ = 1
  for (int t = 0; t < T; ++t) {
    const int b = t & 1;
    const float* hv = hbuf + b * N;
    float hc[CJ];
#pragma unroll
    for (int j = 0; j < CJ; ++j) hc[j] = lane + 32 * j < N ? hv[lane + 32 * j] : 0.0f;
    // Pf = P/λ, kept; ph = Pf·h
    float acc[RP];
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      float s = 0.0f;
      if (i < RI) {
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          if (scale) P[i][j] = P[i][j] / forget;
          s = __fmaf_rn(P[i][j], hc[j], s);
        }
      }
      acc[i] = s;
    }
    halve_rows<RP, 16>(acc, lane);
    const float dot = warp_sum(writer ? __fmul_rn(hv[rrow], acc[0]) : 0.0f);
    if constexpr (CS > 1) {  // into every block of the cluster
      cg::cluster_group cluster = cg::this_cluster();
      for (int k = 0; k < CS; ++k) {
        if (writer) cluster.map_shared_rank(phbuf, k)[b * N + rrow] = acc[0];
        if (lane == 0) cluster.map_shared_rank(red, k)[b * RED + rank * kWarps + warp] = dot;
      }
    } else {
      if (writer) phbuf[b * N + rrow] = acc[0];
      if (lane == 0) red[b * RED + warp] = dot;
    }
    if (t + 1 < T)
      for (int k = tid; k < N; k += kThreads)
        hbuf[(b ^ 1) * N + k] = h_all[((size_t)d * T + t + 1) * N + k];
    if constexpr (CS > 1) {
      cluster_arrive();
      cluster_wait();
    } else {
      __syncthreads();
    }
    float hph = 0.0f;
#pragma unroll
    for (int w = 0; w < RED; ++w) hph += red[b * RED + w];
    const float denom = 1.0f + hph;
    float phc[CJ];
#pragma unroll
    for (int j = 0; j < CJ; ++j) phc[j] = lane + 32 * j < N ? phbuf[b * N + lane + 32 * j] : 0.0f;
    // P = Pf − ph·phᵀ/denom, and gain = P·h from the new P
#pragma unroll
    for (int i = 0; i < RP; ++i) {
      float s = 0.0f;
      if (i < RI) {
        const int r = warp + 8 * i;
        const float phr = r < nrow ? phbuf[b * N + row0 + r] : 0.0f;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          P[i][j] = __fsub_rn(P[i][j], __fmul_rn(phr, phc[j]) / denom);
          s = __fmaf_rn(P[i][j], hc[j], s);
        }
      }
      acc[i] = s;
    }
    halve_rows<RP, 16>(acc, lane);
    if (writer) gains[((size_t)d * T + t) * N + rrow] = acc[0];
  }
  float* pout = p_out + (size_t)d * N * N;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int r = warp + 8 * i, c = lane + 32 * j;
      if (r < nrow && c < N) pout[(size_t)(row0 + r) * N + c] = P[i][j];
    }
}

// The P chain past kMaxN: a cluster of kGainCluster blocks a device, block
// `rank` owning rows [rank·rb, min((rank+1)·rb, N)) of P, which stays in
// p_out (read from p_in at the first sample); warp w takes rows w, w + W, ...
// of them, a lane every 32nd column. Sample t reads each row once: P/λ, the
// update by ph_t and denom_t (both from the step before), the row's gain_t
// and its part of ph_{t+1} = (P_t/λ)·h_{t+1}, which goes into every block's
// shared memory with the warps' h·ph partials; one cluster barrier a sample.
// The arithmetic is ingest_gain_kernel's, each matvec summed in lane order
// then by a xor-butterfly.
__global__ void __launch_bounds__(kWideThreads, 1)
ingest_gain_wide_kernel(const float* __restrict__ h_all, const float* __restrict__ p_in,
                        float* __restrict__ p_out, float* __restrict__ gains, int T, int N,
                        float forget) {
  constexpr int CS = kGainCluster, W = kWideThreads / 32, RED = CS * W;
  extern __shared__ __align__(16) float smem[];
  float* phbuf = smem;          // [2][N]: ph of the step, every block's rows
  float* red = phbuf + 2 * N;   // [2][RED]: the warps' h·ph partials, by block and warp
  cluster_arrive();             // every block runs before any writes to its shared memory
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int d = blockIdx.x / CS;
  const int rb = (N + CS - 1) / CS, row0 = rank * rb;
  const int nrow = max(0, min(rb, N - row0));
  const float* hd = h_all + (size_t)d * T * N;
  const float* pin = p_in + (size_t)d * N * N;
  float* pout = p_out + (size_t)d * N * N;
  float* gd = gains + (size_t)d * T * N;
  const bool scale = forget != 1.0f;
  if (T == 0) {  // nothing to train on: P as it came
    for (int r = warp; r < nrow; r += W)
      for (int j = lane; j < N; j += 32) pout[(size_t)(row0 + r) * N + j] = pin[(size_t)(row0 + r) * N + j];
    cluster_wait();
    return;
  }
  cluster_wait();

  // ph_0 = (P_0/λ)·h_0 of this block's rows and the warps' h_0·ph_0
  float dot = 0.0f;
  for (int r = warp; r < nrow; r += W) {
    const int i = row0 + r;
    const float* row = pin + (size_t)i * N;
    float s = 0.0f;
    for (int j = lane; j < N; j += 32) {
      float x = row[j];
      if (scale) x = x / forget;
      s = __fmaf_rn(x, __ldg(hd + j), s);
    }
    s = warp_sum(s);
    if (lane < CS) cluster.map_shared_rank(phbuf, lane)[i] = s;
    dot = __fadd_rn(dot, __fmul_rn(__ldg(hd + i), s));
  }
  if (lane < CS) cluster.map_shared_rank(red, lane)[rank * W + warp] = dot;
  cluster_arrive();
  cluster_wait();

  for (int t = 0; t < T; ++t) {
    const int b = t & 1;
    const bool more = t + 1 < T;
    const float* ph = phbuf + b * N;
    const float* ht = hd + (size_t)t * N;
    const float* hn = more ? ht + N : ht;
    float hph = 0.0f;
#pragma unroll 8
    for (int w = 0; w < RED; ++w) hph += red[b * RED + w];
    const float denom = 1.0f + hph;
    const float* cur = t == 0 ? pin : pout;
    float dotn = 0.0f;
    for (int r = warp; r < nrow; r += W) {
      const int i = row0 + r;
      const float* row = cur + (size_t)i * N;
      float* orow = pout + (size_t)i * N;
      const float phi = ph[i];
      float g = 0.0f, q = 0.0f;
      // the row is read and written in place: a run of kWideRun of a lane's
      // elements is loaded before any of them is stored, so each run waits
      // on memory once
      for (int j0 = lane; j0 < N; j0 += 32 * kWideRun) {
        float x[kWideRun];
#pragma unroll
        for (int k = 0; k < kWideRun; ++k) {
          const int j = j0 + 32 * k;
          x[k] = j < N ? row[j] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kWideRun; ++k) {
          const int j = j0 + 32 * k;
          if (j >= N) break;
          const float xs = scale ? x[k] / forget : x[k];
          const float pn = __fsub_rn(xs, __fmul_rn(phi, ph[j]) / denom);
          orow[j] = pn;
          g = __fmaf_rn(pn, __ldg(ht + j), g);
          q = __fmaf_rn(scale ? pn / forget : pn, __ldg(hn + j), q);
        }
      }
      g = warp_sum(g);
      if (lane == 0) gd[(size_t)t * N + i] = g;
      if (more) {
        q = warp_sum(q);
        if (lane < CS) cluster.map_shared_rank(phbuf, lane)[(b ^ 1) * N + i] = q;
        dotn = __fadd_rn(dotn, __fmul_rn(__ldg(hn + i), q));
      }
    }
    if (more) {
      if (lane < CS) cluster.map_shared_rank(red, lane)[(b ^ 1) * RED + rank * W + warp] = dotn;
      cluster_arrive();
      cluster_wait();
    }
  }
}

// Start copying rows [0, tcn) of a (·, N) array into dst (tcn rows of
// stride ld ≥ n16, zero from N to n16) by cp.async: 16 bytes a copy when
// N % 4 == 0, else 4.
__device__ __forceinline__ void load_rows_async(float* dst, const float* src, int tcn, int N,
                                                int n16, int ld) {
  const int lane = threadIdx.x % 32;
  for (int t = threadIdx.x / 32; t < tcn; t += kWarps) {
    const float* row = src + (size_t)t * N;
    if (N % 4 == 0) {
      for (int k = 4 * lane; k < n16; k += 128)
        cp_async<16>(dst + t * ld + k, row + (k < N ? k : 0), k < N ? 16 : 0);
    } else {
      for (int k = lane; k < n16; k += 32)
        cp_async<4>(dst + t * ld + k, row + (k < N ? k : 0), k < N ? 4 : 0);
    }
  }
}

// Start copying rows [0, tcn) of a (·, N) array transposed into dst
// (n16 rows of stride ld, dst[k][t]; zero from N to n16 and from tcn to
// TC) by 4-byte cp.async.
__device__ __forceinline__ void load_rows_t_async(float* dst, const float* src, int tcn, int TC,
                                                  int N, int n16, int ld) {
  for (int t = threadIdx.x / 32; t < TC; t += kWarps)
    for (int k = threadIdx.x % 32; k < n16; k += 32) {
      const bool in = t < tcn && k < N;
      cp_async<4>(dst + k * ld + t, src + (in ? (size_t)t * N + k : 0), in ? 4 : 0);
    }
}

// The chunk's E₀ = targets − H·B on the tile, into es (row stride lde),
// with the squares of its entries added to sq. Each half of the block sums
// half of k (warps 0–3 k < n16/2, warps 4–7 the rest), in k order, one fused
// multiply-add each, for rows RW·rg + i (rg = lane % 8) and columns 4·cg..
// 4·cg + 3 (cg = 4·(warp % 4) + lane / 8): each k is an outer product of RW
// values of Hᵀ[k] and four of B[k], so a warp reads 128 distinct bytes of
// each a step. The upper half's sums go through es; the lower half adds
// them (lower + upper), subtracts the sum from the target and writes E₀.
template <int RW>
__device__ __forceinline__ void chunk_errors(float* es, int lde, float& sq, const float* ht,
                                             int ldh, const float* bs, const float* tgt,
                                             int tcn, int n16, int M, int ncol) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int rg = lane % 8, cg = 4 * (warp % 4) + lane / 8, half = warp / 4;
  const int k0 = half * (n16 / 2), k1 = k0 + n16 / 2;
  float acc[RW][4], y[RW][4];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int t = RW * rg + i;
      acc[i][c] = 0.0f;
      // in flight during the product
      y[i][c] = half == 0 && t < tcn && 4 * cg + c < ncol ? tgt[(size_t)t * M + 4 * cg + c] : 0.0f;
    }
  const float* hl = ht + RW * rg;
  const float* bl = bs + 4 * cg;
#pragma unroll 2
  for (int k = k0; k < k1; ++k) {
    const float4 b4 = *reinterpret_cast<const float4*>(bl + k * kBetaTile);
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
    float h[RW];
    if constexpr (RW % 4 == 0) {
#pragma unroll
      for (int i = 0; i < RW; i += 4) {
        const float4 h4 = *reinterpret_cast<const float4*>(hl + k * ldh + i);
        h[i] = h4.x, h[i + 1] = h4.y, h[i + 2] = h4.z, h[i + 3] = h4.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < RW; ++i) h[i] = hl[k * ldh + i];
    }
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = __fmaf_rn(h[i], b[c], acc[i][c]);
  }
  if (half == 1)
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) es[(RW * rg + i) * lde + 4 * cg + c] = acc[i][c];
  __syncthreads();
  if (half == 0)
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int t = RW * rg + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* out = es + t * lde + 4 * cg + c;
        const bool in = t < tcn && 4 * cg + c < ncol;
        const float e = in ? __fsub_rn(y[i][c], __fadd_rn(acc[i][c], *out)) : 0.0f;
        sq = __fmaf_rn(e, e, sq);
        *out = e;
      }
    }
}

// E = (I + L)⁻¹E₀ in place in es (TC rows of stride LDE, 64 columns), L in
// ls (stride LDL), in registers: eight threads (lanes 8q..8q+7, part p)
// take columns 2·cp and 2·cp + 1, rows t ≡ p mod 8. Once e_s is final, its
// owner hands it to the other seven and every later error takes its term
// s, so each error sums s in order. No block barrier inside.
template <int TC, int LDE, int LDL>
__device__ __forceinline__ void substitute(float* es, const float* ls, int tcn) {
  constexpr int R8 = TC / 8;
  const int lane = threadIdx.x % 32, cp = threadIdx.x / 8, p = threadIdx.x % 8;
  float2 e[R8];
#pragma unroll
  for (int r = 0; r < R8; ++r) {
    const int t = p + 8 * r;
    e[r] = t < tcn ? *reinterpret_cast<const float2*>(es + t * LDE + 2 * cp)
                   : make_float2(0.0f, 0.0f);
  }
#pragma unroll
  for (int s = 0; s + 1 < TC; ++s) {
    if (s + 1 >= tcn) break;
    const int src = (lane & ~7) | (s % 8);
    const float ex = __shfl_sync(0xffffffffu, e[s / 8].x, src);
    const float ey = __shfl_sync(0xffffffffu, e[s / 8].y, src);
#pragma unroll
    for (int r = s / 8; r < R8; ++r) {
      const int t = p + 8 * r;
      if (t > s && t < tcn) {
        const float l = -ls[t * LDL + s];
        e[r].x = __fmaf_rn(l, ex, e[r].x);
        e[r].y = __fmaf_rn(l, ey, e[r].y);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R8; ++r) {
    const int t = p + 8 * r;
    if (t < tcn) *reinterpret_cast<float2*>(es + t * LDE + 2 * cp) = e[r];
  }
}

// The block's loss partial: its threads' sq summed by warp, then the warps
// in order (no atomics), into *part.
__device__ __forceinline__ void store_loss_part(float sq, float* red, float* part) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  sq = warp_sum(sq);
  __syncthreads();
  if (lane == 0) red[warp] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w];
    *part = s;
  }
}

// Start copying the 64-column tile j0.. of β (N × M) into bs (n16 × 64),
// zero past N and past M, by cp.async; lane l copies columns 2l and 2l + 1.
__device__ __forceinline__ void load_tile_async(float* bs, const float* beta, int j0, int N,
                                                int n16, int M) {
  const int lane = threadIdx.x % 32;
  for (int k = threadIdx.x / 32; k < n16; k += kWarps)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = j0 + 2 * lane + c;
      const bool in = k < N && j < M;
      cp_async<4>(bs + k * kBetaTile + 2 * lane + c, beta + (in ? (size_t)k * M + j : 0),
                  in ? 4 : 0);
    }
}

// One block per (run of `per` 64-column tiles of β, device): a device's H,
// gains and L of a chunk are loaded and computed once for its run, and the
// next tile arrives by cp.async while this one is worked on (nbuf = 2, when
// two tiles fit in shared memory). Lane l holds columns 2l and 2l + 1.
// RW = rows of a chunk a warp takes, so a chunk holds at most TC = 8·RW
// samples. Shared memory: the tiles (n16 × 64), Hᵀ (n16 × TC), the gains
// (n16 × tc), L (TC × TC) and E (TC × 64), each row padded so that the
// lanes of a warp meet no bank conflict: the gains' by 4 floats (lanes on
// consecutive samples read 16 bytes), L's by 1 (eight threads of a column
// pair read eight rows), E's by 2 and Hᵀ's by 4 (written a column at a
// time).
template <int RW>
__global__ void __launch_bounds__(kThreads, 2)
ingest_beta_kernel(const float* __restrict__ h_all, const float* __restrict__ gains,
                   const float* __restrict__ targets, const float* beta_in, float* beta_out,
                   float* __restrict__ loss_part, int T, int N, int M, int per, int nbuf,
                   int chunk) {
  constexpr int TC = 8 * RW, SJ = (TC + 31) / 32;
  constexpr int LDH = TC + 4, LDL = TC + 1, LDE = kBetaTile + 2;  // padded against bank conflicts
  extern __shared__ __align__(16) float smem[];
  const int n16 = (N + 15) / 16 * 16, ldg = n16 + 4;
  const int tc = min(T, chunk);
  float* tiles = smem;                       // [nbuf][n16][64]
  float* ht = tiles + nbuf * n16 * kBetaTile;  // [n16][LDH]: Hᵀ of the chunk
  float* gs = ht + n16 * LDH;                // [tc][ldg]: the chunk's gains
  float* ls = gs + tc * ldg;                 // [TC][LDL]: the chunk's L
  float* es = ls + (TC * LDL + 3) / 4 * 4;   // [TC][LDE]: E₀, then E
  float* red = es + TC * LDE;                // [kWarps]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int d = blockIdx.y;
  const int n_tiles = (M + kBetaTile - 1) / kBetaTile;
  const int x0 = blockIdx.x * per, x1 = min(x0 + per, n_tiles);
  const float* hd = h_all + (size_t)d * T * N;
  const float* gd = gains + (size_t)d * T * N;
  const float* bin = beta_in + (size_t)d * N * M;
  float* bout = beta_out + (size_t)d * N * M;
  const int chunks = (T + chunk - 1) / chunk;
  float sq = 0.0f;

  for (int c = 0; c < chunks; ++c) {
    const int c0 = c * chunk, tcn = min(chunk, T - c0);
    const float* tgt = targets + ((size_t)d * T + c0) * M;
    __syncthreads();  // the last chunk is done with H, the gains and L
    load_rows_t_async(ht, hd + (size_t)c0 * N, tcn, TC, N, n16, LDH);
    load_rows_async(gs, gd + (size_t)c0 * N, tcn, N, n16, ldg);
    cp_async_commit();
    if (c == 0 && x0 < x1) load_tile_async(tiles, bin, x0 * kBetaTile, N, n16, M);
    cp_async_commit();
    cp_async_wait<1>();  // H and the gains; the first tile may still be in flight
    __syncthreads();
    // L[t][s] = h_t·gain_s (rows t = warp + 8i, samples s = lane + 32j), in
    // k order, one fused multiply-add each; only s < t is read
    {
      float acc[RW][SJ];
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j) acc[i][j] = 0.0f;
      for (int k = 0; k < n16; k += 4) {
        float4 g4[SJ];
#pragma unroll
        for (int j = 0; j < SJ; ++j) {
          const int sj = min(lane + 32 * j, tcn - 1);
          g4[j] = *reinterpret_cast<const float4*>(gs + sj * ldg + k);
        }
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const int t = warp + 8 * i;
          if (t >= tcn) continue;
          const float h0 = ht[k * LDH + t], h1 = ht[(k + 1) * LDH + t];
          const float h2 = ht[(k + 2) * LDH + t], h3 = ht[(k + 3) * LDH + t];
#pragma unroll
          for (int j = 0; j < SJ; ++j) {
            acc[i][j] = __fmaf_rn(h0, g4[j].x, acc[i][j]);
            acc[i][j] = __fmaf_rn(h1, g4[j].y, acc[i][j]);
            acc[i][j] = __fmaf_rn(h2, g4[j].z, acc[i][j]);
            acc[i][j] = __fmaf_rn(h3, g4[j].w, acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int j = 0; j < SJ; ++j)
          if (lane + 32 * j < TC) ls[(warp + 8 * i) * LDL + lane + 32 * j] = acc[i][j];
    }

    for (int x = x0; x < x1; ++x) {
      const int j0 = x * kBetaTile;
      const int ncol = min(kBetaTile, M - j0);
      const bool jv[2] = {2 * lane < ncol, 2 * lane + 1 < ncol};  // the update's columns
      float* bs = tiles;
      if (c == 0) {
        bs += ((x - x0) % nbuf) * n16 * kBetaTile;
        __syncthreads();  // the tile before is consumed: the other buffer is free
        if (nbuf == 2 && x + 1 < x1) {
          load_tile_async(tiles + ((x + 1 - x0) % 2) * n16 * kBetaTile, bin, j0 + kBetaTile, N,
                          n16, M);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          if (nbuf == 1 && x > x0) {  // one buffer: this tile goes in after the last went out
            load_tile_async(tiles, bin, j0, N, n16, M);
            cp_async_commit();
          }
          cp_async_wait<0>();
        }
      } else {
        // a later chunk: the loss is the error under the tick-start β, and the
        // update starts from the β the chunks before left in beta_out
        __syncthreads();
        load_tile_async(tiles, bin, j0, N, n16, M);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        chunk_errors<RW>(es, LDE, sq, ht, LDH, tiles, tgt + j0, tcn, n16, M, ncol);
        __syncthreads();
        load_tile_async(tiles, bout, j0, N, n16, M);
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncthreads();
      // E₀ of the chunk under the current β; its squares are the loss's
      // partials when the current β is the tick-start one
      {
        float none = 0.0f;
        chunk_errors<RW>(es, LDE, c == 0 ? sq : none, ht, LDH, bs, tgt + j0, tcn, n16, M, ncol);
      }
      __syncthreads();
      substitute<TC, LDE, LDL>(es, ls, tcn);
      __syncthreads();
      // β[k][c] += Σ_s gain_s[k]·e_s[c], s in order, rows 16·warp + i
      for (int kb = kUpdateRows * warp; kb < N; kb += kUpdateRows * kWarps) {
        float2 acc[kUpdateRows];
#pragma unroll
        for (int i = 0; i < kUpdateRows; ++i)
          acc[i] = *reinterpret_cast<const float2*>(bs + (kb + i) * kBetaTile + 2 * lane);
        for (int s = 0; s < tcn; ++s) {
          const float2 e = *reinterpret_cast<const float2*>(es + s * LDE + 2 * lane);
          const float* g = gs + s * ldg + kb;
#pragma unroll
          for (int i = 0; i < kUpdateRows; i += 4) {
            const float4 g4 = *reinterpret_cast<const float4*>(g + i);
            const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[i + q].x = __fmaf_rn(gv[q], e.x, acc[i + q].x);
              acc[i + q].y = __fmaf_rn(gv[q], e.y, acc[i + q].y);
            }
          }
        }
        // the updated rows go straight out, each warp's a coalesced 256 bytes
#pragma unroll
        for (int i = 0; i < kUpdateRows; ++i) {
          if (kb + i >= N) break;
          float* row = bout + (size_t)(kb + i) * M + j0 + 2 * lane;
          if (jv[0]) row[0] = acc[i].x;
          if (jv[1]) row[1] = acc[i].y;
        }
      }
    }
  }
  store_loss_part(sq, red, loss_part + (size_t)d * gridDim.x + blockIdx.x);
}

// One stage of the wide β kernel: rows k0 .. k0 + kWideRows of the tile's
// current β (bs, 64 columns), of the tick-start β when two (b0s), the
// chunk's gains at those k (gs[k][s]) and, when hidden, its hidden rows
// (hs[k][t]); zeros past N, M and the chunk, by 4-byte cp.async.
constexpr int kWideLdg = kWideChunk + 4;  // hs and gs row stride
constexpr int kWideStage = 2 * kWideRows * kBetaTile + 2 * kWideRows * kWideLdg;

__device__ __forceinline__ void wide_stage(float* st, const float* bcur, const float* bin,
                                           const float* hc, const float* gc, int k0, int N,
                                           int M, int j0, int tcn, bool two, bool hidden) {
  float* bs = st;
  float* b0s = bs + kWideRows * kBetaTile;
  float* hs = b0s + kWideRows * kBetaTile;
  float* gs = hs + kWideRows * kWideLdg;
  for (int idx = threadIdx.x; idx < kWideRows * kBetaTile; idx += kThreads) {
    const int k = idx / kBetaTile, c = idx % kBetaTile;
    const bool in = k0 + k < N && j0 + c < M;
    const size_t at = in ? (size_t)(k0 + k) * M + j0 + c : 0;
    cp_async<4>(bs + idx, bcur + at, in ? 4 : 0);
    if (two) cp_async<4>(b0s + idx, bin + at, in ? 4 : 0);
  }
  for (int idx = threadIdx.x; idx < kWideRows * kWideChunk; idx += kThreads) {
    const int t = idx / kWideRows, k = idx % kWideRows;  // consecutive threads on consecutive k
    const bool in = t < tcn && k0 + k < N;
    const size_t at = in ? (size_t)t * N + k0 + k : 0;
    if (hidden) cp_async<4>(hs + k * kWideLdg + t, hc + at, in ? 4 : 0);
    cp_async<4>(gs + k * kWideLdg + t, gc + at, in ? 4 : 0);
  }
}

// β past kMaxN: one block per (64-column tile, device), the window in
// chunks of kWideChunk samples. Per chunk, pass 1 streams the tile (and,
// after the first chunk, the tick-start tile for the loss), H and the gains
// by runs of kWideRows rows: E₀ on the tile (rows 2·(tid/16) + {0, 1},
// columns 4·(tid%16)..+3, k in order, one fused multiply-add each) and
// L[t][s] = h_t·gain_s (t = tid/8, s = 4·(tid%8)..+3); then the
// substitution; pass 2 streams the tile and the gains again: β[k][c] +=
// Σ_s gain_s[k]·e_s[c], s in order, rows tid/8, columns 8·(tid%8)..+7.
__global__ void __launch_bounds__(kThreads, 2)
ingest_beta_wide_kernel(const float* __restrict__ h_all, const float* __restrict__ gains,
                        const float* __restrict__ targets, const float* beta_in, float* beta_out,
                        float* __restrict__ loss_part, int T, int N, int M) {
  constexpr int TC = kWideChunk, LDE = kBetaTile + 4, LDL = TC + 1;
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                  // [2][kWideStage]
  float* es = stages + 2 * kWideStage;   // [TC][LDE]: E₀, then E
  float* ls = es + TC * LDE;             // [TC][LDL]: the chunk's L
  float* red = ls + TC * LDL;            // [kWarps]
  const int tid = threadIdx.x, d = blockIdx.y, j0 = blockIdx.x * kBetaTile;
  const int ncol = min(kBetaTile, M - j0);
  const float* bin = beta_in + (size_t)d * N * M;
  float* bout = beta_out + (size_t)d * N * M;
  const int nk = (N + kWideRows - 1) / kWideRows;
  const int eg = tid % 16, tg = tid / 16;  // E₀: columns 4·eg.., rows 2·tg, 2·tg + 1
  const int lt = tid / 8, lg = tid % 8;    // L: row lt, samples 4·lg..; the update: row lt, columns 8·lg..
  float sq = 0.0f;

  for (int c0 = 0; c0 < T; c0 += TC) {
    const int tcn = min(TC, T - c0);
    const bool two = c0 > 0;  // past the first chunk: the loss's errors under the tick-start β
    const float* bcur = two ? bout : bin;
    const float* hc = h_all + ((size_t)d * T + c0) * N;
    const float* gc = gains + ((size_t)d * T + c0) * N;
    float acc[2][4] = {}, acc0[2][4] = {}, lacc[4] = {};
    __syncthreads();  // the chunk before is done with es and the stages
    wide_stage(stages, bcur, bin, hc, gc, 0, N, M, j0, tcn, two, true);
    cp_async_commit();
    for (int kb = 0; kb < nk; ++kb) {
      if (kb + 1 < nk)
        wide_stage(stages + ((kb + 1) & 1) * kWideStage, bcur, bin, hc, gc, (kb + 1) * kWideRows,
                   N, M, j0, tcn, two, true);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* bs = stages + (kb & 1) * kWideStage;
      const float* b0s = bs + kWideRows * kBetaTile;
      const float* hs = b0s + kWideRows * kBetaTile;
      const float* gs = hs + kWideRows * kWideLdg;
      const int kend = min(kWideRows, N - kb * kWideRows);
      for (int k = 0; k < kend; ++k) {
        const float2 h2 = *reinterpret_cast<const float2*>(hs + k * kWideLdg + 2 * tg);
        const float4 b4 = *reinterpret_cast<const float4*>(bs + k * kBetaTile + 4 * eg);
        const float hv[2] = {h2.x, h2.y}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = __fmaf_rn(hv[i], bv[c], acc[i][c]);
        if (two) {
          const float4 a4 = *reinterpret_cast<const float4*>(b0s + k * kBetaTile + 4 * eg);
          const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc0[i][c] = __fmaf_rn(hv[i], av[c], acc0[i][c]);
        }
        const float hl = hs[k * kWideLdg + lt];
        const float4 g4 = *reinterpret_cast<const float4*>(gs + k * kWideLdg + 4 * lg);
        lacc[0] = __fmaf_rn(hl, g4.x, lacc[0]);
        lacc[1] = __fmaf_rn(hl, g4.y, lacc[1]);
        lacc[2] = __fmaf_rn(hl, g4.z, lacc[2]);
        lacc[3] = __fmaf_rn(hl, g4.w, lacc[3]);
      }
      __syncthreads();  // this stage is consumed before the next iteration refills it
    }
    // E₀ = targets − H·β under the current β, and the loss's squares under
    // the tick-start one; L of the chunk
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = 2 * tg + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 4 * eg + c;
        const bool in = t < tcn && col < ncol;
        const float y = in ? targets[((size_t)d * T + c0 + t) * M + j0 + col] : 0.0f;
        const float e = in ? __fsub_rn(y, acc[i][c]) : 0.0f;
        const float e0 = two ? (in ? __fsub_rn(y, acc0[i][c]) : 0.0f) : e;
        sq = __fmaf_rn(e0, e0, sq);
        es[t * LDE + col] = e;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) ls[lt * LDL + 4 * lg + c] = lacc[c];
    __syncthreads();
    substitute<TC, LDE, LDL>(es, ls, tcn);
    __syncthreads();

    // β += Σ_s gain_s e_sᵀ, streamed: read the current tile again, write β_out
    wide_stage(stages, bcur, bin, hc, gc, 0, N, M, j0, tcn, false, false);
    cp_async_commit();
    for (int kb = 0; kb < nk; ++kb) {
      if (kb + 1 < nk)
        wide_stage(stages + ((kb + 1) & 1) * kWideStage, bcur, bin, hc, gc, (kb + 1) * kWideRows,
                   N, M, j0, tcn, false, false);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* bs = stages + (kb & 1) * kWideStage;
      const float* gs = bs + 2 * kWideRows * kBetaTile + kWideRows * kWideLdg;
      const int k = kb * kWideRows + lt;
      float o[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) o[c] = bs[lt * kBetaTile + 8 * lg + c];
      for (int s = 0; s < tcn; ++s) {
        const float g = gs[lt * kWideLdg + s];
        const float4 e0 = *reinterpret_cast<const float4*>(es + s * LDE + 8 * lg);
        const float4 e1 = *reinterpret_cast<const float4*>(es + s * LDE + 8 * lg + 4);
        const float ev[8] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
        for (int c = 0; c < 8; ++c) o[c] = __fmaf_rn(g, ev[c], o[c]);
      }
      if (k < N)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          if (8 * lg + c < ncol) bout[(size_t)k * M + j0 + 8 * lg + c] = o[c];
      __syncthreads();
    }
  }
  store_loss_part(sq, red, loss_part + (size_t)d * gridDim.x + blockIdx.x);
}

// loss[d] = Σ_runs part[d, run] / (T·M), summed in run order.
__global__ void ingest_loss_kernel(const float* __restrict__ part, float* __restrict__ loss,
                                   int D, int runs, float count) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float s = 0.0f;
  for (int i = 0; i < runs; ++i) s += part[(size_t)d * runs + i];
  loss[d] = s / count;
}

template <int RI, int CJ, int CS>
cudaError_t launch_gain(const float* h, const float* p_in, float* p_out, float* gains, int D,
                        int T, int N, float forget, cudaStream_t s) {
  const size_t smem = (4 * (size_t)N + 2 * CS * kWarps) * 4;
  return launch_clustered(ingest_gain_kernel<RI, CJ, CS>, dim3(D * CS), kThreads, smem, CS, s, h,
                          p_in, p_out, gains, T, N, forget);
}

template <int RW>
cudaError_t launch_beta(const float* h, const float* gains, const float* targets,
                        const float* beta_in, float* beta_out, float* part, int D, int T, int N,
                        int M, int groups, int per, int nbuf, int chunk, int smem,
                        cudaStream_t s) {
  auto kernel = ingest_beta_kernel<RW>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(groups, D), kThreads, smem, s>>>(h, gains, targets, beta_in, beta_out, part, T,
                                                  N, M, per, nbuf, chunk);
  return cudaGetLastError();
}

// The chunk a β block holds: TC = 8·RW ≥ tc samples (32 or 64).
int beta_chunk_rows(int tc) { return tc <= 32 ? 32 : 64; }

// The β kernel's shared memory with nbuf tiles, in bytes.
int beta_smem(int N, int tc, int nbuf) {
  const int n16 = (N + 15) / 16 * 16, big = beta_chunk_rows(tc);
  return (nbuf * n16 * kBetaTile + n16 * (big + 4) + tc * (n16 + 4) +
          (big * (big + 1) + 3) / 4 * 4 + big * (kBetaTile + 2) + kWarps) * 4;
}

// The samples of a chunk at Ñ = N: 64 while 64 samples' H, gains and L fit
// one block's shared memory beside a tile of β (Ñ ≤ 240), else 32.
int ingest_chunk(int N) {
  return beta_smem(N, kMaxChunk, 1) <= kMaxSmem ? kMaxChunk : kWideChunk;
}

// Past kMaxN: the P chain and the β update of the wide kernels.
cudaError_t launch_wide(const float* h, const float* targets, const float* p_in,
                        const float* beta_in, float* p_out, float* beta_out, float* gains,
                        float* part, int D, int T, int N, int M, float forget, cudaStream_t s) {
  cudaError_t e = launch_clustered(
      ingest_gain_wide_kernel, dim3(D * kGainCluster), kWideThreads,
      (2 * (size_t)N + 2 * kGainCluster * (kWideThreads / 32)) * 4, kGainCluster, s, h, p_in,
      p_out, gains, T, N, forget);
  if (e != cudaSuccess) return e;
  const int smem = (2 * kWideStage + kWideChunk * (kBetaTile + 4) +
                    kWideChunk * (kWideChunk + 1) + kWarps) * 4;
  e = cudaFuncSetAttribute(ingest_beta_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  const int n_tiles = (M + kBetaTile - 1) / kBetaTile;
  ingest_beta_wide_kernel<<<dim3(n_tiles, D), kThreads, smem, s>>>(h, gains, targets, beta_in,
                                                                   beta_out, part, T, N, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int repro_ingest_beta_tile() { return kBetaTile; }
// The samples of a chunk of the window at Ñ = N (the plain version chunks
// alike).
int repro_ingest_chunk(int N) { return ingest_chunk(N); }

// The ingest's first half: the projection h_ws (D,T,N) = G(x·α + b) of the
// window x (D,T,n), with activation code act. Returns the CUDA error, or 0.
int repro_fleet_ingest_project(const float* x, const float* alpha, const float* bias,
                               float* h_ws, int D, int T, int n, int N, int act, void* stream) {
  return launch_gemm<float, false>(x, alpha, bias, h_ws, 1, D * T, n, N, act,
                                   static_cast<cudaStream_t>(stream));
}

// The ingest's second half, from the hidden rows h_ws (D,T,N): the P chain,
// the β update and the pre-train loss. A registered activation without a
// code of its own takes this route after the wrapper applied it to h_ws.
int repro_fleet_ingest_update(const float* targets, const float* p_in, const float* beta_in,
                              float* p_out, float* beta_out, float* loss, const float* h_ws,
                              float* gain_ws, float* part_ws, int D, int T, int N, int m,
                              float forget, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  const int n_tiles = (m + kBetaTile - 1) / kBetaTile;

  if (N > kMaxN) {
    e = launch_wide(h_ws, targets, p_in, beta_in, p_out, beta_out, gain_ws, part_ws, D, T, N, m,
                    forget, s);
    if (e != cudaSuccess) return e;
    ingest_loss_kernel<<<(D + 127) / 128, 128, 0, s>>>(part_ws, loss, D, n_tiles,
                                                       (float)T * (float)m);
    return cudaGetLastError();
  }

  if (N <= 32)
    e = launch_gain<4, 1, 1>(h_ws, p_in, p_out, gain_ws, D, T, N, forget, s);
  else if (N <= 128)
    e = launch_gain<16, 4, 1>(h_ws, p_in, p_out, gain_ws, D, T, N, forget, s);
  else
    e = launch_gain<kMaxN / (8 * kGainCluster), kMaxN / 32, kGainCluster>(
        h_ws, p_in, p_out, gain_ws, D, T, N, forget, s);
  if (e != cudaSuccess) return e;

  // runs of tiles: as many blocks as fill the card at two an SM, each
  // loading its device's chunk once for its run
  int want = D > 0 ? 2 * sm_count() / D : 1;
  if (want < 1) want = 1;
  const int per = n_tiles > 0 ? (n_tiles + want - 1) / want : 1;
  const int groups = (n_tiles + per - 1) / per;
  const int chunk = ingest_chunk(N);
  const int tc = T < chunk ? T : chunk;
  const int nbuf = per > 1 && beta_smem(N, tc, 2) <= kMaxSmem ? 2 : 1;
  const int bsmem = beta_smem(N, tc, nbuf);
  auto beta = beta_chunk_rows(tc) == 32 ? launch_beta<4> : launch_beta<8>;
  e = beta(h_ws, gain_ws, targets, beta_in, beta_out, part_ws, D, T, N, m, groups, per, nbuf,
           chunk, bsmem, s);
  if (e != cudaSuccess) return e;

  ingest_loss_kernel<<<(D + 127) / 128, 128, 0, s>>>(part_ws, loss, D, groups,
                                                     (float)T * (float)m);
  return cudaGetLastError();
}

// All pointers are device pointers to contiguous f32 arrays:
// x (D,T,n), targets (D,T,m), alpha (n,N), bias (N), p_in/p_out (D,N,N),
// beta_in/beta_out (D,N,m), loss (D); workspaces h_ws and gain_ws (D,T,N),
// part_ws (D, ceil(m/64)), of which each run of β tiles fills one column.
// The window is taken in chunks of ingest_chunk(N) samples. Returns the
// first CUDA error, or 0.
int repro_fleet_ingest(const float* x, const float* targets, const float* alpha,
                       const float* bias, const float* p_in, const float* beta_in,
                       float* p_out, float* beta_out, float* loss, float* h_ws,
                       float* gain_ws, float* part_ws, int D, int T, int n, int N, int m,
                       int act, float forget, void* stream) {
  int e = repro_fleet_ingest_project(x, alpha, bias, h_ws, D, T, n, N, act, stream);
  if (e != 0) return e;
  return repro_fleet_ingest_update(targets, p_in, beta_in, p_out, beta_out, loss, h_ws, gain_ws,
                                   part_ws, D, T, N, m, forget, stream);
}

}  // extern "C"
