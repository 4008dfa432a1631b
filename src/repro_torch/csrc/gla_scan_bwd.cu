// Chunked gated-linear-attention backward for Hopper (sm_90a).
//
// Replaces no pallas_call: the reference trains its Mamba and mLSTM mixers
// through jax's autodiff of src/repro/models/ssm.py::chunked_linear_attention
// (:33). This is the gradient of gla_scan.cu's forward
//     y = (q ⊙ e^{cum})·S_in + ((q kᵀ) ⊙ gate)·v,   S_out = e^{tot}·S_in + (k ⊙ e^{tot−cum})ᵀ·v
// per chunk of C = min(128, S) tokens, cum the inclusive f32 cumsum of log a
// in the chunk, tot its last entry, gate = tril(e^{cum_t − cum_τ}) by select.
// Given dy and, optionally, the final state's cotangent dS_final:
//     ΔG_c = (q ⊙ e^{cum})ᵀ·dy                 (dk × dv, a chunk)
//     G_{n−1} = dS_final (or 0),  G_{c−1} = G_c·e^{tot_c} + ΔG_c
// (G_c, the gradient of the state leaving chunk c), and per chunk, with
// dP = (dy·vᵀ) ⊙ gate and the scores P = (q·kᵀ) ⊙ gate,
//     dq = e^{cum} ⊙ (dy·S_inᵀ) + dP·k
//     dk = dPᵀ·q + e^{tot−cum} ⊙ (v·G_cᵀ)
//     dv = Pᵀ·dy + e^{tot−cum} ⊙ (k·G_c)
//     dC_t = q_t·dq_t − k_t·dk_t,   dlog a_t = ⟨dS_final, S_final⟩ + Σ_{s ≥ t} dC_s
// (the last: a reverse cumsum within each chunk, then each chunk's carry of
// the later chunks' sums, in chunk order from the last). S_in and e^{tot}
// come from the forward (its scratch dstate and decay): the carry is not
// computed again.
//
// Bound on an H100, counting the products above once (no recompute; the
// causal ones over the C(C+1)/2 kept pairs; chip_smoke.py's gla_bwd_work):
// at hymba-1.5b's training shape (B = 4, S = 512, H = 25, dk = 16, dv = 64)
// 1.58 GFLOP against 29.1 MB of operands, states and results: 8.7 µs of
// bytes at 3.35 TB/s, 1.6 µs of operations at the tensor cores' 989 TFLOP/s
// of bf16, 23.6 µs at 67 TFLOP/s of f32; at xLSTM's mLSTM (B = 2, S = 256,
// H = 4, dk = 512, dv = 513) 4.98 GFLOP against 48.3 MB (the states entering
// the chunks most of it): 14.4 µs of bytes, 74 µs of f32 operations. One C
// entry, two routes by type, four launches each (bf16 a fifth first where it
// pads), each gradient element written by one block, no atomics, the same
// bits on every run:
//
// * f32, on the CUDA cores:
//   - gla_bwd_state_kernel, one block per (b·h, chunk, 64 × 64 tile of ΔG):
//     ΔG_c's tile, a 4 × 4 block a thread summed over the chunk's tokens in
//     order (gla_wide_state_kernel's design, q ⊙ e^{cum} and dy in place of
//     k ⊙ e^{tot−cum} and v).
//   - gla_bwd_carry_kernel (both routes), one thread per (b·h, element): G_c
//     from the last chunk to the first, written over ΔG_c, product and sum
//     rounded apart; with a cotangent each block's share of ⟨dS_final,
//     S_final⟩ too.
//   - gla_bwd_chunk_kernel, one block per (b·h, chunk, strip) of two kinds.
//     A block of the first kind owns 64 columns of dk: it walks dv in tiles
//     of 64, summing dP (a thread's four 4 t × 4 τ blocks of the lower
//     triangle) and dy·S_inᵀ (8 rows × 4 columns a thread), gates dP into
//     shared memory, walks dv again for v·G_cᵀ, then takes dq = gated dP·k
//     and, the gated tile transposed in place, dk = its transpose·q: dq and
//     dk whole, summed over every column of dv in the block, and its strip's
//     share of dC_t to a scratch row (the 16 lanes of a row added by a fixed
//     butterfly). A block of the second kind owns 64 columns of dv: it walks
//     dk in strips of 64 for the scores q·kᵀ and k·G_c, gates the scores
//     into shared memory and takes dv. 182 KB of shared memory, one block an
//     SM; loads element by element, any width and alignment.
//   - gla_bwd_dlog_a_kernel (both routes), one block per (b, h): ⟨dS_final,
//     S_final⟩ from the carry blocks' shares by a fixed tree, each token's dC
//     from its strips in strip order, a warp a chunk for the reverse sum
//     (lane 0 adding token after token, as the forward's cumsum), then the
//     chunks' carry on one thread.
//   Inputs widened to f32, every sum in f32, dq, dk and dv rounded once.
// * bf16, on the tensor cores (mma.sync m16n8k16, bf16 in and f32 sums;
//   csrc/mma_tile.cuh's tile loader and fragment reads), blocks of four warps:
//   - gla_bwd_pad_kernel, first, only where a width is not a multiple of 8
//     or an operand is off a 16-byte boundary (the mLSTM's dv 513): q and k,
//     or v and dy, copied in one launch onto rows of padded(width) elements
//     (zero columns add nothing to any product or to dC).
//   - gla_bwd_state_mma_kernel, one block per (b·h, chunk, 64-row tile of ΔG,
//     run of 64-column tiles, runs cut so that the grid fills two blocks an
//     SM): q ⊙ e^{cum} split once in shared memory into hi = bf16(x) and lo =
//     bf16(x − hi), ΔG = hiᵀ·dy + loᵀ·dy over each dy tile of the run (a
//     two-stage cp.async ring), written through shared memory a row at a
//     time.
//   - gla_bwd_carry_kernel, as above.
//   - gla_bwd_chunk_mma_kernel<WK, WV>, blocks by output strip: a dq/dk strip
//     of WK columns of dk walks dv in tiles of 32, summing dPᵀ = v·dyᵀ over
//     the causal triangle, dy·S_inᵀ and v·G_cᵀ; then dk = dSᵀ·q from the
//     gated triangle in registers (its accumulators are the next product's A
//     fragments, as in flash_attn_bwd.cu) and dq = dS·k from dSᵀ put in
//     shared memory. A dv strip of WV columns walks dk the same way for Sᵀ =
//     k·qᵀ and k·G_c, then dv = Pᵀ·dy. The walk is a ring: the bf16 tiles
//     (v and dy, or q and k) by cp.async three deep, so that tile d + 2's
//     copies are in flight while tile d's products run; S_in's and G_c's f32
//     tiles by 4-byte cp.async (any DV) into a staging tile, each thread
//     splitting its own elements into hi and lo tiles after tile d's products
//     (two deep); one barrier a tile. The strip's own columns (dy, or q and
//     k) come after the walk, over its buffers, while the triangle is gated.
//     Warp w owns the 16-token tiles w and 7 − w, so the triangle's 36 tiles
//     of 16 × 16 split 9 a warp. dP is built again by each dq/dk strip and the
//     scores by each dv strip (at 512 × 513, 16 and 9 times a chunk's 128·128
//     pairs over 520 and 512: about 0.14 GFLOP over the call). A block takes
//     one strip, or ("paired") a dv strip and then a dq/dk strip; the strip
//     widths and the pairing come from kernels/gla_scan.py::bwd_plan. 78-98
//     KB of shared memory and 216-255 registers (none spilled; nvcc -Xptxas
//     -v for sm_90a), two blocks an SM.
//   - gla_bwd_dlog_a_kernel, as above, on the dq/dk strips' shares.
//   Rows of q, k, v, dy and the gradients are padded(DK) and padded(DV)
//   elements on 16-byte boundaries; the states S_in and G_c keep DK × DV.
//   bf16 roundings, at the reference's points and no others (ssm.py under
//   jax.vjp, as jax.make_jaxpr of it shows on bf16 q, k, v and dy; the state
//   side in f32):
//   - the scores bf16(q·kᵀ) as they leave the accumulators (:74, a bf16
//     einsum), P = bf16(scores ⊙ gate) (:79's cast);
//   - dP = bf16(dy·vᵀ) (the transpose of :78's bf16 einsum), dS = bf16(dP
//     ⊙ gate) (the transpose of :74's cast to f32);
//   - the intra terms bf16(dS·k), bf16(dSᵀ·q) (:74's einsum transposed) and
//     bf16(Pᵀ·dy) (:78's);
//   - the inter terms bf16(e^{cum} ⊙ (dy·S_inᵀ)) (:70-71), bf16(e^{tot−cum}
//     ⊙ (v·G_cᵀ)) and bf16(e^{tot−cum} ⊙ (k·G_c)) (:84), f32 products cast to
//     the operand's type (the transpose of its promotion to f32);
//   - dq, dk and dv = bf16(intra + inter), the two bf16 cotangents added.
//   dC_t takes dq and dk as the f32 sums intra + inter before any of these
//   roundings (the reference's dlog a comes from f32 terms: its bf16 dP and
//   scores times the f32 gate, and the f32 state products; from the rounded
//   dq and dk it strays 5× the reference's own bf16-to-f32 spread,
//   tests/test_torch_gla_bwd.py). The f32 operands of the state products
//   (q ⊙ e^{cum} in ΔG, S_in, G_c) enter as hi and lo against the exact bf16
//   one, within about
//   2^-16 of the reference's f32 product (one bf16 rounding of the state
//   would add 2^-9). The carry and the dlog a pass keep their f32
//   arithmetic and order. kernels/gla_scan.py::gla_backward_plain takes the
//   same roundings and split for bf16, so card and plain differ in the order
//   of f32 sums and in the gate's last bits (ex2.approx, gate_pack).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "device.cuh"
#include "mma_tile.cuh"
#include "ptx.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;          // tokens a chunk at most
constexpr int kStride = kMaxChunk + 4;  // row stride of the token-minor tiles (16-byte rows)
constexpr int kTile = 64;               // state tile rows and columns; a strip of dk or dv
constexpr int kRowsPerWarp = kMaxChunk / kWarps;

__device__ __forceinline__ float widen(float x) { return x; }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// One warp: cum[0..128) = the inclusive cumsum of la[t·H] over the chunk's
// `valid` tokens (0 past them), lane 0 adding token after token, eight
// tokens a pair of 16-byte loads, as gla_scan.cu's forward and
// gla_forward_plain add them (the same bits). cum must be 16-byte aligned.
__device__ void chunk_cumsum(const float* __restrict__ la, int H, int valid, float* cum) {
  const int lane = threadIdx.x % 32;
  float x[kMaxChunk / 32];
#pragma unroll
  for (int s = 0; s < kMaxChunk / 32; ++s) {
    const int t = lane + 32 * s;
    x[s] = t < valid ? la[(long long)t * H] : 0.0f;
  }
#pragma unroll
  for (int s = 0; s < kMaxChunk / 32; ++s) cum[lane + 32 * s] = x[s];
  __syncwarp();
  if (lane == 0) {
    float acc = -0.0f;  // −0 + x is x for every x: cum[0] is la[0] itself
#pragma unroll 4
    for (int t0 = 0; t0 < kMaxChunk; t0 += 8) {
      const float4 a = ld4(cum + t0), b = ld4(cum + t0 + 4);
      float y[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) y[r] = acc = __fadd_rn(acc, y[r]);
      *reinterpret_cast<float4*>(cum + t0) = make_float4(y[0], y[1], y[2], y[3]);
      *reinterpret_cast<float4*>(cum + t0 + 4) = make_float4(y[4], y[5], y[6], y[7]);
    }
  }
  __syncwarp();
}

// The chunk of `blk`: its (b·h), its index, its first token, its tokens
// before S, and `base`, the row of its first token in the (B, S, H) layout
// (token t of the chunk is row base + t·H).
struct Chunk {
  int bh, c, tok0, valid;
  long long base;
};

__device__ __forceinline__ Chunk chunk_of(int blk, int S, int H, int C, int n_chunks) {
  Chunk ch;
  ch.bh = blk / n_chunks;
  ch.c = blk % n_chunks;
  ch.tok0 = ch.c * C;
  ch.valid = min(C, S - ch.tok0);
  const int b = ch.bh / H, h = ch.bh % H;
  ch.base = (long long)b * S * H + h + (long long)ch.tok0 * H;
  return ch;
}

// Columns j0 .. j0 + cols of the chunk's rows r < kMaxChunk of a (·, width)
// array whose token t sits at src + (base + t·H)·width, widened to f32 into
// dst[r·ld + j − j0] (or, with kTransposed, dst[(j − j0)·ld + r]), zeros
// past `valid` rows and past `width`. A lane loads its column of all its
// rows before it stores any, so that their latencies overlap.
template <bool kTransposed, typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ src, long long base, int H,
                                          int width, int j0, int cols, int valid, float* dst,
                                          int ld) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int jj = lane; jj < cols; jj += 32) {
    const int j = j0 + jj;
    float x[kRowsPerWarp];
#pragma unroll
    for (int s = 0; s < kRowsPerWarp; ++s) {
      const int r = warp + s * kWarps;
      x[s] = r < valid && j < width ? widen(src[(base + (long long)r * H) * width + j]) : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < kRowsPerWarp; ++s) {
      const int r = warp + s * kWarps;
      dst[kTransposed ? jj * ld + r : r * ld + jj] = x[s];
    }
  }
}

// Rows i0 .. i0 + 63 and columns j0 .. j0 + 63 of a (DK, DV) f32 matrix into
// dst[(i − i0)·kTile + j − j0] (or, with kTransposed, dst[(j − j0)·kTile +
// i − i0]), zeros past DK and DV.
template <bool kTransposed>
__device__ __forceinline__ void load_state_tile(const float* __restrict__ m, int DK, int DV,
                                                int i0, int j0, float* dst) {
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int ii = e / kTile, jj = e % kTile, i = i0 + ii, j = j0 + jj;
    const float x = i < DK && j < DV ? m[(long long)i * DV + j] : 0.0f;
    dst[kTransposed ? jj * kTile + ii : e] = x;
  }
}

// e1[t] = e^{cum_t}, e2[t] = e^{tot − cum_t} over the chunk's kMaxChunk rows
__device__ __forceinline__ void chunk_decays(const float* cum, int C, float* e1, float* e2) {
  const int t = threadIdx.x;
  if (t < kMaxChunk) {
    e1[t] = expf(cum[t]);
    e2[t] = expf(cum[C - 1] - cum[t]);
  }
}

// Pass 1, one block per (b·h, chunk, 64 × 64 tile): ΔG_c's rows i0.. and
// columns j0.. = Σ_t (q_t ⊙ e^{cum_t}) dy_tᵀ over the chunk's tokens in
// order, into dgrad (B·H, n_chunks, DK, DV). tj: column tiles of ΔG.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gla_bwd_state_kernel(const T* __restrict__ q, const T* __restrict__ dy,
                     const float* __restrict__ log_a, float* __restrict__ dgrad, int S, int H,
                     int DK, int DV, int C, int n_chunks, int tiles, int tj) {
  extern __shared__ __align__(16) float smem[];
  float* qe = smem;                       // [kMaxChunk][kTile]: q ⊙ e^{cum}
  float* ys = qe + kMaxChunk * kTile;     // [kMaxChunk][kTile]: dy
  float* cum = ys + kMaxChunk * kTile;    // [kMaxChunk]
  float* e1 = cum + kMaxChunk;            // [kMaxChunk]
  float* e2 = e1 + kMaxChunk;             // [kMaxChunk] (not read here)
  const int tid = threadIdx.x, warp = tid / 32;
  const int tile = blockIdx.x % tiles;
  const Chunk ch = chunk_of(blockIdx.x / tiles, S, H, C, n_chunks);
  const int i0 = tile / tj * kTile, j0 = tile % tj * kTile;

  if (warp == 0) chunk_cumsum(log_a + ch.base, H, ch.valid, cum);
  load_cols<false>(q, ch.base, H, DK, i0, kTile, ch.valid, qe, kTile);
  load_cols<false>(dy, ch.base, H, DV, j0, kTile, ch.valid, ys, kTile);
  __syncthreads();
  chunk_decays(cum, C, e1, e2);
  __syncthreads();
  for (int e = tid; e < C * kTile; e += kThreads) qe[e] = __fmul_rn(qe[e], e1[e / kTile]);
  __syncthreads();

  const int a0 = 4 * (tid / 16), b0 = 4 * (tid % 16);  // this thread's 4 × 4 block
  float acc[4][4] = {};
#pragma unroll 4
  for (int t = 0; t < C; ++t) {
    const float4 a = ld4(qe + t * kTile + a0), w = ld4(ys + t * kTile + b0);
    const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int z = 0; z < 4; ++z) acc[x][z] = __fmaf_rn(av[x], wv[z], acc[x][z]);
  }
  float* dg = dgrad + ((long long)ch.bh * n_chunks + ch.c) * DK * DV;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int i = i0 + a0 + x;
    if (i >= DK) break;
#pragma unroll
    for (int z = 0; z < 4; ++z)
      if (j0 + b0 + z < DV) dg[(long long)i * DV + j0 + b0 + z] = acc[x][z];
  }
}

// A block's sum of x over its threads by a fixed tree (red: kThreads floats
// of shared memory); every thread of the block must call it.
__device__ __forceinline__ float block_sum(float x, float* red) {
  const int tid = threadIdx.x;
  red[tid] = x;
  __syncthreads();
  for (int o = kThreads / 2; o > 0; o /= 2) {
    if (tid < o) red[tid] = __fadd_rn(red[tid], red[tid + o]);
    __syncthreads();
  }
  const float sum = red[0];
  __syncthreads();
  return sum;
}

// Pass 2: G_c from G_{n−1} = dS_final (0 where dfinal is null) down to
// chunk 0, G_{c−1} = G_c·e^{tot_c} + ΔG_c, one thread per (b·h, state
// element) (E = DK·DV, `per` blocks a b·h); G_c overwrites ΔG_c. With a
// cotangent, each block also writes its elements' share of ⟨dS_final,
// S_final⟩ to fin (B·H, per).
__global__ void __launch_bounds__(kThreads)
gla_bwd_carry_kernel(float* __restrict__ dgrad, const float* __restrict__ decay,
                     const float* __restrict__ dfinal, const float* __restrict__ sfinal,
                     float* __restrict__ fin, int n_chunks, int E, int per) {
  __shared__ float red[kThreads];
  const int bh = blockIdx.x / per;
  const int e = (blockIdx.x % per) * kThreads + threadIdx.x;
  float g = 0.0f;
  if (dfinal) {
    const long long at = (long long)bh * E + e;
    g = e < E ? dfinal[at] : 0.0f;
    const float share = block_sum(e < E ? __fmul_rn(g, sfinal[at]) : 0.0f, red);
    if (threadIdx.x == 0) fin[blockIdx.x] = share;
  }
  if (e >= E) return;
  float* dg = dgrad + (long long)bh * n_chunks * E + e;
  const float* dc = decay + (long long)bh * n_chunks;
  constexpr int kBatch = 8;  // chunks whose loads are in flight together
  for (int c1 = n_chunks - 1; c1 >= 0; c1 -= kBatch) {
    float inc[kBatch], d[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int c = c1 - b;
      inc[b] = c >= 0 ? dg[(long long)c * E] : 0.0f;
      d[b] = c >= 0 ? dc[c] : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int c = c1 - b;
      if (c < 0) break;
      dg[(long long)c * E] = g;
      g = __fadd_rn(__fmul_rn(g, d[b]), inc[b]);
    }
  }
}

// shared memory of the chunk pass, in floats: two token-minor tiles, a state
// tile, the gated tile, a row-major strip, cum and the two decays
constexpr int kChunkSmem = 2 * kTile * kStride + kTile * kTile + kMaxChunk * kStride +
                           kMaxChunk * kTile + 3 * kMaxChunk;

// sco[s][x][z] += Σ_{j < w} a[j·kStride + ta + x] · b[j·kStride + 32s + ua + z]
// over the blocks of the lower triangle (t ≥ τ somewhere in the block)
__device__ __forceinline__ void score_blocks(const float* a, const float* b, int w, int ta,
                                             int ua, int C, float (&sco)[4][4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int u = 32 * s + ua;
    if (ta + 3 >= u && ta < C && u < C) {
      for (int j = 0; j < w; ++j) {
        const float4 x4 = ld4(a + j * kStride + ta);
        const float4 y4 = ld4(b + j * kStride + u);
        const float av[4] = {x4.x, x4.y, x4.z, x4.w}, bv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int z = 0; z < 4; ++z) sco[s][x][z] = __fmaf_rn(av[x], bv[z], sco[s][x][z]);
      }
    }
  }
}

// acc[r][x] += Σ_{j < w} a[j·kStride + r0 + r] · m[j·kTile + 4·lx + x]: 8
// rows (tokens) × 4 columns a thread, a token-minor tile against a state
// tile
__device__ __forceinline__ void rows_by_tile(const float* a, const float* m, int w, int r0,
                                             int lx, float (&acc)[8][4]) {
  for (int j = 0; j < w; ++j) {
    const float4 a0 = ld4(a + j * kStride + r0), a1 = ld4(a + j * kStride + r0 + 4);
    const float4 mv = ld4(m + j * kTile + 4 * lx);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float wv[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[r][x] = __fmaf_rn(av[r], wv[x], acc[r][x]);
  }
}

// acc[r][x] += Σ_{lo ≤ u < hi} g[u·kStride + r0 + r] · m[u·kTile + 4·lx + x]:
// the gated tile's column of this thread's 8 rows against a row-major strip
__device__ __forceinline__ void gated_by_strip(const float* g, const float* m, int lo, int hi,
                                               int r0, int lx, float (&acc)[8][4]) {
#pragma unroll 4
  for (int u = lo; u < hi; ++u) {
    const float4 g0 = ld4(g + u * kStride + r0), g1 = ld4(g + u * kStride + r0 + 4);
    const float4 w = ld4(m + u * kTile + 4 * lx);
    const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[r][x] = __fmaf_rn(gv[r], wv[x], acc[r][x]);
  }
}

// The gate by select: sco ⊙ e^{cum_t − cum_τ} where τ ≤ t, else 0, into gt,
// the t-major layout gt[t·kStride + τ] when kTMajor, else gt[τ·kStride + t].
template <bool kTMajor>
__device__ __forceinline__ void store_gated(const float (&sco)[4][4][4], const float* cum,
                                            int ta, int ua, int C, float* gt) {
  const float4 ct = ld4(cum + ta);
  const float cta[4] = {ct.x, ct.y, ct.z, ct.w};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int u = 32 * s + ua;
    const float4 cu = ld4(cum + u);
    const float cua[4] = {cu.x, cu.y, cu.z, cu.w};
    const bool live = ta + 3 >= u && ta < C && u < C;
    float g[4][4];
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int z = 0; z < 4; ++z)
        g[x][z] = live && u + z <= ta + x ? __fmul_rn(sco[s][x][z], expf(cta[x] - cua[z])) : 0.0f;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      if (kTMajor)
        *reinterpret_cast<float4*>(gt + (ta + y) * kStride + u) =
            make_float4(g[y][0], g[y][1], g[y][2], g[y][3]);
      else
        *reinterpret_cast<float4*>(gt + (u + y) * kStride + ta) =
            make_float4(g[0][y], g[1][y], g[2][y], g[3][y]);
    }
  }
}

// Σ over the 16 lanes of a half-warp (the lanes of one row), by a fixed
// butterfly: every lane of the half ends with the same bits
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o /= 2) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Pass 3, one block per (b·h, chunk, strip): blocks r < ti of a chunk own
// columns 64r.. of dq and dk, and write their strip's share of dC to parts
// (B·H, n_chunks, ti, C); blocks ti + r own columns 64r.. of dv. sin is the
// state entering each chunk, dgrad G_c, both (B·H, n_chunks, DK, DV). Warp
// w's lane (ly, lx) owns rows 16w + 8·ly + 0..7 (tokens) and columns 4·lx +
// 0..3 of its strip; the score blocks are gla_scan.cu's.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gla_bwd_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ log_a, const T* __restrict__ dy,
                     const float* __restrict__ sin, const float* __restrict__ dgrad,
                     T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ parts, int S, int H, int DK, int DV, int C,
                     int n_chunks, int ti, int tj) {
  extern __shared__ __align__(16) float smem[];
  float* ta_ = smem;                           // [kTile][kStride]: a token-minor tile
  float* tb_ = ta_ + kTile * kStride;          // [kTile][kStride]: another
  float* st = tb_ + kTile * kStride;           // [kTile][kTile]: a tile of S_in or G_c
  float* gt = st + kTile * kTile;              // [kMaxChunk][kStride]: a gated tile
  float* xs = gt + kMaxChunk * kStride;        // [kMaxChunk][kTile]: a row-major strip
  float* cum = xs + kMaxChunk * kTile;         // [kMaxChunk]
  float* e1 = cum + kMaxChunk;                 // [kMaxChunk]: e^{cum}
  float* e2 = e1 + kMaxChunk;                  // [kMaxChunk]: e^{tot − cum}
  float* ys = ta_;                             // [kMaxChunk][kTile] over both tiles, late
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per = ti + tj, role = blockIdx.x % per;
  const Chunk ch = chunk_of(blockIdx.x / per, S, H, C, n_chunks);
  const long long at = ((long long)ch.bh * n_chunks + ch.c) * DK * DV;
  const float* sc = sin + at;
  const float* gc = dgrad + at;

  // warp 0 sums log a while the others start on the first tiles; the decays
  // follow the first walk's barriers
  if (warp == 0) chunk_cumsum(log_a + ch.base, H, ch.valid, cum);

  const int ly = lane / 16, lx = lane % 16;
  const int r0 = 16 * warp + 8 * ly;                            // this thread's 8 rows
  const int wlo = 16 * warp, wend = wlo < C ? min(wlo + 16, C) : 0;  // this warp's rows
  const int ta = 4 * (tid / 8), ua = 4 * (tid % 8);             // score blocks: rows ta.., τ 32s + ua..
  float sco[4][4][4], inter[8][4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int z = 0; z < 4; ++z) sco[s][x][z] = 0.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int x = 0; x < 4; ++x) inter[r][x] = 0.0f;
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[r][x] = 0.0f;

  if (role < ti) {  // ---- dq and dk, columns i0 .. i0 + 63
    const int i0 = role * kTile;
    // dP = dy·vᵀ and dy·S_inᵀ over dv in tiles of 64
    for (int j0 = 0; j0 < DV; j0 += kTile) {
      __syncthreads();  // the previous tile is consumed
      load_cols<true>(dy, ch.base, H, DV, j0, kTile, ch.valid, ta_, kStride);
      load_cols<true>(v, ch.base, H, DV, j0, kTile, ch.valid, tb_, kStride);
      load_state_tile<true>(sc, DK, DV, i0, j0, st);
      __syncthreads();
      const int w = min(kTile, DV - j0);
      score_blocks(ta_, tb_, w, ta, ua, C, sco);
      rows_by_tile(ta_, st, w, r0, lx, inter);  // dy·S_inᵀ: rows t, columns i
    }
    chunk_decays(cum, C, e1, e2);
    store_gated<false>(sco, cum, ta, ua, C, gt);  // gated dP as gt[τ][t]
    // v·G_cᵀ over dv again
    float kin[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int x = 0; x < 4; ++x) kin[r][x] = 0.0f;
    for (int j0 = 0; j0 < DV; j0 += kTile) {
      __syncthreads();
      load_cols<true>(v, ch.base, H, DV, j0, kTile, ch.valid, tb_, kStride);
      load_state_tile<true>(gc, DK, DV, i0, j0, st);
      __syncthreads();
      rows_by_tile(tb_, st, min(kTile, DV - j0), r0, lx, kin);  // rows τ, columns i
    }
    __syncthreads();
    load_cols<false>(k, ch.base, H, DK, i0, kTile, ch.valid, xs, kTile);   // k[τ][i]
    load_cols<false>(q, ch.base, H, DK, i0, kTile, ch.valid, ys, kTile);   // q[t][i]
    __syncthreads();

    // dq[t][i] = e^{cum_t}·(dy·S_inᵀ) + Σ_{τ ≤ t} dP[t][τ]·k[τ][i]
    gated_by_strip(gt, xs, 0, wend, r0, lx, acc);
    float qdq[8], kdk[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int t = r0 + r;
      float o[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) o[x] = __fadd_rn(__fmul_rn(e1[t], inter[r][x]), acc[r][x]);
      float p = 0.0f;
#pragma unroll
      for (int x = 0; x < 4; ++x) p = __fmaf_rn(ys[t * kTile + 4 * lx + x], o[x], p);
      qdq[r] = p;
      if (t < ch.valid) {
        T* row = dq + (ch.base + (long long)t * H) * DK;
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (i0 + 4 * lx + x < DK) row[i0 + 4 * lx + x] = narrow<T>(o[x]);
      }
    }
    // the gated tile transposed in place, gt[t][τ]: each pair swapped by one thread
    __syncthreads();
    for (int e = tid; e < kMaxChunk * kMaxChunk; e += kThreads) {
      const int r = e / kMaxChunk, c = e % kMaxChunk;
      if (r < c) {
        const float x = gt[r * kStride + c];
        gt[r * kStride + c] = gt[c * kStride + r];
        gt[c * kStride + r] = x;
      }
    }
    __syncthreads();
    // dk[τ][i] = Σ_{t ≥ τ} dP[t][τ]·q[t][i] + e^{tot − cum_τ}·(v·G_cᵀ)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[r][x] = 0.0f;
    gated_by_strip(gt, ys, wlo, C, r0, lx, acc);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int t = r0 + r;
      float o[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) o[x] = __fadd_rn(acc[r][x], __fmul_rn(e2[t], kin[r][x]));
      float p = 0.0f;
#pragma unroll
      for (int x = 0; x < 4; ++x) p = __fmaf_rn(xs[t * kTile + 4 * lx + x], o[x], p);
      kdk[r] = p;
      if (t < ch.valid) {
        T* row = dk + (ch.base + (long long)t * H) * DK;
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (i0 + 4 * lx + x < DK) row[i0 + 4 * lx + x] = narrow<T>(o[x]);
      }
    }
    // this strip's share of dC_t = q_t·dq_t − k_t·dk_t
    float* pp = parts + (((long long)ch.bh * n_chunks + ch.c) * ti + role) * C;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float a = half_warp_sum(qdq[r]), b = half_warp_sum(kdk[r]);
      if (lx == 0 && r0 + r < C) pp[r0 + r] = __fsub_rn(a, b);
    }
  } else {  // ---- dv, columns j0 .. j0 + 63
    const int j0 = (role - ti) * kTile;
    // the scores q·kᵀ and k·G_c over dk in strips of 64
    for (int i0 = 0; i0 < DK; i0 += kTile) {
      __syncthreads();
      load_cols<true>(q, ch.base, H, DK, i0, kTile, ch.valid, ta_, kStride);
      load_cols<true>(k, ch.base, H, DK, i0, kTile, ch.valid, tb_, kStride);
      load_state_tile<false>(gc, DK, DV, i0, j0, st);
      __syncthreads();
      const int w = min(kTile, DK - i0);
      score_blocks(ta_, tb_, w, ta, ua, C, sco);
      rows_by_tile(tb_, st, w, r0, lx, inter);  // k·G_c: rows τ, columns j
    }
    chunk_decays(cum, C, e1, e2);
    store_gated<true>(sco, cum, ta, ua, C, gt);  // gated scores as gt[t][τ]
    load_cols<false>(dy, ch.base, H, DV, j0, kTile, ch.valid, xs, kTile);  // dy[t][j]
    __syncthreads();
    // dv[τ][j] = Σ_{t ≥ τ} P[t][τ]·dy[t][j] + e^{tot − cum_τ}·(k·G_c)
    gated_by_strip(gt, xs, wlo, C, r0, lx, acc);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int t = r0 + r;
      if (t >= ch.valid) continue;
      T* row = dv + (ch.base + (long long)t * H) * DV;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int j = j0 + 4 * lx + x;
        if (j < DV) row[j] = narrow<T>(__fadd_rn(acc[r][x], __fmul_rn(e2[t], inter[r][x])));
      }
    }
  }
}

// Pass 4, one block per (b·h): dlog a_t = ⟨dS_final, S_final⟩ + Σ_{s ≥ t}
// dC_s, dC_s the sum of its strips' shares in strip order; each chunk's
// reverse sum on lane 0 of a warp, token after token from the last, then
// the chunks' carry from the last chunk on one thread. fin holds the carry
// blocks' shares of ⟨dS_final, S_final⟩ (per a b·h), null without a
// cotangent. dlog_a (B, S, H).
__global__ void __launch_bounds__(kThreads)
gla_bwd_dlog_a_kernel(const float* __restrict__ parts, const float* __restrict__ fin,
                      float* __restrict__ dlog_a, int S, int H, int per, int C, int n_chunks,
                      int ti) {
  extern __shared__ __align__(16) float smem[];
  float* red = smem;                    // [kThreads]
  float* buf = red + kThreads;          // [kWarps][kMaxChunk]
  float* tot = buf + kWarps * kMaxChunk;  // [n_chunks]: each chunk's sum
  float* car = tot + n_chunks;            // [n_chunks]: the carry into each chunk
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;

  float dot = 0.0f;
  if (fin) {  // the shares in order a thread, then a fixed tree
    float x = 0.0f;
    for (int p = tid; p < per; p += kThreads) x = __fadd_rn(x, fin[(long long)bh * per + p]);
    dot = block_sum(x, red);
  }

  float* wb = buf + warp * kMaxChunk;
  for (int c = warp; c < n_chunks; c += kWarps) {
    const float* pc = parts + ((long long)bh * n_chunks + c) * ti * C;
    for (int t = lane; t < kMaxChunk; t += 32) {
      float x = 0.0f;
      if (t < C) {
        x = pc[t];
        for (int p = 1; p < ti; ++p) x = __fadd_rn(x, pc[(long long)p * C + t]);
      }
      wb[t] = x;
    }
    __syncwarp();
    if (lane == 0) {
      float acc = -0.0f;
      for (int t = C - 1; t >= 0; --t) wb[t] = acc = __fadd_rn(acc, wb[t]);
      tot[c] = acc;
    }
    __syncwarp();
    const int valid = min(C, S - c * C);
    float* out = dlog_a + (long long)b * S * H + h + (long long)c * C * H;
    for (int t = lane; t < valid; t += 32) out[(long long)t * H] = wb[t];
    __syncwarp();
  }
  __syncthreads();
  if (tid == 0) {
    float carry = dot;
    for (int c = n_chunks - 1; c >= 0; --c) {
      car[c] = carry;
      carry = __fadd_rn(carry, tot[c]);
    }
  }
  __syncthreads();
  float* out = dlog_a + (long long)b * S * H + h;
  for (int t = tid; t < S; t += kThreads)
    out[(long long)t * H] = __fadd_rn(out[(long long)t * H], car[t / C]);
}

template <typename T>
cudaError_t launch_gla_bwd(const T* q, const T* k, const T* v, const float* log_a, const T* dy,
                           const float* states, const float* decay, const float* dfinal,
                           const float* sfinal, T* dq, T* dk, T* dv, float* dlog_a,
                           float* dgrad, float* parts, float* fin, int B, int S, int H, int DK,
                           int DV, int C, cudaStream_t st) {
  const int n_chunks = (S + C - 1) / C;
  const int ti = (DK + kTile - 1) / kTile, tj = (DV + kTile - 1) / kTile;
  const long long chunks = (long long)B * H * n_chunks;
  const long long E = (long long)DK * DV, per = (E + kThreads - 1) / kThreads;
  if (chunks * ti * tj > INT_MAX || chunks * (ti + tj) > INT_MAX || E > INT_MAX ||
      B * H * per > INT_MAX)
    return cudaErrorInvalidValue;
  const int smem1 = (2 * kMaxChunk * kTile + 3 * kMaxChunk) * (int)sizeof(float);
  const int smem3 = kChunkSmem * (int)sizeof(float);
  const long long smem4 = (long long)(kThreads + kWarps * kMaxChunk + 2 * n_chunks) * sizeof(float);
  if (smem4 > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(gla_bwd_state_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(gla_bwd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem3);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(gla_bwd_dlog_a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem4);
  if (e != cudaSuccess) return e;
  gla_bwd_state_kernel<T><<<(unsigned)(chunks * ti * tj), kThreads, smem1, st>>>(
      q, dy, log_a, dgrad, S, H, DK, DV, C, n_chunks, ti * tj, tj);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  gla_bwd_carry_kernel<<<(unsigned)(B * H * per), kThreads, 0, st>>>(
      dgrad, decay, dfinal, sfinal, fin, n_chunks, (int)E, (int)per);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  gla_bwd_chunk_kernel<T><<<(unsigned)(chunks * (ti + tj)), kThreads, smem3, st>>>(
      q, k, v, log_a, dy, states, dgrad, dq, dk, dv, parts, S, H, DK, DV, C, n_chunks, ti, tj);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  gla_bwd_dlog_a_kernel<<<(unsigned)(B * H), kThreads, (size_t)smem4, st>>>(
      parts, dfinal ? fin : nullptr, dlog_a, S, H, (int)per, C, n_chunks, ti);
  return cudaGetLastError();
}

// ---- bf16: the tensor-core family

using bf16 = __nv_bfloat16;

constexpr int kDepth = 32;             // depth of a walked tile: dv (dq/dk strips) or dk (dv strips)
constexpr int kLdD = kDepth + 8;       // its padded row (16 bytes of padding, as mma_tile.cuh's)
constexpr int kLdG = kMaxChunk + 8;    // padded row of the gated dSᵀ tile
constexpr int kSlots = 9;              // 16 × 16 tiles of the causal triangle a warp owns

// bf16 rows are this many elements wide (16 bytes): the wrapper pads q, k,
// v, dy and the gradients to it
__host__ __device__ __forceinline__ int padded(int n) { return (n + 7) / 8 * 8; }

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// Warp w (of four) owns the 16-row tiles w and 7 − w of a chunk: rows τ of
// the transposed products dPᵀ = V·DYᵀ and Sᵀ = K·Qᵀ, of dk, dv and their
// inter terms, and rows t of dq. So the causal triangle's 36 tiles of
// 16 × 16 split 9 a warp: slot s < 8 − w is row tile w against column tile
// w + s, the others row tile 7 − w against column tile s − 1.
__device__ __forceinline__ bool slot_hi(int s, int w) { return s >= 8 - w; }
__device__ __forceinline__ int slot_col(int s, int w) { return slot_hi(s, w) ? s - 1 : w + s; }
__device__ __forceinline__ int slot_row(int s, int w) { return slot_hi(s, w) ? 7 - w : w; }

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// An R × W tile of a (DK, DV) f32 matrix from row r0 and column c0 (zeros
// past DK and DV), copied by cp.async 4 bytes a copy (any DV, any
// alignment), 4 consecutive columns a thread a round, into an f32 staging
// tile while earlier tiles' products run; each thread then splits the
// elements it copied into hi = bf16(x) and lo = bf16(x − hi) (x − hi is
// exact) in two padded bf16 tiles of R × (W + 8): hi + lo is x within 2^-16
// of |x|, and the two products against an exact bf16 operand keep the
// reference's f32 product to about that.
template <int R, int W>
struct SplitTile {
  static constexpr int N = R * W / (4 * kMmaThreads);
  static_assert(R * W % (4 * kMmaThreads) == 0 && W % 4 == 0, "whole rounds of the block");

  static __device__ __forceinline__ void fetch(float* stage, const float* __restrict__ m, int DK,
                                               int DV, int r0, int c0) {
#pragma unroll
    for (int s = 0; s < N; ++s) {
      const int e = 4 * (threadIdx.x + s * kMmaThreads), r = r0 + e / W, c = c0 + e % W;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const bool in = r < DK && c + x < DV;
        cp_async<4>(stage + e + x, in ? m + (long long)r * DV + c + x : m, in ? 4 : 0);
      }
    }
  }

  // after cp_async_wait: this thread's own copies have landed
  static __device__ __forceinline__ void split(const float* stage, bf16* hi, bf16* lo) {
#pragma unroll
    for (int s = 0; s < N; ++s) {
      const int e = 4 * (threadIdx.x + s * kMmaThreads), at = e / W * (W + 8) + e % W;
      const float4 x = *reinterpret_cast<const float4*>(stage + e);
      const float xs[4] = {x.x, x.y, x.z, x.w};
      uint32_t h[2], l[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        h[k] = pack_bf16(xs[2 * k], xs[2 * k + 1]);
        const float2 hf = unpack_bf16(h[k]);
        l[k] = pack_bf16(__fsub_rn(xs[2 * k], hf.x), __fsub_rn(xs[2 * k + 1], hf.y));
      }
      *reinterpret_cast<uint2*>(hi + at) = make_uint2(h[0], h[1]);
      *reinterpret_cast<uint2*>(lo + at) = make_uint2(l[0], l[1]);
    }
  }
};

// cum, e^{cum} and e^{tot − cum} of the chunk (warp 0 sums log a, then
// every thread one token's decays); a block calls it once, after issuing
// its first copies, and reads e1 and e2 after a later barrier.
__device__ __forceinline__ void chunk_prep(const float* __restrict__ la, int H, int valid, int C,
                                           float* cum, float* e1, float* e2) {
  if (threadIdx.x < 32) chunk_cumsum(la, H, valid, cum);
  __syncthreads();
  chunk_decays(cum, C, e1, e2);
}

// tri[s] += the slot's 16 × 16 tile of A·Bᵀ over one 16-deep step ks: a the
// A fragments of the warp's two row tiles, B a tile whose rows are the
// product's columns (tokens); column tiles at or past nt (no token of the
// chunk) are skipped.
template <int LD>
__device__ __forceinline__ void tri_step(float (&tri)[kSlots][2][4], const uint32_t (&a)[2][4],
                                         const bf16* bt, int ks, int w, int lane, int nt) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int u = slot_col(s, w);
    if (u >= nt) continue;
    const bool hi = slot_hi(s, w);
    uint32_t x[4], b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = hi ? a[1][e] : a[0][e];
    b_frag_rows<LD>(b, bt, 2 * u, ks, lane);
    mma_bf16_16816(tri[s][0], x, b[0], b[1]);
    mma_bf16_16816(tri[s][1], x, b[2], b[3]);
  }
}

// acc[r] += rows of the warp's row tile r of A (fragments a) against the
// hi and lo tiles of a split f32 operand, NJ 8-wide column tiles at depth
// step ks: B's rows are the product's columns (kRows, ldmatrix) or its depth
// (ldmatrix.trans).
template <int LD, int NJ, bool kRows>
__device__ __forceinline__ void split_step(float (&acc)[2][NJ][4], const uint32_t (&a)[2][4],
                                           const bf16* hi, const bf16* lo, int ks, int w,
                                           int lane, int nt) {
#pragma unroll
  for (int j = 0; j < NJ; j += 2)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t b[4];
      if (kRows)
        b_frag_rows<LD>(b, p ? lo : hi, j, ks, lane);
      else
        b_frag_trans<LD>(b, p ? lo : hi, j, ks, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if ((r ? 7 - w : w) >= nt) continue;
        mma_bf16_16816(acc[r][j], a[r], b[0], b[1]);
        mma_bf16_16816(acc[r][j + 1], a[r], b[2], b[3]);
      }
    }
}

// The gate by select on a triangle of scores (rows τ, columns t), packed as
// the A fragments of the next product: bf16(bf16(x)·e^{cum_t − cum_τ})
// where t ≥ τ, else 0 (ssm.py:74 rounds the scores, :79 the gated scores;
// under autodiff dP and dS = dP ⊙ gate the same way). e^x is
// 2^(x·log2 e) by one ex2.approx (ptx.cuh): within about 2^-22 + |x|·2^-24
// of expf, a few parts in 10^7 where the gate matters, so a bf16 rounding of
// P or dS moves rarely; expf was a fifth of the chunk pass at hymba's shape
// (H100).
__device__ __forceinline__ void gate_pack(const float (&tri)[kSlots][2][4],
                                          uint32_t (&pt)[kSlots][4], const float* cum, int w,
                                          int lane, int nt) {
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int u = slot_col(s, w), m = slot_row(s, w);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float y[2] = {0.0f, 0.0f};
        if (u < nt) {
          const int tau = 16 * m + g + 8 * r;
          const float ct = cum[tau];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int t = 16 * u + 8 * h + 2 * tq + c;
            const float gate = exp2_approx(__fmul_rn(__fsub_rn(cum[t], ct), kLog2e));
            y[c] = t >= tau ? bf16r(__fmul_rn(bf16r(tri[s][h][2 * r + c]), gate)) : 0.0f;
          }
        }
        pt[s][2 * h + r] = pack_bf16(y[0], y[1]);
      }
  }
}

// acc[r] += X·B over the warp's slots: X the packed gated triangle (rows τ,
// depth t), B the token rows of a tile through ldmatrix.trans, NJ 8-wide
// column tiles.
template <int LD, int NJ>
__device__ __forceinline__ void tri_times(float (&acc)[2][NJ][4], const uint32_t (&pt)[kSlots][4],
                                          const bf16* bt, int w, int lane, int nt) {
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int u = slot_col(s, w);
    if (u >= nt) continue;
    const bool hi = slot_hi(s, w);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t b[4];
      b_frag_trans<LD>(b, bt, j, u, lane);
      if (hi) {
        mma_bf16_16816(acc[1][j], pt[s], b[0], b[1]);
        mma_bf16_16816(acc[1][j + 1], pt[s], b[2], b[3]);
      } else {
        mma_bf16_16816(acc[0][j], pt[s], b[0], b[1]);
        mma_bf16_16816(acc[0][j + 1], pt[s], b[2], b[3]);
      }
    }
  }
}

// The inter term of a gradient, rounded to bf16 (ssm.py's f32 einsums
// against the state, cast to the operand's type under autodiff): the decay
// of the row times the f32 sum, packed by row half.
template <int NJ>
__device__ __forceinline__ void round_inter(uint32_t (&out)[2][NJ][2], const float (&acc)[2][NJ][4],
                                            const float* decay, int w, int lane) {
  const int g = lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float d = decay[16 * (r ? 7 - w : w) + g + 8 * h];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        out[r][j][h] = pack_bf16(__fmul_rn(d, acc[r][j][2 * h]), __fmul_rn(d, acc[r][j][2 * h + 1]));
    }
}

// acc ← the decay of its row times acc, in f32 (an inter term before its rounding)
template <int NJ>
__device__ __forceinline__ void scale_rows(float (&acc)[2][NJ][4], const float* decay, int w,
                                           int lane) {
  const int g = lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float d = decay[16 * (r ? 7 - w : w) + g + 8 * h];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) acc[r][j][2 * h + c] = __fmul_rn(d, acc[r][j][2 * h + c]);
    }
}

// A dq or dk strip's rows of the warp: out = bf16(bf16(inter) + bf16(intra))
// (rows below the chunk's tokens, columns below padded(DK)), and each row's
// share of ⟨x_t, inter + intra⟩, x the strip's q or k columns in shared
// memory, summed over the thread's columns into dot[r][h]: dC's term from
// the sums before any rounding, as the reference's dlog a takes its f32
// terms.
template <int NJ>
__device__ __forceinline__ void strip_out(bf16* __restrict__ out, float (&dot)[2][2],
                                          const float (&inter)[2][NJ][4],
                                          const float (&intra)[2][NJ][4], const bf16* xs,
                                          const Chunk& ch, int i0, int H, int DKp, int w,
                                          int lane) {
  constexpr int kLd = NJ * 8 + 8;
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = 16 * (r ? 7 - w : w) + g + 8 * h;
      bf16* row = out + (ch.base + (long long)t * H) * DKp + i0;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = 8 * j + 2 * tq;
        const float a0 = inter[r][j][2 * h], a1 = inter[r][j][2 * h + 1];
        const float b0 = intra[r][j][2 * h], b1 = intra[r][j][2 * h + 1];
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs + t * kLd + col));
        acc = __fmaf_rn(xv.y, __fadd_rn(a1, b1), __fmaf_rn(xv.x, __fadd_rn(a0, b0), acc));
        if (t < ch.valid && i0 + col < DKp)
          *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(
              __fadd_rn(bf16r(a0), bf16r(b0)), __fadd_rn(bf16r(a1), bf16r(b1)));
      }
      dot[r][h] = acc;
    }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[2][NJ][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j][0] = acc[r][j][1] = acc[r][j][2] = acc[r][j][3] = 0.0f;
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The walk's ring: the bf16 tiles kRing deep (two in flight while one is
// used), the hi/lo tiles and the f32 staging two deep (one split while one
// is used).
constexpr int kRing = 3;

// Shared memory of the chunk pass, in bytes: cum, e^{cum} and e^{tot −
// cum} (3 × 128 floats), then a dv strip's ring of q and k over a dk tile,
// G_c's hi and lo tiles and staging; or a dq/dk strip's ring of v and dy
// over a dv tile, S_in's and G_c's hi and lo tiles and staging. Once the
// walk is done the dv strip's dy columns, or the dq/dk strip's gated dSᵀ
// and its q and k columns, go over them.
template <int WK, int WV>
struct ChunkMma {
  static constexpr int kLdK = WK + 8, kLdV = WV + 8;
  static constexpr int kTiles = 2 * kMaxChunk * kLdD;  // bf16: two token tiles of a ring stage
  static constexpr int kBytesV = 2 * (kRing * kTiles + 2 * 2 * kDepth * kLdV) + 2 * 4 * kDepth * WV;
  static constexpr int kBytesK = 2 * (kRing * kTiles + 2 * 4 * WK * kLdD) + 2 * 4 * 2 * WK * kDepth;
  static constexpr int kBytes = 3 * kMaxChunk * 4 + (kBytesV > kBytesK ? kBytesV : kBytesK);
  static_assert(2 * (kMaxChunk * kLdG + 2 * kMaxChunk * kLdK) <= kBytesK, "dSᵀ, q, k over the walk");
  static_assert(2 * kMaxChunk * kLdV <= kBytesV, "dy over the walk");
};

// A block's dv strip, columns j0 .. j0 + WV − 1: the scores Sᵀ = K·Qᵀ and
// k·G_c over dk in tiles of kDepth (the ring: tile d + 2's copies in flight
// while tile d's products run, tile d + 1 split after them, one barrier a
// tile), then dv = bf16(Pᵀ·dy) + bf16(e^{tot − cum}·(k·G_c)), rounded again
// once summed (ssm.py's two bf16 terms).
template <int WV>
__device__ __forceinline__ void dv_strip(const Chunk& ch, int j0, const bf16* __restrict__ q,
                                         const bf16* __restrict__ k, const float* __restrict__ gc,
                                         const bf16* __restrict__ dy, bf16* __restrict__ dv, int H,
                                         int DK, int DV, int C, const float* __restrict__ la,
                                         bool first, float* cum, float* e1, float* e2,
                                         bf16* sm) {
  constexpr int kLdV = WV + 8, NJ = WV / 8;
  constexpr int kTiles = 2 * kMaxChunk * kLdD, kHiLo = 2 * kDepth * kLdV;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const int DKp = padded(DK), DVp = padded(DV), nt = (ch.valid + 15) / 16;
  const long long rq = (long long)H * DKp, rv = (long long)H * DVp;
  const bf16* qb = q + ch.base * DKp;
  const bf16* kb = k + ch.base * DKp;
  bf16* hilo = sm + kRing * kTiles;                                // [2]: G_c hi, lo
  float* stg = reinterpret_cast<float*>(hilo + 2 * kHiLo);         // [2][kDepth][WV]: G_c
  using Split = SplitTile<kDepth, WV>;
  auto start_tile = [&](int d) {  // dk tile d: q, k and G_c by cp.async
    bf16* s = sm + d % kRing * kTiles;
    const int i0 = d * kDepth;
    load_tile<kMaxChunk, kDepth, true>(s, qb + i0, rq, 0, ch.valid, DKp - i0);
    load_tile<kMaxChunk, kDepth, true>(s + kMaxChunk * kLdD, kb + i0, rq, 0, ch.valid, DKp - i0);
    Split::fetch(stg + d % 2 * kDepth * WV, gc, DK, DV, i0, j0);
    cp_async_commit();
  };
  const int nd = (DKp + kDepth - 1) / kDepth;
  start_tile(0);
  if (nd > 1) start_tile(1);
  if (first) chunk_prep(la, H, ch.valid, C, cum, e1, e2);
  if (nd > 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
  Split::split(stg, hilo, hilo + kDepth * kLdV);

  float tri[kSlots][2][4], vi[2][NJ][4];
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
#pragma unroll
    for (int e = 0; e < 8; ++e) tri[s][e / 4][e % 4] = 0.0f;
  zero(vi);
  for (int d = 0; d < nd; ++d) {
    __syncthreads();  // tile d and its split are every thread's; tile d − 1's buffers are free
    if (d + 2 < nd) start_tile(d + 2);
    const bf16* s = sm + d % kRing * kTiles;
    const bf16* gh = hilo + d % 2 * kHiLo;
#pragma unroll
    for (int ks = 0; ks < kDepth / 16; ++ks) {
      if (d * kDepth + 16 * ks >= DKp) break;  // zero columns past dk
      uint32_t ak[2][4];
      a_frag<kLdD>(ak[0], s + kMaxChunk * kLdD, 16 * w, ks, lane);
      a_frag<kLdD>(ak[1], s + kMaxChunk * kLdD, 16 * (7 - w), ks, lane);
      tri_step<kLdD>(tri, ak, s, ks, w, lane, nt);                                // Sᵀ = K·Qᵀ
      split_step<kLdV, NJ, false>(vi, ak, gh, gh + kDepth * kLdV, ks, w, lane, nt);  // k·G_c
    }
    if (d + 1 < nd) {  // tile d + 1 landed (tile d + 2 may be in flight): split it
      if (d + 2 < nd)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      bf16* nh = hilo + (d + 1) % 2 * kHiLo;
      Split::split(stg + (d + 1) % 2 * kDepth * WV, nh, nh + kDepth * kLdV);
    }
  }
  __syncthreads();  // the walk's buffers are free: dy's columns go over them
  bf16* sy = sm;    // [kMaxChunk][kLdV]
  load_tile<kMaxChunk, WV, true>(sy, dy + ch.base * DVp + j0, rv, 0, ch.valid, DVp - j0);
  cp_async_commit();
  uint32_t vb[2][NJ][2], pt[kSlots][4];
  round_inter(vb, vi, e2, w, lane);
  gate_pack(tri, pt, cum, w, lane, nt);
  cp_async_wait<0>();
  __syncthreads();
  float acc[2][NJ][4];
  zero(acc);
  tri_times<kLdV, NJ>(acc, pt, sy, w, lane, nt);  // Pᵀ·dy
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tau = 16 * (r ? 7 - w : w) + g + 8 * h;
      if (tau >= ch.valid) continue;
      bf16* row = dv + (ch.base + (long long)tau * H) * DVp + j0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = 8 * j + 2 * tq;
        if (j0 + col >= DVp) continue;
        const float2 in = unpack_bf16(vb[r][j][h]);
        *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(
            __fadd_rn(in.x, bf16r(acc[r][j][2 * h])), __fadd_rn(in.y, bf16r(acc[r][j][2 * h + 1])));
      }
    }
}

// A block's dq/dk strip, columns i0 .. i0 + WK − 1: dPᵀ = V·DYᵀ, dy·S_inᵀ
// and v·G_cᵀ over dv in tiles of kDepth (the dv strip's ring), then dk =
// bf16(dSᵀ·q) + bf16(e^{tot − cum}·(v·G_cᵀ)) and, dSᵀ through shared
// memory, dq = bf16(dS·k) + bf16(e^{cum}·(dy·S_inᵀ)), each rounded again
// once summed, and the strip's share of dC_t = q_t·dq_t − k_t·dk_t from the
// sums before any rounding (the 4 lanes of a row added by a fixed
// butterfly) to pp.
template <int WK>
__device__ __forceinline__ void dqdk_strip(const Chunk& ch, int i0, const bf16* __restrict__ q,
                                           const bf16* __restrict__ k, const bf16* __restrict__ v,
                                           const bf16* __restrict__ dy,
                                           const float* __restrict__ sc,
                                           const float* __restrict__ gc, bf16* __restrict__ dq,
                                           bf16* __restrict__ dk, float* __restrict__ pp, int H,
                                           int DK, int DV, int C, const float* __restrict__ la,
                                           bool first, float* cum, float* e1, float* e2,
                                           bf16* sm) {
  constexpr int kLdK = WK + 8, NJ = WK / 8;
  constexpr int kTiles = 2 * kMaxChunk * kLdD, kHiLo = 4 * WK * kLdD, kStg = 2 * WK * kDepth;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const int DKp = padded(DK), DVp = padded(DV), nt = (ch.valid + 15) / 16;
  const long long rq = (long long)H * DKp, rv = (long long)H * DVp;
  const bf16* vb = v + ch.base * DVp;
  const bf16* yb = dy + ch.base * DVp;
  bf16* hilo = sm + kRing * kTiles;                         // [2]: S_in hi, lo, G_c hi, lo
  float* stg = reinterpret_cast<float*>(hilo + 2 * kHiLo);  // [2][2][WK][kDepth]: S_in, G_c
  using Split = SplitTile<WK, kDepth>;
  auto start_tile = [&](int d) {  // dv tile d: v, dy, S_in and G_c by cp.async
    bf16* s = sm + d % kRing * kTiles;
    const int j0 = d * kDepth;
    float* f = stg + d % 2 * kStg;
    load_tile<kMaxChunk, kDepth, true>(s, vb + j0, rv, 0, ch.valid, DVp - j0);
    load_tile<kMaxChunk, kDepth, true>(s + kMaxChunk * kLdD, yb + j0, rv, 0, ch.valid, DVp - j0);
    Split::fetch(f, sc, DK, DV, i0, j0);
    Split::fetch(f + WK * kDepth, gc, DK, DV, i0, j0);
    cp_async_commit();
  };
  auto split = [&](int d) {  // tile d's S_in and G_c into its hi/lo buffer
    bf16* h = hilo + d % 2 * kHiLo;
    const float* f = stg + d % 2 * kStg;
    Split::split(f, h, h + WK * kLdD);
    Split::split(f + WK * kDepth, h + 2 * WK * kLdD, h + 3 * WK * kLdD);
  };
  const int nd = (DVp + kDepth - 1) / kDepth;
  start_tile(0);
  if (nd > 1) start_tile(1);
  if (first) chunk_prep(la, H, ch.valid, C, cum, e1, e2);
  if (nd > 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
  split(0);

  float tri[kSlots][2][4], qi[2][NJ][4], ki[2][NJ][4];
#pragma unroll
  for (int s = 0; s < kSlots; ++s)
#pragma unroll
    for (int e = 0; e < 8; ++e) tri[s][e / 4][e % 4] = 0.0f;
  zero(qi);
  zero(ki);
  for (int d = 0; d < nd; ++d) {
    __syncthreads();  // tile d and its split are every thread's; tile d − 1's buffers are free
    if (d + 2 < nd) start_tile(d + 2);
    const bf16* s = sm + d % kRing * kTiles;
    const bf16* t = hilo + d % 2 * kHiLo;
#pragma unroll
    for (int ks = 0; ks < kDepth / 16; ++ks) {
      if (d * kDepth + 16 * ks >= DVp) break;  // zero columns past dv
      uint32_t av[2][4], ay[2][4];
      a_frag<kLdD>(av[0], s, 16 * w, ks, lane);
      a_frag<kLdD>(av[1], s, 16 * (7 - w), ks, lane);
      a_frag<kLdD>(ay[0], s + kMaxChunk * kLdD, 16 * w, ks, lane);
      a_frag<kLdD>(ay[1], s + kMaxChunk * kLdD, 16 * (7 - w), ks, lane);
      tri_step<kLdD>(tri, av, s + kMaxChunk * kLdD, ks, w, lane, nt);       // dPᵀ = V·DYᵀ
      split_step<kLdD, NJ, true>(qi, ay, t, t + WK * kLdD, ks, w, lane, nt);  // dy·S_inᵀ
      split_step<kLdD, NJ, true>(ki, av, t + 2 * WK * kLdD, t + 3 * WK * kLdD, ks, w, lane,
                                 nt);  // v·G_cᵀ
    }
    if (d + 1 < nd) {  // tile d + 1 landed (tile d + 2 may be in flight): split it
      if (d + 2 < nd)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      split(d + 1);
    }
  }
  __syncthreads();  // the walk's buffers are free: dSᵀ, q's and k's columns go over them
  bf16* dst = sm;                       // [kMaxChunk][kLdG]: dSᵀ
  bf16* sqs = dst + kMaxChunk * kLdG;   // [kMaxChunk][kLdK]: q's columns of the strip
  bf16* sks = sqs + kMaxChunk * kLdK;   // [kMaxChunk][kLdK]: k's
  load_tile<kMaxChunk, WK, true>(sqs, q + ch.base * DKp + i0, rq, 0, ch.valid, DKp - i0);
  load_tile<kMaxChunk, WK, true>(sks, k + ch.base * DKp + i0, rq, 0, ch.valid, DKp - i0);
  cp_async_commit();
  scale_rows(qi, e1, w, lane);  // the inter terms e^{cum}·(dy·S_inᵀ) and e^{tot − cum}·(v·G_cᵀ)
  scale_rows(ki, e2, w, lane);
  uint32_t pt[kSlots][4];
  gate_pack(tri, pt, cum, w, lane, nt);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int u = slot_col(s, w), m = slot_row(s, w);
    if (u >= nt) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(dst + (16 * m + g + 8 * r) * kLdG + 16 * u + 8 * h + 2 * tq) =
            pt[s][2 * h + r];
  }
  cp_async_wait<0>();
  __syncthreads();  // q's and k's columns landed, dSᵀ whole
  float x[2][NJ][4], kd[2][2], qd[2][2];
  zero(x);
  tri_times<kLdK, NJ>(x, pt, sqs, w, lane, nt);  // dSᵀ·q
  strip_out(dk, kd, ki, x, sks, ch, i0, H, DKp, w, lane);
  zero(x);
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // dS·k: rows t of the warp's tile, τ up to its diagonal
    const int m = r ? 7 - w : w;
    if (m >= nt) continue;
    for (int u = 0; u <= m; ++u) {
      uint32_t a[4];
      a_frag_trans<kLdG>(a, dst, 16 * m, u, lane);
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        uint32_t b[4];
        b_frag_trans<kLdK>(b, sks, j, u, lane);
        mma_bf16_16816(x[r][j], a, b[0], b[1]);
        mma_bf16_16816(x[r][j + 1], a, b[2], b[3]);
      }
    }
  }
  strip_out(dq, qd, qi, x, sqs, ch, i0, H, DKp, w, lane);
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = 16 * (r ? 7 - w : w) + g + 8 * h;
      const float d = __fsub_rn(quad_sum(qd[r][h]), quad_sum(kd[r][h]));
      if (tq == 0 && t < C) pp[t] = d;
    }
}

// Pass 1 of the bf16 route, one block per (b·h, chunk, 64-row tile of ΔG,
// run of jr 64-column tiles): ΔG_c = (q ⊙ e^{cum})ᵀ·dy on the tensor cores,
// q ⊙ e^{cum} (f32, as ssm.py:69 promotes it) split once into hi and lo,
// both against each dy tile of the run (a two-stage cp.async ring); warp w
// takes a tile's columns 16w .. 16w + 15, every row tile below DK.
__global__ void __launch_bounds__(kMmaThreads)
gla_bwd_state_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ dy,
                         const float* __restrict__ log_a, float* __restrict__ dgrad, int S, int H,
                         int DK, int DV, int C, int n_chunks, int ti, int tj, int jr) {
  constexpr int kW = 64, kLd = kW + 8, kTileEl = kMaxChunk * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);  // [kMaxChunk]
  float* e1 = cum + kMaxChunk;
  float* e2 = e1 + kMaxChunk;
  bf16* qh = reinterpret_cast<bf16*>(e2 + kMaxChunk);  // [kMaxChunk][kLd]: q ⊙ e^{cum}, hi
  bf16* ql = qh + kTileEl;                             // lo
  bf16* ys = ql + kTileEl;                             // two stages of dy
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32, g = lane / 4, tq = lane % 4;
  const int groups = (tj + jr - 1) / jr, per = ti * groups, tile = blockIdx.x % per;
  const Chunk ch = chunk_of(blockIdx.x / per, S, H, C, n_chunks);
  const int i0 = tile / groups * kW, jt0 = tile % groups * jr, jt1 = min(tj, jt0 + jr);
  const int DKp = padded(DK), DVp = padded(DV), nk = (ch.valid + 15) / 16;
  auto load_y = [&](int jt) {
    const int j0 = jt * kW;
    load_tile<kMaxChunk, kW, true>(ys + (jt - jt0) % 2 * kTileEl, dy + ch.base * DVp + j0,
                                   (long long)H * DVp, 0, ch.valid, DVp - j0);
  };
  load_tile<kMaxChunk, kW, true>(qh, q + ch.base * DKp + i0, (long long)H * DKp, 0, ch.valid,
                                 DKp - i0);
  load_y(jt0);
  cp_async_commit();
  chunk_prep(log_a + ch.base, H, ch.valid, C, cum, e1, e2);
  cp_async_wait<0>();
  __syncthreads();
  const int cw = min(kW, DKp - i0) / 8;  // 16-byte chunks of a row below DK
  for (int c = tid; c < kMaxChunk * cw; c += kMmaThreads) {  // 8 elements a thread a step
    const int r = c / cw, at = r * kLd + c % cw * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(qh + at);
    const bf16* x = reinterpret_cast<const bf16*>(&raw);
    uint4 hv, lv;
    bf16* hp = reinterpret_cast<bf16*>(&hv);
    bf16* lp = reinterpret_cast<bf16*>(&lv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float y = __fmul_rn(__bfloat162float(x[e]), e1[r]);
      hp[e] = __float2bfloat16_rn(y);
      lp[e] = __float2bfloat16_rn(__fsub_rn(y, __bfloat162float(hp[e])));
    }
    *reinterpret_cast<uint4*>(qh + at) = hv;
    *reinterpret_cast<uint4*>(ql + at) = lv;
  }
  __syncthreads();

  float* dg = dgrad + ((long long)ch.bh * n_chunks + ch.c) * DK * DV;
  const int rows = min(kW, DK - i0);
  for (int jt = jt0; jt < jt1; ++jt) {
    if (jt > jt0) {
      cp_async_wait<0>();
      __syncthreads();  // dy tile jt landed; tile jt − 1's stage is free
    }
    if (jt + 1 < jt1) {
      load_y(jt + 1);
      cp_async_commit();
    }
    bf16* y = ys + (jt - jt0) % 2 * kTileEl;
    const int j0 = jt * kW;
    float acc[kW / 16][2][4];
#pragma unroll
    for (int mt = 0; mt < kW / 16; ++mt)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[mt][e / 4][e % 4] = 0.0f;
    if (j0 + 16 * w < DVp) {
      for (int ks = 0; ks < nk; ++ks) {
        uint32_t b[4];
        b_frag_trans<kLd>(b, y, 2 * w, ks, lane);
#pragma unroll
        for (int mt = 0; mt < kW / 16; ++mt) {
          if (i0 + 16 * mt < DKp) {
            uint32_t a[4];
            a_frag_trans<kLd>(a, qh, 16 * mt, ks, lane);
            mma_bf16_16816(acc[mt][0], a, b[0], b[1]);
            mma_bf16_16816(acc[mt][1], a, b[2], b[3]);
            a_frag_trans<kLd>(a, ql, 16 * mt, ks, lane);
            mma_bf16_16816(acc[mt][0], a, b[0], b[1]);
            mma_bf16_16816(acc[mt][1], a, b[2], b[3]);
          }
        }
      }
    }
    // the tile through shared memory (over dy's consumed stage), then to
    // dgrad a row at a time, consecutive threads on consecutive columns
    __syncthreads();
    float* out = reinterpret_cast<float*>(y);  // [kW][kW + 4]
#pragma unroll
    for (int mt = 0; mt < kW / 16; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(out + (16 * mt + g + 8 * r) * (kW + 4) + 16 * w + 8 * h +
                                     2 * tq) = make_float2(acc[mt][h][2 * r], acc[mt][h][2 * r + 1]);
    __syncthreads();
    const int cols = min(kW, DV - j0);
    for (int e = tid; e < rows * kW; e += kMmaThreads) {
      const int r = e / kW, c = e % kW;
      if (c < cols) dg[(long long)(i0 + r) * DV + j0 + c] = out[r * (kW + 4) + c];
    }
  }
}

// Pass 3 of the bf16 route, one block per (b·h, chunk, strip): with
// `paired`, block r of a chunk takes dv strip r (if r < nb) and then dq/dk
// strip r (if r < na); else blocks r < na take dq/dk strip r and the rest dv
// strip r − na. sin is the state entering each chunk, dgrad G_c.
template <int WK, int WV>
__global__ void __launch_bounds__(kMmaThreads, 2)
gla_bwd_chunk_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ log_a,
                         const bf16* __restrict__ dy, const float* __restrict__ sin,
                         const float* __restrict__ dgrad, bf16* __restrict__ dq,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ parts,
                         int S, int H, int DK, int DV, int C, int n_chunks, int na, int nb,
                         int paired) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cum = reinterpret_cast<float*>(smem_raw);  // [kMaxChunk]
  float* e1 = cum + kMaxChunk;                       // e^{cum}
  float* e2 = e1 + kMaxChunk;                        // e^{tot − cum}
  bf16* sm = reinterpret_cast<bf16*>(e2 + kMaxChunk);
  const int per = paired ? max(na, nb) : na + nb, r = blockIdx.x % per;
  const Chunk ch = chunk_of(blockIdx.x / per, S, H, C, n_chunks);
  const long long at = ((long long)ch.bh * n_chunks + ch.c) * DK * DV;
  const float* la = log_a + ch.base;
  const int sv = paired ? (r < nb ? r : -1) : r - na;  // this block's dv strip, or < 0
  const int sk = r < na ? r : -1;                      // its dq/dk strip, or −1
  if (sv >= 0)
    dv_strip<WV>(ch, sv * WV, q, k, dgrad + at, dy, dv, H, DK, DV, C, la, true, cum, e1, e2, sm);
  if (sk >= 0) {
    if (sv >= 0) __syncthreads();  // the dv strip is done with shared memory
    float* pp = parts + (((long long)ch.bh * n_chunks + ch.c) * na + sk) * C;
    dqdk_strip<WK>(ch, sk * WK, q, k, v, dy, sin + at, dgrad + at, dq, dk, pp, H, DK, DV, C, la,
                   sv < 0, cum, e1, e2, sm);
  }
}

// The bf16 route's operands onto its rows: blockIdx.y picks src0 → dst0 or
// src1 → dst1 (null: none), each rows × width elements (any alignment)
// into rows × padded(width) on 16-byte boundaries, zeros past width; a
// thread builds one 16-byte chunk.
__global__ void __launch_bounds__(256)
gla_bwd_pad_kernel(const bf16* __restrict__ src0, bf16* __restrict__ dst0,
                   const bf16* __restrict__ src1, bf16* __restrict__ dst1, long long rows,
                   int width) {
  const bf16* src = blockIdx.y ? src1 : src0;
  bf16* dst = blockIdx.y ? dst1 : dst0;
  const int ch = padded(width) / 8;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (dst == nullptr || c >= rows * ch) return;
  const long long r = c / ch;
  const int j0 = (int)(c % ch) * 8;
  uint4 out;
  bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    o[e] = j0 + e < width ? src[r * width + j0 + e] : __float2bfloat16_rn(0.0f);
  reinterpret_cast<uint4*>(dst)[c] = out;
}

template <int WK, int WV>
cudaError_t launch_chunk_mma(const bf16* q, const bf16* k, const bf16* v, const float* log_a,
                             const bf16* dy, const float* states, const float* dgrad, bf16* dq,
                             bf16* dk, bf16* dv, float* parts, int S, int H, int DK, int DV,
                             int C, int n_chunks, long long chunks, int na, int nb, int paired,
                             cudaStream_t st) {
  constexpr int kBytes = ChunkMma<WK, WV>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gla_bwd_chunk_mma_kernel<WK, WV>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return attr;
  const long long blocks = chunks * (paired ? max(na, nb) : na + nb);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  gla_bwd_chunk_mma_kernel<WK, WV><<<(unsigned)blocks, kMmaThreads, kBytes, st>>>(
      q, k, v, log_a, dy, states, dgrad, dq, dk, dv, parts, S, H, DK, DV, C, n_chunks, na, nb,
      paired);
  return cudaGetLastError();
}

// The bf16 route: q, k, v, dy, dq, dk and dv rows padded to padded(DK) and
// padded(DV) elements, 16-byte aligned; wk × wv one of the chunk pass's
// instances.
cudaError_t launch_gla_bwd_mma(const bf16* q, const bf16* k, const bf16* v, const float* log_a,
                               const bf16* dy, const float* states, const float* decay,
                               const float* dfinal, const float* sfinal, bf16* dq, bf16* dk,
                               bf16* dv, float* dlog_a, float* dgrad, float* parts, float* fin,
                               int B, int S, int H, int DK, int DV, int C, int wk, int wv,
                               int paired, cudaStream_t st) {
  const int n_chunks = (S + C - 1) / C;
  const int DKp = padded(DK), DVp = padded(DV);
  const int ti = (DKp + 63) / 64, tj = (DVp + 63) / 64;
  const int na = (DKp + wk - 1) / wk, nb = (DVp + wv - 1) / wv;
  const long long chunks = (long long)B * H * n_chunks;
  const long long E = (long long)DK * DV, per = (E + kThreads - 1) / kThreads;
  if (chunks * ti * tj > INT_MAX || E > INT_MAX || B * H * per > INT_MAX)
    return cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(dy) || !aligned16(dq) ||
      !aligned16(dk) || !aligned16(dv))
    return cudaErrorMisalignedAddress;
  constexpr int smem1 = 3 * kMaxChunk * 4 + 4 * kMaxChunk * 72 * 2;
  // ΔG's column tiles a block: enough blocks for two an SM where the chunks
  // and row tiles alone are fewer (the mLSTM's 128 at B 2, S 256, H 4)
  const long long rows = chunks * ti;
  long long groups = (2LL * sm_count() + rows - 1) / rows;
  groups = groups < 1 ? 1 : (groups > tj ? tj : groups);
  const int jr = (int)((tj + groups - 1) / groups);
  const long long smem4 = (long long)(kThreads + kWarps * kMaxChunk + 2 * n_chunks) * sizeof(float);
  if (smem4 > kMaxSmem) return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gla_bwd_state_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (attr != cudaSuccess) return attr;
  cudaError_t e = cudaFuncSetAttribute(gla_bwd_dlog_a_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem4);
  if (e != cudaSuccess) return e;
  gla_bwd_state_mma_kernel<<<(unsigned)(rows * ((tj + jr - 1) / jr)), kMmaThreads, smem1, st>>>(
      q, dy, log_a, dgrad, S, H, DK, DV, C, n_chunks, ti, tj, jr);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  gla_bwd_carry_kernel<<<(unsigned)(B * H * per), kThreads, 0, st>>>(
      dgrad, decay, dfinal, sfinal, fin, n_chunks, (int)E, (int)per);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (wk == 16 && wv == 32)
    e = launch_chunk_mma<16, 32>(q, k, v, log_a, dy, states, dgrad, dq, dk, dv, parts, S, H, DK,
                                 DV, C, n_chunks, chunks, na, nb, paired, st);
  else if (wk == 16 && wv == 64)
    e = launch_chunk_mma<16, 64>(q, k, v, log_a, dy, states, dgrad, dq, dk, dv, parts, S, H, DK,
                                 DV, C, n_chunks, chunks, na, nb, paired, st);
  else if (wk == 32 && wv == 32)
    e = launch_chunk_mma<32, 32>(q, k, v, log_a, dy, states, dgrad, dq, dk, dv, parts, S, H, DK,
                                 DV, C, n_chunks, chunks, na, nb, paired, st);
  else if (wk == 32 && wv == 64)
    e = launch_chunk_mma<32, 64>(q, k, v, log_a, dy, states, dgrad, dq, dk, dv, parts, S, H, DK,
                                 DV, C, n_chunks, chunks, na, nb, paired, st);
  else
    return cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  gla_bwd_dlog_a_kernel<<<(unsigned)(B * H), kThreads, (size_t)smem4, st>>>(
      parts, dfinal ? fin : nullptr, dlog_a, S, H, (int)per, C, n_chunks, na);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The floats of repro_gla_backward's scratch `parts` where the chunk pass
// has `strips` strips of dk (⌈DK/64⌉ for f32, ⌈padded(DK)/wk⌉ for bf16).
long long repro_gla_bwd_parts(int B, int S, int H, int DK, int DV, int C, int strips) {
  if (S == 0 || C < 1) return 0;
  const long long bh = (long long)B * H;
  return bh * ((S + C - 1) / C) * strips * C + bh * (((long long)DK * DV + kThreads - 1) / kThreads);
}

// q, k (B, S, H, DK), v and dy (B, S, H, DV): device pointers to contiguous
// arrays of one type, f32 or (bf16 = 1) bf16 with rows padded to
// padded(DK), padded(DV) elements on 16-byte boundaries; log_a (B, S, H)
// f32; states (B, H, ⌈S/C⌉, DK, DV), the state entering each chunk, and
// decay (B, H, ⌈S/C⌉), each chunk's e^{tot}, both f32 as repro_gla_forward
// leaves them in its scratch; dfinal, the final state's cotangent, and
// sfinal, the final state, (B, H, DK, DV) f32, or both null for no
// cotangent. Writes dq, dk and dv in the input type (bf16 rows padded as
// q's and v's) and dlog_a (B, S, H) f32; scratch dgrad (B, H, ⌈S/C⌉, DK,
// DV) f32 and parts, f32, of repro_gla_bwd_parts floats: (B, H, ⌈S/C⌉,
// strips, C) for dC's shares, then (B, H, ⌈DK·DV/256⌉) for ⟨dS_final,
// S_final⟩'s. C is the forward's chunk (1 ≤ C ≤ 128); any DK and DV. bf16
// takes the chunk pass's strips wk × wv (16 or 32 × 32 or 64), paired or
// not; f32 ignores them. Returns the first failed launch's CUDA error, or 0.
// Copies bf16 (rows, width) arrays src0 and src1 (src1 and dst1 may be
// null) of any alignment into dst0 and dst1, (rows, padded(width)) on
// 16-byte boundaries, zeros past width, in one launch: the bf16 route's q
// and k, or v and dy, where their rows are off its 16-byte copies. Returns
// the launch's CUDA error, or 0.
int repro_gla_bwd_pad(const void* src0, void* dst0, const void* src1, void* dst1, long long rows,
                      int width, void* stream) {
  if (rows == 0) return cudaSuccess;
  if (!aligned16(dst0) || (dst1 && !aligned16(dst1))) return cudaErrorMisalignedAddress;
  const long long chunks = rows * (padded(width) / 8), blocks = (chunks + 255) / 256;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gla_bwd_pad_kernel<<<dim3((unsigned)blocks, dst1 ? 2 : 1), 256, 0, st>>>(
      static_cast<const bf16*>(src0), static_cast<bf16*>(dst0), static_cast<const bf16*>(src1),
      static_cast<bf16*>(dst1), rows, width);
  return cudaGetLastError();
}

int repro_gla_backward(const void* q, const void* k, const void* v, const float* log_a,
                       const void* dy, const float* states, const float* decay,
                       const float* dfinal, const float* sfinal, void* dq, void* dk, void* dv,
                       float* dlog_a, float* dgrad, float* parts, int B, int S, int H, int DK,
                       int DV, int C, int bf16_in, int wk, int wv, int paired, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || S == 0) return cudaSuccess;
  if (C < 1 || C > kMaxChunk || (dfinal == nullptr) != (sfinal == nullptr))
    return cudaErrorInvalidValue;
  const long long chunks = (long long)B * H * ((S + C - 1) / C);
  if (bf16_in) {
    if (wk < 1 || wv < 1) return cudaErrorInvalidValue;
    float* fin = parts + chunks * ((padded(DK) + wk - 1) / wk) * C;
    return launch_gla_bwd_mma(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                              static_cast<const bf16*>(v), log_a, static_cast<const bf16*>(dy),
                              states, decay, dfinal, sfinal, static_cast<bf16*>(dq),
                              static_cast<bf16*>(dk), static_cast<bf16*>(dv), dlog_a, dgrad, parts,
                              fin, B, S, H, DK, DV, C, wk, wv, paired, st);
  }
  float* fin = parts + chunks * ((DK + kTile - 1) / kTile) * C;
  return launch_gla_bwd<float>(static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), log_a,
                               static_cast<const float*>(dy), states, decay, dfinal, sfinal,
                               static_cast<float*>(dq), static_cast<float*>(dk),
                               static_cast<float*>(dv), dlog_a, dgrad, parts, fin, B, S, H, DK,
                               DV, C, st);
}

}  // extern "C"
