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
// at hymba-1.5b's training shape (B = 4, S = 512, H = 25, dk = 16, dv = 64,
// bf16) 1.58 GFLOP, 23.6 µs at the 67 TFLOP/s of f32 on the CUDA cores,
// where they run here (TF32 would change the bits), against 29.1 MB of
// operands, states and results, 8.7 µs at 3.35 TB/s; at xLSTM's mLSTM
// (B = 2, S = 256, H = 4, dk = 512, dv = 513, bf16) 4.98 GFLOP, 74 µs,
// against 48.3 MB (the states entering the chunks most of it), 14.4 µs. On
// the CUDA cores the operations bound both (at the tensor cores' 989
// TFLOP/s of bf16 the bytes would). Four launches, each gradient element
// written by one block, no atomics, the same bits on every run:
//
// * gla_bwd_state_kernel, one block per (b·h, chunk, 64 × 64 tile of ΔG):
//   ΔG_c's tile, a 4 × 4 block a thread summed over the chunk's tokens in
//   order (gla_wide_state_kernel's design, q ⊙ e^{cum} and dy in place of
//   k ⊙ e^{tot−cum} and v).
// * gla_bwd_carry_kernel, one thread per (b·h, element): G_c from the last
//   chunk to the first, written over ΔG_c, product and sum rounded apart;
//   with a cotangent each block's share of ⟨dS_final, S_final⟩ too.
// * gla_bwd_chunk_kernel, one block per (b·h, chunk, strip) of two kinds.
//   A block of the first kind owns 64 columns of dk: it walks dv in tiles
//   of 64, summing dP (a thread's four 4 t × 4 τ blocks of the lower
//   triangle) and dy·S_inᵀ (8 rows × 4 columns a thread), gates dP into
//   shared memory, walks dv again for v·G_cᵀ, then takes dq = gated dP·k
//   and, the gated tile transposed in place, dk = its transpose·q: dq and
//   dk whole, summed over every column of dv in the block, and its strip's
//   share of dC_t to a scratch row (the 16 lanes of a row added by a fixed
//   butterfly). A block of the second kind owns 64 columns of dv: it walks
//   dk in strips of 64 for the scores q·kᵀ and k·G_c, gates the scores
//   into shared memory and takes dv. dP is built again by each strip of dk
//   and the scores by each tile of dv, as the forward's wide output pass
//   builds its scores: at 512 × 513, 8 and 9 times a chunk's 128·128·512
//   pairs, against the inter terms' 128·512·513 each. 182 KB of shared
//   memory, one block an SM; loads element by element, any width and
//   alignment.
// * gla_bwd_dlog_a_kernel, one block per (b, h): ⟨dS_final, S_final⟩ from
//   the carry blocks' shares by a fixed tree, each token's dC from its
//   strips in strip order, a warp a
//   chunk for the reverse sum (lane 0 adding token after token, as the
//   forward's cumsum), then the chunks' carry on one thread.
//
// Arithmetic, as the forward's: inputs widened to f32, every sum in f32, the
// gate by select (an e^{cum_t − cum_τ} that overflows above the diagonal
// never meets a 0); padding past S has log a = 0 and zeroed q, k, v and dy.
// dq, dk and dv are rounded once to the input type, dlog a stays f32 (the
// wrapper gives it log a's type); dC takes dq and dk before that rounding.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;          // tokens a chunk at most
constexpr int kStride = kMaxChunk + 4;  // row stride of the token-minor tiles (16-byte rows)
constexpr int kTile = 64;               // state tile rows and columns; a strip of dk or dv
constexpr int kRowsPerWarp = kMaxChunk / kWarps;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

}  // namespace

extern "C" {

// q, k (B, S, H, DK), v and dy (B, S, H, DV): device pointers to contiguous
// arrays of one type (f32, or bf16 when bf16 is 1); log_a (B, S, H) f32;
// states (B, H, ⌈S/C⌉, DK, DV), the state entering each chunk, and decay
// (B, H, ⌈S/C⌉), each chunk's e^{tot}, both f32 as repro_gla_forward leaves
// them in its scratch; dfinal, the final state's cotangent, and sfinal, the
// final state, (B, H, DK, DV) f32, or both null for no cotangent. Writes dq,
// dk (B, S, H, DK) and dv (B, S, H, DV) in the input type and dlog_a (B, S,
// H) f32; scratch dgrad (B, H, ⌈S/C⌉, DK, DV) f32 and parts, f32, of
// repro_gla_bwd_parts(B, S, H, DK, DV, C) floats: (B, H, ⌈S/C⌉, ⌈DK/64⌉, C)
// for dC's shares, then (B, H, ⌈DK·DV/256⌉) for ⟨dS_final, S_final⟩'s. C
// is the forward's chunk (1 ≤ C ≤ 128); any DK and DV. Returns the first
// failed launch's CUDA error, or 0.
// The floats of repro_gla_backward's scratch `parts`.
long long repro_gla_bwd_parts(int B, int S, int H, int DK, int DV, int C) {
  if (S == 0 || C < 1) return 0;
  const long long bh = (long long)B * H;
  return bh * ((S + C - 1) / C) * ((DK + kTile - 1) / kTile) * C +
         bh * (((long long)DK * DV + kThreads - 1) / kThreads);
}

int repro_gla_backward(const void* q, const void* k, const void* v, const float* log_a,
                       const void* dy, const float* states, const float* decay,
                       const float* dfinal, const float* sfinal, void* dq, void* dk, void* dv,
                       float* dlog_a, float* dgrad, float* parts, int B, int S, int H, int DK,
                       int DV, int C, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || S == 0) return cudaSuccess;
  if (C < 1 || C > kMaxChunk || (dfinal == nullptr) != (sfinal == nullptr))
    return cudaErrorInvalidValue;
  float* fin = parts + (long long)B * H * ((S + C - 1) / C) * ((DK + kTile - 1) / kTile) * C;
  if (bf16) {
    using T = __nv_bfloat16;
    return launch_gla_bwd<T>(static_cast<const T*>(q), static_cast<const T*>(k),
                             static_cast<const T*>(v), log_a, static_cast<const T*>(dy), states,
                             decay, dfinal, sfinal, static_cast<T*>(dq), static_cast<T*>(dk),
                             static_cast<T*>(dv), dlog_a, dgrad, parts, fin, B, S, H, DK, DV, C,
                             st);
  }
  return launch_gla_bwd<float>(static_cast<const float*>(q), static_cast<const float*>(k),
                               static_cast<const float*>(v), log_a,
                               static_cast<const float*>(dy), states, decay, dfinal, sfinal,
                               static_cast<float*>(dq), static_cast<float*>(dk),
                               static_cast<float*>(dv), dlog_a, dgrad, parts, fin, B, S, H, DK,
                               DV, C, st);
}

}  // extern "C"
