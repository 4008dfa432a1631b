// Chunked gated-linear-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gla_scan.py::gla_forward
// (pallas_call :106, inner kernel _gla_kernel :28). The recurrence
//     h_t = a_t · h_{t−1} + k_t v_tᵀ,   y_t = q_tᵀ h_t
// is computed per chunk of C tokens (C = min(128, S)) as
//     y = (q ⊙ e^{cum}) · S  +  ((q kᵀ) ⊙ tril e^{cum_t − cum_τ}) · v
//     S ← e^{tot} · S  +  (k ⊙ e^{tot − cum})ᵀ · v
// with cum the inclusive f32 cumsum of log a within the chunk and tot its
// last entry. On the TPU the grid's chunk axis runs in order and carries S
// in VMEM scratch. Unlike the TPU kernel this one also writes the final S:
// the model's prefill keeps it as the mamba head's decode state.
//
// Bound on an H100 at the hymba-1.5b serving shape (B = 4, S = 512,
// H = 25, dk = 16, dv = 64, bf16): q, k, v, log a, y and the state are
// 17 MB, 5.1 µs at 3.35 TB/s; the chunked products (chip_smoke.py's
// gla_work) are 0.74 GFLOP, 0.75 µs at 989 TFLOP/s bf16 and 11 µs at the
// 67 TFLOP/s of f32 on the CUDA cores, where they run here (the gated
// scores are f32, and TF32 would change the bits). One block per (batch,
// head) walking its chunks in order, as the TPU grid walks them, runs 100
// blocks on 132 SMs, one an SM (the whole 128 × 128 gate tile is 64 KB),
// with two shared loads per fused multiply-add: 0.272 ms alone. Instead:
//
// * Chunks in parallel. Given the state entering a chunk, its output, and
//   its own increment ΔS_c = (k ⊙ e^{tot−cum})ᵀ·v, depend on no other
//   chunk; only the carry S_c = S_{c−1}·e^{tot_c} + ΔS_c is sequential,
//   dk × dv = 1 024 floats a step. Three launches in one call:
//   gla_chunk_state_kernel (one block per (b, h, chunk): ΔS_c, a 4 × 4
//   tile a thread over a quarter of the chunk, and e^{tot_c}),
//   gla_carry_kernel (one thread per (b, h) and state element walks the
//   chunks in order, eight chunks' loads in flight, writing the state
//   entering each chunk over its ΔS, and the final state), and
//   gla_chunk_out_kernel (one block per (b, h, chunk): y). 400 blocks at
//   S = 512 and 1 600 at S = 2048. (A cluster over the chunks would pass S
//   through distributed shared memory, but it holds 8 chunks, 16 past the
//   portable size, and chains one cluster barrier a chunk; the carry pass
//   costs one short launch at any S.)
// * Products tiled in registers. In gla_chunk_out_kernel a thread owns
//   8 rows × 4 columns of y: per token τ it reads two 16-byte words of the
//   gated scores and one of v for 32 fused multiply-adds, and per key
//   width i two of q and one of S for the inter term's 32. The gated
//   scores are built a strip of 32 τ at a time, double-buffered (2 × 16 KB,
//   not the 64 KB tile; one barrier a strip), 4 t × 4 τ a thread from
//   16-byte loads of q and k stored token-minor; tiles wholly above the
//   diagonal are not computed, and a warp skips the strips past its last
//   row. 88 KB of shared memory and 128 registers a thread: two blocks an
//   SM.
// * Loads in flight together. Every thread issues all of its loads of a
//   tile (16-byte vectors where the widths and pointers allow, else one
//   element of 16 rows) before it stores any to shared memory: one
//   element at a time, one row after another, the loads' latency set the
//   time of both chunk passes.
// * The cumsum of log a stays sequential, 127 dependent adds on lane 0 of
//   warp 0, while the other warps load the chunk and other blocks share
//   the SM.
//
// * Past one block's shared memory (repro_gla_smem above kMaxSmem: from
//   dk × dv = 128 × 64 or 96 × 96 on; xLSTM's mLSTM is 512 × 513), the same
//   three passes over tiles (gla_wide_state_kernel, gla_carry_kernel,
//   gla_wide_out_kernel). ΔS's rows depend only on their own column of k
//   and its columns only on their own column of v, so the state pass takes
//   one block per (b·h, chunk, 64 × 64 tile of ΔS): the chunk's two strips
//   of k and v, 65 KB. The output pass takes one block per (b·h, chunk, 64
//   columns of y) and streams q, k and S_in through shared memory in dk
//   strips of 32, summing the chunk's 128 × 128 scores and the inter term
//   in registers; the gate is applied once the scores are whole, then the
//   gated tile (64 KB) meets the block's 64 columns of v. Each column tile
//   builds the scores again: at 512 × 513, 9 times 128·128·512 fused
//   multiply-adds a chunk, against the inter term's 128·512·513. Loads are
//   element by element, so any width and any alignment go. 140 KB of shared
//   memory, one block an SM. The scratch dstate is (B, H, ⌈S/C⌉, dk, dv) f32
//   on either path: 268 MB at B = 4, S = 2048, H = 4 and 512 × 513.
//
// Arithmetic, as the reference's kernel: inputs widened to f32, every sum
// in f32; the intra-chunk gate built by select, 0 above the diagonal, so
// that an e^{cum_t − cum_τ} that overflows for τ > t never meets a 0
// (inf · 0 is NaN); padding tokens past S have log a = 0 and zeroed q, k
// and v, so they leave S untouched. The carry is S·e^{tot} + ΔS, product
// and sum rounded apart, as the plain version chains it. y is rounded once
// to the input type; the state stays f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "device.cuh"
#include "ptx.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;          // tokens a chunk at most: the scan's 32 lanes × 4
constexpr int kStride = kMaxChunk + 4;  // row stride of the token-minor tiles (16-byte rows)
constexpr int kStrip = 32;              // gate columns τ built at a time
constexpr int kCols = 64;               // y columns a pass: 16 lanes × 4
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

// four consecutive outputs, each rounded once to T, in one store (p aligned
// to the four)
__device__ __forceinline__ void store4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&o)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]), hi = __floats2bfloat162_rn(o[2], o[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// One warp: cum[0..128) = the inclusive cumsum of la[t·H] over the chunk's
// `valid` tokens (0 past them). The lanes load, then lane 0 adds in token
// order, as gla_forward_plain does, eight tokens a 32-byte load so that the
// loads run ahead of the dependent adds; the block's other warps load the
// chunk meanwhile. (A warp scan's tree order, tried, took one element of
// the chunk-invariance test in tests/test_torch_gla_scan.py past its
// bound.) cum must be 16-byte aligned.
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
      float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) x[r] = acc = __fadd_rn(acc, x[r]);
      *reinterpret_cast<float4*>(cum + t0) = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(cum + t0 + 4) = make_float4(x[4], x[5], x[6], x[7]);
    }
  }
  __syncwarp();
}

// The chunk of block `blk`: its (b·h), its index, its first token, its
// tokens before S, and `base`, the row of (b, h)'s token 0 in the
// (B, S, H) layout (token t is row base + t·H).
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
  ch.base = (long long)b * S * H + h + (long long)ch.tok0 * H;  // the chunk's first token
  return ch;
}

// Every row r < kMaxChunk of a tile of `width` columns whose token t sits
// at src + (base + t·H)·width, widened to f32 into dst[r·ld + j] (or, with
// kTransposed, dst[j·ld + r]), zeros past `valid` rows and past `width` up
// to `wpad` columns. Warp w takes rows w, w + 8, ...; a lane loads its
// column of all of them before storing any, so their latencies overlap.
template <bool kTransposed, typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, long long base, int H,
                                          int width, int wpad, int valid, float* dst, int ld) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int j = lane; j < wpad; j += 32) {
    float x[kRowsPerWarp];
#pragma unroll
    for (int s = 0; s < kRowsPerWarp; ++s) {
      const int r = warp + s * kWarps;
      x[s] = r < valid && j < width ? widen(src[(base + (long long)r * H) * width + j]) : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < kRowsPerWarp; ++s) {
      const int r = warp + s * kWarps;
      dst[kTransposed ? j * ld + r : r * ld + j] = x[s];
    }
  }
}

// The same with 16-byte loads: each row is `width` elements, a multiple of
// 16 / sizeof(T), and starts on a 16-byte boundary. A thread loads up to
// kVecBatch vectors before it stores any.
constexpr int kVecBatch = 8;

__device__ __forceinline__ void widen8(const uint4& u, const __nv_bfloat16*, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void widen8(const uint4& u, const float*, float (&x)[8]) {
  const float4 f = *reinterpret_cast<const float4*>(&u);
  x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
}

template <bool kTransposed, typename T>
__device__ __forceinline__ void load_rows_vec(const T* __restrict__ src, long long base, int H,
                                              int width, int valid, float* dst, int ld) {
  constexpr int E = 16 / sizeof(T);  // elements a vector
  const int nv = width / E, total = kMaxChunk * nv;
  for (int v0 = threadIdx.x; v0 < total; v0 += kVecBatch * kThreads) {
    uint4 buf[kVecBatch];
#pragma unroll
    for (int b = 0; b < kVecBatch; ++b) {
      const int vi = v0 + b * kThreads, r = vi / nv, j = (vi % nv) * E;
      buf[b] = vi < total && r < valid
                   ? *reinterpret_cast<const uint4*>(src + (base + (long long)r * H) * width + j)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int b = 0; b < kVecBatch; ++b) {
      const int vi = v0 + b * kThreads, r = vi / nv, j = (vi % nv) * E;
      if (vi >= total) break;
      float x[8];
      widen8(buf[b], src, x);
#pragma unroll
      for (int e = 0; e < E; ++e) dst[kTransposed ? (j + e) * ld + r : r * ld + j + e] = x[e];
    }
  }
}

// Rows through the vector path where kVec, else element by element.
template <bool kVec, bool kTransposed, typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, long long base, int H,
                                          int width, int wpad, int valid, float* dst, int ld) {
  if constexpr (kVec) {
    load_rows_vec<kTransposed>(src, base, H, width, valid, dst, ld);
    if (wpad > width)  // zero the padding columns
      for (int e = threadIdx.x; e < kMaxChunk * (wpad - width); e += kThreads) {
        const int r = e / (wpad - width), j = width + e % (wpad - width);
        dst[kTransposed ? j * ld + r : r * ld + j] = 0.0f;
      }
  } else {
    load_rows<kTransposed>(src, base, H, width, wpad, valid, dst, ld);
  }
}

// The state pass's runs of τ: as many as leave one (tile, run) a thread.
__host__ __device__ int state_groups(int DK, int DV) {
  const int tiles = (DK + 3) / 4 * ((DV + 3) / 4);
  return tiles * 4 <= kThreads ? 4 : tiles * 2 <= kThreads ? 2 : 1;
}

// shared memory, in floats
__host__ __device__ int state_smem_floats(int DK, int DV) {
  const int dk4 = (DK + 3) / 4 * 4, dv4 = (DV + 3) / 4 * 4;
  return kMaxChunk * (dk4 + dv4) + 2 * kMaxChunk + state_groups(DK, DV) * dk4 * dv4;
}
__host__ __device__ int out_smem_floats(int DK, int DV) {
  const int vp = (DV + kCols - 1) / kCols * kCols;
  return 2 * DK * kStride + kMaxChunk * vp + DK * vp + 2 * kStrip * kStride + kMaxChunk;
}

// Pass 1, one block per (b·h, chunk): ΔS = (k ⊙ e^{tot − cum})ᵀ·v into
// dstate (B·H, n_chunks, DK, DV) and e^{tot} into decay (B·H, n_chunks).
// A thread owns a 4 × 4 tile of ΔS over one of `groups` runs of τ (16
// independent fused multiply-adds a step); the runs' partial sums are then
// added in run order. kVec: 16-byte loads (see launch_gla).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
gla_chunk_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ log_a, float* __restrict__ dstate,
                       float* __restrict__ decay, int S, int H, int DK, int DV, int C,
                       int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  const int dk4 = (DK + 3) / 4 * 4, dv4 = (DV + 3) / 4 * 4;
  const int tiles = dk4 / 4 * (dv4 / 4), groups = state_groups(DK, DV);
  float* ke = smem;                   // [kMaxChunk][dk4]: k, then k ⊙ e^{tot − cum}
  float* vs = ke + kMaxChunk * dk4;   // [kMaxChunk][dv4]
  float* cum = vs + kMaxChunk * dv4;  // [kMaxChunk]
  float* ew = cum + kMaxChunk;        // [kMaxChunk]: e^{tot − cum}
  float* part = ew + kMaxChunk;       // [groups][tiles][16]: each run's partial sums
  const int tid = threadIdx.x, warp = tid / 32;
  const Chunk ch = chunk_of(blockIdx.x, S, H, C, n_chunks);

  if (warp == 0) chunk_cumsum(log_a + ch.base, H, ch.valid, cum);
  load_tile<kVec, false>(k, ch.base, H, DK, dk4, ch.valid, ke, dk4);
  load_tile<kVec, false>(v, ch.base, H, DV, dv4, ch.valid, vs, dv4);
  __syncthreads();
  if (tid < kMaxChunk) ew[tid] = expf(cum[C - 1] - cum[tid]);
  __syncthreads();
  for (int e = tid; e < C * dk4; e += kThreads) ke[e] = __fmul_rn(ke[e], ew[e / dk4]);
  __syncthreads();

  for (int item = tid; item < tiles * groups; item += kThreads) {
    const int tile = item % tiles, g = item / tiles;
    const int i0 = tile / (dv4 / 4) * 4, j0 = tile % (dv4 / 4) * 4;
    float acc[4][4] = {};
    const int lo = g * C / groups, hi = (g + 1) * C / groups;
#pragma unroll 4
    for (int tau = lo; tau < hi; ++tau) {
      const float4 a = ld4(ke + tau * dk4 + i0), w = ld4(vs + tau * dv4 + j0);
      const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int z = 0; z < 4; ++z) acc[x][z] = __fmaf_rn(av[x], wv[z], acc[x][z]);
    }
    float* pp = part + (g * tiles + tile) * 16;
#pragma unroll
    for (int x = 0; x < 4; ++x)
      *reinterpret_cast<float4*>(pp + 4 * x) = make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
  }
  __syncthreads();
  float* ds = dstate + ((long long)ch.bh * n_chunks + ch.c) * DK * DV;
  for (int e = tid; e < DK * DV; e += kThreads) {
    const int i = e / DV, j = e % DV;
    const int at = ((i / 4) * (dv4 / 4) + j / 4) * 16 + (i % 4) * 4 + j % 4;
    float sum = part[at];
    for (int g = 1; g < groups; ++g) sum = __fadd_rn(sum, part[g * tiles * 16 + at]);
    ds[e] = sum;
  }
  if (tid == 0) decay[(long long)ch.bh * n_chunks + ch.c] = expf(cum[C - 1]);
}

// Pass 2: S_c = S_{c−1}·e^{tot_c} + ΔS_c from S = 0, in chunk order, one
// thread per (b·h, state element) (E = DK·DV, `per` blocks a b·h). The
// state entering chunk c overwrites ΔS_c; the last S is the final state.
__global__ void __launch_bounds__(kThreads)
gla_carry_kernel(float* __restrict__ dstate, const float* __restrict__ decay,
                 float* __restrict__ state, int n_chunks, int E, int per) {
  const int bh = blockIdx.x / per;
  const int e = (blockIdx.x % per) * kThreads + threadIdx.x;
  if (e >= E) return;
  float* ds = dstate + (long long)bh * n_chunks * E + e;
  const float* dc = decay + (long long)bh * n_chunks;
  float s = 0.0f;
  constexpr int kBatch = 8;  // chunks whose loads are in flight together
  for (int c0 = 0; c0 < n_chunks; c0 += kBatch) {
    float inc[kBatch], d[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const bool in = c0 + b < n_chunks;
      inc[b] = in ? ds[(long long)(c0 + b) * E] : 0.0f;
      d[b] = in ? dc[c0 + b] : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (c0 + b >= n_chunks) break;
      ds[(long long)(c0 + b) * E] = s;
      s = __fadd_rn(__fmul_rn(s, d[b]), inc[b]);
    }
  }
  state[(long long)bh * E + e] = s;
}

// Pass 3, one block per (b·h, chunk): y = (q ⊙ e^{cum})·S_in + the gated
// scores · v, with S_in from pass 2 (sin, laid out as dstate). Warp w owns
// rows 16w..16w+15 of the chunk, lane (ly, lx) rows 16w + 8·ly + 0..7 and
// columns c0 + 4·lx + 0..3 of each 64-column pass c0. kVec: 16-byte loads
// and one store for a row's four columns (see launch_gla).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
gla_chunk_out_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ log_a, const float* __restrict__ sin,
                     T* __restrict__ y, int S, int H, int DK, int DV, int C, int n_chunks) {
  extern __shared__ __align__(16) float smem[];
  const int vp = (DV + kCols - 1) / kCols * kCols;
  float* qt = smem;                     // [DK][kStride]: q, token-minor
  float* kt = qt + DK * kStride;        // [DK][kStride]: k, token-minor
  float* vs = kt + DK * kStride;        // [kMaxChunk][vp]
  float* ss = vs + kMaxChunk * vp;      // [DK][vp]: the state entering the chunk
  float* gt = ss + DK * vp;             // [2][kStrip][kStride]: gated scores gt[τ − τ0][t]
  float* cum = gt + 2 * kStrip * kStride;  // [kMaxChunk]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const Chunk ch = chunk_of(blockIdx.x, S, H, C, n_chunks);

  const float* sc = sin + ((long long)ch.bh * n_chunks + ch.c) * DK * DV;
  for (int e = tid; e < DK * vp; e += kThreads) {  // S_in by cp.async, zeros past DV
    const int i = e / vp, j = e % vp;
    cp_async<4>(ss + e, sc + (j < DV ? i * DV + j : 0), j < DV ? 4 : 0);
  }
  cp_async_commit();
  if (warp == 0) chunk_cumsum(log_a + ch.base, H, ch.valid, cum);
  load_tile<kVec, true>(q, ch.base, H, DK, DK, ch.valid, qt, kStride);
  load_tile<kVec, true>(k, ch.base, H, DK, DK, ch.valid, kt, kStride);
  load_tile<kVec, false>(v, ch.base, H, DV, vp, ch.valid, vs, vp);
  cp_async_wait<0>();
  __syncthreads();

  const int ly = lane / 16, lx = lane % 16;
  const int r0 = 16 * warp + 8 * ly;                    // this thread's 8 rows
  const int wend = 16 * warp < C ? min(16 * warp + 16, C) : 0;  // this warp's rows end
  const int ta = 4 * (tid / 8), ua = 4 * (tid % 8);     // score tile: rows ta.., strip columns ua..
  float eq[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) eq[r] = expf(cum[r0 + r]);
  T* yc = y + ch.base * DV;
  int buf = 0;  // the strips alternate between two buffers: one barrier a strip

  for (int c0 = 0; c0 < vp; c0 += kCols) {
    float acc[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[r][x] = 0.0f;

    for (int tau0 = 0; tau0 < C; tau0 += kStrip, buf ^= 1) {
      float* g = gt + buf * kStrip * kStride;
      {  // the strip's gated scores: (q·k) ⊙ e^{cum_t − cum_τ} for τ ≤ t, else 0
        const int u = tau0 + ua;
        float sco[4][4];
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int z = 0; z < 4; ++z) sco[x][z] = 0.0f;
        if (ta + 3 >= u && ta < C && u < C) {
          for (int i = 0; i < DK; ++i) {
            const float4 a = ld4(qt + i * kStride + ta);
            const float4 b = ld4(kt + i * kStride + u);
            const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int x = 0; x < 4; ++x)
#pragma unroll
              for (int z = 0; z < 4; ++z) sco[x][z] = __fmaf_rn(av[x], bv[z], sco[x][z]);
          }
          const float4 ct = ld4(cum + ta), cu = ld4(cum + u);
          const float cta[4] = {ct.x, ct.y, ct.z, ct.w}, cua[4] = {cu.x, cu.y, cu.z, cu.w};
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int z = 0; z < 4; ++z)
              sco[x][z] = u + z <= ta + x ? __fmul_rn(sco[x][z], expf(cta[x] - cua[z])) : 0.0f;
        }
#pragma unroll
        for (int z = 0; z < 4; ++z)
          *reinterpret_cast<float4*>(g + (ua + z) * kStride + ta) =
              make_float4(sco[0][z], sco[1][z], sco[2][z], sco[3][z]);
      }
      __syncthreads();  // the strip is built; the one two strips back is consumed
      const int uend = min(tau0 + kStrip, wend);  // past the warp's last row the scores are 0
#pragma unroll 4
      for (int u = tau0; u < uend; ++u) {
        const float4 g0 = ld4(g + (u - tau0) * kStride + r0);
        const float4 g1 = ld4(g + (u - tau0) * kStride + r0 + 4);
        const float4 w = ld4(vs + u * vp + c0 + 4 * lx);
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int x = 0; x < 4; ++x) acc[r][x] = __fmaf_rn(gv[r], wv[x], acc[r][x]);
      }
    }

    float inter[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int x = 0; x < 4; ++x) inter[r][x] = 0.0f;
    for (int i = 0; i < DK; ++i) {
      const float4 a0 = ld4(qt + i * kStride + r0);
      const float4 a1 = ld4(qt + i * kStride + r0 + 4);
      const float4 w = ld4(ss + i * vp + c0 + 4 * lx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float qe = __fmul_rn(av[r], eq[r]);
#pragma unroll
        for (int x = 0; x < 4; ++x) inter[r][x] = __fmaf_rn(qe, wv[x], inter[r][x]);
      }
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int t = r0 + r;
      if (t >= ch.valid) continue;
      T* row = yc + (long long)t * H * DV;
      const int j = c0 + 4 * lx;
      float o[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) o[x] = __fadd_rn(inter[r][x], acc[r][x]);
      if (kVec) {  // DV is a multiple of 4: the four columns are all in or all out
        if (j < DV) store4(row + j, o);
      } else {
#pragma unroll
        for (int x = 0; x < 4; ++x)
          if (j + x < DV) row[j + x] = narrow<T>(o[x]);
      }
    }
  }
}

template <typename T, bool kVec>
cudaError_t launch_gla_path(const T* q, const T* k, const T* v, const float* log_a, T* y,
                       float* state, float* dstate, float* decay, int B, int S, int H, int DK,
                       int DV, int C, cudaStream_t st) {
  const int n_chunks = (S + C - 1) / C;
  const long long blocks = (long long)B * H * n_chunks;
  const int E = DK * DV, per = (E + kThreads - 1) / kThreads;
  if (blocks > INT_MAX || (long long)B * H * per > INT_MAX) return cudaErrorInvalidValue;
  const int smem1 = state_smem_floats(DK, DV) * (int)sizeof(float);
  const int smem3 = out_smem_floats(DK, DV) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(gla_chunk_state_kernel<T, kVec>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(gla_chunk_out_kernel<T, kVec>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem3);
  if (e != cudaSuccess) return e;
  gla_chunk_state_kernel<T, kVec><<<(unsigned)blocks, kThreads, smem1, st>>>(
      k, v, log_a, dstate, decay, S, H, DK, DV, C, n_chunks);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  gla_carry_kernel<<<(unsigned)(B * H * per), kThreads, 0, st>>>(dstate, decay, state, n_chunks,
                                                                    E, per);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  gla_chunk_out_kernel<T, kVec><<<(unsigned)blocks, kThreads, smem3, st>>>(
      q, k, v, log_a, dstate, y, S, H, DK, DV, C, n_chunks);
  return cudaGetLastError();
}

// ---- the wide path: dk × dv past one block's shared memory

constexpr int kWideTile = 64;   // ΔS tile rows and columns; y columns a block
constexpr int kWideStrip = 32;  // dk rows of q, k and S_in a step of the output pass

// Columns j0 .. j0 + cols of the chunk's rows r < kMaxChunk of a (·, width)
// array whose token t sits at src + (base + t·H)·width, widened to f32 into
// dst[r·ld + j − j0] (or, with kTransposed, dst[(j − j0)·ld + r]), zeros
// past `valid` rows and past `width`. Element by element, every load of a
// lane's column issued before any store, as load_rows.
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

// shared memory, in floats
constexpr int kWideStateSmem = 2 * kMaxChunk * kWideTile + 2 * kMaxChunk;
constexpr int kWideOutSmem = 2 * kWideStrip * kStride + kWideStrip * kWideTile +
                             kMaxChunk * kWideTile + kMaxChunk * kStride + kMaxChunk;

// Pass 1 of the wide path, one block per (b·h, chunk, tile of ΔS): rows
// i0..i0+63 and columns j0..j0+63 of ΔS = (k ⊙ e^{tot − cum})ᵀ·v into
// dstate, a 4 × 4 block a thread summed over the chunk's tokens in order;
// the tile-(0, 0) block also writes e^{tot}. tj: column tiles of ΔS.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gla_wide_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ log_a, float* __restrict__ dstate,
                      float* __restrict__ decay, int S, int H, int DK, int DV, int C,
                      int n_chunks, int tiles, int tj) {
  extern __shared__ __align__(16) float smem[];
  float* ke = smem;                         // [kMaxChunk][kWideTile]: k ⊙ e^{tot − cum}
  float* vs = ke + kMaxChunk * kWideTile;   // [kMaxChunk][kWideTile]
  float* cum = vs + kMaxChunk * kWideTile;  // [kMaxChunk]
  float* ew = cum + kMaxChunk;              // [kMaxChunk]
  const int tid = threadIdx.x, warp = tid / 32;
  const int tile = blockIdx.x % tiles;
  const Chunk ch = chunk_of(blockIdx.x / tiles, S, H, C, n_chunks);
  const int i0 = tile / tj * kWideTile, j0 = tile % tj * kWideTile;

  if (warp == 0) chunk_cumsum(log_a + ch.base, H, ch.valid, cum);
  load_cols<false>(k, ch.base, H, DK, i0, kWideTile, ch.valid, ke, kWideTile);
  load_cols<false>(v, ch.base, H, DV, j0, kWideTile, ch.valid, vs, kWideTile);
  __syncthreads();
  if (tid < kMaxChunk) ew[tid] = expf(cum[C - 1] - cum[tid]);
  __syncthreads();
  for (int e = tid; e < C * kWideTile; e += kThreads)
    ke[e] = __fmul_rn(ke[e], ew[e / kWideTile]);
  __syncthreads();

  const int a0 = 4 * (tid / 16), b0 = 4 * (tid % 16);  // this thread's 4 × 4 block
  float acc[4][4] = {};
#pragma unroll 4
  for (int tau = 0; tau < C; ++tau) {
    const float4 a = ld4(ke + tau * kWideTile + a0), w = ld4(vs + tau * kWideTile + b0);
    const float av[4] = {a.x, a.y, a.z, a.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int z = 0; z < 4; ++z) acc[x][z] = __fmaf_rn(av[x], wv[z], acc[x][z]);
  }
  float* ds = dstate + ((long long)ch.bh * n_chunks + ch.c) * DK * DV;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int i = i0 + a0 + x;
    if (i >= DK) break;
#pragma unroll
    for (int z = 0; z < 4; ++z)
      if (j0 + b0 + z < DV) ds[(long long)i * DV + j0 + b0 + z] = acc[x][z];
  }
  if (tile == 0 && tid == 0) decay[(long long)ch.bh * n_chunks + ch.c] = expf(cum[C - 1]);
}

// Pass 3 of the wide path, one block per (b·h, chunk, 64 columns of y): the
// scores q·kᵀ (a thread's four 4 t × 4 τ blocks, one in each 32-τ strip)
// and the inter term (q ⊙ e^{cum})·S_in[:, cols] (8 rows × 4 columns a
// thread, as gla_chunk_out_kernel) summed over dk strips of 32; then the
// gate by select into shared memory and the gated scores · v. tj: column
// tiles of y.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gla_wide_out_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ log_a, const float* __restrict__ sin,
                    T* __restrict__ y, int S, int H, int DK, int DV, int C, int n_chunks,
                    int tj) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // [kWideStrip][kStride]: q, token-minor
  float* ks = qs + kWideStrip * kStride;     // [kWideStrip][kStride]: k, token-minor
  float* ss = ks + kWideStrip * kStride;     // [kWideStrip][kWideTile]: S_in's strip
  float* vs = ss + kWideStrip * kWideTile;   // [kMaxChunk][kWideTile]
  float* gt = vs + kMaxChunk * kWideTile;    // [kMaxChunk][kStride]: gated scores gt[τ][t]
  float* cum = gt + kMaxChunk * kStride;     // [kMaxChunk]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j0 = blockIdx.x % tj * kWideTile;
  const Chunk ch = chunk_of(blockIdx.x / tj, S, H, C, n_chunks);
  const float* sc = sin + ((long long)ch.bh * n_chunks + ch.c) * DK * DV;

  if (warp == 0) chunk_cumsum(log_a + ch.base, H, ch.valid, cum);
  load_cols<false>(v, ch.base, H, DV, j0, kWideTile, ch.valid, vs, kWideTile);
  __syncthreads();

  const int ly = lane / 16, lx = lane % 16;
  const int r0 = 16 * warp + 8 * ly;                    // this thread's 8 rows
  const int wend = 16 * warp < C ? min(16 * warp + 16, C) : 0;  // this warp's rows end
  const int ta = 4 * (tid / 8), ua = 4 * (tid % 8);     // score blocks: rows ta.., τ 32s + ua..
  float eq[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) eq[r] = expf(cum[r0 + r]);
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

  for (int i0 = 0; i0 < DK; i0 += kWideStrip) {
    const int w = min(kWideStrip, DK - i0);
    __syncthreads();  // the previous strip is consumed
    load_cols<true>(q, ch.base, H, DK, i0, kWideStrip, ch.valid, qs, kStride);
    load_cols<true>(k, ch.base, H, DK, i0, kWideStrip, ch.valid, ks, kStride);
    for (int e = tid; e < kWideStrip * kWideTile; e += kThreads) {
      const int i = i0 + e / kWideTile, j = j0 + e % kWideTile;
      ss[e] = i < DK && j < DV ? sc[(long long)i * DV + j] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int u = 32 * s + ua;
      if (ta + 3 >= u && ta < C && u < C) {  // blocks wholly above the diagonal stay 0
        for (int i = 0; i < w; ++i) {
          const float4 a = ld4(qs + i * kStride + ta);
          const float4 b = ld4(ks + i * kStride + u);
          const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int z = 0; z < 4; ++z) sco[s][x][z] = __fmaf_rn(av[x], bv[z], sco[s][x][z]);
        }
      }
    }
    for (int i = 0; i < w; ++i) {
      const float4 a0 = ld4(qs + i * kStride + r0);
      const float4 a1 = ld4(qs + i * kStride + r0 + 4);
      const float4 sv = ld4(ss + i * kWideTile + 4 * lx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float wv[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float qe = __fmul_rn(av[r], eq[r]);
#pragma unroll
        for (int x = 0; x < 4; ++x) inter[r][x] = __fmaf_rn(qe, wv[x], inter[r][x]);
      }
    }
  }

  // the gate, by select: (q·k) ⊙ e^{cum_t − cum_τ} for τ ≤ t, else 0
  const float4 ct = ld4(cum + ta);
  const float cta[4] = {ct.x, ct.y, ct.z, ct.w};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int u = 32 * s + ua;
    const float4 cu = ld4(cum + u);
    const float cua[4] = {cu.x, cu.y, cu.z, cu.w};
    const bool live = ta + 3 >= u && ta < C && u < C;
#pragma unroll
    for (int z = 0; z < 4; ++z) {
      float g[4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
        g[x] = live && u + z <= ta + x ? __fmul_rn(sco[s][x][z], expf(cta[x] - cua[z])) : 0.0f;
      *reinterpret_cast<float4*>(gt + (u + z) * kStride + ta) = make_float4(g[0], g[1], g[2], g[3]);
    }
  }
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[r][x] = 0.0f;
#pragma unroll 4
  for (int u = 0; u < wend; ++u) {  // past the warp's last row the scores are 0
    const float4 g0 = ld4(gt + u * kStride + r0);
    const float4 g1 = ld4(gt + u * kStride + r0 + 4);
    const float4 w = ld4(vs + u * kWideTile + 4 * lx);
    const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[r][x] = __fmaf_rn(gv[r], wv[x], acc[r][x]);
  }
  T* yc = y + ch.base * DV;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = r0 + r;
    if (t >= ch.valid) continue;
    T* row = yc + (long long)t * H * DV;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int j = j0 + 4 * lx + x;
      if (j < DV) row[j] = narrow<T>(__fadd_rn(inter[r][x], acc[r][x]));
    }
  }
}

template <typename T>
cudaError_t launch_gla_wide(const T* q, const T* k, const T* v, const float* log_a, T* y,
                            float* state, float* dstate, float* decay, int B, int S, int H,
                            int DK, int DV, int C, cudaStream_t st) {
  const int n_chunks = (S + C - 1) / C;
  const int ti = (DK + kWideTile - 1) / kWideTile, tj = (DV + kWideTile - 1) / kWideTile;
  const long long chunks = (long long)B * H * n_chunks;
  const long long E = (long long)DK * DV, per = (E + kThreads - 1) / kThreads;
  if (chunks * ti * tj > INT_MAX || E > INT_MAX || B * H * per > INT_MAX)
    return cudaErrorInvalidValue;
  const int smem1 = kWideStateSmem * (int)sizeof(float);
  const int smem3 = kWideOutSmem * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(gla_wide_state_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(gla_wide_out_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem3);
  if (e != cudaSuccess) return e;
  gla_wide_state_kernel<T><<<(unsigned)(chunks * ti * tj), kThreads, smem1, st>>>(
      k, v, log_a, dstate, decay, S, H, DK, DV, C, n_chunks, ti * tj, tj);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  gla_carry_kernel<<<(unsigned)(B * H * per), kThreads, 0, st>>>(dstate, decay, state, n_chunks,
                                                                    (int)E, (int)per);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  gla_wide_out_kernel<T><<<(unsigned)(chunks * tj), kThreads, smem3, st>>>(
      q, k, v, log_a, dstate, y, S, H, DK, DV, C, n_chunks, tj);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// The vector path takes rows of whole 16-byte vectors on 16-byte boundaries
// (and y's four columns a thread on an 8- or 16-byte boundary).
template <typename T>
cudaError_t launch_gla(const T* q, const T* k, const T* v, const float* log_a, T* y,
                       float* state, float* dstate, float* decay, int B, int S, int H, int DK,
                       int DV, int C, cudaStream_t st) {
  const int a = state_smem_floats(DK, DV), b = out_smem_floats(DK, DV);
  if ((long long)(a > b ? a : b) * (long long)sizeof(float) > kMaxSmem)
    return launch_gla_wide<T>(q, k, v, log_a, y, state, dstate, decay, B, S, H, DK, DV, C, st);
  constexpr int kE = 16 / sizeof(T);
  const bool vec = DK % kE == 0 && DV % kE == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(y);
  return vec ? launch_gla_path<T, true>(q, k, v, log_a, y, state, dstate, decay, B, S, H, DK, DV,
                                        C, st)
             : launch_gla_path<T, false>(q, k, v, log_a, y, state, dstate, decay, B, S, H, DK, DV,
                                         C, st);
}

}  // namespace

extern "C" {

// The larger of the two chunk kernels' shared memory, in bytes; past a
// block's kMaxSmem the call takes the wide path.
int repro_gla_smem(int DK, int DV) {
  const int a = state_smem_floats(DK, DV), b = out_smem_floats(DK, DV);
  return (a > b ? a : b) * (int)sizeof(float);
}

// q, k (B, S, H, DK), v (B, S, H, DV): device pointers to contiguous arrays
// of one type (f32, or bf16 when bf16 is 1); log_a (B, S, H) f32; y
// (B, S, H, DV) of the input type; state (B, H, DK, DV) f32; scratch
// dstate (B, H, ⌈S/C⌉, DK, DV) and decay (B, H, ⌈S/C⌉) f32. C is the chunk
// (1 ≤ C ≤ 128); any DK and DV. Returns the first failed launch's CUDA
// error, or 0.
int repro_gla_forward(const void* q, const void* k, const void* v, const float* log_a, void* y,
                      float* state, float* dstate, float* decay, int B, int S, int H, int DK,
                      int DV, int C, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * H == 0 || S == 0) return cudaSuccess;
  if (C < 1 || C > kMaxChunk) return cudaErrorInvalidValue;
  if (bf16) {
    using T = __nv_bfloat16;
    return launch_gla<T>(static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v), log_a, static_cast<T*>(y), state, dstate,
                         decay, B, S, H, DK, DV, C, st);
  }
  return launch_gla<float>(static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), log_a, static_cast<float*>(y), state,
                           dstate, decay, B, S, H, DK, DV, C, st);
}

}  // extern "C"
