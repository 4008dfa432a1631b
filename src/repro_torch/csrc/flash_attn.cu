// Fused attention forward with an online softmax for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::flash_attention
// (pallas_call :105, inner kernel _flash_kernel :31). On the TPU one grid
// step is a (batch·head, query block, KV block) triple and the running max
// m, the sum l and the f32 accumulator live in VMEM scratch across the
// sequential KV axis. Blocks on Hopper run in no order, so here one thread
// block owns one (batch·head, query block) pair and walks the KV tiles in a
// loop of its own, with m, l and the accumulator in registers. Nothing of
// the (S × S) scores reaches device memory.
//
// Arithmetic, as the reference's kernel and its oracle
// (models/layers.py::blockwise_attention): s = (q·k) · hd^−½, the scale
// applied after the dot product; masked scores (key past the sequence, or
// above the diagonal when causal) are −1e30, never −inf, so a row with no
// valid key yet gives exp(0) and not NaN; p = exp(s − m_new) is rounded to
// the type of v before p·v (bf16 inputs) while l sums the unrounded p; the
// output is acc / max(l, 1e-30), rounded to the input type. Tiles of 64
// keys in both kernels (the plain version's KV_TILE). Causal calls skip the
// KV tiles wholly above the block's last query: their p is exactly 0 in f32
// once a row has seen key 0, which every row has.
//
// Two kernels, one for each input type, at the head widths 64, 128 and
// 256 (template instances):
//
// * bf16, flash_fwd_kernel_mma (FlashAttention-2's layout): 64 query rows a
//   block, 4 warps of 16 rows each. Q is copied once into shared memory as
//   bf16 and its fragments kept in registers (read again each tile at
//   hd = 256, where registers run out); K and V tiles go through a ring of
//   two stages filled by cp.async, 16 bytes a thread from offsets computed
//   once, so tile t+1's copy overlaps tile t's products, with one barrier a
//   tile. S = Q·Kᵀ and O += P·V run on the tensor cores (mma.sync m16n8k16,
//   bf16 in, f32 sums), their operands brought in by ldmatrix (V transposed
//   by ldmatrix.trans). The softmax runs on S's accumulator fragments in
//   registers: a row's max is reduced over the 4 lanes that hold it with
//   __shfl_xor_sync, each lane keeps its share of l, and P is rounded to
//   bf16 and packed straight from S's accumulator into P·V's A operand, so
//   P never goes to shared memory. The scores carry log2(e) in their scale,
//   so that each p is one ex2.approx of s − m (relative error about 2^-22,
//   far below p's bf16 rounding); m and the −1e30 of a masked score are in
//   the same units, so a row with no valid key still gives p = 1. Shared
//   rows are padded by 16 bytes, so the 8 rows an ldmatrix reads fall in 8
//   different bank groups. The output goes back through the warp's own Q
//   rows, for 16-byte stores. Shared memory: 45 KB at hd = 64, 85 KB at
//   128, 165 KB at 256; registers 128, 168 and 241 a thread, none spilled.
// * f32, flash_fwd_kernel: the products on the CUDA cores in f32 (the
//   tensor cores have no f32 input), with the tiles widened once into
//   shared memory: 64 query rows for hd = 64, 32 for 128, 16 for 256
//   (152 KB). 128 threads as 8 row groups × 16 column groups; a thread
//   holds a (BQ/8) × 4 block of scores and a (BQ/8) × (hd/16) block of the
//   output.
//
// Other head widths and views take the same kernels or a third:
//
// * hd ≤ 256 and not an instance: the next larger instance, masked at hd
//   (kMasked): q, k and v columns past hd load as zeros, so they add
//   nothing to q·kᵀ, columns past hd are not stored, and the scale is the
//   true hd^−½ (the wrapper's). The row stride is H·hd. bf16 stays on the
//   tensor cores where its 16-byte copies can go: hd a multiple of 8 and
//   q, k, v and out on 16-byte boundaries. Otherwise (hd·2 bytes not a
//   multiple of 16, or a view that starts off a 16-byte boundary) bf16
//   runs flash_fwd_kernel, which loads element by element, widened to f32,
//   and rounds p to bf16 before p·v as the tensor-core kernel does.
// * hd > 256: flash_fwd_wide_kernel, one block per (batch·head, 16 query
//   rows, 64 columns of the output). It streams q·kᵀ over hd in slices of
//   64 through shared memory (41 KB), runs the online softmax on the whole
//   scores and accumulates only its 64 columns of p·v: each column slice
//   computes the scores again (hd/64 times at hd = 512). f32 on the CUDA
//   cores for both types, element loads. A repair, not tuned.
//
// Bound on an H100 at the hymba-1.5b serving shape (B = 4, S = 512, H = 25,
// hd = 64, causal, bf16): q, k, v and out are 26 MB, 7.8 µs at 3.35 TB/s;
// the products are 3.4 GFLOP, 3.4 µs at 989 TFLOP/s: bound by bytes. At
// S = 2048 the products (54 GFLOP, 54 µs) bound it. mma.sync reaches a
// fraction of the bf16 peak: PyTorch's scaled_dot_product_attention on the
// H100 runs cuDNN's wgmma kernel, and a warp-specialised wgmma/TMA pipeline
// is later work. The f32 kernel cannot come within 10× of its bound
// (67 TFLOP/s at best on the CUDA cores).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "ptx.cuh"

namespace {

constexpr int kThreads = 128;  // 8 row groups × 16 column groups
constexpr int kBK = 64;        // keys per tile
constexpr float kNegInf = -1e30f;

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

// The online softmax of one tile of a thread's RM × CN block of scores
// (rows q0 + ty + 8i, keys k0 + tx + 16j; 16 threads a row): scale and
// mask, the rows' new max over the 16 threads, p = exp(s − m_new) rounded
// to T into sp (the sum l over the unrounded p), and acc rescaled.
template <typename T, int RM, int CN, int DN>
__device__ __forceinline__ void softmax_tile(float (&s)[RM][CN], float (&m)[RM], float (&l)[RM],
                                             float (&acc)[RM][DN], float* sp, int ps, int q0,
                                             int k0, int SK, int causal, float scale, int tx,
                                             int ty) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qpos = q0 + ty + 8 * i;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int kpos = k0 + tx + 16 * j;
      const bool valid = kpos < SK && (!causal || kpos <= qpos);
      s[i][j] = valid ? s[i][j] * scale : kNegInf;
      mx = fmaxf(mx, s[i][j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m[i], mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const float p = expf(s[i][j] - m_new);
      sum += p;
      sp[(ty + 8 * i) * ps + tx + 16 * j] = widen(narrow<T>(p));
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float alpha = expf(m[i] - m_new);
    l[i] = l[i] * alpha + sum;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
    m[i] = m_new;
  }
}

template <int HD>
struct Tile {
  static constexpr int BQ = HD == 64 ? 64 : (HD == 128 ? 32 : 16);
  static constexpr int QS = HD + 1;  // padded row stride of the q and k tiles
  static constexpr int PS = kBK + 1; // padded row stride of the p tile
  static constexpr int smem_floats = BQ * QS + kBK * QS + kBK * HD + BQ * PS;
};

// q (B, SQ, H, hd), k and v (B, SK, H, hd), out (B, SQ, H, hd), contiguous,
// hd = HD unless kMasked (then hd < HD, the columns past it zeros).
// grid (B·H, nq): B·H on x, which takes any count; blockIdx.y counts query
// blocks from the last, so that a causal call starts its longest blocks
// first.
template <typename T, int HD, bool kMasked>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int H, int SQ, int SK, int hd, int causal, float scale) {
  using Tl = Tile<HD>;
  constexpr int BQ = Tl::BQ, QS = Tl::QS, PS = Tl::PS;
  constexpr int RM = BQ / 8;    // query rows a thread holds
  constexpr int CN = kBK / 16;  // key columns a thread holds
  constexpr int DN = HD / 16;   // output columns a thread holds
  extern __shared__ float smem[];
  float* sq = smem;            // BQ × QS
  float* sk = sq + BQ * QS;    // kBK × QS
  float* sv = sk + kBK * QS;   // kBK × HD
  float* sp = sv + kBK * HD;   // BQ × PS

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qb = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = qb * BQ;
  const int dim = kMasked ? hd : HD;
  const long long row_stride = (long long)H * dim;
  const T* qbase = q + ((long long)b * SQ * H + h) * dim;
  const T* kbase = k + ((long long)b * SK * H + h) * dim;
  const T* vbase = v + ((long long)b * SK * H + h) * dim;

  for (int e = tid; e < BQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, s = q0 + r;
    sq[r * QS + d] = s < SQ && (!kMasked || d < dim) ? widen(qbase[s * row_stride + d]) : 0.f;
  }

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (SK + kBK - 1) / kBK;
  if (causal) {
    const int last_q = min(q0 + BQ, SQ) - 1;
    n_tiles = min(n_tiles, last_q / kBK + 1);
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's k, v and p are consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD, s = k0 + r;
      const bool in = s < SK && (!kMasked || d < dim);
      sk[r * QS + d] = in ? widen(kbase[s * row_stride + d]) : 0.f;
      sv[r * HD + d] = in ? widen(vbase[s * row_stride + d]) : 0.f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[RM], c[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = sq[(ty + 8 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) c[j] = sk[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }

    softmax_tile<T>(s, m, l, acc, sp, PS, q0, k0, SK, causal, scale, tx, ty);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[RM], w[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = sp[(ty + 8 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) w[j] = sv[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }

  T* obase = out + ((long long)b * SQ * H + h) * dim;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int s = q0 + ty + 8 * i;
    if (s >= SQ) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DN; ++j)
      if (!kMasked || tx + 16 * j < dim)
        obase[s * row_stride + tx + 16 * j] = narrow<T>(acc[i][j] / denom);
  }
}

// ---- head widths past 256

constexpr int kSlice = 64;   // head dims a step of q·kᵀ, and output columns a block
constexpr int kWideBQ = 16;  // query rows a block

// q, k, v, out as flash_fwd_kernel's with any HD; grid (B·H, nq, ⌈HD/64⌉):
// blockIdx.z is the block's slice of 64 output columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ out, int H, int SQ, int SK, int HD, int causal,
                      float scale) {
  constexpr int BQ = kWideBQ, QS = kSlice + 1, PS = kBK + 1;
  constexpr int RM = BQ / 8, CN = kBK / 16, DN = kSlice / 16;
  __shared__ float sq[BQ * QS];
  __shared__ float sk[kBK * QS];
  __shared__ float sv[kBK * kSlice];
  __shared__ float sp[BQ * PS];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qb = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = qb * BQ, c0 = blockIdx.z * kSlice;
  const long long row_stride = (long long)H * HD;
  const T* qbase = q + ((long long)b * SQ * H + h) * HD;
  const T* kbase = k + ((long long)b * SK * H + h) * HD;
  const T* vbase = v + ((long long)b * SK * H + h) * HD;

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (SK + kBK - 1) / kBK;
  if (causal) {
    const int last_q = min(q0 + BQ, SQ) - 1;
    n_tiles = min(n_tiles, last_q / kBK + 1);
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < HD; d0 += kSlice) {
      __syncthreads();  // the previous slice's q and k, the previous tile's v and p, are consumed
      for (int e = tid; e < BQ * kSlice; e += kThreads) {
        const int r = e / kSlice, d = e % kSlice, sr = q0 + r;
        sq[r * QS + d] = sr < SQ && d0 + d < HD ? widen(qbase[sr * row_stride + d0 + d]) : 0.f;
      }
      for (int e = tid; e < kBK * kSlice; e += kThreads) {
        const int r = e / kSlice, d = e % kSlice, sr = k0 + r;
        sk[r * QS + d] = sr < SK && d0 + d < HD ? widen(kbase[sr * row_stride + d0 + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kSlice; ++d) {
        float a[RM], c[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) a[i] = sq[(ty + 8 * i) * QS + d];
#pragma unroll
        for (int j = 0; j < CN; ++j) c[j] = sk[(tx + 16 * j) * QS + d];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
      }
    }
    softmax_tile<T>(s, m, l, acc, sp, PS, q0, k0, SK, causal, scale, tx, ty);
    for (int e = tid; e < kBK * kSlice; e += kThreads) {
      const int r = e / kSlice, d = e % kSlice, sr = k0 + r;
      sv[r * kSlice + d] = sr < SK && c0 + d < HD ? widen(vbase[sr * row_stride + c0 + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[RM], w[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = sp[(ty + 8 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) w[j] = sv[c * kSlice + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }

  T* obase = out + ((long long)b * SQ * H + h) * HD;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int s = q0 + ty + 8 * i;
    if (s >= SQ) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < HD) obase[s * row_stride + col] = narrow<T>(acc[i][j] / denom);
    }
  }
}

// ---- bf16 on the tensor cores

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows a block, 16 a warp
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kMmaRows == kBK, "q, k and v tiles share one shape and one loader");

template <int HD>
struct MmaTile {
  static constexpr int LD = HD + 8;  // padded row, in bf16 elements
  // Q's fragments stay in registers across the KV loop where they fit (32
  // registers); at hd = 256 they are read again from shared memory each tile
  static constexpr bool q_in_regs = HD <= 128;
  static constexpr int smem_bytes = 5 * kBK * LD * 2;  // q; k and v in two stages
};

struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct AddOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};

// op over this lane's 2·N entries of row r (0: row g, 1: row g+8) of an
// accumulator tile, as a pairwise tree (short dependency chains)
template <int N, typename Op>
__device__ __forceinline__ float row_tree(const float (&acc)[N][4], int r, Op op) {
  float t[N];
#pragma unroll
  for (int j = 0; j < N; ++j) t[j] = op(acc[j][2 * r], acc[j][2 * r + 1]);
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = op(t[j], t[j + w]);
  return t[0];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// q, k, v, out as flash_fwd_kernel's, bf16, each on a 16-byte boundary (and
// hd a multiple of 8 when kMasked); grid (B·H, nq) with kMmaRows query rows
// a block.
template <int HD, bool kMasked>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_kernel_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                     int H, int SQ, int SK, int hd, int causal, float scale) {
  using Tl = MmaTile<HD>;
  constexpr int LD = Tl::LD, TILE = kBK * LD;
  constexpr int CH = HD / 8;               // 16-byte chunks a row
  constexpr int RSTEP = kMmaThreads / CH;  // rows between one thread's chunks
  constexpr int NT = kBK / 8;              // 8-key column tiles of S
  constexpr int DT = HD / 8;               // 8-wide column tiles of O
  constexpr int KS = HD / 16;              // 16-deep steps of Q·Kᵀ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + TILE;      // two stages
  __nv_bfloat16* sv = sk + 2 * TILE;  // two stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int qb = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = qb * kMmaRows, w0 = q0 + 16 * warp;  // the block's and the warp's first row
  const int dim = kMasked ? hd : HD;
  const long long rs = (long long)H * dim;
  const __nv_bfloat16* qbase = q + ((long long)b * SQ * H + h) * dim;
  const __nv_bfloat16* kbase = k + ((long long)b * SK * H + h) * dim;
  const __nv_bfloat16* vbase = v + ((long long)b * SK * H + h) * dim;
  // s·log2(e), so that exp(s − m) is one exp2 of a difference; m, like s, in
  // those units, and a masked score is −1e30 in them
  const float scale2 = scale * kLog2e;

  // Copy rows row0..row0+63 (those below n; the rest zero-filled) of a
  // (·, H, hd) array into a padded tile. Thread tid copies the 16 bytes at
  // column lc of rows lr, lr + RSTEP, ... (zeros at a column past hd); a
  // tile wholly below n skips the row checks.
  const int lr = tid / CH, lc = (tid % CH) * 8;
  const bool col_in = !kMasked || lc < dim;
  auto load_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* base, int row0, int n) {
    dst += lr * LD + lc;
    const __nv_bfloat16* src = base + (row0 + lr) * rs + lc;
    if (row0 + kBK <= n) {
#pragma unroll
      for (int i = 0; i < kBK / RSTEP; ++i)
        cp_async<16>(dst + i * RSTEP * LD, col_in ? src + i * RSTEP * rs : base, col_in ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < kBK / RSTEP; ++i) {
        const bool in = col_in && row0 + lr + i * RSTEP < n;
        cp_async<16>(dst + i * RSTEP * LD, in ? src + i * RSTEP * rs : base, in ? 16 : 0);
      }
    }
  };
  // the A fragment of the warp's rows at depth step ks, from shared memory
  auto q_frag = [&](uint32_t (&a)[4], int ks) {
    ldmatrix_x4(a, sq + (16 * warp + lane % 16) * LD + 16 * ks + (lane / 16) * 8);
  };

  int n_tiles = (SK + kBK - 1) / kBK;
  if (causal) {
    const int last_q = min(q0 + kMmaRows, SQ) - 1;
    n_tiles = min(n_tiles, last_q / kBK + 1);
  }
  // commit groups: q, then each key tile (k and v)
  load_tile(sq, qbase, q0, SQ);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile(sk, kbase, 0, SK);
    load_tile(sv, vbase, 0, SK);
  }
  cp_async_commit();

  uint32_t qf[Tl::q_in_regs ? KS : 1][4];
  if constexpr (Tl::q_in_regs) {
    cp_async_wait<1>();  // q has landed
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) q_frag(qf[ks], ks);
  }

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g and g+8

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();  // tile t has landed for this thread
    __syncthreads();     // ... and for every thread; tile t−1 is consumed, its stage free
    if (t + 1 < n_tiles) {
      load_tile(sk + (t + 1) % 2 * TILE, kbase, (t + 1) * kBK, SK);
      load_tile(sv + (t + 1) % 2 * TILE, vbase, (t + 1) * kBK, SK);
      cp_async_commit();
    }
    const __nv_bfloat16* kt = sk + t % 2 * TILE;
    const __nv_bfloat16* vt = sv + t % 2 * TILE;

    // S = Q·Kᵀ: per depth step, one ldmatrix of K gives key tiles j and j+1
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      if constexpr (Tl::q_in_regs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
      } else {
        q_frag(a, ks);
      }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + (8 * j + lane % 8 + (lane / 16) * 8) * LD + 16 * ks
                            + ((lane / 8) % 2) * 8);
        mma_bf16_16816(s[j], a, kb[0], kb[1]);
        mma_bf16_16816(s[j + 1], a, kb[2], kb[3]);
      }
    }

    // the online softmax on S's fragments: lane (g, tq) holds rows g and g+8
    // at keys 8j + 2tq, 8j + 2tq + 1
    const int k0 = t * kBK;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    if (k0 + kBK > SK || (causal && k0 + kBK - 1 > w0)) {  // a tile at an edge of the mask
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * tq + e % 2, qpos = w0 + g + 8 * (e / 2);
          if (kpos >= SK || (causal && kpos > qpos)) s[j][e] = kNegInf;
        }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = row_tree<NT>(s, r, MaxOp{});
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));  // the 4 lanes of the row
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = exp2_approx(s[j][e] - m[e / 2]);
    // l = l·α + this lane's share of the tile's row sum, of the unrounded p
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + row_tree<NT>(s, r, AddOp{});
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P·V: S's accumulators of key tiles 2kk and 2kk+1, rounded to
    // bf16, are the A operand of step kk; ldmatrix.trans gives V's B operand
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (16 * kk + lane % 8 + ((lane / 8) % 2) * 8) * LD + 8 * j
                                  + (lane / 16) * 8);
        mma_bf16_16816(o[j], a, vb[0], vb[1]);
        mma_bf16_16816(o[j + 1], a, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();  // a call with no key tile still has q in flight
  __syncthreads();

  // the row sums over the 4 lanes of a row; the output through the warp's
  // own rows of q (no other warp reads them), then 16-byte stores
  __nv_bfloat16* so = sq + 16 * warp * LD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float denom = fmaxf(sum, 1e-30f);
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(so + (g + 8 * r) * LD + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(o[j][2 * r] / denom, o[j][2 * r + 1] / denom);
  }
  __syncwarp();
  __nv_bfloat16* obase = out + ((long long)b * SQ * H + h) * dim;
#pragma unroll
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, col = (c % CH) * 8, s = w0 + r;
    if (s < SQ && (!kMasked || col < dim))
      *reinterpret_cast<uint4*>(obase + s * rs + col) =
          *reinterpret_cast<const uint4*>(so + r * LD + col);
  }
}

// The dynamic shared memory above 48 KB is allowed once per kernel instance
// (a function-local static), not at every launch.
template <int HD, bool kMasked>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int H, int SQ,
               int SK, int hd, int causal, float scale, cudaStream_t st) {
  constexpr int smem = MmaTile<HD>::smem_bytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel_mma<HD, kMasked>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  using T = __nv_bfloat16;
  const dim3 grid(B * H, (SQ + kMmaRows - 1) / kMmaRows);
  flash_fwd_kernel_mma<HD, kMasked><<<grid, kMmaThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, SQ, SK, hd, causal, scale);
  return cudaGetLastError();
}

template <typename T, int HD, bool kMasked>
int launch_simt(const void* q, const void* k, const void* v, void* out, int B, int H, int SQ,
                int SK, int hd, int causal, float scale, cudaStream_t st) {
  using Tl = Tile<HD>;
  constexpr int smem = Tl::smem_floats * (int)sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD, kMasked>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * H, (SQ + Tl::BQ - 1) / Tl::BQ);
  flash_fwd_kernel<T, HD, kMasked><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, SQ, SK, hd, causal, scale);
  return cudaGetLastError();
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* out, int B, int H, int SQ,
                int SK, int hd, int causal, float scale, cudaStream_t st) {
  const dim3 grid(B * H, (SQ + kWideBQ - 1) / kWideBQ, (hd + kSlice - 1) / kSlice);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  flash_fwd_wide_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, SQ, SK, hd, causal, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// hd ≤ 256 on the instance of the next width up (masked past hd unless
// equal); bf16 on the tensor cores where its 16-byte copies go, else on
// the CUDA cores; past 256 the wide kernel.
template <int HD>
int dispatch_width(const void* q, const void* k, const void* v, void* out, int B, int H, int SQ,
                   int SK, int hd, int causal, float scale, int bf16, cudaStream_t st) {
  using B16 = __nv_bfloat16;
  if (bf16) {
    const bool vec = hd % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
    if (vec && hd == HD) return launch_mma<HD, false>(q, k, v, out, B, H, SQ, SK, hd, causal, scale, st);
    if (vec) return launch_mma<HD, true>(q, k, v, out, B, H, SQ, SK, hd, causal, scale, st);
    return launch_simt<B16, HD, true>(q, k, v, out, B, H, SQ, SK, hd, causal, scale, st);
  }
  if (hd == HD) return launch_simt<float, HD, false>(q, k, v, out, B, H, SQ, SK, hd, causal, scale, st);
  return launch_simt<float, HD, true>(q, k, v, out, B, H, SQ, SK, hd, causal, scale, st);
}

int dispatch(const void* q, const void* k, const void* v, void* out, int B, int H, int SQ,
             int SK, int hd, int causal, float scale, int bf16, cudaStream_t st) {
  if (hd < 1) return cudaErrorInvalidValue;
  if (hd <= 64) return dispatch_width<64>(q, k, v, out, B, H, SQ, SK, hd, causal, scale, bf16, st);
  if (hd <= 128) return dispatch_width<128>(q, k, v, out, B, H, SQ, SK, hd, causal, scale, bf16, st);
  if (hd <= 256) return dispatch_width<256>(q, k, v, out, B, H, SQ, SK, hd, causal, scale, bf16, st);
  if (bf16) return launch_wide<__nv_bfloat16>(q, k, v, out, B, H, SQ, SK, hd, causal, scale, st);
  return launch_wide<float>(q, k, v, out, B, H, SQ, SK, hd, causal, scale, st);
}

}  // namespace

extern "C" {

// q (B, SQ, H, HD), k and v (B, SK, H, HD), out (B, SQ, H, HD): device
// pointers to contiguous arrays of one type (f32, or bf16 when bf16 is 1).
// Any HD ≥ 1 and any alignment; causal masks the keys after the query's row.
// Returns the launch's CUDA error, or 0.
int repro_flash_attention(const void* q, const void* k, const void* v, void* out, int B, int H,
                          int SQ, int SK, int HD, int causal, float scale, int bf16,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (SQ == 0 || B * H == 0) return cudaSuccess;
  return dispatch(q, k, v, out, B, H, SQ, SK, HD, causal, scale, bf16, st);
}

}  // extern "C"
