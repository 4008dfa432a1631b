// Fused attention backward for Hopper (sm_90a).
//
// Replaces no pl.pallas_call: the reference writes its flash backward in jnp,
// as the custom VJP of models/layers.py::blockwise_attention (_fa_backward_impl
// :192, _fa_backward_inner :197). Like it, these kernels never keep the (S × S)
// scores: they recompute each tile of them from q, k and the forward's row
// statistics m and l (csrc/flash_attn.cu writes them), so attention's memory
// in training stays O(S).
//
// Arithmetic, as _fa_backward_inner's, in f32 sums whatever the input type:
//   δ = rowsum(dout ∘ out)
//   s = (q·k)·hd^−½, −1e30 where masked (a key past the sequence, or above the
//       diagonal when causal), p = exp(s − m) / max(l, 1e-30)
//   dv = pᵀ·dout,  dp = dout·vᵀ,  ds = p ∘ (dp − δ)·hd^−½,  dq = ds·k,  dk = dsᵀ·q
// with dq, dk and dv rounded once to the input type. A masked pair gives
// p = 0 exactly, as exp(−1e30 − m) does in the reference.
//
// Two launches on the caller's stream, no atomics, so the gradients come out
// the same bits on every run: a dq kernel, a block per (batch·head, query
// rows), which walks the key tiles and writes δ of its rows (to a scratch the
// second kernel reads) and dq; then a dk/dv kernel, a block per (batch·head,
// keys), which walks the query tiles. Causal calls skip the tiles wholly above
// the diagonal in both, and the longest blocks start first.
//
// Two routes, chosen by shape, each a hand-written kernel pair:
//
// * bf16 on the tensor cores, flash_bwd_dq_kernel_mma and
//   flash_bwd_dkdv_kernel_mma, where the 16-byte copies go (hd a multiple of
//   8, every tensor on a 16-byte boundary; under 256 the next larger instance
//   masked at hd, as the forward's). All five products run on mma.sync
//   m16n8k16, bf16 in and f32 sums, with the forward's parts (csrc/ptx.cuh;
//   the tile loader, fragment reads and staged store of csrc/mma_tile.cuh).
//   The dq kernel keeps its Q and dO rows (64, 16 a warp) in shared memory
//   and computes S = Q·Kᵀ, dP = dO·Vᵀ and dQ += dS·K; the dk/dv kernel keeps
//   its K and V rows and computes Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ, dV += Pᵀ·dO and
//   dK += dSᵀ·Q. That transposed form puts Pᵀ and dSᵀ in the accumulator
//   fragments laid out as the next product's A operand, so they are packed
//   to bf16 in registers, as the forward packs P, and neither P nor dS goes
//   through shared memory. B operands come by ldmatrix: K and V rows, and Q
//   and dO rows, as they lie for the products over hd, and K, dO and Q
//   through ldmatrix.trans for the products over the sequence. The walked
//   tiles (K and V; Q, dO and the rows' m, l and δ) come through a two-stage
//   cp.async ring, 16 bytes a thread (zeros past the sequence and past hd),
//   one barrier a tile, the next tile's copy overlapping this one's products.
//   Rows are padded by 16 bytes so that the 8 rows an ldmatrix reads fall in
//   8 bank groups. p = 2^(s·hd^−½·log2 e − m·log2 e) · (1 / max(l, 1e-30)),
//   one ex2.approx (relative error ~2^-22). p is rounded to bf16 before
//   dV += Pᵀ·dO and ds before dQ and dK (FlashAttention-2's and cuDNN's
//   rounding points); the CUDA-core pair's bf16 instance rounds at the same
//   two points, and flash_attention_bwd_plain takes the same two roundings
//   for bf16 operands, so one plain version holds both bf16 routes. The
//   reference keeps p and ds in f32 and instead rounds s to bf16 (its einsum
//   of bf16 q and k, models/layers.py:220, :227-230), so the two bf16
//   backwards differ by about one such rounding (tests/test_torch_flash_bwd.py).
//   Block shapes, four warps each (the accumulators decide them): the dq
//   kernel 64 query rows, tiles of 64 keys (32 at hd 256: dq, s and dp are
//   then 160 registers); the dk/dv kernel 64 keys of dk and dv, tiles of 64
//   queries at hd 64 and 32 at hd 128, and at hd 256 32 keys with the warps
//   split by gradient (two warps dv, two dk, 16 keys each; 16 keys × 256 of
//   both would be 256 registers a thread). Shared memory: dq 54, 102 and
//   132 KB, dk/dv 56, 69 and 100 KB at hd 64, 128 and 256. Registers a
//   thread (nvcc -Xptxas -v for sm_90a, none spilled): dq 168, 223 and 242,
//   dk/dv 190, 239 and 246 at hd 64, 128 and 256; the masked instances dq
//   162, 234 and 248, dk/dv 230, 241 and 251. So three blocks of four warps
//   an SM for the dq kernel at hd 64, one at hd 256 (its shared memory),
//   two elsewhere.
// * Every other call (f32, or bf16 where the copies cannot go) on the CUDA
//   cores in f32, flash_bwd_dq_kernel and flash_bwd_dkdv_kernel: bf16
//   operands are widened once into shared memory, and p and ds, formed in
//   f32, are rounded to bf16 before the products they enter (f32 keeps them).
//   128 threads as 8 row groups × 16 column groups, as the forward's f32
//   kernel. Tiles: 64/32/16 rows a block at head width 64/128/256 and 64
//   columns a tile step; at hd = 256 the dq kernel holds q, dout, k and v
//   tiles in 169 KB of shared memory and the dk/dv kernel 173 KB, its dk and
//   dv accumulators (16 keys × 256) in registers.
// * Past hd 256 (any type, any alignment) the wide pair on the CUDA cores,
//   flash_bwd_wide_dq_kernel and flash_bwd_wide_dkdv_kernel, modelled on the
//   forward's flash_fwd_wide_kernel: a block owns 16 query rows (dq) or 16
//   keys (dk/dv) and one slice of 64 gradient columns (grid.z), streams q·kᵀ
//   and dout·vᵀ over the width in slices of 64 through shared memory, then
//   adds ds·k, or pᵀ·dout and dsᵀ·q, on its own slice. A row tile's f32
//   accumulators at the full width (16 × 512 × 4 bytes, twice for dk and dv)
//   would not fit the static 48 KB beside the tiles the products stream, and
//   a global scratch would add its bytes to every tile step; so each block
//   keeps only its slice's accumulators in registers (8 or 16 a thread) and
//   recomputes s and dp once a slice, ⌈hd/64⌉ times in all: 5× at hd 320, 8×
//   at 512. Both kernels stay in static shared memory (45 and 42 KB), bf16 is
//   widened on load, p and ds are rounded to bf16 at the same two points as
//   the narrow pair's, δ is written by the first column slice's dq blocks,
//   and each gradient element is written once, with no atomics.
// Widths under 256 run the next larger instance masked at hd.
//
// Bound on an H100 (the larger of the two): the eight tensors (q, k, v, out,
// dout and dq, dk, dv) read or written once, at 3.35 TB/s, and about
// 10·B·H·Sq·Sk·hd operations (4 products of 2·hd a pair, plus the recomputed
// q·kᵀ; half when causal) at 67 TFLOP/s in f32 or 989 TFLOP/s for bf16 on the
// tensor cores. The two-kernel design computes q·kᵀ and dout·vᵀ in both, 14·hd
// a pair; mma.sync reaches a fraction of the bf16 peak, and wgmma with TMA is
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "device.cuh"
#include "mma_tile.cuh"
#include "ptx.cuh"

namespace {

constexpr int kThreads = 128;  // 8 row groups × 16 column groups
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

// x rounded to T and back: p and ds in bf16 before the products they enter,
// as the tensor cores take them (nothing for f32)
template <typename T>
__device__ __forceinline__ float round_as(float x) { return widen(narrow<T>(x)); }

template <int HD>
struct BwdTile {
  static constexpr int BQ = HD == 64 ? 64 : (HD == 128 ? 32 : 16);  // dq: query rows a block
  static constexpr int BKV = BQ;                                    // dk/dv: keys a block
  static constexpr int BT = 64;   // keys (dq) or queries (dk/dv) a tile step
  static constexpr int S = HD + 1;  // padded row stride of the q, dout, k and v tiles
  static constexpr int PS = BT + 1; // padded row stride of the p and ds tiles
  static constexpr int dq_floats = 2 * BQ * S + 2 * BT * S + BQ * PS;
  static constexpr int kv_floats = 2 * BKV * S + 2 * BT * S + 2 * BKV * PS;
};

// Rows row0.. of a (·, H, dim) array into a padded f32 tile of R × HD (zeros
// past n rows and past dim columns).
template <typename T, int R, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* base, long long rs, int row0,
                                          int n, int dim) {
  constexpr int S = HD + 1;
  for (int e = threadIdx.x; e < R * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, s = row0 + r;
    dst[r * S + d] = s < n && d < dim ? widen(base[s * rs + d]) : 0.f;
  }
}

// q, out, dout, dq (B, SQ, H, hd); k, v (B, SK, H, hd); m, l, delta (B, H, SQ)
// f32. grid (B·H, ⌈SQ/BQ⌉), the longest causal blocks first.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ out, const T* __restrict__ dout,
                    const float* __restrict__ m_in, const float* __restrict__ l_in,
                    T* __restrict__ dq, float* __restrict__ delta, int H, int SQ, int SK, int hd,
                    int causal, float scale) {
  using Tl = BwdTile<HD>;
  constexpr int BQ = Tl::BQ, BK = Tl::BT, S = Tl::S, PS = Tl::PS;
  constexpr int RM = BQ / 8;    // query rows a thread holds
  constexpr int CN = BK / 16;   // key columns a thread holds
  constexpr int DN = HD / 16;   // dq columns a thread holds
  extern __shared__ float smem[];
  float* sq = smem;             // BQ × S
  float* sdo = sq + BQ * S;     // BQ × S
  float* sk = sdo + BQ * S;     // BK × S
  float* sv = sk + BK * S;      // BK × S
  float* sds = sv + BK * S;     // BQ × PS

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qb = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = qb * BQ;
  const long long rs = (long long)H * hd;
  const long long qoff = ((long long)b * SQ * H + h) * hd;
  const long long koff = ((long long)b * SK * H + h) * hd;
  const long long roff = (long long)bh * SQ;

  load_rows<T, BQ, HD>(sq, q + qoff, rs, q0, SQ, hd);
  load_rows<T, BQ, HD>(sdo, dout + qoff, rs, q0, SQ, hd);
  __syncthreads();

  // δ of the block's rows: each of a row's 16 threads sums its columns, then
  // the 16 add up (the same 16 lanes of one warp)
  float mi[RM], li[RM], di[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 8 * i, s = q0 + r;
    float part = 0.f;
    if (s < SQ)
      for (int d = tx; d < hd; d += 16) part = fmaf(sdo[r * S + d], widen(out[qoff + s * rs + d]), part);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    di[i] = part;
    mi[i] = s < SQ ? m_in[roff + s] : 0.f;
    li[i] = s < SQ ? fmaxf(l_in[roff + s], 1e-30f) : 1.f;
    if (s < SQ && tx == 0) delta[roff + s] = part;
  }

  float acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;

  int n_tiles = (SK + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, SQ) - 1) / BK + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's k, v and ds are consumed
    load_rows<T, BK, HD>(sk, k + koff, rs, k0, SK, hd);
    load_rows<T, BK, HD>(sv, v + koff, rs, k0, SK, hd);
    __syncthreads();

    // s = q·kᵀ and dp = dout·vᵀ on the thread's RM × CN pairs
    float st[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) st[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[RM], ad[RM], c[CN], cv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        a[i] = sq[(ty + 8 * i) * S + d];
        ad[i] = sdo[(ty + 8 * i) * S + d];
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        c[j] = sk[(tx + 16 * j) * S + d];
        cv[j] = sv[(tx + 16 * j) * S + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          st[i][j] = fmaf(a[i], c[j], st[i][j]);
          dp[i][j] = fmaf(ad[i], cv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + ty + 8 * i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = qpos < SQ && kpos < SK && (!causal || kpos <= qpos);
        const float p = valid ? expf(st[i][j] * scale - mi[i]) / li[i] : 0.f;
        sds[(ty + 8 * i) * PS + tx + 16 * j] = round_as<T>(p * (dp[i][j] - di[i]) * scale);
      }
    }
    __syncthreads();

    // dq += ds·k
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[RM], w[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) ds[i] = sds[(ty + 8 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) w[j] = sk[c * S + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(ds[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int s = q0 + ty + 8 * i;
    if (s >= SQ) continue;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) dq[qoff + s * rs + col] = narrow<T>(acc[i][j]);
    }
  }
}

// q, dout (B, SQ, H, hd); k, v, dk, dv (B, SK, H, hd); m, l, delta (B, H, SQ)
// f32, delta written by flash_bwd_dq_kernel. grid (B·H, ⌈SK/BKV⌉), the
// longest causal blocks (the first keys) first.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ m_in,
                      const float* __restrict__ l_in, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int H, int SQ, int SK, int hd,
                      int causal, float scale) {
  using Tl = BwdTile<HD>;
  constexpr int BKV = Tl::BKV, BQ = Tl::BT, S = Tl::S, PS = Tl::PS;
  constexpr int RM = BKV / 8;   // keys a thread holds
  constexpr int CN = BQ / 16;   // query columns a thread holds
  constexpr int DN = HD / 16;   // dk and dv columns a thread holds
  extern __shared__ float smem[];
  float* sk = smem;             // BKV × S
  float* sv = sk + BKV * S;     // BKV × S
  float* sq = sv + BKV * S;     // BQ × S
  float* sdo = sq + BQ * S;     // BQ × S
  float* sp = sdo + BQ * S;     // BKV × PS
  float* sds = sp + BKV * PS;   // BKV × PS
  __shared__ float sm[BQ], sl[BQ], sdelta[BQ];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BKV;
  const long long rs = (long long)H * hd;
  const long long qoff = ((long long)b * SQ * H + h) * hd;
  const long long koff = ((long long)b * SK * H + h) * hd;
  const long long roff = (long long)bh * SQ;

  load_rows<T, BKV, HD>(sk, k + koff, rs, k0, SK, hd);
  load_rows<T, BKV, HD>(sv, v + koff, rs, k0, SK, hd);

  float gk[RM][DN], gv[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) gk[i][j] = gv[i][j] = 0.f;

  const int n_tiles = (SQ + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's q, dout, p and ds are consumed
    load_rows<T, BQ, HD>(sq, q + qoff, rs, q0, SQ, hd);
    load_rows<T, BQ, HD>(sdo, dout + qoff, rs, q0, SQ, hd);
    for (int r = tid; r < BQ; r += kThreads) {
      const int s = q0 + r;
      sm[r] = s < SQ ? m_in[roff + s] : 0.f;
      sl[r] = s < SQ ? fmaxf(l_in[roff + s], 1e-30f) : 1.f;
      sdelta[r] = s < SQ ? delta[roff + s] : 0.f;
    }
    __syncthreads();

    // sᵀ = k·qᵀ and dpᵀ = v·doutᵀ on the thread's RM keys × CN queries
    float st[RM][CN], dpt[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[RM], av[RM], c[CN], cd[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        a[i] = sk[(ty + 8 * i) * S + d];
        av[i] = sv[(ty + 8 * i) * S + d];
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        c[j] = sq[(tx + 16 * j) * S + d];
        cd[j] = sdo[(tx + 16 * j) * S + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          st[i][j] = fmaf(a[i], c[j], st[i][j]);
          dpt[i][j] = fmaf(av[i], cd[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int kpos = k0 + ty + 8 * i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = tx + 16 * j, qpos = q0 + c;
        const bool valid = qpos < SQ && kpos < SK && (!causal || kpos <= qpos);
        const float p = valid ? expf(st[i][j] * scale - sm[c]) / sl[c] : 0.f;
        sp[(ty + 8 * i) * PS + c] = round_as<T>(p);
        sds[(ty + 8 * i) * PS + c] = round_as<T>(p * (dpt[i][j] - sdelta[c]) * scale);
      }
    }
    __syncthreads();

    // dv += pᵀ·dout, dk += dsᵀ·q over the tile's queries in order
#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float p[RM], ds[RM], wdo[DN], wq[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        p[i] = sp[(ty + 8 * i) * PS + c];
        ds[i] = sds[(ty + 8 * i) * PS + c];
      }
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        wdo[j] = sdo[c * S + tx + 16 * j];
        wq[j] = sq[c * S + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) {
          gv[i][j] = fmaf(p[i], wdo[j], gv[i][j]);
          gk[i][j] = fmaf(ds[i], wq[j], gk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int s = k0 + ty + 8 * i;
    if (s >= SK) continue;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) {
        dk[koff + s * rs + col] = narrow<T>(gk[i][j]);
        dv[koff + s * rs + col] = narrow<T>(gv[i][j]);
      }
    }
  }
}

// ---- bf16 on the tensor cores

using bf16 = __nv_bfloat16;

template <int HD>
struct MmaBwdTile {
  static constexpr int LD = HD + 8;             // padded row, in bf16 elements
  static constexpr int BQ = 16 * kMmaWarps;     // dq: query rows a block, 16 a warp
  static constexpr int BK = HD == 256 ? 32 : 64;  // dq: keys a tile step
  // dk/dv: at hd 256 the warps split the gradients, two on dv and two on dk
  // of the same 32 keys; below it each warp takes both for 16 keys
  static constexpr bool split = HD == 256;
  static constexpr int BKV = split ? 32 : 64;     // keys a block
  static constexpr int BT = HD == 64 ? 64 : 32;   // queries a tile step
  static constexpr int dq_smem = (2 * BQ + 4 * BK) * LD * 2;
  static constexpr int kv_smem = (2 * BKV + 4 * BT) * LD * 2 + 2 * 3 * BT * 4;
};

// q, out, dout, dq (B, SQ, H, dim); k, v (B, SK, H, dim), bf16 on 16-byte
// boundaries, dim = hd (a multiple of 8) when kMasked, else HD; m, l, delta
// (B, H, SQ) f32. grid (B·H, ⌈SQ/64⌉), the longest causal blocks first.
template <int HD, bool kMasked>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ out,
                        const bf16* __restrict__ dout, const float* __restrict__ m_in,
                        const float* __restrict__ l_in, bf16* __restrict__ dq,
                        float* __restrict__ delta, int H, int SQ, int SK, int hd, int causal,
                        float scale) {
  using Tl = MmaBwdTile<HD>;
  constexpr int LD = Tl::LD, BQ = Tl::BQ, BK = Tl::BK;
  constexpr int NT = BK / 8;   // 8-key column tiles of S and dP
  constexpr int DT = HD / 8;   // 8-wide column tiles of dQ
  constexpr int KS = HD / 16;  // 16-deep steps over hd
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // BQ × LD
  bf16* sdo = sq + BQ * LD;                       // BQ × LD
  bf16* sk = sdo + BQ * LD;                       // two stages of BK × LD
  bf16* sv = sk + 2 * BK * LD;                    // two stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int qb = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = qb * BQ, w0 = q0 + 16 * warp;  // the block's and the warp's first row
  const int dim = kMasked ? hd : HD;
  const long long rs = (long long)H * dim;
  const long long qoff = ((long long)b * SQ * H + h) * dim;
  const long long koff = ((long long)b * SK * H + h) * dim;
  const long long roff = (long long)bh * SQ;
  const float scale2 = scale * kLog2e;  // s in log2 units: p is one exp2

  int n_tiles = (SK + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, SQ) - 1) / BK + 1);
  // commit groups: q and dout, then each key tile (k and v)
  load_tile<BQ, HD, kMasked>(sq, q + qoff, rs, q0, SQ, dim);
  load_tile<BQ, HD, kMasked>(sdo, dout + qoff, rs, q0, SQ, dim);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<BK, HD, kMasked>(sk, k + koff, rs, 0, SK, dim);
    load_tile<BK, HD, kMasked>(sv, v + koff, rs, 0, SK, dim);
  }
  cp_async_commit();
  cp_async_wait<1>();  // q and dout have landed for this thread
  __syncthreads();     // ... and for every thread

  // δ of the warp's 16 rows: lanes 2r and 2r+1 sum row r over alternate
  // 8-column chunks (dout from shared memory, out from device memory); then
  // lane (g, tq) takes rows g and g+8, with their m (log2 units) and 1/l
  float dl[2], ml[2], rl[2];
  {
    const int r = lane / 2, s = w0 + r;
    float part = 0.f;
    if (s < SQ) {
      const bf16* orow = out + qoff + s * rs;
      const bf16* drow = sdo + (16 * warp + r) * LD;
#pragma unroll 4
      for (int c = (lane % 2) * 8; c < HD; c += 16) {
        if (kMasked && c >= dim) break;
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
          part = fmaf(df.x, of.x, part);
          part = fmaf(df.y, of.y, part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (lane % 2 == 0 && s < SQ) delta[roff + s] = part;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      dl[rr] = __shfl_sync(0xffffffffu, part, 2 * (g + 8 * rr));
      const int sr = w0 + g + 8 * rr;
      ml[rr] = sr < SQ ? m_in[roff + sr] * kLog2e : 0.f;
      rl[rr] = sr < SQ ? 1.f / fmaxf(l_in[roff + sr], 1e-30f) : 0.f;
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();  // tile t has landed for this thread
    __syncthreads();     // ... and for every thread; tile t−1 is consumed, its stage free
    if (t + 1 < n_tiles) {
      load_tile<BK, HD, kMasked>(sk + (t + 1) % 2 * BK * LD, k + koff, rs, (t + 1) * BK, SK, dim);
      load_tile<BK, HD, kMasked>(sv + (t + 1) % 2 * BK * LD, v + koff, rs, (t + 1) * BK, SK, dim);
      cp_async_commit();
    }
    const int k0 = t * BK;
    if (w0 >= SQ || (causal && k0 > w0 + 15)) continue;  // no row of the warp sees the tile
    const bf16* kt = sk + t % 2 * BK * LD;
    const bf16* vt = sv + t % 2 * BK * LD;

    // S = Q·Kᵀ and dP = dO·Vᵀ: lane (g, tq) holds rows g and g+8 at keys
    // 8j + 2tq and 8j + 2tq + 1
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t aq[4], ad[4];
      a_frag<LD>(aq, sq, 16 * warp, ks, lane);
      a_frag<LD>(ad, sdo, 16 * warp, ks, lane);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kb[4], vb[4];
        b_frag_rows<LD>(kb, kt, j, ks, lane);
        b_frag_rows<LD>(vb, vt, j, ks, lane);
        mma_bf16_16816(s[j], aq, kb[0], kb[1]);
        mma_bf16_16816(s[j + 1], aq, kb[2], kb[3]);
        mma_bf16_16816(dp[j], ad, vb[0], vb[1]);
        mma_bf16_16816(dp[j + 1], ad, vb[2], vb[3]);
      }
    }

    // p, then ds = p ∘ (dp − δ)·hd^−½ in place of s
    const bool edge = k0 + BK > SK || (causal && k0 + BK - 1 > w0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2_approx(s[j][e] * scale2 - ml[e / 2]) * rl[e / 2];
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * tq + e % 2, qpos = w0 + g + 8 * (e / 2);
          if (kpos >= SK || (causal && kpos > qpos)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - dl[e / 2]) * scale;
      }

    // dQ += dS·K: ds rounded to bf16 is the A operand of depth step kk (key
    // tiles 2kk and 2kk+1); ldmatrix.trans gives K's B operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t kb[4];
        b_frag_trans<LD>(kb, kt, j, kk, lane);
        mma_bf16_16816(acc[j], a, kb[0], kb[1]);
        mma_bf16_16816(acc[j + 1], a, kb[2], kb[3]);
      }
    }
  }
  cp_async_wait<0>();  // a call with no key tile still has an empty group in flight
  __syncwarp();
  // dq through the warp's own rows of q (no other warp reads them)
  store_rows<HD, kMasked>(acc, sq + 16 * warp * LD, dq + qoff, rs, w0, SQ, dim, lane);
}

// q, dout (B, SQ, H, dim); k, v, dk, dv (B, SK, H, dim), bf16 as the dq
// kernel's; m, l, delta (B, H, SQ) f32, delta written by
// flash_bwd_dq_kernel_mma. grid (B·H, ⌈SK/BKV⌉), the longest causal blocks
// (the first keys) first.
template <int HD, bool kMasked>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ m_in, const float* __restrict__ l_in,
                          const float* __restrict__ delta, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int H, int SQ, int SK, int hd, int causal,
                          float scale) {
  using Tl = MmaBwdTile<HD>;
  constexpr int LD = Tl::LD, BKV = Tl::BKV, BT = Tl::BT;
  constexpr bool kSplit = Tl::split;
  constexpr int NT = BT / 8;   // 8-query column tiles of Sᵀ and dPᵀ
  constexpr int DT = HD / 8;   // 8-wide column tiles of dK and dV
  constexpr int KS = HD / 16;  // 16-deep steps over hd
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // BKV × LD
  bf16* sv = sk + BKV * LD;                       // BKV × LD
  bf16* sq = sv + BKV * LD;                       // two stages of BT × LD
  bf16* sdo = sq + 2 * BT * LD;                   // two stages
  float* sst = reinterpret_cast<float*>(sdo + 2 * BT * LD);  // two stages of m, l, δ (3 × BT)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BKV;
  // the warp's 16 keys (rows kr.. of the block's tile) and its gradients
  const int kr = 16 * (kSplit ? warp % 2 : warp), kw0 = k0 + kr;
  const bool do_dv = !kSplit || warp < 2, do_dk = !kSplit || warp >= 2;
  const int dim = kMasked ? hd : HD;
  const long long rs = (long long)H * dim;
  const long long qoff = ((long long)b * SQ * H + h) * dim;
  const long long koff = ((long long)b * SK * H + h) * dim;
  const long long roff = (long long)bh * SQ;
  const float scale2 = scale * kLog2e;

  // query tile t into stage t % 2: q, dout, and the rows' m, l, δ (zeros past SQ)
  auto load_queries = [&](int t) {
    const int st = t % 2, r0 = t * BT;
    load_tile<BT, HD, kMasked>(sq + st * BT * LD, q + qoff, rs, r0, SQ, dim);
    load_tile<BT, HD, kMasked>(sdo + st * BT * LD, dout + qoff, rs, r0, SQ, dim);
    for (int i = tid; i < 3 * BT; i += kMmaThreads) {
      const int r = i % BT, s = r0 + r;
      const float* src = i < BT ? m_in : (i < 2 * BT ? l_in : delta);
      const bool in = s < SQ;
      cp_async<4>(sst + st * 3 * BT + i, in ? src + roff + s : src, in ? 4 : 0);
    }
  };

  const int n_tiles = (SQ + BT - 1) / BT;
  const int t0 = causal ? k0 / BT : 0;
  // commit groups: k and v, then each query tile
  load_tile<BKV, HD, kMasked>(sk, k + koff, rs, k0, SK, dim);
  load_tile<BKV, HD, kMasked>(sv, v + koff, rs, k0, SK, dim);
  cp_async_commit();
  if (t0 < n_tiles) load_queries(t0);
  cp_async_commit();

  // dv in acc[0] and dk in acc[1]; split, the warp's one gradient in acc[0]
  constexpr int NA = kSplit ? 1 : 2;
  float acc[NA][DT][4];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[a][j][0] = acc[a][j][1] = acc[a][j][2] = acc[a][j][3] = 0.f;
  float(&gv)[DT][4] = acc[0];
  float(&gk)[DT][4] = acc[NA - 1];

  for (int t = t0; t < n_tiles; ++t) {
    cp_async_wait<0>();  // tile t (and k, v) landed for this thread
    __syncthreads();     // ... and for every thread; tile t−1 is consumed, its stage free
    if (t + 1 < n_tiles) {
      load_queries(t + 1);
      cp_async_commit();
    }
    const int q0 = t * BT;
    if (kw0 >= SK || (causal && q0 + BT - 1 < kw0)) continue;  // no key of the warp is seen
    const bf16* qt = sq + t % 2 * BT * LD;
    const bf16* dot = sdo + t % 2 * BT * LD;
    const float* st = sst + t % 2 * 3 * BT;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: lane (g, tq) holds keys kr+g and kr+g+8 at
    // queries 8j + 2tq and 8j + 2tq + 1 of the tile
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ak[4];
      a_frag<LD>(ak, sk, kr, ks, lane);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t qb[4];
        b_frag_rows<LD>(qb, qt, j, ks, lane);
        mma_bf16_16816(s[j], ak, qb[0], qb[1]);
        mma_bf16_16816(s[j + 1], ak, qb[2], qb[3]);
      }
      if (do_dk) {
        uint32_t av[4];
        a_frag<LD>(av, sv, kr, ks, lane);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t db[4];
          b_frag_rows<LD>(db, dot, j, ks, lane);
          mma_bf16_16816(dp[j], av, db[0], db[1]);
          mma_bf16_16816(dp[j + 1], av, db[2], db[3]);
        }
      }
    }

    // pᵀ in place of sᵀ, dsᵀ = pᵀ ∘ (dpᵀ − δ)·hd^−½ in place of dpᵀ; each
    // query column's m (log2 units), 1/l and δ from the tile's stage
    const bool edge = q0 + BT > SQ || kw0 + 16 > SK || (causal && kw0 + 15 > q0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int c = 8 * j + 2 * tq + c2;
        const float mc = st[c] * kLog2e, rc = 1.f / fmaxf(st[BT + c], 1e-30f), dc = st[2 * BT + c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int e = 2 * r + c2;
          float p = exp2_approx(s[j][e] * scale2 - mc) * rc;
          if (edge) {
            const int kpos = kw0 + g + 8 * r, qpos = q0 + c;
            if (qpos >= SQ || kpos >= SK || (causal && kpos > qpos)) p = 0.f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dc) * scale;
        }
      }

    // dV += Pᵀ·dO and dK += dSᵀ·Q over the tile's queries: pᵀ and dsᵀ
    // rounded to bf16 are the A operands of depth step kk (query tiles 2kk
    // and 2kk+1); ldmatrix.trans gives dO's and Q's B operands
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      if (do_dv) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < DT; j += 2) {
          uint32_t db[4];
          b_frag_trans<LD>(db, dot, j, kk, lane);
          mma_bf16_16816(gv[j], a, db[0], db[1]);
          mma_bf16_16816(gv[j + 1], a, db[2], db[3]);
        }
      }
      if (do_dk) {
        const uint32_t a[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                               pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                               pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                               pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int j = 0; j < DT; j += 2) {
          uint32_t qb[4];
          b_frag_trans<LD>(qb, qt, j, kk, lane);
          mma_bf16_16816(gk[j], a, qb[0], qb[1]);
          mma_bf16_16816(gk[j + 1], a, qb[2], qb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with k and v: they stage the results
  // dv through the warp's rows of v, dk through its rows of k
  if (do_dv) store_rows<HD, kMasked>(gv, sv + kr * LD, dv + koff, rs, kw0, SK, dim, lane);
  if (do_dk) store_rows<HD, kMasked>(gk, sk + kr * LD, dk + koff, rs, kw0, SK, dim, lane);
}

template <int HD, bool kMasked>
int launch_mma(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* m, const float* l, void* dq, void* dk, void* dv, float* delta, int B,
               int H, int SQ, int SK, int hd, int causal, float scale, cudaStream_t st) {
  using Tl = MmaBwdTile<HD>;
  static const cudaError_t attr_dq =
      cudaFuncSetAttribute(flash_bwd_dq_kernel_mma<HD, kMasked>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::dq_smem);
  static const cudaError_t attr_kv =
      cudaFuncSetAttribute(flash_bwd_dkdv_kernel_mma<HD, kMasked>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::kv_smem);
  if (attr_dq != cudaSuccess) return attr_dq;
  if (attr_kv != cudaSuccess) return attr_kv;
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  const dim3 grid_q(B * H, (SQ + Tl::BQ - 1) / Tl::BQ);
  const dim3 grid_k(B * H, (SK + Tl::BKV - 1) / Tl::BKV);
  if (grid_q.y > 65535 || grid_k.y > 65535) return cudaErrorInvalidValue;
  flash_bwd_dq_kernel_mma<HD, kMasked><<<grid_q, kMmaThreads, Tl::dq_smem, st>>>(
      tq, tk, tv, static_cast<const bf16*>(out), tdo, m, l, static_cast<bf16*>(dq), delta, H, SQ,
      SK, hd, causal, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || SK == 0) return err;
  flash_bwd_dkdv_kernel_mma<HD, kMasked><<<grid_k, kMmaThreads, Tl::kv_smem, st>>>(
      tq, tk, tv, tdo, m, l, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, SQ, SK, hd,
      causal, scale);
  return cudaGetLastError();
}

// ---- head widths past 256: the wide pair, on the CUDA cores

constexpr int kSlice = 64;     // head dims a step of q·kᵀ and dout·vᵀ, and gradient columns a block
constexpr int kWideRows = 16;  // dq: query rows a block; dk/dv: keys a block
constexpr int kWideStep = 64;  // dq: keys a tile step; dk/dv: queries a tile step

// A kRows × kSlice slice (columns c0..) of rows row0.. of a (·, H, HD) array
// into a padded f32 tile (zeros past n rows and past HD columns).
template <typename T, int R>
__device__ __forceinline__ void load_slice(float* dst, const T* base, long long rs, int row0,
                                           int n, int c0, int HD) {
  constexpr int S = kSlice + 1;
  for (int e = threadIdx.x; e < R * kSlice; e += kThreads) {
    const int r = e / kSlice, d = e % kSlice, s = row0 + r;
    dst[r * S + d] = s < n && c0 + d < HD ? widen(base[s * rs + c0 + d]) : 0.f;
  }
}

// As flash_bwd_dq_kernel, for any HD; grid (B·H, ⌈SQ/16⌉, ⌈HD/64⌉), the
// longest causal blocks first: blockIdx.z is the block's slice of 64 dq
// columns. Every block of a row tile recomputes the same s and dp over the
// whole width (the slices of 64 in order) and δ of its rows; the first
// column slice's block writes δ.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ out,
                         const T* __restrict__ dout, const float* __restrict__ m_in,
                         const float* __restrict__ l_in, T* __restrict__ dq,
                         float* __restrict__ delta, int H, int SQ, int SK, int HD, int causal,
                         float scale) {
  constexpr int BQ = kWideRows, BK = kWideStep, S = kSlice + 1, PS = BK + 1;
  constexpr int RM = BQ / 8, CN = BK / 16, DN = kSlice / 16;
  __shared__ float sq[BQ * S], sdo[BQ * S], sk[BK * S], sv[BK * S], sds[BQ * PS];  // 45 KB

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qb = gridDim.y - 1 - blockIdx.y;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = qb * BQ, c0 = blockIdx.z * kSlice;
  const long long rs = (long long)H * HD;
  const long long qoff = ((long long)b * SQ * H + h) * HD;
  const long long koff = ((long long)b * SK * H + h) * HD;
  const long long roff = (long long)bh * SQ;

  // δ of the block's rows, in the narrow kernels' order: each of a row's 16
  // threads sums its columns, then the 16 add up
  float mi[RM], li[RM], di[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int s = q0 + ty + 8 * i;
    float part = 0.f;
    if (s < SQ)
      for (int d = tx; d < HD; d += 16)
        part = fmaf(widen(dout[qoff + s * rs + d]), widen(out[qoff + s * rs + d]), part);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    di[i] = part;
    mi[i] = s < SQ ? m_in[roff + s] : 0.f;
    li[i] = s < SQ ? fmaxf(l_in[roff + s], 1e-30f) : 1.f;
    if (s < SQ && tx == 0 && blockIdx.z == 0) delta[roff + s] = part;
  }

  float acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;

  int n_tiles = (SK + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, SQ) - 1) / BK + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    // s = q·kᵀ and dp = dout·vᵀ over the width, a slice of 64 at a time
    float st[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) st[i][j] = dp[i][j] = 0.f;
    for (int d0 = 0; d0 < HD; d0 += kSlice) {
      __syncthreads();  // the previous slice, and the previous tile's k and ds, are consumed
      load_slice<T, BQ>(sq, q + qoff, rs, q0, SQ, d0, HD);
      load_slice<T, BQ>(sdo, dout + qoff, rs, q0, SQ, d0, HD);
      load_slice<T, BK>(sk, k + koff, rs, k0, SK, d0, HD);
      load_slice<T, BK>(sv, v + koff, rs, k0, SK, d0, HD);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kSlice; ++d) {
        float a[RM], ad[RM], c[CN], cv[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          a[i] = sq[(ty + 8 * i) * S + d];
          ad[i] = sdo[(ty + 8 * i) * S + d];
        }
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          c[j] = sk[(tx + 16 * j) * S + d];
          cv[j] = sv[(tx + 16 * j) * S + d];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            st[i][j] = fmaf(a[i], c[j], st[i][j]);
            dp[i][j] = fmaf(ad[i], cv[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + ty + 8 * i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = qpos < SQ && kpos < SK && (!causal || kpos <= qpos);
        const float p = valid ? expf(st[i][j] * scale - mi[i]) / li[i] : 0.f;
        sds[(ty + 8 * i) * PS + tx + 16 * j] = round_as<T>(p * (dp[i][j] - di[i]) * scale);
      }
    }
    __syncthreads();  // ds is written and the last slice of k is consumed
    load_slice<T, BK>(sk, k + koff, rs, k0, SK, c0, HD);
    __syncthreads();

    // dq[:, c0 slice] += ds·k[:, c0 slice]
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[RM], w[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) ds[i] = sds[(ty + 8 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) w[j] = sk[c * S + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(ds[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int s = q0 + ty + 8 * i;
    if (s >= SQ) continue;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < HD) dq[qoff + s * rs + col] = narrow<T>(acc[i][j]);
    }
  }
}

// As flash_bwd_dkdv_kernel, for any HD; grid (B·H, ⌈SK/16⌉, ⌈HD/64⌉):
// blockIdx.z is the block's slice of 64 dk and dv columns. Each block
// recomputes sᵀ and dpᵀ of its 16 keys against a tile of 64 queries over the
// whole width, then adds pᵀ·dout and dsᵀ·q on its slice. The k and v slices
// of the recompute and the p and ds tiles of the sums share their shared
// memory (42 KB in all).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_wide_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ m_in, const float* __restrict__ l_in,
                           const float* __restrict__ delta, T* __restrict__ dk,
                           T* __restrict__ dv, int H, int SQ, int SK, int HD, int causal,
                           float scale) {
  constexpr int BKV = kWideRows, BQ = kWideStep, S = kSlice + 1, PS = BQ + 1;
  constexpr int RM = BKV / 8, CN = BQ / 16, DN = kSlice / 16;
  static_assert(PS == S, "the p and ds tiles reuse the k and v slices' memory");
  __shared__ float skv[2 * BKV * S], sq[BQ * S], sdo[BQ * S];
  __shared__ float sm[BQ], sl[BQ], sdelta[BQ];
  float* sk = skv;              // BKV × S, while s and dp are recomputed
  float* sv = skv + BKV * S;
  float* sp = skv;              // BKV × PS, while dv and dk are summed
  float* sds = skv + BKV * PS;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BKV, c0 = blockIdx.z * kSlice;
  const long long rs = (long long)H * HD;
  const long long qoff = ((long long)b * SQ * H + h) * HD;
  const long long koff = ((long long)b * SK * H + h) * HD;
  const long long roff = (long long)bh * SQ;

  float gk[RM][DN], gv[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) gk[i][j] = gv[i][j] = 0.f;

  const int n_tiles = (SQ + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's statistics, q, dout, p and ds are consumed
    for (int r = tid; r < BQ; r += kThreads) {
      const int s = q0 + r;
      sm[r] = s < SQ ? m_in[roff + s] : 0.f;
      sl[r] = s < SQ ? fmaxf(l_in[roff + s], 1e-30f) : 1.f;
      sdelta[r] = s < SQ ? delta[roff + s] : 0.f;
    }
    // sᵀ = k·qᵀ and dpᵀ = v·doutᵀ on the thread's RM keys × CN queries
    float st[RM][CN], dpt[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) st[i][j] = dpt[i][j] = 0.f;
    for (int d0 = 0; d0 < HD; d0 += kSlice) {
      __syncthreads();
      load_slice<T, BKV>(sk, k + koff, rs, k0, SK, d0, HD);
      load_slice<T, BKV>(sv, v + koff, rs, k0, SK, d0, HD);
      load_slice<T, BQ>(sq, q + qoff, rs, q0, SQ, d0, HD);
      load_slice<T, BQ>(sdo, dout + qoff, rs, q0, SQ, d0, HD);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kSlice; ++d) {
        float a[RM], av[RM], c[CN], cd[CN];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          a[i] = sk[(ty + 8 * i) * S + d];
          av[i] = sv[(ty + 8 * i) * S + d];
        }
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          c[j] = sq[(tx + 16 * j) * S + d];
          cd[j] = sdo[(tx + 16 * j) * S + d];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < CN; ++j) {
            st[i][j] = fmaf(a[i], c[j], st[i][j]);
            dpt[i][j] = fmaf(av[i], cd[j], dpt[i][j]);
          }
      }
    }
    __syncthreads();  // the k and v slices are consumed: their memory takes p and ds
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int kpos = k0 + ty + 8 * i;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = tx + 16 * j, qpos = q0 + c;
        const bool valid = qpos < SQ && kpos < SK && (!causal || kpos <= qpos);
        const float p = valid ? expf(st[i][j] * scale - sm[c]) / sl[c] : 0.f;
        sp[(ty + 8 * i) * PS + c] = round_as<T>(p);
        sds[(ty + 8 * i) * PS + c] = round_as<T>(p * (dpt[i][j] - sdelta[c]) * scale);
      }
    }
    load_slice<T, BQ>(sq, q + qoff, rs, q0, SQ, c0, HD);
    load_slice<T, BQ>(sdo, dout + qoff, rs, q0, SQ, c0, HD);
    __syncthreads();

    // dv[:, c0 slice] += pᵀ·dout[:, c0 slice], dk[:, c0 slice] += dsᵀ·q[:, c0 slice]
#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      float p[RM], ds[RM], wdo[DN], wq[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        p[i] = sp[(ty + 8 * i) * PS + c];
        ds[i] = sds[(ty + 8 * i) * PS + c];
      }
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        wdo[j] = sdo[c * S + tx + 16 * j];
        wq[j] = sq[c * S + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) {
          gv[i][j] = fmaf(p[i], wdo[j], gv[i][j]);
          gk[i][j] = fmaf(ds[i], wq[j], gk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int s = k0 + ty + 8 * i;
    if (s >= SK) continue;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int col = c0 + tx + 16 * j;
      if (col < HD) {
        dk[koff + s * rs + col] = narrow<T>(gk[i][j]);
        dv[koff + s * rs + col] = narrow<T>(gv[i][j]);
      }
    }
  }
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, const void* out, const void* dout,
                const float* m, const float* l, void* dq, void* dk, void* dv, float* delta,
                int B, int H, int SQ, int SK, int HD, int causal, float scale, cudaStream_t st) {
  const int slices = (HD + kSlice - 1) / kSlice;
  const dim3 grid_q(B * H, (SQ + kWideRows - 1) / kWideRows, slices);
  const dim3 grid_k(B * H, (SK + kWideRows - 1) / kWideRows, slices);
  if (grid_q.y > 65535 || grid_k.y > 65535) return cudaErrorInvalidValue;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  flash_bwd_wide_dq_kernel<T><<<grid_q, kThreads, 0, st>>>(
      tq, tk, tv, static_cast<const T*>(out), tdo, m, l, static_cast<T*>(dq), delta, H, SQ, SK,
      HD, causal, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || SK == 0) return err;
  flash_bwd_wide_dkdv_kernel<T><<<grid_k, kThreads, 0, st>>>(
      tq, tk, tv, tdo, m, l, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, SQ, SK, HD,
      causal, scale);
  return cudaGetLastError();
}

// ---- dispatch

// The dynamic shared memory above 48 KB is allowed once per kernel instance
// (a function-local static), not at every launch.
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* m, const float* l, void* dq, void* dk, void* dv, float* delta, int B,
           int H, int SQ, int SK, int hd, int causal, float scale, cudaStream_t st) {
  using Tl = BwdTile<HD>;
  constexpr int dq_smem = Tl::dq_floats * (int)sizeof(float);
  constexpr int kv_smem = Tl::kv_floats * (int)sizeof(float);
  static const cudaError_t attr_dq = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  if (attr_dq != cudaSuccess) return attr_dq;
  if (attr_kv != cudaSuccess) return attr_kv;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const dim3 grid_q(B * H, (SQ + Tl::BQ - 1) / Tl::BQ);
  const dim3 grid_k(B * H, (SK + Tl::BKV - 1) / Tl::BKV);
  if (grid_q.y > 65535 || grid_k.y > 65535) return cudaErrorInvalidValue;
  flash_bwd_dq_kernel<T, HD><<<grid_q, kThreads, dq_smem, st>>>(
      tq, tk, tv, static_cast<const T*>(out), tdo, m, l, static_cast<T*>(dq), delta, H, SQ, SK, hd,
      causal, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || SK == 0) return err;
  flash_bwd_dkdv_kernel<T, HD><<<grid_k, kThreads, kv_smem, st>>>(
      tq, tk, tv, tdo, m, l, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, SQ, SK, hd,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const float* m, const float* l, void* dq, void* dk, void* dv, float* delta, int B,
             int H, int SQ, int SK, int hd, int causal, float scale, cudaStream_t st) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, dout, m, l, dq, dk, dv, delta, B, H, SQ, SK, hd, causal,
                         scale, st);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, out, dout, m, l, dq, dk, dv, delta, B, H, SQ, SK, hd, causal,
                          scale, st);
  return launch<T, 256>(q, k, v, out, dout, m, l, dq, dk, dv, delta, B, H, SQ, SK, hd, causal,
                        scale, st);
}

template <int HD>
int dispatch_mma(const void* q, const void* k, const void* v, const void* out, const void* dout,
                 const float* m, const float* l, void* dq, void* dk, void* dv, float* delta,
                 int B, int H, int SQ, int SK, int hd, int causal, float scale, cudaStream_t st) {
  if (hd == HD)
    return launch_mma<HD, false>(q, k, v, out, dout, m, l, dq, dk, dv, delta, B, H, SQ, SK, hd,
                                 causal, scale, st);
  return launch_mma<HD, true>(q, k, v, out, dout, m, l, dq, dk, dv, delta, B, H, SQ, SK, hd,
                              causal, scale, st);
}

// bf16 on the tensor cores where its 16-byte copies go (hd a multiple of 8,
// every tensor on a 16-byte boundary), on the instance of the next width up
int dispatch_bf16(const void* q, const void* k, const void* v, const void* out, const void* dout,
                  const float* m, const float* l, void* dq, void* dk, void* dv, float* delta,
                  int B, int H, int SQ, int SK, int hd, int causal, float scale, cudaStream_t st) {
  const void* ptrs[] = {q, k, v, out, dout, dq, dk, dv};
  bool vec = hd % 8 == 0;
  for (const void* p : ptrs) vec = vec && aligned16(p);
  if (!vec)
    return dispatch<bf16>(q, k, v, out, dout, m, l, dq, dk, dv, delta, B, H, SQ, SK, hd, causal,
                          scale, st);
  if (hd <= 64)
    return dispatch_mma<64>(q, k, v, out, dout, m, l, dq, dk, dv, delta, B, H, SQ, SK, hd, causal,
                            scale, st);
  if (hd <= 128)
    return dispatch_mma<128>(q, k, v, out, dout, m, l, dq, dk, dv, delta, B, H, SQ, SK, hd,
                             causal, scale, st);
  return dispatch_mma<256>(q, k, v, out, dout, m, l, dq, dk, dv, delta, B, H, SQ, SK, hd, causal,
                           scale, st);
}

}  // namespace

extern "C" {

// q, out, dout, dq (B, SQ, H, HD); k, v, dk, dv (B, SK, H, HD): device
// pointers to contiguous arrays of one type (f32, or bf16 when bf16 is 1),
// any alignment; m and l (B, H, SQ) f32 from repro_flash_attention; delta a
// (B, H, SQ) f32 scratch. Any HD ≥ 1 (else cudaErrorInvalidValue), any SQ and
// SK, causal as the forward's. Up to HD 256 bf16 runs on the tensor cores
// where HD is a multiple of 8 and every array is on a 16-byte boundary, else
// on the CUDA cores; past 256 the wide pair, on the CUDA cores. Returns the
// first launch error, or 0.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                              const void* dout, const void* m, const void* l, void* dq,
                              void* dk, void* dv, void* delta, int B, int H, int SQ, int SK,
                              int HD, int causal, float scale, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD < 1) return cudaErrorInvalidValue;
  if (B * H == 0 || SQ == 0) {  // no query: dk and dv are zero
    if (B * H == 0 || SK == 0) return cudaSuccess;
    const size_t bytes = (size_t)B * SK * H * HD * (bf16 ? 2 : 4);
    cudaError_t err = cudaMemsetAsync(dk, 0, bytes, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, bytes, st);
    return err;
  }
  const float* fm = static_cast<const float*>(m);
  const float* fl = static_cast<const float*>(l);
  float* fd = static_cast<float*>(delta);
  if (HD > 256)
    return bf16 ? launch_wide<__nv_bfloat16>(q, k, v, out, dout, fm, fl, dq, dk, dv, fd, B, H,
                                             SQ, SK, HD, causal, scale, st)
                : launch_wide<float>(q, k, v, out, dout, fm, fl, dq, dk, dv, fd, B, H, SQ, SK, HD,
                                     causal, scale, st);
  if (bf16)
    return dispatch_bf16(q, k, v, out, dout, fm, fl, dq, dk, dv, fd, B, H, SQ, SK, HD, causal,
                         scale, st);
  return dispatch<float>(q, k, v, out, dout, fm, fl, dq, dk, dv, fd, B, H, SQ, SK, HD, causal,
                         scale, st);
}

}  // extern "C"
