// Fused attention backward for Hopper (sm_90a).
//
// Replaces no pl.pallas_call: the reference writes its flash backward in jnp,
// as the custom VJP of models/layers.py::blockwise_attention (_fa_backward_impl
// :192, _fa_backward_inner :197). Like it, this kernel never keeps the (S × S)
// scores: it recomputes each tile of them from q, k and the forward's row
// statistics m and l (csrc/flash_attn.cu writes them), so attention's memory
// in training stays O(S).
//
// Arithmetic, as _fa_backward_inner's, in f32 whatever the input type:
//   δ = rowsum(dout ∘ out)
//   s = (q·k)·hd^−½, −1e30 where masked (a key past the sequence, or above the
//       diagonal when causal), p = exp(s − m) / max(l, 1e-30)
//   dv = pᵀ·dout,  dp = dout·vᵀ,  ds = p ∘ (dp − δ)·hd^−½,  dq = ds·k,  dk = dsᵀ·q
// with dq, dk and dv rounded once to the input type. A masked pair gives
// p = 0 exactly, as exp(−1e30 − m) does in the reference.
//
// Two launches on the caller's stream, no atomics, so the gradients come out
// the same bits on every run:
// * flash_bwd_dq_kernel, a block per (batch·head, BQ query rows), which walks
//   the key tiles: it writes δ of its rows (to a scratch the dk/dv kernel reads)
//   and dq;
// * flash_bwd_dkdv_kernel, a block per (batch·head, BKV keys), which walks the
//   query tiles: dk and dv.
// Causal calls skip the tiles wholly above the diagonal in both.
//
// Simple first: both kernels run on the CUDA cores in f32 (bf16 operands are
// widened once into shared memory), 128 threads as 8 row groups × 16 column
// groups, as the forward's f32 kernel. Tiles: 64/32/16 rows a block at head
// width 64/128/256 and 64 columns a tile step; at hd = 256 the dq kernel holds
// q, dout, k and v tiles in 169 KB of shared memory and the dk/dv kernel 173 KB,
// its dk and dv accumulators (16 keys × 256) in registers. Widths under 256
// run the next larger instance masked at hd; past 256 the entry refuses.
//
// Bound on an H100 (the larger of the two): the eight tensors (q, k, v, out,
// dout and dq, dk, dv) read or written once, at 3.35 TB/s, and about
// 10·B·H·Sq·Sk·hd operations (4 products of 2·hd a pair, plus the recomputed
// q·kᵀ; half when causal) at 67 TFLOP/s in f32 or 989 TFLOP/s for bf16 on the
// tensor cores. On the CUDA cores this kernel cannot come near the bf16
// figure: mma.sync, then wgmma and TMA, are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
        sds[(ty + 8 * i) * PS + tx + 16 * j] = p * (dp[i][j] - di[i]) * scale;
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
        sp[(ty + 8 * i) * PS + c] = p;
        sds[(ty + 8 * i) * PS + c] = p * (dpt[i][j] - sdelta[c]) * scale;
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

}  // namespace

extern "C" {

// q, out, dout, dq (B, SQ, H, HD); k, v, dk, dv (B, SK, H, HD): device
// pointers to contiguous arrays of one type (f32, or bf16 when bf16 is 1); m
// and l (B, H, SQ) f32 from repro_flash_attention; delta a (B, H, SQ) f32
// scratch. 1 ≤ HD ≤ 256 (else cudaErrorInvalidValue), any SQ and SK, causal
// as the forward's. Returns the first launch error, or 0.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                              const void* dout, const void* m, const void* l, void* dq,
                              void* dk, void* dv, void* delta, int B, int H, int SQ, int SK,
                              int HD, int causal, float scale, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD < 1 || HD > 256) return cudaErrorInvalidValue;
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
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, dout, fm, fl, dq, dk, dv, fd, B, H, SQ, SK, HD,
                                   causal, scale, st);
  return dispatch<float>(q, k, v, out, dout, fm, fl, dq, dk, dv, fd, B, H, SQ, SK, HD, causal,
                         scale, st);
}

}  // extern "C"
