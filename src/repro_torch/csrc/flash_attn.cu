// Fused attention forward with an online softmax for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py::flash_attention
// (pallas_call :105, inner kernel _flash_kernel :31). On the TPU one grid
// step is a (batch·head, query block, KV block) triple and the running max
// m, the sum l and the f32 accumulator live in VMEM scratch across the
// sequential KV axis. Blocks on Hopper run in no order, so here one thread
// block owns one (batch·head, query block) pair and walks the KV tiles in a
// loop of its own, with m, l and the accumulator in registers and the
// query, key, value and probability tiles in shared memory (f32, widened
// once at the load). Nothing of the (S × S) scores reaches device memory.
//
// Arithmetic, as the reference's kernel and its oracle
// (models/layers.py::blockwise_attention): s = (q·k) · hd^−½, the scale
// applied after the dot product; masked scores (key past the sequence, or
// above the diagonal when causal) are −1e30, never −inf, so a row with no
// valid key yet gives exp(0) and not NaN; p = exp(s − m_new) is rounded to
// the type of v before p·v (bf16 inputs) while l sums the unrounded p; the
// output is acc / max(l, 1e-30), rounded to the input type.
//
// Tiles: 64 keys a tile; 64 query rows for hd = 64, 32 for hd = 128, 16 for
// hd = 256, so that the f32 tiles fit in shared memory (hd = 256: 152 KB).
// 128 threads as 8 row groups × 16 column groups; a thread holds a
// (BQ/8) × 4 block of scores and a (BQ/8) × (hd/16) block of the output.
// Causal calls skip the KV tiles wholly above the block's last query: their
// p is exactly 0 in f32 once a row has seen key 0, which every row has.
//
// Bound on an H100 at the hymba-1.5b serving shape (B = 4, S = 1024,
// H = 25, hd = 64, causal, bf16): 4·B·H·S²·hd/2 = 13.4 GFLOP of products,
// 14 µs at 989 TFLOP/s on the tensor cores; q, k, v and out are 52 MB,
// 16 µs at 3.35 TB/s: bound by bytes. This kernel does its products on
// the CUDA cores in f32 (67 TFLOP/s at best), so it cannot come within
// 10× of that bound; a tensor-core (wgmma) version is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <int HD>
struct Tile {
  static constexpr int BQ = HD == 64 ? 64 : (HD == 128 ? 32 : 16);
  static constexpr int QS = HD + 1;  // padded row stride of the q and k tiles
  static constexpr int PS = kBK + 1; // padded row stride of the p tile
  static constexpr int smem_floats = BQ * QS + kBK * QS + kBK * HD + BQ * PS;
};

// q (B, SQ, H, HD), k and v (B, SK, H, HD), out (B, SQ, H, HD), contiguous.
// grid (nq, B·H): blockIdx.x counts query blocks from the last, so that a
// causal call starts its longest blocks first.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int H, int SQ, int SK, int causal, float scale) {
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
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qb * BQ;
  const long long row_stride = (long long)H * HD;
  const T* qbase = q + ((long long)b * SQ * H + h) * HD;
  const T* kbase = k + ((long long)b * SK * H + h) * HD;
  const T* vbase = v + ((long long)b * SK * H + h) * HD;

  for (int e = tid; e < BQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, s = q0 + r;
    sq[r * QS + d] = s < SQ ? widen(qbase[s * row_stride + d]) : 0.f;
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
      const bool in = s < SK;
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
        sp[(ty + 8 * i) * PS + tx + 16 * j] = widen(narrow<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
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

  T* obase = out + ((long long)b * SQ * H + h) * HD;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int s = q0 + ty + 8 * i;
    if (s >= SQ) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DN; ++j) obase[s * row_stride + tx + 16 * j] = narrow<T>(acc[i][j] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int SQ, int SK,
           int causal, float scale, cudaStream_t st) {
  using Tl = Tile<HD>;
  const int smem = Tl::smem_floats * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((SQ + Tl::BQ - 1) / Tl::BQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, SQ, SK, causal, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int H, int SQ,
             int SK, int HD, int causal, float scale, cudaStream_t st) {
  switch (HD) {
    case 64: return launch<T, 64>(q, k, v, out, B, H, SQ, SK, causal, scale, st);
    case 128: return launch<T, 128>(q, k, v, out, B, H, SQ, SK, causal, scale, st);
    case 256: return launch<T, 256>(q, k, v, out, B, H, SQ, SK, causal, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, SQ, H, HD), k and v (B, SK, H, HD), out (B, SQ, H, HD): device
// pointers to contiguous arrays of one type (f32, or bf16 when bf16 is 1).
// HD is 64, 128 or 256; causal masks the keys after the query's row.
// Returns the launch's CUDA error, or 0.
int repro_flash_attention(const void* q, const void* k, const void* v, void* out, int B, int H,
                          int SQ, int SK, int HD, int causal, float scale, int bf16,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (SQ == 0 || B * H == 0) return cudaSuccess;
  if (bf16) return dispatch<__nv_bfloat16>(q, k, v, out, B, H, SQ, SK, HD, causal, scale, st);
  return dispatch<float>(q, k, v, out, B, H, SQ, SK, HD, causal, scale, st);
}

}  // extern "C"
