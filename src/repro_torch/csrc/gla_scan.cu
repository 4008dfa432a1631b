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
// in VMEM scratch; here one thread block owns one (batch, head) pair and
// walks its chunks in a loop, with S (dk × dv, f32) in shared memory. Unlike
// the TPU kernel it also writes the final S: the model's prefill keeps it as
// the mamba head's decode state.
//
// Arithmetic, as the reference's kernel: inputs widened to f32, every sum in
// f32; the cumsum sequential within the chunk (one thread, token order); the
// intra-chunk gate built by select, 0 above the diagonal, so that an
// e^{cum_t − cum_τ} that overflows for τ > t never meets a 0 (inf · 0 is
// NaN); padding tokens past S have log a = 0 and zeroed q, k and v, so they
// leave S untouched. y is rounded to the input type; the state stays f32.
//
// Bound on an H100 at the hymba-1.5b serving shape (B = 4, S = 1024,
// H = 25, dk = 16, dv = 64, bf16): q, k, v, log a, y and the state are
// 34 MB, 10 µs at 3.35 TB/s; the chunked products, about
// B·H·S·(C·(dk + dv) + 4·dk·dv) ≈ 1.5 GFLOP, take 1.5 µs at 989 TFLOP/s
// bf16: bound by bytes. This kernel does its products in f32 on the CUDA
// cores (22 µs at 67 TFLOP/s at best), and only B·H = 100 blocks run, one
// per SM, on 100 of 132 SMs; splitting one sequence's chunks across blocks
// (a second pass for the carried state) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;

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

// shared memory, in floats, for chunk C and widths dk, dv
__host__ __device__ int gla_smem_floats(int C, int DK, int DV) {
  return 2 * C * (DK + 1) + C * DV + C * (C + 1) + DK * DV + 3 * C;
}

// q, k (B, S, H, DK) and v (B, S, H, DV) of type T, log_a (B, S, H) f32;
// y (B, S, H, DV) of type T, state (B, H, DK, DV) f32. One block per b·h.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gla_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ log_a, T* __restrict__ y, float* __restrict__ state,
               int S, int H, int DK, int DV, int C) {
  extern __shared__ float smem[];
  const int KS = DK + 1, GS = C + 1;  // padded row strides
  float* sq = smem;              // C × KS
  float* sk = sq + C * KS;       // C × KS
  float* sv = sk + C * KS;       // C × DV
  float* sg = sv + C * DV;       // C × GS, the gated scores
  float* ss = sg + C * GS;       // DK × DV, the carried state
  float* cum = ss + DK * DV;     // C
  float* eq = cum + C;           // e^{cum}
  float* ew = eq + C;            // e^{tot − cum}

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const long long tok = (long long)H;  // tokens are H rows apart
  const T* qb = q + ((long long)b * S * H + h) * DK;
  const T* kb = k + ((long long)b * S * H + h) * DK;
  const T* vb = v + ((long long)b * S * H + h) * DV;
  const float* lb = log_a + (long long)b * S * H + h;
  T* yb = y + ((long long)b * S * H + h) * DV;

  for (int e = tid; e < DK * DV; e += kThreads) ss[e] = 0.f;
  const int n_chunks = (S + C - 1) / C;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * C;
    __syncthreads();  // the previous chunk's tiles and S are consumed
    for (int e = tid; e < C * DK; e += kThreads) {
      const int r = e / DK, i = e % DK, t = t0 + r;
      const bool in = t < S;
      sq[r * KS + i] = in ? widen(qb[t * tok * DK + i]) : 0.f;
      sk[r * KS + i] = in ? widen(kb[t * tok * DK + i]) : 0.f;
    }
    for (int e = tid; e < C * DV; e += kThreads) {
      const int r = e / DV, j = e % DV, t = t0 + r;
      sv[r * DV + j] = t < S ? widen(vb[t * tok * DV + j]) : 0.f;
    }
    for (int r = tid; r < C; r += kThreads) cum[r] = t0 + r < S ? lb[(t0 + r) * tok] : 0.f;
    __syncthreads();
    if (tid == 0) {
      for (int r = 1; r < C; ++r) cum[r] += cum[r - 1];
    }
    __syncthreads();
    const float tot = cum[C - 1];
    for (int r = tid; r < C; r += kThreads) {
      eq[r] = expf(cum[r]);
      ew[r] = expf(tot - cum[r]);
    }
    for (int e = tid; e < C * C; e += kThreads) {
      const int t = e / C, tau = e % C;
      float g = 0.f;
      if (tau <= t) {
        float dot = 0.f;
        for (int i = 0; i < DK; ++i) dot = fmaf(sq[t * KS + i], sk[tau * KS + i], dot);
        g = dot * expf(cum[t] - cum[tau]);
      }
      sg[t * GS + tau] = g;
    }
    __syncthreads();

    for (int e = tid; e < C * DV; e += kThreads) {
      const int t = e / DV, j = e % DV;
      float inter = 0.f;
      for (int i = 0; i < DK; ++i) inter = fmaf(sq[t * KS + i] * eq[t], ss[i * DV + j], inter);
      float intra = 0.f;
      for (int tau = 0; tau <= t; ++tau) intra = fmaf(sg[t * GS + tau], sv[tau * DV + j], intra);
      if (t0 + t < S) yb[(t0 + t) * tok * DV + j] = narrow<T>(inter + intra);
    }
    __syncthreads();  // every y has read the old S

    const float decay = expf(tot);
    for (int e = tid; e < DK * DV; e += kThreads) {
      const int i = e / DV, j = e % DV;
      float upd = 0.f;
      for (int tau = 0; tau < C; ++tau) upd = fmaf(sk[tau * KS + i] * ew[tau], sv[tau * DV + j], upd);
      ss[e] = ss[e] * decay + upd;
    }
  }
  __syncthreads();
  float* st = state + (long long)bh * DK * DV;
  for (int e = tid; e < DK * DV; e += kThreads) st[e] = ss[e];
}

}  // namespace

extern "C" {

int repro_gla_smem(int C, int DK, int DV) {
  return gla_smem_floats(C, DK, DV) * (int)sizeof(float);
}

// q, k (B, S, H, DK), v (B, S, H, DV): device pointers to contiguous arrays
// of one type (f32, or bf16 when bf16 is 1); log_a (B, S, H) f32; y
// (B, S, H, DV) of the input type; state (B, H, DK, DV) f32. C is the chunk
// (1 ≤ C ≤ 128). Returns the launch's CUDA error, or 0.
int repro_gla_forward(const void* q, const void* k, const void* v, const float* log_a, void* y,
                      float* state, int B, int S, int H, int DK, int DV, int C, int bf16,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * H == 0) return cudaSuccess;
  if (C < 1 || C > kMaxChunk) return cudaErrorInvalidValue;
  const int smem = repro_gla_smem(C, DK, DV);
  cudaError_t e;
  if (bf16) {
    using T = __nv_bfloat16;
    e = cudaFuncSetAttribute(gla_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    gla_fwd_kernel<T><<<B * H, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), log_a,
        static_cast<T*>(y), state, S, H, DK, DV, C);
  } else {
    e = cudaFuncSetAttribute(gla_fwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    gla_fwd_kernel<float><<<B * H, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        log_a, static_cast<float*>(y), state, S, H, DK, DV, C);
  }
  return cudaGetLastError();
}

}  // extern "C"
