// Fused int8 publish step of the quantized merge for Hopper (sm_90a).
//
// Replaces the TPU kernel quantize_pack of src/repro/kernels/quantize_pack.py
// (pallas_call :106, _qpack_kernel :55). Per device d and 128-column tile t
// of the packed payload x = [U | V] + residual, shape (D, n, n+m):
//   1. amax  = max |x| over the tile (n rows × up to 128 columns);
//   2. scale = amax · fl(1/127), or 1.0 when amax is not > 0 (all zero, or
//      NaN);
//   3. codes = clip(rint(x / scale), ±127) as int8 (a NaN code is 0);
//   4. residual' = x − codes·scale.
//
// Bound on an H100: bytes. At the har width (D = 256, n = 128, m = 561) it
// reads u, v and the residual (180.6 MB) and writes codes and residual'
// (112.9 MB): 293.5 MB, 0.0876 ms at 3.35 TB/s, for about five operations
// per element. Design: one block per (tile, device) holds its tile of x in
// shared memory (n × 128 f32, 64 KB at n = 128), so amax and the code and
// residual pass take one read of device memory. Neighbouring threads take
// neighbouring columns of a row, so every read and write is coalesced. The
// tile straddles the U | V seam at column n wherever n is not a multiple
// of 128; the last tile is ragged. The TPU's 32-row int8 padding is not
// carried over.
//
// Bit-exact with the reference as XLA compiles it: x = u|v + r is one f32
// add; XLA rewrites amax / 127 into amax times the rounded reciprocal
// fl(1/127), so the scale is __fmul_rn(amax, 1.0f / 127.0f); x / scale is
// an IEEE division (__fdiv_rn, no fast math); rintf rounds half to even as
// jnp.round does; the max propagates NaN as jnp.max does (fmaxf would drop
// it); the residual is __fmaf_rn(-q, scale, x), rounded once, as XLA
// contracts x − q·scale into a fused multiply-add.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;  // columns per quantization tile (TILE_COLS)

// max that keeps a NaN once it has seen one
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__global__ void __launch_bounds__(kThreads)
quantize_pack_kernel(const float* __restrict__ u, const float* __restrict__ v,
                     const float* __restrict__ r, signed char* __restrict__ codes,
                     float* __restrict__ scales, float* __restrict__ resid, int n, int m) {
  extern __shared__ float tile[];  // n × kTile
  __shared__ float warp_max[kThreads / 32];
  const int t = blockIdx.x, d = blockIdx.y, nt = gridDim.x;
  const int ld = n + m, c0 = t * kTile;
  const int width = min(kTile, ld - c0);
  const size_t base = (size_t)d * n * ld;
  const float* ud = u + (size_t)d * n * n;
  const float* vd = v + (size_t)d * n * m;

  float amax = 0.0f;
  for (int idx = threadIdx.x; idx < n * kTile; idx += kThreads) {
    const int i = idx / kTile, j = idx % kTile, c = c0 + j;
    if (j >= width) continue;
    float x = c < n ? ud[(size_t)i * n + c] : vd[(size_t)i * m + (c - n)];
    if (r != nullptr) x = __fadd_rn(x, r[base + (size_t)i * ld + c]);
    tile[i * kTile + j] = x;
    amax = nan_max(fabsf(x), amax);
  }
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(__shfl_xor_sync(0xffffffffu, amax, off), amax);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = warp_max[0];
  for (int w = 1; w < kThreads / 32; ++w) amax = nan_max(warp_max[w], amax);
  const float scale = amax > 0.0f ? __fmul_rn(amax, 1.0f / 127.0f) : 1.0f;
  if (threadIdx.x == 0) scales[(size_t)d * nt + t] = scale;

  for (int idx = threadIdx.x; idx < n * kTile; idx += kThreads) {
    const int i = idx / kTile, j = idx % kTile;
    if (j >= width) continue;
    const float x = tile[i * kTile + j];
    float q = rintf(__fdiv_rn(x, scale));
    q = q != q ? 0.0f : fminf(fmaxf(q, -127.0f), 127.0f);
    const size_t at = base + (size_t)i * ld + c0 + j;
    codes[at] = static_cast<signed char>(q);
    resid[at] = __fmaf_rn(-q, scale, x);
  }
}

int quantize_pack_smem(int n) { return n * kTile * (int)sizeof(float); }

}  // namespace

extern "C" {

int repro_quantize_pack_smem(int n) { return quantize_pack_smem(n); }

// u (D,n,n), v (D,n,m), r (D,n,n+m) or null, all contiguous f32 →
// codes (D,n,n+m) int8, scales (D, ceil((n+m)/128)) f32, resid (D,n,n+m) f32.
int repro_quantize_pack(const float* u, const float* v, const float* r, signed char* codes,
                        float* scales, float* resid, int D, int n, int m, void* stream) {
  const int smem = quantize_pack_smem(n);
  cudaError_t e = cudaFuncSetAttribute(quantize_pack_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n + m + kTile - 1) / kTile, D);
  quantize_pack_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      u, v, r, codes, scales, resid, n, m);
  return cudaGetLastError();
}

}  // extern "C"
