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
// per element. Design: one thread-block cluster per (tile, device) splits
// the tile's n rows over its blocks (up to 32 rows a block for n ≤ 256, 64
// up to n = 512; 4 blocks of 32 rows at n = 128), and each thread holds its
// elements of the tile in registers (four columns × up to 8 rows): no
// shared-memory tile, so nothing on the card grows with n but the cluster.
// A thread starts all of its loads of u|v and of the residual before it
// uses any of them, so their latencies overlap. The amax is reduced
// by shuffles within a warp, in shared memory across the block, and across
// the cluster through distributed shared memory (each block writes its amax
// into every block's slot for it), one cluster barrier; the codes and the
// residual are then written from the registers. Where every row is 16-byte
// aligned (n and m multiples of 4, aligned arrays) a thread's four columns
// are adjacent and move as one 16-byte load or store (4 bytes of codes);
// otherwise (the har width: V and residual rows at a stride of 689) lane l
// takes columns l, l + 32, l + 64, l + 96, so each load of a warp is one
// 128-byte row segment. The tile straddles the U | V seam at column n
// wherever n is not a multiple of 128; the last tile is ragged. The TPU's
// 32-row int8 padding is not carried over.
//
// Bit-exact with the reference as XLA compiles it: x = u|v + r is one f32
// add; XLA rewrites amax / 127 into amax times the rounded reciprocal
// fl(1/127), so the scale is __fmul_rn(amax, 1.0f / 127.0f); x / scale is
// an IEEE division (__fdiv_rn, no fast math); rintf rounds half to even as
// jnp.round does; the max propagates NaN as jnp.max does (fmaxf would drop
// it), and, as a max, takes its operands in any order; the residual is
// __fmaf_rn(-q, scale, x), rounded once, as XLA contracts x − q·scale into
// a fused multiply-add.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;        // columns per quantization tile (TILE_COLS)
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kMaxN = 8 * kMaxCluster * 8;  // 8 row passes of 8 warps in 8 blocks: n ≤ 512

// max that keeps a NaN once it has seen one
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Tile column of a thread's element q (q < 4): adjacent when kVec.
template <bool kVec>
__device__ __forceinline__ int tile_col(int lane, int q) {
  return kVec ? 4 * lane + q : lane + 32 * q;
}

// Cluster (rank) of blockIdx.x / cs = tile t, blockIdx.y = device d; block
// `rank` takes rows [rank·rb, min((rank+1)·rb, n)), its warp w rows
// w + 8i (i < R) of those. u (D,n,n), v (D,n,m), r (D,n,n+m) or null.
template <int R, bool kVec>
__global__ void __launch_bounds__(kThreads)
quantize_pack_kernel(const float* __restrict__ u, const float* __restrict__ v,
                     const float* __restrict__ r, signed char* __restrict__ codes,
                     float* __restrict__ scales, float* __restrict__ resid, int n, int m,
                     int rb) {
  __shared__ float warp_max[kWarps];
  __shared__ float block_max[kMaxCluster];
  cluster_arrive();  // every block of the cluster runs before any writes to its shared memory
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int t = blockIdx.x / cs, d = blockIdx.y, nt = gridDim.x / cs;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ld = n + m, c0 = t * kTile;
  const int width = min(kTile, ld - c0);
  const int row0 = rank * rb, rows = max(0, min(rb, n - row0));
  const size_t base = (size_t)d * n * ld;
  const float* ud = u + (size_t)d * n * n;
  const float* vd = v + (size_t)d * n * m;

  // every load in flight before any use
  float x[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int rl = warp + 8 * i, row = row0 + rl;
    if constexpr (kVec) {
      const int c = c0 + 4 * lane;
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (rl < rows && 4 * lane < width)
        a = *reinterpret_cast<const float4*>(c < n ? ud + (size_t)row * n + c
                                                   : vd + (size_t)row * m + (c - n));
      x[i][0] = a.x, x[i][1] = a.y, x[i][2] = a.z, x[i][3] = a.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = tile_col<false>(lane, q), c = c0 + j;
        x[i][q] = rl < rows && j < width
                      ? (c < n ? ud[(size_t)row * n + c] : vd[(size_t)row * m + (c - n)])
                      : 0.0f;
      }
    }
  }
  if (r != nullptr) {
    float y[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int rl = warp + 8 * i;
      const float* rr = r + base + (size_t)(row0 + rl) * ld + c0;
      if constexpr (kVec) {
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (rl < rows && 4 * lane < width) a = *reinterpret_cast<const float4*>(rr + 4 * lane);
        y[i][0] = a.x, y[i][1] = a.y, y[i][2] = a.z, y[i][3] = a.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = tile_col<false>(lane, q);
          y[i][q] = rl < rows && j < width ? rr[j] : 0.0f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) x[i][q] = __fadd_rn(x[i][q], y[i][q]);
  }

  // amax: the thread's elements (zeros past the tile change nothing), the
  // warp, the block, the cluster
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) amax = nan_max(fabsf(x[i][q]), amax);
  for (int off = 16; off > 0; off >>= 1)
    amax = nan_max(__shfl_xor_sync(0xffffffffu, amax, off), amax);
  if (lane == 0) warp_max[warp] = amax;
  __syncthreads();
  cluster_wait();
  if (threadIdx.x < cs) {
    amax = warp_max[0];
    for (int w = 1; w < kWarps; ++w) amax = nan_max(warp_max[w], amax);
    cluster.map_shared_rank(block_max, (int)threadIdx.x)[rank] = amax;
  }
  cluster_arrive();
  cluster_wait();  // every block's amax is in block_max; no block reads another's after this
  amax = block_max[0];
  for (int k = 1; k < cs; ++k) amax = nan_max(block_max[k], amax);
  const float scale = amax > 0.0f ? __fmul_rn(amax, 1.0f / 127.0f) : 1.0f;
  if (rank == 0 && threadIdx.x == 0) scales[(size_t)d * nt + t] = scale;

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int rl = warp + 8 * i;
    if (rl >= rows) continue;
    float qv[4], rv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float c = rintf(__fdiv_rn(x[i][q], scale));
      c = c != c ? 0.0f : fminf(fmaxf(c, -127.0f), 127.0f);
      qv[q] = c;
      rv[q] = __fmaf_rn(-c, scale, x[i][q]);
    }
    const size_t at = base + (size_t)(row0 + rl) * ld + c0;
    if constexpr (kVec) {
      if (4 * lane < width) {
        *reinterpret_cast<char4*>(codes + at + 4 * lane) =
            make_char4((signed char)qv[0], (signed char)qv[1], (signed char)qv[2],
                       (signed char)qv[3]);
        *reinterpret_cast<float4*>(resid + at + 4 * lane) = make_float4(rv[0], rv[1], rv[2], rv[3]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = tile_col<false>(lane, q);
        if (j < width) {
          codes[at + j] = static_cast<signed char>(qv[q]);
          resid[at + j] = rv[q];
        }
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

template <int R, bool kVec>
cudaError_t launch_quantize_pack(const float* u, const float* v, const float* r,
                                 signed char* codes, float* scales, float* resid, int D, int n,
                                 int m, int cs, cudaStream_t st) {
  const int nt = (n + m + kTile - 1) / kTile;
  return launch_clustered(quantize_pack_kernel<R, kVec>, dim3(nt * cs, D), kThreads, 0, cs, st,
                          u, v, r, codes, scales, resid, n, m, (n + cs - 1) / cs);
}

}  // namespace

extern "C" {

int repro_quantize_pack_max_n() { return kMaxN; }

// u (D,n,n), v (D,n,m), r (D,n,n+m) or null, all contiguous f32 →
// codes (D,n,n+m) int8, scales (D, ceil((n+m)/128)) f32, resid (D,n,n+m)
// f32; n ≤ repro_quantize_pack_max_n().
int repro_quantize_pack(const float* u, const float* v, const float* r, signed char* codes,
                        float* scales, float* resid, int D, int n, int m, void* stream) {
  if (n > kMaxN) return cudaErrorInvalidValue;
  if (D == 0 || n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && m % 4 == 0 && aligned16(u) && aligned16(v) &&
                   (r == nullptr || aligned16(r)) && aligned16(codes) && aligned16(resid);
  // 32 rows a block (four passes of 8 warps) in the fewest blocks, a power
  // of two; past 8 blocks of 32, 64 rows a block in 8
  int cs = 1;
  while (cs < kMaxCluster && cs * 32 < n) cs *= 2;
  if (cs * 32 >= n)
    return vec ? launch_quantize_pack<4, true>(u, v, r, codes, scales, resid, D, n, m, cs, st)
               : launch_quantize_pack<4, false>(u, v, r, codes, scales, resid, D, n, m, cs, st);
  return vec ? launch_quantize_pack<8, true>(u, v, r, codes, scales, resid, D, n, m, cs, st)
             : launch_quantize_pack<8, false>(u, v, r, codes, scales, resid, D, n, m, cs, st);
}

}  // extern "C"
