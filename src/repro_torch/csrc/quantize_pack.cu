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
// Past n = 512 a block's rows beyond the 64 it holds in registers are read
// twice: once into the amax, and again, after the cluster's amax, to be
// coded (their x recomputed with the same single add, so the bits agree).
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
constexpr int kRegRows = 8 * kWarps;        // a block's rows in registers at R = 8

// max that keeps a NaN once it has seen one
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Tile column of a thread's element q (q < 4): adjacent when kVec.
template <bool kVec>
__device__ __forceinline__ int tile_col(int lane, int q) {
  return kVec ? 4 * lane + q : lane + 32 * q;
}

// x = u|v + r at row `row` of device d's tile, the four columns of element
// q < 4 of lane (zeros past the tile).
template <bool kVec>
__device__ __forceinline__ void load_row(float (&x)[4], const float* ud, const float* vd,
                                         const float* rr, int row, int lane, int c0, int width,
                                         int n, int m) {
  if constexpr (kVec) {
    const int c = c0 + 4 * lane;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
    if (4 * lane < width) {
      a = *reinterpret_cast<const float4*>(c < n ? ud + (size_t)row * n + c
                                                 : vd + (size_t)row * m + (c - n));
      if (rr != nullptr) b = *reinterpret_cast<const float4*>(rr + 4 * lane);
    }
    x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    if (rr != nullptr)
      x[0] = __fadd_rn(x[0], b.x), x[1] = __fadd_rn(x[1], b.y), x[2] = __fadd_rn(x[2], b.z),
      x[3] = __fadd_rn(x[3], b.w);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = tile_col<false>(lane, q), c = c0 + j;
      x[q] = j < width ? (c < n ? ud[(size_t)row * n + c] : vd[(size_t)row * m + (c - n)]) : 0.0f;
      if (rr != nullptr && j < width) x[q] = __fadd_rn(x[q], rr[j]);
    }
  }
}

// Code x against scale and store codes and residual at row offset `at`.
template <bool kVec>
__device__ __forceinline__ void code_row(const float (&x)[4], float scale, signed char* codes,
                                         float* resid, size_t at, int lane, int width) {
  float qv[4], rv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float c = rintf(__fdiv_rn(x[q], scale));
    c = c != c ? 0.0f : fminf(fmaxf(c, -127.0f), 127.0f);
    qv[q] = c;
    rv[q] = __fmaf_rn(-c, scale, x[q]);
  }
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

// Cluster (rank) of blockIdx.x / cs = tile t, blockIdx.y = device d; block
// `rank` takes rows [rank·rb, min((rank+1)·rb, n)), its warp w rows
// w + 8i (i < R) of those in registers and, with kMore, rows 64 + w + 8i
// past them in two reads. u (D,n,n), v (D,n,m), r (D,n,n+m) or null.
template <int R, bool kVec, bool kMore = false>
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
  if constexpr (kMore) {
    for (int rl = kRegRows + warp; rl < rows; rl += kWarps) {
      float y[4];
      load_row<kVec>(y, ud, vd, r == nullptr ? nullptr : r + base + (size_t)(row0 + rl) * ld + c0,
                     row0 + rl, lane, c0, width, n, m);
#pragma unroll
      for (int q = 0; q < 4; ++q) amax = nan_max(fabsf(y[q]), amax);
    }
  }
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
    code_row<kVec>(x[i], scale, codes, resid, base + (size_t)(row0 + rl) * ld + c0, lane, width);
  }
  if constexpr (kMore) {
    for (int rl = kRegRows + warp; rl < rows; rl += kWarps) {
      const size_t at = base + (size_t)(row0 + rl) * ld + c0;
      float y[4];
      load_row<kVec>(y, ud, vd, r == nullptr ? nullptr : r + at, row0 + rl, lane, c0, width, n, m);
      code_row<kVec>(y, scale, codes, resid, at, lane, width);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

template <int R, bool kVec, bool kMore = false>
cudaError_t launch_quantize_pack(const float* u, const float* v, const float* r,
                                 signed char* codes, float* scales, float* resid, int D, int n,
                                 int m, int cs, cudaStream_t st) {
  const int nt = (n + m + kTile - 1) / kTile;
  return launch_clustered(quantize_pack_kernel<R, kVec, kMore>, dim3(nt * cs, D), kThreads, 0,
                          cs, st, u, v, r, codes, scales, resid, n, m, (n + cs - 1) / cs);
}

}  // namespace

extern "C" {

// u (D,n,n), v (D,n,m), r (D,n,n+m) or null, all contiguous f32 →
// codes (D,n,n+m) int8, scales (D, ceil((n+m)/128)) f32, resid (D,n,n+m)
// f32.
int repro_quantize_pack(const float* u, const float* v, const float* r, signed char* codes,
                        float* scales, float* resid, int D, int n, int m, void* stream) {
  if (D == 0 || n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && m % 4 == 0 && aligned16(u) && aligned16(v) &&
                   (r == nullptr || aligned16(r)) && aligned16(codes) && aligned16(resid);
  // 32 rows a block (four passes of 8 warps) in the fewest blocks, a power
  // of two; past 8 blocks of 32, 64 rows a block in 8; past 8 blocks of
  // 64, the rest of a block's rows read twice
  int cs = 1;
  while (cs < kMaxCluster && cs * 32 < n) cs *= 2;
  if (cs * 32 >= n)
    return vec ? launch_quantize_pack<4, true>(u, v, r, codes, scales, resid, D, n, m, cs, st)
               : launch_quantize_pack<4, false>(u, v, r, codes, scales, resid, D, n, m, cs, st);
  if (cs * kRegRows >= n)
    return vec ? launch_quantize_pack<8, true>(u, v, r, codes, scales, resid, D, n, m, cs, st)
               : launch_quantize_pack<8, false>(u, v, r, codes, scales, resid, D, n, m, cs, st);
  return vec ? launch_quantize_pack<8, true, true>(u, v, r, codes, scales, resid, D, n, m, cs, st)
             : launch_quantize_pack<8, false, true>(u, v, r, codes, scales, resid, D, n, m, cs,
                                                    st);
}

}  // extern "C"
