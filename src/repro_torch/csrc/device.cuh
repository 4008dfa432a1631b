// Facts of the card the launch plans read, and the thread-block cluster
// launch and barrier, shared by the kernel sources.
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSmem = 232448;  // the shared memory a block may use on Hopper

// Streaming multiprocessors of the current device (132 on an H100 SXM),
// asked once.
int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

// The two halves of a cluster barrier: writes to any block's shared memory
// before arrive are seen by every block after wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Launch kernel on grid in clusters of cs blocks along x (cs ≤ 8, the
// portable size; grid.x a multiple of cs), with smem bytes of dynamic
// shared memory, raising the kernel's limit to that first.
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                             int cs, cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace
