// Facts of the card the launch plans read, shared by the kernel sources.
#pragma once
#include <cuda_runtime.h>

namespace {

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

}  // namespace
