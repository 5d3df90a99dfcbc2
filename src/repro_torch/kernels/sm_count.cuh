// The current device's SM count, for launchers that size their grids to
// the card.  Read once per device and cached; 132 (an H100 SXM) when the
// query fails.  The build passes this directory to nvcc with -I.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDevices = 64;

int sm_count() {
  static int counts[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 132;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
    counts[dev] = n;
  }
  return counts[dev];
}

}  // namespace
