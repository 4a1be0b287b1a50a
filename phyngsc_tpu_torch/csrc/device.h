// Helpers of the .cu launchers that size their grids to the blocks the SMs
// keep resident: per-device values, read once a device.
#pragma once

#include <cuda_runtime.h>

namespace phyngsc {

constexpr int kMaxDevices = 64;

// the current device, as an index into a table of kMaxDevices
inline int device_index() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev >= 0 && dev < kMaxDevices ? dev : 0;
}

// the current device's SM count
inline int sm_count() {
  static int sms[kMaxDevices] = {};
  const int dev = device_index();
  if (sms[dev] <= 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] > 0 ? sms[dev] : 1;
}

}  // namespace phyngsc
