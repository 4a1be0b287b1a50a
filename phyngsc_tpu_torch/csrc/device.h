// Helpers of the .cu launchers that size their grids to the blocks the SMs
// keep resident: per-device values, read once a device.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <set>
#include <tuple>
#include <utility>

namespace phyngsc {

constexpr int kMaxDevices = 64;

// the current device, as an index into a table of kMaxDevices
inline int device_index() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev >= 0 && dev < kMaxDevices ? dev : 0;
}

// the current device's SM count (each entry is written with the same value
// by whichever thread reads it first)
inline int sm_count() {
  static int sms[kMaxDevices] = {};
  const int dev = device_index();
  if (sms[dev] <= 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev] > 0 ? sms[dev] : 1;
}

// Blocks of `kernel` that an SM of the current device keeps resident at
// `threads` threads and `smem` bytes of dynamic shared memory, in `blocks`
// (at least 1). The first call above 48 KB for a kernel on a device opts the
// kernel in to the device's largest dynamic shared memory; the occupancy
// query runs once per (kernel, device, threads, smem). The launchers run on
// several host threads at once (ctypes drops the GIL), so the cache is
// guarded by one mutex.
inline cudaError_t resident_blocks(const void* kernel, int threads, int smem,
                                   int& blocks) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, int> cache;
  static std::set<std::pair<const void*, int>> opted_in;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kernel, dev, threads, smem);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    blocks = hit->second;
    return cudaSuccess;
  }
  if (smem > 48 * 1024 && !opted_in.count({kernel, dev})) {
    int most = 0;
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    opted_in.insert({kernel, dev});
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  blocks = blocks > 0 ? blocks : 1;
  cache[key] = blocks;
  return cudaSuccess;
}

}  // namespace phyngsc
