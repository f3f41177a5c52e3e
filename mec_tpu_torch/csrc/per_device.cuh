// A kernel's function attributes belong to the context of one device:
// cudaFuncSetAttribute applies to the caller's current device only. So
// a kernel that needs more dynamic shared memory than a launch gets
// unasked (or a non-portable cluster size) records what it was allowed
// per device, and raises it under a lock, since serving threads driving
// several cards may call one kernel at once.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace mec {

constexpr int kMaxAttrDevices = 16;

struct SmemGrant {
  std::mutex mu;
  int bytes[kMaxAttrDevices];
  explicit SmemGrant(int unasked = -1) {
    for (int& b : bytes) b = unasked;
  }
};

// Allow `kernel` at least `bytes` of dynamic shared memory on the current
// device (and, with cluster_nonportable, clusters above 8 blocks);
// returns a cudaError_t as int.
template <typename Kernel>
int grant_smem(Kernel kernel, int bytes, SmemGrant& grant, bool cluster_nonportable = false) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxAttrDevices) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(grant.mu);
  if (bytes <= grant.bytes[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (cluster_nonportable) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  grant.bytes[dev] = bytes;
  return 0;
}

}  // namespace mec
