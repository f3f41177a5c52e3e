// Warp and block reductions shared by the kernels.
//
// block_* reduce across the whole block and return the result to EVERY
// thread. They begin with a barrier, so one scratch array can serve
// back-to-back calls, and the caller must reach them with all threads.
// Every warp folds the warps' partial results itself, one load a lane
// and a shuffle fold: a loop over them is a chain of shared-memory
// latencies, a thousand clocks for 32 warps.
// Integer sums are exact, so their order does not matter; float and
// integer min/max are exact too.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace mec {

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ uint32_t warp_min(uint32_t v) {
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// scratch: at least blockDim.x / 32 entries of shared memory
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum((threadIdx.x & 31) < (blockDim.x >> 5) ? scratch[threadIdx.x & 31] : 0);
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_max((threadIdx.x & 31) < (blockDim.x >> 5) ? scratch[threadIdx.x & 31] : scratch[0]);
}

__device__ __forceinline__ float block_min(float v, float* scratch) {
  v = warp_min(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_min((threadIdx.x & 31) < (blockDim.x >> 5) ? scratch[threadIdx.x & 31] : scratch[0]);
}

__device__ __forceinline__ uint32_t block_min(uint32_t v, uint32_t* scratch) {
  v = warp_min(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_min((threadIdx.x & 31) < (blockDim.x >> 5) ? scratch[threadIdx.x & 31] : scratch[0]);
}

}  // namespace mec
