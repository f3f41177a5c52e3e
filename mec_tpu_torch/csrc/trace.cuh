// Phase marks for a kernel's own clock, compiled in only with -DMEC_TRACE
// (bench/kernel_ab.py --trace builds one source alone that way; the
// serving build never defines it, and the marks expand to nothing).
//
// Thread 0 of block 0 writes clock64() at every mark it passes, in
// order, so the differences are that one SM's clocks between marks:
// where one block of the kernel spends its time, which the profiler
// (whole launches only) cannot show and ncu is not there to show.
// mec_trace_read copies the marks of the last launch to the host.
#pragma once
#include <cuda_runtime.h>

#ifdef MEC_TRACE
namespace mec {
constexpr int kTraceMarks = 128;
__device__ long long trace_clk[kTraceMarks];
__device__ int trace_n;
}  // namespace mec
#define MEC_TRACE_BEGIN() \
  if (blockIdx.x == 0 && threadIdx.x == 0) { mec::trace_n = 0; }
#define MEC_TRACE_MARK()                                            \
  if (blockIdx.x == 0 && threadIdx.x == 0 && mec::trace_n < mec::kTraceMarks) { \
    mec::trace_clk[mec::trace_n++] = clock64();                      \
  }
// host: (kTraceMarks,) clocks and their count; returns a cudaError_t
extern "C" int mec_trace_read(long long* clocks, int* count) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyFromSymbol(count, mec::trace_n, sizeof(int));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(clocks, mec::trace_clk, sizeof(mec::trace_clk));
}
#else
#define MEC_TRACE_BEGIN()
#define MEC_TRACE_MARK()
#endif
