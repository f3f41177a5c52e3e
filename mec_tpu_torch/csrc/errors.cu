// Error text for the cudaError_t codes the kernel launchers return
// (ops/_build.py::check_error turns a nonzero code into an exception).
#include <cuda_runtime.h>

extern "C" const char* mec_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
