// The text of a CUDA error code, for the wrappers' messages
// (ops/_build.py:check): every C entry point of the library returns one.

#include <cuda_runtime.h>

extern "C" const char* dg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
