// Shared by every kernel library of the port: the C entry point that
// turns a CUDA error code returned by a launch function into its text.
#pragma once
#include <cuda_runtime.h>

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
