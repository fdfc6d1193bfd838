// Shared by every kernel library of repro_torch.  Each source is built by
// nvcc into its own shared library with a plain C interface and loaded with
// ctypes (repro_torch/kernels/_build.py); every launcher returns
// cudaGetLastError() and this function turns the code into a message.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Live-row limit of a front-packed survivor buffer: a device scalar when the
// caller keeps the count on the card (the stage loop never syncs), else a
// host value.
__device__ __forceinline__ int live_limit(const int* n_valid_dev,
                                          int n_valid_host, int m) {
  const int nv = n_valid_dev ? *n_valid_dev : n_valid_host;
  return nv < m ? nv : m;
}
