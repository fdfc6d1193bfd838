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

// Inclusive block-wide prefix of a 0/1 flag over threadIdx.x in one
// barrier; *total gets the block's count.  A warp's prefix is a ballot's
// popcount, and each thread adds the lower warps' counts.  Every thread of
// the CTA must call it, and blockDim.x must be a multiple of 32.  The
// compaction prefix of B4 and B7 matrix (mega_stage.cu; 0.1 us a launch
// faster there than a shuffle scan) and of B6 (cascade_lane.cu).
__device__ inline int block_flag_scan(bool v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, v);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int off = 0, all = 0;
  for (int w = 0; w < n_warps; ++w) {
    const int c = s_warp[w];
    off += w < warp ? c : 0;
    all += c;
  }
  *total = all;
  return off + __popc(ballot & (0xffffffffu >> (31 - lane)));
}
