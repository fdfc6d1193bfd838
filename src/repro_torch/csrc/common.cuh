// Shared by every kernel library of repro_torch.  Each source is built by
// nvcc into its own shared library with a plain C interface and loaded with
// ctypes (repro_torch/kernels/_build.py); every launcher returns
// cudaGetLastError() and this function turns the code into a message.
#pragma once

#include <cuda_runtime.h>

#include "threshold_step.cuh"

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
// faster there than a shuffle scan), of B6 (cascade_lane.cu) and of B2's
// step form (cascade_chunk.cu).
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

// 4 floats from 16-byte aligned memory in one load
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
}

constexpr int kWalkGroup = 8;  // columns whose loads are in flight at once

// One lane's threshold walk over the W columns of its score row `row`, with
// the threshold rows `ep`, `en` and the column mask `cv` (null: every column
// valid) of its stage; exit steps are 1-based within the row (relative).
// The walk of B6 (cascade_lane.cu) and of B2's step form (cascade_chunk.cu).
// The loads of a group of 8 columns (scores, mask, thresholds) are issued
// together before its steps, so a lane waits for one round of loads a
// group, not for one a step; with `vec` (W % 4 == 0, the rows 16-byte
// aligned and the mask rows 4-byte aligned) as 16-byte loads (4-byte for
// the mask).  A lane inactive at a group's start reads nothing and adds
// 0.0f, as the plain version does, and a masked column adds a literal 0.0f.
__device__ __forceinline__ void lane_walk(const float* row, const float* ep,
                                          const float* en, const bool* cv,
                                          int W, bool vec, float& g,
                                          bool& active, bool& dec, int& ex) {
  for (int j0 = 0; j0 < W; j0 += kWalkGroup) {
    float f[kWalkGroup], p[kWalkGroup], q[kWalkGroup];
#pragma unroll
    for (int k = 0; k < kWalkGroup; ++k) f[k] = p[k] = q[k] = 0.0f;
    if (active && vec) {
#pragma unroll
      for (int h = 0; h < kWalkGroup; h += 4) {
        if (j0 + h < W) {  // W % 4 == 0: the whole quad is in the row
          load4(row + j0 + h, f + h);
          load4(ep + j0 + h, p + h);
          load4(en + j0 + h, q + h);
          if (cv) {
            const unsigned c = *reinterpret_cast<const unsigned*>(cv + j0 + h);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (((c >> (8 * k)) & 0xffu) == 0) f[h + k] = 0.0f;
            }
          }
        }
      }
    } else if (active) {
#pragma unroll
      for (int k = 0; k < kWalkGroup; ++k) {
        const int j = j0 + k;
        if (j < W) {
          const float s = row[j];
          f[k] = (!cv || cv[j]) ? s : 0.0f;
          p[k] = ep[j];
          q[k] = en[j];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kWalkGroup; ++k) {
      if (j0 + k < W) threshold_step(g, active, dec, ex, f[k], p[k], q[k], j0 + k + 1);
    }
  }
}
