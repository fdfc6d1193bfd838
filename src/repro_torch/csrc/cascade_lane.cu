// B6: one mixed-stage threshold walk (the lane decide of streaming
// admission).
//
// Replaces repro/kernels/cascade_kernel.py cascade_lane_pallas (its
// pallas_call at :316).  B2 with per-lane thresholds: streaming admission
// refills freed lanes with stage-0 rows next to mid-cascade ones, so row i
// walks its ct scores with its own threshold row eps_pos[i, :],
// eps_neg[i, :] (gathered from the stage table at its own stage).  Rows at
// or past n_valid start inactive.  Outputs g, active, decided_pos and the
// RELATIVE 1-based exit step within the row's chunk (0 = survived); the
// caller rebases it by each row's stage start.
//
// What bounds it on an H100: bytes.  A row reads 3 ct + 1 floats, writes
// four words and does ct adds and 2 ct compares; at the serving shape
// (m = 256, ct = 8) the call moves about 29 KB, 9 ns at the card's memory
// rate, so in practice the launch itself is the cost.
//
// Design: one thread per row, serial over the ct columns (the walk is a
// dependent chain), each step the shared threshold_step device function,
// as in B2.  A row at or past n_valid (a whole CTA of them, once the live
// count is below the CTA's first row) and a row that has exited read no
// scores or thresholds: only g0 is read and the four outputs written.
#include "common.cuh"
#include "threshold_step.cuh"

__global__ void cascade_lane_kernel(const float* __restrict__ g0,
                                    const float* __restrict__ scores,
                                    const float* __restrict__ eps_pos,
                                    const float* __restrict__ eps_neg,
                                    const int* __restrict__ n_valid_dev,
                                    int n_valid_host, int m, int ct,
                                    float* __restrict__ g_out,
                                    int* __restrict__ active_out,
                                    int* __restrict__ dec_out,
                                    int* __restrict__ exit_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int lim = live_limit(n_valid_dev, n_valid_host, m);
  float g = g0[i];
  bool active = i < lim;
  bool dec = false;
  int ex = 0;
  const size_t row = static_cast<size_t>(i) * ct;
  for (int j = 0; j < ct; ++j) {
    // an inactive row adds 0.0f as the plain version does, and reads nothing
    const float f = active ? scores[row + j] : 0.0f;
    const float ep = active ? eps_pos[row + j] : 0.0f;
    const float en = active ? eps_neg[row + j] : 0.0f;
    threshold_step(g, active, dec, ex, f, ep, en, j + 1);
  }
  g_out[i] = g;
  active_out[i] = active ? 1 : 0;
  dec_out[i] = dec ? 1 : 0;
  exit_out[i] = ex;
}

extern "C" int cascade_lane_launch(const float* g0, const float* scores,
                                   const float* eps_pos, const float* eps_neg,
                                   const int* n_valid_dev, int n_valid_host,
                                   int m, int ct, int threads, float* g_out,
                                   int* active_out, int* dec_out,
                                   int* exit_out, cudaStream_t stream) {
  const int blocks = (m + threads - 1) / threads;
  cascade_lane_kernel<<<blocks, threads, 0, stream>>>(
      g0, scores, eps_pos, eps_neg, n_valid_dev, n_valid_host, m, ct, g_out,
      active_out, dec_out, exit_out);
  return static_cast<int>(cudaGetLastError());
}
