// B2: one cascade stage's threshold walk (the chunk decide).
//
// Replaces repro/kernels/cascade_kernel.py cascade_chunk_pallas (its
// pallas_call at :395).  Given the carried partial sums g0 (m,) of the
// front-packed survivors and the stage's scores (m, ct), each row walks the
// ct stage-shared thresholds with threshold_step.  Rows at or past n_valid
// start inactive.  Outputs g, active, decided_pos and the absolute 1-based
// exit step (0 = survived the stage).
//
// What bounds it on an H100: bytes.  A row reads ct + 1 floats and writes
// four words and does ct adds and 2 ct compares, far below the card's ratio
// of operations to bytes; at the serving shape (m = 256, ct = 8) the whole
// call moves about 13 KB, so in practice the launch itself is the cost.
//
// Design: one thread per row, serial over the ct columns (the walk is a
// dependent chain, as on the TPU).  The TPU kernel stopped a block's walk
// once every lane had exited; here each row is its own thread, so a retired
// row reads no more scores.  No shared memory: the two threshold rows are
// tiny and read through the cache.
#include "common.cuh"
#include "threshold_step.cuh"

__global__ void cascade_chunk_kernel(const float* __restrict__ g0,
                                     const float* __restrict__ scores,
                                     const float* __restrict__ eps_pos,
                                     const float* __restrict__ eps_neg,
                                     const int* __restrict__ n_valid_dev,
                                     int n_valid_host, int m, int ct, int t0,
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
  const float* row = scores + static_cast<size_t>(i) * ct;
  for (int j = 0; j < ct; ++j) {
    const float f = active ? row[j] : 0.0f;
    threshold_step(g, active, dec, ex, f, eps_pos[j], eps_neg[j], t0 + j + 1);
  }
  g_out[i] = g;
  active_out[i] = active ? 1 : 0;
  dec_out[i] = dec ? 1 : 0;
  exit_out[i] = ex;
}

extern "C" int cascade_chunk_launch(const float* g0, const float* scores,
                                    const float* eps_pos, const float* eps_neg,
                                    const int* n_valid_dev, int n_valid_host,
                                    int m, int ct, int t0, int threads,
                                    float* g_out, int* active_out,
                                    int* dec_out, int* exit_out,
                                    cudaStream_t stream) {
  const int blocks = (m + threads - 1) / threads;
  cascade_chunk_kernel<<<blocks, threads, 0, stream>>>(
      g0, scores, eps_pos, eps_neg, n_valid_dev, n_valid_host, m, ct, t0,
      g_out, active_out, dec_out, exit_out);
  return static_cast<int>(cudaGetLastError());
}
