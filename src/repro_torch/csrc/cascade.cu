// B1: the whole-matrix early-exit cascade decide ("quit when you can").
//
// Replaces repro/kernels/cascade_kernel.py cascade_pallas (its pallas_call
// at :153).  Each row of a QWYC-ordered (N, T) f32 score matrix walks the T
// thresholds with threshold_step, 1-based exit steps, and stops once it has
// exited.  A row still active at T is decided by g >= beta (beta as f32,
// which is how the reference compares its f32 partial sums with its static
// Python float).  Outputs: decisions (int32 0/1) and exit_step (int32,
// 1-based, T when the row never exited).
//
// What bounds it on an H100: bytes, and the walk's dependence.  A row reads
// only the scores up to its exit, and each step is one add and two
// compares, far below the card's ratio of operations to bytes.  The steps of
// a row are a dependent chain, so a thread spends the latency of each load
// and add in turn.
//
// Design: one thread per row, serial over T in chunks of `chunk_t`; after
// each chunk a warp stops as soon as none of its lanes is active (the TPU
// kernel stopped a whole row block the same way).  A retired lane reads no
// more scores.  The thresholds are read through the cache at one address per
// warp (a broadcast).  With the row-major matrix a warp's loads are strided
// by T floats: each lane's first read of a 32-byte sector brings its next 7
// scores into L1.  Rows past N are not launched; the TPU kernel's padded
// rows have no counterpart.
#include "common.cuh"
#include "threshold_step.cuh"

__global__ void cascade_kernel(const float* __restrict__ scores,
                               const float* __restrict__ eps_pos,
                               const float* __restrict__ eps_neg, int n,
                               int T, int chunk_t, float beta,
                               int* __restrict__ dec_out,
                               int* __restrict__ exit_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool row_ok = i < n;
  const float* row = scores + static_cast<size_t>(row_ok ? i : 0) * T;
  float g = 0.0f;
  bool active = row_ok;
  bool dec = false;
  int ex = T;
  // every lane of the warp reaches each __any_sync: the chunk bounds are
  // uniform and the break is the vote's uniform result
  for (int c0 = 0; c0 < T; c0 += chunk_t) {
    if (!__any_sync(0xffffffffu, active)) break;
    const int c1 = min(c0 + chunk_t, T);
    for (int t = c0; t < c1; ++t) {
      const float f = active ? row[t] : 0.0f;
      threshold_step(g, active, dec, ex, f, eps_pos[t], eps_neg[t], t + 1);
    }
  }
  if (row_ok) {
    dec_out[i] = (active ? (g >= beta) : dec) ? 1 : 0;
    exit_out[i] = ex;
  }
}

extern "C" int cascade_launch(const float* scores, const float* eps_pos,
                              const float* eps_neg, int n, int T, int chunk_t,
                              float beta, int threads, int* dec_out,
                              int* exit_out, cudaStream_t stream) {
  const int blocks = (n + threads - 1) / threads;
  cascade_kernel<<<blocks, threads, 0, stream>>>(
      scores, eps_pos, eps_neg, n, T, chunk_t, beta, dec_out, exit_out);
  return static_cast<int>(cudaGetLastError());
}
