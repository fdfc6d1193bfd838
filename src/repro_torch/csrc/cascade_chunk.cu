// B2: one cascade stage's threshold walk (the chunk decide), in two forms.
//
// Replaces repro/kernels/cascade_kernel.py cascade_chunk_pallas (its
// pallas_call at :395).
//
// The reference's form (cascade_chunk_kernel): given the carried partial
// sums g0 (m,) of the front-packed survivors and the stage's scores (m, ct),
// each row walks the ct stage-shared thresholds with threshold_step.  Rows
// at or past n_valid start inactive.  Outputs g, active, decided_pos and the
// absolute 1-based exit step (0 = survived the stage).  The host
// ChunkedExecutor's decide (ops.kernel_decide_fn) runs it.
//
// The step form (chunk_step_kernel) is the unfused batch stage of
// DeviceExecutor._program, and takes over what the reference's stage does
// around the decide (repro/kernels/device_executor.py:832-849): lane i
// reads its partial sum in place, g[rows[i]], from the (cap + 1,) buffer
// whose slot cap is the trash slot; it reads stage s's threshold rows and
// column mask in place from the plan's (S, W) tables, adding a literal 0.0f
// for a column the mask marks invalid (the padded tail of a ragged last
// stage); it walks with common.cuh's lane_walk (shared with B6), exit steps
// RELATIVE to the stage; and it writes the compaction of the survivors:
// * mode 1 (cap <= 1024, one CTA): pack[i] = the lane's front-packed
//   destination, or cap, and *count = the lanes kept;
// * mode 2 (more lanes): pack[i] = the lane's block-local inclusive prefix
//   minus one, count[block] = the block's lanes kept; the caller adds the
//   blocks' exclusive scan (cascade_kernel.combine_blocks).
// Every lane still active after the walk is kept, the last stage's too:
// a batch row that survives stage S - 1 is decided by beta after the loop
// (B6, whose lanes are refilled, leaves its last-stage lanes out instead).
//
// What bounds it on an H100: bytes.  A lane reads its row id, g, W scores
// and the stage's threshold rows, and writes five words; at the serving
// shape (cap 256, W 8) the whole call moves about 13 KB, so in practice the
// launch itself is the cost, and with the step form the PyTorch calls of
// the gather, the mask and the cumsum pack are gone with it.
//
// Design: one thread per row, serial over the columns (the walk is a
// dependent chain, as on the TPU).  The TPU kernel stopped a block's walk
// once every lane had exited; here each row is its own thread, so a retired
// row reads no more scores.  The reference's form reads the two threshold
// rows through the cache at one address a warp.
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

namespace {

struct StepArgs {
  const float* g;          // (cap + 1,) partial sums by buffer slot
  const long long* rows;   // (cap,) each lane's slot, clamped into [0, cap]
  const float* scores;     // (cap, W) the stage's scores
  const float* eps_pos;    // stage s's row of the (S, W) tables
  const float* eps_neg;
  const bool* col_valid;
  const int* n_valid_dev;
  int n_valid_host;
  int cap, W;
  int vec;  // W % 4 == 0, scores and tables 16-byte and col_valid 4-byte aligned
  float* g_out;
  int* active;
  int* dec;
  int* exit_rel;
  int* pack;   // mode 1: destinations; mode 2: block-local prefixes
  int* count;  // mode 1: the kept total; mode 2: each block's
};

template <int kMode>
__global__ void __launch_bounds__(1024) chunk_step_kernel(const StepArgs a) {
  __shared__ int s_warp[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane_ok = i < a.cap;
  const int lim = live_limit(a.n_valid_dev, a.n_valid_host, a.cap);
  // the row id and the live count first, then g through the row id
  const long long r = lane_ok ? a.rows[i] : 0;
  const long long slot = r < 0 ? 0 : (r > a.cap ? a.cap : r);
  float g = lane_ok ? a.g[slot] : 0.0f;
  bool active = lane_ok && i < lim;
  bool dec = false;
  int ex = 0;
  lane_walk(a.scores + static_cast<size_t>(i) * a.W, a.eps_pos, a.eps_neg,
            a.col_valid, a.W, a.vec != 0, g, active, dec, ex);
  int total;
  const int incl = block_flag_scan(active, s_warp, &total);
  if (lane_ok) {
    a.pack[i] = (kMode == 1 && !active) ? a.cap : incl - 1;
    a.g_out[i] = g;
    a.active[i] = active ? 1 : 0;
    a.dec[i] = dec ? 1 : 0;
    a.exit_rel[i] = ex;
  }
  if (threadIdx.x == 0) a.count[blockIdx.x] = total;
}

}  // namespace

// `mode`, `blocks` and `threads` come from the wrapper's launch geometry
// (cascade_kernel.lane_geometry, as B6's); both modes take whole warps.
// eps_pos, eps_neg and col_valid point at stage s's rows of the tables.
extern "C" int cascade_chunk_step_launch(
    const float* g, const long long* rows, const float* scores,
    const float* eps_pos, const float* eps_neg, const bool* col_valid,
    const int* n_valid_dev, int n_valid_host, int cap, int W, int vec,
    int mode, int blocks, int threads, float* g_out, int* active_out,
    int* dec_out, int* exit_out, int* pack_out, int* count_out,
    cudaStream_t stream) {
  const StepArgs a{g, rows, scores, eps_pos, eps_neg, col_valid, n_valid_dev,
                   n_valid_host, cap, W, vec, g_out, active_out, dec_out,
                   exit_out, pack_out, count_out};
  switch (mode) {
    case 1:
      chunk_step_kernel<1><<<blocks, threads, 0, stream>>>(a);
      break;
    case 2:
      chunk_step_kernel<2><<<blocks, threads, 0, stream>>>(a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
