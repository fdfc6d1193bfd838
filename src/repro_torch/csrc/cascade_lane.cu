// B6: the lane decide of streaming admission, a threshold walk over lanes
// at mixed stages, with the compaction prefix of the step.
//
// Replaces repro/kernels/cascade_kernel.py cascade_lane_pallas (its
// pallas_call at :316), and takes over what the reference's unfused
// streaming step (repro/kernels/device_executor.py:1059-1076) does around
// it: gather each lane's threshold rows and column mask at its own stage,
// zero the masked scores, and pack the survivors by a cumsum.  Lane i walks
// its W scores with the threshold row of its own stage st = stages[i] from
// the (S, W) tables eps_pos, eps_neg, adding a literal 0.0f for a column
// that col_valid[st] marks invalid (the padded tail of a ragged last stage).
// Lanes at or past n_valid start inactive.  Outputs g, active, decided_pos
// and the RELATIVE 1-based exit step within the stage (0 = survived); the
// caller rebases it by each lane's stage start.  A lane at stage >=
// stop_stage (its last stage) is left out of the compaction whether it
// exits or not, and so is a lane that exits or starts inactive:
// * mode 1 (cap <= 1024, one CTA): pack[i] = the lane's front-packed
//   destination, or cap, and *count = the lanes kept;
// * mode 2 (more lanes): pack[i] = the lane's block-local inclusive prefix
//   minus one, count[block] = the block's lanes kept; the caller adds the
//   blocks' exclusive scan (cascade_kernel.combine_blocks);
// * mode 0: no compaction.  The JAX-shaped form, (m, ct) per-row threshold
//   slabs, runs as stages = null (lane i reads table row i), no column mask
//   and no stop.
//
// What bounds it on an H100: bytes.  A lane reads W scores, its stage and
// g0 and its stage's threshold rows (read in place, so lanes at one stage
// share them through the caches), and writes five words; at the serving
// shape (cap 256, W 8, lanes over 64 stages) that is about 20 KB, 6 ns at
// the card's memory rate, so in practice the launch is the cost, and the
// PyTorch launches that gathered and packed around the kernel.
//
// Design: one thread per lane, serial over the W columns (the walk is a
// dependent chain), each step the shared threshold_step device function,
// as in B2 and B4; the walk is common.cuh's lane_walk (shared with B2's
// step form): the loads of a group of 8 columns issued together, as
// 16-byte loads where W % 4 == 0 and the rows are aligned, which cuts the
// L1 requests of a warp's scattered threshold rows about 4x.  Then one
// block_flag_scan (common.cuh) of the kept flags.  A lane at or past
// n_valid, and a lane that exited in an earlier group, reads no scores or
// thresholds.
#include "common.cuh"
#include "threshold_step.cuh"

namespace {

struct LaneArgs {
  const float* g0;
  const float* scores;   // (cap, W)
  const int* stages;     // (cap,) or null: lane i at table row i
  const float* eps_pos;  // (n_stages, W)
  const float* eps_neg;
  const bool* col_valid;  // (n_stages, W) or null: every column valid
  const int* n_valid_dev;
  int n_valid_host;
  int cap, W, n_stages, stop_stage;
  int vec;  // W % 4 == 0, scores and tables 16-byte and col_valid 4-byte aligned
  float* g;
  int* active;
  int* dec;
  int* exit_rel;
  int* pack;   // mode 1: destinations; mode 2: block-local prefixes
  int* count;  // mode 1: the kept total; mode 2: each block's
};

template <int kMode>
__global__ void __launch_bounds__(1024) lane_kernel(const LaneArgs a) {
  __shared__ int s_warp[32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane_ok = i < a.cap;
  const int lim = live_limit(a.n_valid_dev, a.n_valid_host, a.cap);
  int st = i;
  if (a.stages && lane_ok) st = min(max(a.stages[i], 0), a.n_stages - 1);
  float g = lane_ok ? a.g0[i] : 0.0f;
  bool active = lane_ok && i < lim;
  bool dec = false;
  int ex = 0;
  const size_t trow = static_cast<size_t>(st) * a.W;
  lane_walk(a.scores + static_cast<size_t>(i) * a.W, a.eps_pos + trow,
            a.eps_neg + trow, a.col_valid ? a.col_valid + trow : nullptr, a.W,
            a.vec != 0, g, active, dec, ex);
  if (kMode != 0) {
    const bool keep = active && st < a.stop_stage;
    int total;
    const int incl = block_flag_scan(keep, s_warp, &total);
    if (lane_ok) a.pack[i] = (kMode == 1 && !keep) ? a.cap : incl - 1;
    if (threadIdx.x == 0) a.count[blockIdx.x] = total;
  }
  if (lane_ok) {
    a.g[i] = g;
    a.active[i] = active ? 1 : 0;
    a.dec[i] = dec ? 1 : 0;
    a.exit_rel[i] = ex;
  }
}

}  // namespace

// `mode`, `blocks` and `threads` come from the wrapper's launch geometry
// (cascade_kernel.lane_geometry); modes 1 and 2 take whole warps.  A
// stop_stage of INT_MAX flags no lane.
extern "C" int cascade_lane_launch(
    const float* g0, const float* scores, const int* stages,
    const float* eps_pos, const float* eps_neg, const bool* col_valid,
    const int* n_valid_dev, int n_valid_host, int cap, int W, int n_stages,
    int stop_stage, int vec, int mode, int blocks, int threads, float* g_out,
    int* active_out, int* dec_out, int* exit_out, int* pack_out,
    int* count_out, cudaStream_t stream) {
  const LaneArgs a{g0, scores, stages, eps_pos, eps_neg, col_valid,
                   n_valid_dev, n_valid_host, cap, W, n_stages, stop_stage,
                   vec, g_out, active_out, dec_out, exit_out, pack_out,
                   count_out};
  switch (mode) {
    case 0:
      lane_kernel<0><<<blocks, threads, 0, stream>>>(a);
      break;
    case 1:
      lane_kernel<1><<<blocks, threads, 0, stream>>>(a);
      break;
    case 2:
      lane_kernel<2><<<blocks, threads, 0, stream>>>(a);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
