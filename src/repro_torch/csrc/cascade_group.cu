// B8: the group decide of a ranking cascade (query-level early exit).
//
// Replaces repro/kernels/cascade_kernel.py cascade_group_pallas (its
// pallas_call at :518, body _cascade_group_kernel at :422-471).  Given the
// partial document scores g (G, B) of G query groups laid out in one bucket
// width B, the real-lane mask valid (G, B) and a per-group threshold eps
// (G,), each group's top-k stability margin is its k-th best score minus its
// (k+1)-th best, +inf when the group has at most k documents.  A group exits
// as a unit iff it is live (before n_live) and margin > eps, strictly, so
// eps = +inf never exits.
//
// The reference takes k + 1 masked-max passes, each consuming the first
// (lowest-lane) hit of the pass's maximum.  The picks are therefore the
// valid lanes in the order (score descending, lane ascending), and pass i's
// maximum is the i-th of them.  Here a pass keeps no consumed mask: it
// takes the best lane strictly after the previous pick in that order
// (score below it, or equal to it at a higher lane).  Every operation is a
// compare, a select or the one f32 subtract, so margin and exit equal the
// plain version's and numpy's topk_margin bit for bit.  A NaN among a
// group's valid lanes is never consumed by the reference and makes every
// pass's maximum NaN; the kernel reproduces that with one vote.
//
// What bounds it on an H100: bytes.  It reads g and valid once (8 bytes a
// lane) and writes 8 bytes a group, and does about 3 (k + 1) compares a
// lane.  At the serving shape (tens of groups of up to 32 lanes) the call
// moves a few KB: the launch is the cost.
//
// Design: one warp per group, 8 groups (warps) per CTA as the reference's
// block_g.  Lanes stride over B; each pass is a per-lane scan of its
// strided lanes, then one warp reduction by __shfl_xor_sync over
// (score, lane) pairs (larger score wins, a tie goes to the lower lane).
// The rescans hit L1.  n_live is read on the device when the caller keeps
// the live count there, so a stage past the quit retires with no host read.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // groups per CTA
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fffffff); }

// (v, l) before (bv, bl) in the pick order: larger score, then lower lane.
__device__ __forceinline__ bool before(float v, int l, float bv, int bl) {
  return v > bv || (v == bv && l < bl);
}

}  // namespace

__global__ void cascade_group_kernel(const float* __restrict__ g,
                                     const int* __restrict__ valid,
                                     const float* __restrict__ eps,
                                     const int* __restrict__ n_live_dev,
                                     int n_live_host, int G, int B, int k,
                                     float* __restrict__ margin_out,
                                     int* __restrict__ exit_out) {
  const int lane = threadIdx.x & 31;
  const int grp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (grp >= G) return;  // whole warps only: grp is warp-uniform
  const float* gr = g + static_cast<size_t>(grp) * B;
  const int* vr = valid + static_cast<size_t>(grp) * B;

  // size = popcount of valid; a NaN on a valid lane poisons every pass
  int size = 0;
  bool nan = false;
  for (int j = lane; j < B; j += 32) {
    if (vr[j] != 0) {
      ++size;
      nan |= gr[j] != gr[j];
    }
  }
  for (int off = 16; off > 0; off >>= 1) size += __shfl_xor_sync(kFull, size, off);
  nan = __any_sync(kFull, nan);

  // k + 1 picks in (score desc, lane asc) order; a pass with nothing left
  // has maximum -inf, as the reference's max over an all -inf row
  float prev_v = pos_inf();
  int prev_l = -1;
  float vk = -pos_inf(), vk1 = -pos_inf();
  for (int i = 0; i <= k; ++i) {
    float bv = -pos_inf();
    int bl = INT_MAX;
    for (int j = lane; j < B; j += 32) {
      if (vr[j] == 0) continue;
      const float v = gr[j];
      const bool after = v < prev_v || (v == prev_v && j > prev_l);
      if (after && before(v, j, bv, bl)) {
        bv = v;
        bl = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int ol = __shfl_xor_sync(kFull, bl, off);
      if (before(ov, ol, bv, bl)) {
        bv = ov;
        bl = ol;
      }
    }
    const float cur = nan ? quiet_nan() : bv;
    if (i == k - 1) vk = cur;
    if (i == k) vk1 = cur;
    prev_v = bv;
    prev_l = bl;
  }

  if (lane == 0) {
    // the size guard also fences the -inf - -inf of exhausted passes
    const float margin = size <= k ? pos_inf() : vk - vk1;
    const int lim = live_limit(n_live_dev, n_live_host, G);
    margin_out[grp] = margin;
    exit_out[grp] = (grp < lim && margin > eps[grp]) ? 1 : 0;
  }
}

extern "C" int cascade_group_launch(const float* g, const int* valid,
                                    const float* eps, const int* n_live_dev,
                                    int n_live_host, int G, int B, int k,
                                    float* margin_out, int* exit_out,
                                    cudaStream_t stream) {
  const int blocks = (G + kWarps - 1) / kWarps;
  cascade_group_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      g, valid, eps, n_live_dev, n_live_host, G, B, k, margin_out, exit_out);
  return static_cast<int>(cudaGetLastError());
}
