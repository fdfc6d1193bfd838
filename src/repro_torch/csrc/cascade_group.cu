// B8: the group decide of a ranking cascade (query-level early exit), and
// the group's top-k picks.
//
// Replaces repro/kernels/cascade_kernel.py cascade_group_pallas (its
// pallas_call at :518, body _cascade_group_kernel at :422-471), and takes
// over the picks of repro/kernels/device_executor.py group_topk_rows
// (:650-683), which the reference's grouped loop runs beside it.  Given the
// partial document scores g (G, B) of G query groups laid out in one bucket
// width B, the real-lane mask valid (G, B) and a per-group threshold eps
// (G,), each group's top-k stability margin is its k-th best score minus its
// (k+1)-th best, +inf when the group has at most k documents.  A group exits
// as a unit iff it is live (before n_live) and margin > eps, strictly, so
// eps = +inf never exits.  With rows (G, B) given, the kernel also writes
// picks (G, k): the global row ids of the group's first k valid lanes in the
// order (score descending, lane ascending), -1 past the group's size.
//
// The reference takes k + 1 masked-max passes, each consuming the first
// (lowest-lane) hit of the pass's maximum, so its picks are the valid lanes
// in that order and pass i's maximum is the i-th of them.  A NaN among a
// group's valid lanes is never consumed and makes every pass's maximum NaN:
// the margin is NaN (exit 0) when the group has more than k documents, and
// every pick is -1.  The kernel reproduces both with one vote.
//
// What bounds it on an H100: bytes.  It reads g, valid and rows once (16
// bytes a lane) and writes 8 + 4k bytes a group; at the serving shape (256
// groups of 32 lanes, k 10) that is 0.14 MB, 0.04 us at the card's memory
// rate, so the launch is the cost.  What the design removes is the passes'
// dependent chain (k + 1 rescans, each behind a 5-round shuffle reduction)
// and, on the grouped loop, the stable sort of (G, B) int64 keys and the
// gathers that recomputed the picks beside every launch.
//
// Design: rank by counting.  A valid lane's rank is the number of valid
// lanes before it in the pick order (a larger score, or an equal one at a
// lower lane; == takes -0.0 and +0.0 as equal), so the B compares of a lane
// are independent.  The lanes of rank k - 1 and k hold vk and vk1, and a
// lane of rank below k writes its row id to picks[rank].  An invalid lane
// enters the compares as NaN, which no compare counts.
// * B <= 32: one warp a group, a lane a document, the group's scores
//   broadcast from register to register (__shfl_sync); groups_per_cta warps
//   a CTA, chosen by the wrapper so that a serving wave spreads over the
//   SMs.
// * B > 32: one CTA a group (up to 1024 threads, a thread a document or
//   several), the group's scores staged once in shared memory and read as
//   broadcasts.
// n_live is read on the device when the caller keeps the live count there,
// so a stage past the quit retires with no host read.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
// the NaN a subtraction of NaNs gives on the card
__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fffffff); }

struct GroupArgs {
  const float* g;
  const int* valid;
  const float* eps;
  const long long* rows;  // null: no picks
  const int* n_live_dev;
  int n_live_host;
  int G, B, k;
  float* margin;
  int* exit;
  int* picks;
};

// (w at lane s) before (v at lane j) in the pick order; false when either
// is NaN (an invalid lane's key)
__device__ __forceinline__ bool before(float w, int s, float v, int j) {
  return w > v || (w == v && s < j);
}

__device__ __forceinline__ void decide(const GroupArgs& a, int grp, int size, bool nan,
                                       float vk, float vk1) {
  // the size guard also fences a margin between exhausted ranks
  const float margin = size <= a.k ? pos_inf() : (nan ? quiet_nan() : vk - vk1);
  const int lim = live_limit(a.n_live_dev, a.n_live_host, a.G);
  a.margin[grp] = margin;
  a.exit[grp] = (grp < lim && margin > a.eps[grp]) ? 1 : 0;
}

// B <= 32: warp w of the CTA decides group blockIdx.x * groups + w
__global__ void group_warp_kernel(const GroupArgs a) {
  const int lane = threadIdx.x & 31;
  const int grp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (grp >= a.G) return;  // whole warps only: grp is warp-uniform
  const size_t base = static_cast<size_t>(grp) * a.B;
  const bool in = lane < a.B;
  const bool ok = in && a.valid[base + lane] != 0;
  const float v = in ? a.g[base + lane] : 0.0f;
  const long long row = (a.rows && in) ? a.rows[base + lane] : 0;
  const float key = ok ? v : quiet_nan();
  const int size = __popc(__ballot_sync(kFull, ok));
  const bool nan = __any_sync(kFull, ok && v != v);

  int rank = 0;
  for (int s = 0; s < a.B; ++s) {
    rank += before(__shfl_sync(kFull, key, s), s, key, lane) ? 1 : 0;
  }
  const bool ranked = ok && !nan;
  const unsigned at_k1 = __ballot_sync(kFull, ranked && rank == a.k - 1);
  const unsigned at_k = __ballot_sync(kFull, ranked && rank == a.k);
  const float vk = __shfl_sync(kFull, v, at_k1 ? __ffs(at_k1) - 1 : 0);
  const float vk1 = __shfl_sync(kFull, v, at_k ? __ffs(at_k) - 1 : 0);

  if (a.picks) {
    int* p = a.picks + static_cast<size_t>(grp) * a.k;
    if (ranked && rank < a.k) p[rank] = static_cast<int>(row);
    for (int r = (nan ? 0 : min(size, a.k)) + lane; r < a.k; r += 32) p[r] = -1;
  }
  if (lane == 0) decide(a, grp, size, nan, vk, vk1);
}

// B > 32: CTA blockIdx.x decides one group; s_key holds its B keys
__global__ void __launch_bounds__(1024) group_block_kernel(const GroupArgs a) {
  extern __shared__ float s_key[];
  __shared__ float s_vk, s_vk1;
  const int grp = blockIdx.x;
  const size_t base = static_cast<size_t>(grp) * a.B;
  int size = 0;
  bool nan = false;
  for (int j0 = 0; j0 < a.B; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    bool ok = false, bad = false;
    if (j < a.B) {
      ok = a.valid[base + j] != 0;
      const float v = a.g[base + j];
      bad = ok && v != v;
      s_key[j] = ok ? v : quiet_nan();
    }
    size += __syncthreads_count(ok);
    nan = __syncthreads_or(bad) || nan;
  }
  if (!nan) {
    for (int j = threadIdx.x; j < a.B; j += blockDim.x) {
      const float v = s_key[j];
      if (v != v) continue;  // an invalid lane
      int rank = 0;
      for (int s = 0; s < a.B; ++s) rank += before(s_key[s], s, v, j) ? 1 : 0;
      if (rank == a.k - 1) s_vk = v;
      if (rank == a.k) s_vk1 = v;
      if (a.picks && rank < a.k) {
        a.picks[static_cast<size_t>(grp) * a.k + rank] = static_cast<int>(a.rows[base + j]);
      }
    }
  }
  if (a.picks) {
    int* p = a.picks + static_cast<size_t>(grp) * a.k;
    for (int r = (nan ? 0 : min(size, a.k)) + threadIdx.x; r < a.k; r += blockDim.x) p[r] = -1;
  }
  __syncthreads();
  if (threadIdx.x == 0) decide(a, grp, size, nan, s_vk, s_vk1);
}

}  // namespace

// `blocks`, `threads` and `smem` come from the wrapper's launch geometry
// (cascade_kernel.group_geometry): B <= 32 runs the warp kernel with
// threads / 32 groups a CTA, B > 32 the block kernel with one group a CTA
// and B floats of shared memory.  `rows` and `picks` are both null or both
// given.
extern "C" int cascade_group_launch(const float* g, const int* valid,
                                    const float* eps, const long long* rows,
                                    const int* n_live_dev, int n_live_host,
                                    int G, int B, int k, int blocks,
                                    int threads, int smem, float* margin_out,
                                    int* exit_out, int* picks_out,
                                    cudaStream_t stream) {
  const GroupArgs a{g, valid, eps, rows, n_live_dev, n_live_host, G, B, k,
                    margin_out, exit_out, picks_out};
  if (B <= 32) {
    group_warp_kernel<<<blocks, threads, 0, stream>>>(a);
  } else {
    group_block_kernel<<<blocks, threads, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
