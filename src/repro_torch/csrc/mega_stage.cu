// B4: one fused cascade stage step per row block (f32 slabs; tree, matrix
// and lattice variants).
//
// Replaces repro/kernels/megakernel.py mega_stage_pallas (its pallas_call at
// :632).  For the survivor buffer's rows and stage `stage`: score the
// stage's W models (oblivious trees or lattices from the stage's parameter
// slab, or matrix columns t0 + j masked by the stage's true width), walk
// threshold_step W times with relative 1-based exits, then emit the
// block-local compaction prefix cumsum(keep) - 1 and the block's survivor
// count.  The caller turns those into pack positions with an exclusive scan
// over the (n_blocks,) counts.  Blocks at or past n_valid write inert
// outputs (g = g0, zeros) and compute nothing.
//
// What bounds it on an H100: bytes and, at serving sizes, the launch.  At
// the exp1 shape (256 rows x 14 features, W = 8, depth 5) a call reads about
// 16 KB of rows and 1.4 KB of slab and writes 5 KB.  The lattice variant at
// the exp4 shape (256 rows x 30 features, W = 8, S = 8) reads 31 KB of rows
// and 8.4 KB of slab and does 1.6 MFLOP, 23 ns at the card's f32 peak.  The
// fusion is what matters: the unfused stage writes a (cap, W) score buffer
// that the decide kernel reads back, and a cap-wide cumsum makes another
// pass.
//
// Design: one CTA per row block of `bn` rows, one thread per row.  The
// stage's slab (feature ids, thresholds, leaf tables or lattice vertex
// values, the two threshold rows) is loaded into shared memory once and read
// by every row of the block; all threads score the same model at a time, so
// a lattice's vertex reads are broadcasts, and its partial values stay in
// registers (lattice_interp, shared with B5).  The block prefix is a warp
// scan with shuffles, then a scan of the per-warp totals.
#include "common.cuh"
#include "lattice.cuh"
#include "threshold_step.cuh"

namespace {

// Inclusive block-wide sum of `v` over threadIdx.x; *total gets the block's
// sum.  Every thread of the CTA must call it (blockDim.x % 32 == 0).
__device__ int block_inclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    if (lane < n_warps) s_warp[lane] = w;
  }
  __syncthreads();
  *total = s_warp[n_warps - 1];
  return v + (warp > 0 ? s_warp[warp - 1] : 0);
}

struct Outputs {
  float* g;
  int* active;
  int* dec;
  int* exit_rel;
  int* pfx;
  int* cnt;
};

// The walk + pack shared by both variants.  `score(j)` gives model j's
// score for this thread's row; it is called for active rows only.
template <typename Score>
__device__ void walk_and_pack(const float* __restrict__ g0, int i,
                              bool lane_ok, int nv, int W,
                              const float* s_ep, const float* s_en,
                              int* s_warp, Score score, Outputs out) {
  float g = lane_ok ? g0[i] : 0.0f;
  bool active = lane_ok && i < nv;
  bool dec = false;
  int ex = 0;
  for (int j = 0; j < W; ++j) {
    const float f = active ? score(j) : 0.0f;
    threshold_step(g, active, dec, ex, f, s_ep[j], s_en[j], j + 1);
  }
  int total;
  const int incl = block_inclusive_scan(active ? 1 : 0, s_warp, &total);
  if (lane_ok) {
    out.g[i] = g;
    out.active[i] = active ? 1 : 0;
    out.dec[i] = dec ? 1 : 0;
    out.exit_rel[i] = ex;
    out.pfx[i] = incl - 1;
  }
  if (threadIdx.x == 0) out.cnt[blockIdx.x] = total;
}

// A block past the live count: inert outputs, nothing computed.
__device__ void skip_block(const float* __restrict__ g0, int i, bool lane_ok,
                           Outputs out) {
  if (lane_ok) {
    out.g[i] = g0[i];
    out.active[i] = 0;
    out.dec[i] = 0;
    out.exit_rel[i] = 0;
    out.pfx[i] = 0;
  }
  if (threadIdx.x == 0) out.cnt[blockIdx.x] = 0;
}

__global__ void mega_stage_tree_kernel(
    const float* __restrict__ x, const float* __restrict__ g0, int stage,
    const int* n_valid_dev, int n_valid_host, int cap, int d, int W,
    int depth, int bn, const int* __restrict__ feats,
    const float* __restrict__ thrs, const float* __restrict__ leaves,
    const float* __restrict__ eps_pos, const float* __restrict__ eps_neg,
    Outputs out) {
  extern __shared__ unsigned char smem[];
  const int n_leaves = 1 << depth;
  int* s_warp = reinterpret_cast<int*>(smem);  // 32 ints
  int* s_feats = s_warp + 32;                  // W * depth
  float* s_thrs = reinterpret_cast<float*>(s_feats + W * depth);
  float* s_leaves = s_thrs + W * depth;  // W * n_leaves
  float* s_ep = s_leaves + W * n_leaves;
  float* s_en = s_ep + W;

  const int block_start = blockIdx.x * bn;
  const int i = block_start + threadIdx.x;
  const bool lane_ok = threadIdx.x < bn && i < cap;
  const int nv = live_limit(n_valid_dev, n_valid_host, cap);
  if (block_start >= nv) {
    skip_block(g0, i, lane_ok, out);
    return;
  }
  const size_t so = static_cast<size_t>(stage) * W;
  for (int k = threadIdx.x; k < W * depth; k += blockDim.x) {
    s_feats[k] = feats[so * depth + k];
    s_thrs[k] = thrs[so * depth + k];
  }
  for (int k = threadIdx.x; k < W * n_leaves; k += blockDim.x) {
    s_leaves[k] = leaves[so * n_leaves + k];
  }
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    s_ep[k] = eps_pos[so + k];
    s_en[k] = eps_neg[so + k];
  }
  __syncthreads();
  const float* xr = x + static_cast<size_t>(lane_ok ? i : 0) * d;
  auto score = [&](int j) {
    int idx = 0;
    for (int k = 0; k < depth; ++k) {
      idx = 2 * idx + (xr[s_feats[j * depth + k]] > s_thrs[j * depth + k]);
    }
    return s_leaves[j * n_leaves + idx];
  };
  walk_and_pack(g0, i, lane_ok, nv, W, s_ep, s_en, s_warp, score, out);
}

__global__ void mega_stage_matrix_kernel(
    const float* __restrict__ x, const float* __restrict__ g0, int stage,
    int t0, const int* n_valid_dev, int n_valid_host, int cap, int t_pad,
    int W, int bn, const int* __restrict__ widths,
    const float* __restrict__ eps_pos, const float* __restrict__ eps_neg,
    Outputs out) {
  extern __shared__ unsigned char smem[];
  int* s_warp = reinterpret_cast<int*>(smem);  // 32 ints
  float* s_ep = reinterpret_cast<float*>(s_warp + 32);
  float* s_en = s_ep + W;

  const int block_start = blockIdx.x * bn;
  const int i = block_start + threadIdx.x;
  const bool lane_ok = threadIdx.x < bn && i < cap;
  const int nv = live_limit(n_valid_dev, n_valid_host, cap);
  if (block_start >= nv) {
    skip_block(g0, i, lane_ok, out);
    return;
  }
  const size_t so = static_cast<size_t>(stage) * W;
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    s_ep[k] = eps_pos[so + k];
    s_en[k] = eps_neg[so + k];
  }
  __syncthreads();
  const int width = widths[stage];
  const float* xr = x + static_cast<size_t>(lane_ok ? i : 0) * t_pad + t0;
  auto score = [&](int j) { return j < width ? xr[j] : 0.0f; };
  walk_and_pack(g0, i, lane_ok, nv, W, s_ep, s_en, s_warp, score, out);
}

template <int S>
__global__ void mega_stage_lattice_kernel(
    const float* __restrict__ x, const float* __restrict__ g0, int stage,
    const int* n_valid_dev, int n_valid_host, int cap, int d, int W, int bn,
    const int* __restrict__ feats, const float* __restrict__ theta,
    const float* __restrict__ eps_pos, const float* __restrict__ eps_neg,
    Outputs out) {
  constexpr int P = 1 << S;
  extern __shared__ unsigned char smem[];
  int* s_warp = reinterpret_cast<int*>(smem);  // 32 ints
  int* s_feats = s_warp + 32;                  // W * S
  float* s_theta = reinterpret_cast<float*>(s_feats + W * S);  // W * P
  float* s_ep = s_theta + W * P;
  float* s_en = s_ep + W;

  const int block_start = blockIdx.x * bn;
  const int i = block_start + threadIdx.x;
  const bool lane_ok = threadIdx.x < bn && i < cap;
  const int nv = live_limit(n_valid_dev, n_valid_host, cap);
  if (block_start >= nv) {
    skip_block(g0, i, lane_ok, out);
    return;
  }
  const size_t so = static_cast<size_t>(stage) * W;
  for (int k = threadIdx.x; k < W * S; k += blockDim.x) {
    s_feats[k] = feats[so * S + k];
  }
  for (int k = threadIdx.x; k < W * P; k += blockDim.x) {
    s_theta[k] = theta[so * P + k];
  }
  for (int k = threadIdx.x; k < W; k += blockDim.x) {
    s_ep[k] = eps_pos[so + k];
    s_en[k] = eps_neg[so + k];
  }
  __syncthreads();
  const float* xr = x + static_cast<size_t>(lane_ok ? i : 0) * d;
  auto score = [&](int j) {
    float xs[S];
#pragma unroll
    for (int k = 0; k < S; ++k) xs[k] = xr[s_feats[j * S + k]];
    return lattice_interp<S>(s_theta + j * P, xs);
  };
  walk_and_pack(g0, i, lane_ok, nv, W, s_ep, s_en, s_warp, score, out);
}

template <int S>
int launch_lattice(const float* x, const float* g0, int stage,
                   const int* n_valid_dev, int n_valid_host, int cap, int d,
                   int W, int bn, const int* feats, const float* theta,
                   const float* eps_pos, const float* eps_neg,
                   const Outputs& out, cudaStream_t stream) {
  const int threads = ((bn + 31) / 32) * 32;  // whole warps for the scan
  const int blocks = (cap + bn - 1) / bn;
  const size_t smem = static_cast<size_t>(32 + W * (S + (1 << S)) + 2 * W) * 4;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(mega_stage_lattice_kernel<S>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  mega_stage_lattice_kernel<S><<<blocks, threads, smem, stream>>>(
      x, g0, stage, n_valid_dev, n_valid_host, cap, d, W, bn, feats, theta,
      eps_pos, eps_neg, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mega_stage_tree_launch(
    const float* x, const float* g0, int stage, const int* n_valid_dev,
    int n_valid_host, int cap, int d, int W, int depth, int bn,
    const int* feats, const float* thrs, const float* leaves,
    const float* eps_pos, const float* eps_neg, float* g_out, int* act_out,
    int* dec_out, int* ex_out, int* pfx_out, int* cnt_out,
    cudaStream_t stream) {
  const int threads = ((bn + 31) / 32) * 32;  // whole warps for the scan
  const int blocks = (cap + bn - 1) / bn;
  const size_t smem =
      static_cast<size_t>(32 + W * (2 * depth + (1 << depth)) + 2 * W) * 4;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(mega_stage_tree_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const Outputs out{g_out, act_out, dec_out, ex_out, pfx_out, cnt_out};
  mega_stage_tree_kernel<<<blocks, threads, smem, stream>>>(
      x, g0, stage, n_valid_dev, n_valid_host, cap, d, W, depth, bn, feats,
      thrs, leaves, eps_pos, eps_neg, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mega_stage_matrix_launch(
    const float* x, const float* g0, int stage, int t0,
    const int* n_valid_dev, int n_valid_host, int cap, int t_pad, int W,
    int bn, const int* widths, const float* eps_pos, const float* eps_neg,
    float* g_out, int* act_out, int* dec_out, int* ex_out, int* pfx_out,
    int* cnt_out, cudaStream_t stream) {
  const int threads = ((bn + 31) / 32) * 32;  // whole warps for the scan
  const int blocks = (cap + bn - 1) / bn;
  const size_t smem = static_cast<size_t>(32 + 2 * W) * 4;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(mega_stage_matrix_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const Outputs out{g_out, act_out, dec_out, ex_out, pfx_out, cnt_out};
  mega_stage_matrix_kernel<<<blocks, threads, smem, stream>>>(
      x, g0, stage, t0, n_valid_dev, n_valid_host, cap, t_pad, W, bn, widths,
      eps_pos, eps_neg, out);
  return static_cast<int>(cudaGetLastError());
}

// `s` is the lattices' input count (2^s vertex values each); returns
// cudaErrorInvalidValue for s outside [1, kMaxLatticeDims].
extern "C" int mega_stage_lattice_launch(
    const float* x, const float* g0, int stage, const int* n_valid_dev,
    int n_valid_host, int cap, int d, int W, int s, int bn, const int* feats,
    const float* theta, const float* eps_pos, const float* eps_neg,
    float* g_out, int* act_out, int* dec_out, int* ex_out, int* pfx_out,
    int* cnt_out, cudaStream_t stream) {
  const Outputs out{g_out, act_out, dec_out, ex_out, pfx_out, cnt_out};
  switch (s) {
#define LATTICE_CASE(S)                                                     \
  case S:                                                                   \
    return launch_lattice<S>(x, g0, stage, n_valid_dev, n_valid_host, cap, \
                             d, W, bn, feats, theta, eps_pos, eps_neg, out, \
                             stream);
    LATTICE_CASE(1)
    LATTICE_CASE(2)
    LATTICE_CASE(3)
    LATTICE_CASE(4)
    LATTICE_CASE(5)
    LATTICE_CASE(6)
    LATTICE_CASE(7)
    LATTICE_CASE(8)
#undef LATTICE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
