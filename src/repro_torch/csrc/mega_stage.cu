// B4: one fused cascade stage step per row block (tree, matrix and lattice
// variants), and B7, its mixed-stage form for streaming admission, each over
// f32, bf16 or int8 parameter slabs.
//
// Replaces repro/kernels/megakernel.py mega_stage_pallas (B4, its
// pallas_call at :632) and mega_lane_pallas (B7, its pallas_call at :806).
// B4: for the survivor buffer's rows and stage `stage`: score the
// stage's W models (oblivious trees or lattices from the stage's parameter
// slab, or matrix columns t0 + j masked by the stage's true width), walk
// threshold_step W times with relative 1-based exits, then emit the
// block-local compaction prefix cumsum(keep) - 1 and the block's survivor
// count.  The caller turns those into pack positions with an exclusive scan
// over the (n_blocks,) counts.  Blocks at or past n_valid write inert
// outputs (g = g0, zeros) and compute nothing.
//
// B7: the same step for a block whose lanes sit at different stages
// (streaming admission refills freed lanes with stage-0 rows next to
// mid-cascade ones): lane i reads row rows[i] of the operand and the slab,
// threshold row and (matrix) start and width of its own stage stage[i], and
// a lane flagged stop[i] (running its last stage) is left out of the
// compaction prefix whether it exits or not.
//
// Quantised slabs: the payload (tree leaves, lattice vertex values, or the
// matrix operand) is stored as P = float, __nv_bfloat16 or int8_t, with one
// f32 scale per stage for int8.  dequant() turns a stored value into the
// f32 the plain version computes with (bf16 widened, int8 times its stage's
// scale: one rounded multiply, never contracted into a later add under
// -fmad=false), and everything after it is the f32 arithmetic.  Feature ids
// and tree thresholds are never quantised.
//
// What bounds it on an H100: bytes and, at serving sizes, the launch.  At
// the exp1 shape (256 rows x 14 features, W = 8, depth 5) a call reads about
// 16 KB of rows and 1.4 KB of slab and writes 5 KB.  The lattice variant at
// the exp4 shape (256 rows x 30 features, W = 8, S = 8) reads 31 KB of rows
// and 8.4 KB of slab and does 1.6 MFLOP, 23 ns at the card's f32 peak.  The
// fusion is what matters: the unfused stage writes a (cap, W) score buffer
// that the decide kernel reads back, and a cap-wide cumsum makes another
// pass.  B7 reads one stage slab per lane (8.4 KB for a lattice stage at
// f32, half at bf16, a quarter at int8); lanes at one stage read the same
// one, and the whole stacked slab of a T = 500 ensemble (520 KB for the
// lattices at f32) stays in the 50 MB L2.
//
// Design: one CTA per row block of `bn` rows, one thread per row.  B4 loads
// the stage's slab (feature ids, thresholds, leaf tables or lattice vertex
// values, the two threshold rows) into shared memory once, dequantising the
// payload while it stages it into the f32 layout, and every row of the
// block reads it; all threads score the same model at a time, so a
// lattice's vertex reads are broadcasts, and its partial values stay in
// registers (lattice_interp, shared with B5).  B7's lanes need different
// slabs, so it reads them in place through the caches with plain indexed
// loads and dequantises at each read with the lane's stage scale (the TPU
// kernel's per-lane one-hot gathers and pre-gathered per-lane slab copies
// have no counterpart).  The block prefix is a warp scan with shuffles,
// then a scan of the per-warp totals.
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "lattice.cuh"
#include "threshold_step.cuh"

namespace {

// A stored payload value as the f32 the plain version computes with.
__device__ __forceinline__ float dequant(float q, float) { return q; }
__device__ __forceinline__ float dequant(__nv_bfloat16 q, float) {
  return __bfloat162float(q);
}
__device__ __forceinline__ float dequant(int8_t q, float scale) {
  return static_cast<float>(q) * scale;
}

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

// The walk + pack shared by every variant of B4 and B7.  `score(j)` gives
// model j's score for this thread's row; it is called for active rows only.
// `ep`/`en` are the row's threshold row.  A lane with `stop` set is left out
// of the prefix and the count (B7's last-stage lanes; always false in B4).
template <typename Score>
__device__ void walk_and_pack(const float* __restrict__ g0, int i,
                              bool lane_ok, int nv, int W, const float* ep,
                              const float* en, int* s_warp, Score score,
                              Outputs out, bool stop) {
  float g = lane_ok ? g0[i] : 0.0f;
  bool active = lane_ok && i < nv;
  bool dec = false;
  int ex = 0;
  for (int j = 0; j < W; ++j) {
    const float f = active ? score(j) : 0.0f;
    threshold_step(g, active, dec, ex, f, ep[j], en[j], j + 1);
  }
  int total;
  const int incl =
      block_inclusive_scan(active && !stop ? 1 : 0, s_warp, &total);
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

template <typename P>
__global__ void mega_stage_tree_kernel(
    const float* __restrict__ x, const float* __restrict__ g0, int stage,
    const int* n_valid_dev, int n_valid_host, int cap, int d, int W,
    int depth, int bn, const int* __restrict__ feats,
    const float* __restrict__ thrs, const P* __restrict__ leaves,
    const float* __restrict__ scales, const float* __restrict__ eps_pos,
    const float* __restrict__ eps_neg, Outputs out) {
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
  const float scale = scales[stage];
  for (int k = threadIdx.x; k < W * n_leaves; k += blockDim.x) {
    s_leaves[k] = dequant(leaves[so * n_leaves + k], scale);
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
  walk_and_pack(g0, i, lane_ok, nv, W, s_ep, s_en, s_warp, score, out,
                false);
}

template <typename P>
__global__ void mega_stage_matrix_kernel(
    const P* __restrict__ x, const float* __restrict__ g0, int stage,
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
  const P* xr = x + static_cast<size_t>(lane_ok ? i : 0) * t_pad + t0;
  auto score = [&](int j) { return j < width ? dequant(xr[j], 1.0f) : 0.0f; };
  walk_and_pack(g0, i, lane_ok, nv, W, s_ep, s_en, s_warp, score, out,
                false);
}

template <int S, typename P>
__global__ void mega_stage_lattice_kernel(
    const float* __restrict__ x, const float* __restrict__ g0, int stage,
    const int* n_valid_dev, int n_valid_host, int cap, int d, int W, int bn,
    const int* __restrict__ feats, const P* __restrict__ theta,
    const float* __restrict__ scales, const float* __restrict__ eps_pos,
    const float* __restrict__ eps_neg, Outputs out) {
  constexpr int V = 1 << S;  // vertex values per lattice
  extern __shared__ unsigned char smem[];
  int* s_warp = reinterpret_cast<int*>(smem);  // 32 ints
  int* s_feats = s_warp + 32;                  // W * S
  float* s_theta = reinterpret_cast<float*>(s_feats + W * S);  // W * V
  float* s_ep = s_theta + W * V;
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
  const float scale = scales[stage];
  for (int k = threadIdx.x; k < W * V; k += blockDim.x) {
    s_theta[k] = dequant(theta[so * V + k], scale);
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
    return lattice_interp<S>(s_theta + j * V, xs);
  };
  walk_and_pack(g0, i, lane_ok, nv, W, s_ep, s_en, s_warp, score, out,
                false);
}

template <int S, typename P>
int launch_lattice(const float* x, const float* g0, int stage,
                   const int* n_valid_dev, int n_valid_host, int cap, int d,
                   int W, int bn, const int* feats, const void* theta,
                   const float* scales, const float* eps_pos,
                   const float* eps_neg, const Outputs& out,
                   cudaStream_t stream) {
  const int threads = ((bn + 31) / 32) * 32;  // whole warps for the scan
  const int blocks = (cap + bn - 1) / bn;
  const size_t smem = static_cast<size_t>(32 + W * (S + (1 << S)) + 2 * W) * 4;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(mega_stage_lattice_kernel<S, P>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  mega_stage_lattice_kernel<S, P><<<blocks, threads, smem, stream>>>(
      x, g0, stage, n_valid_dev, n_valid_host, cap, d, W, bn, feats,
      static_cast<const P*>(theta), scales, eps_pos, eps_neg, out);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_lattice_quant(int quant, const float* x, const float* g0,
                         int stage, const int* n_valid_dev, int n_valid_host,
                         int cap, int d, int W, int bn, const int* feats,
                         const void* theta, const float* scales,
                         const float* eps_pos, const float* eps_neg,
                         const Outputs& out, cudaStream_t stream) {
  switch (quant) {
#define LATTICE_QUANT_CASE(Q, T)                                            \
  case Q:                                                                   \
    return launch_lattice<S, T>(x, g0, stage, n_valid_dev, n_valid_host,   \
                                cap, d, W, bn, feats, theta, scales,       \
                                eps_pos, eps_neg, out, stream);
    LATTICE_QUANT_CASE(0, float)
    LATTICE_QUANT_CASE(1, __nv_bfloat16)
    LATTICE_QUANT_CASE(2, int8_t)
#undef LATTICE_QUANT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- B7: mixed-stage lanes ------------------------------------------------

// What every B7 variant reads besides its slab.  Lane i scores row rows[i]
// of x (n_rows x d, rows clamped into range; X = float, or the matrix
// variant's bf16 operand) at stage stage[i] (clamped into [0, n_stages));
// eps_pos/eps_neg are the (n_stages, W) threshold tables.
template <typename X>
struct LaneArgs {
  const X* x;
  const long long* rows;
  int n_rows;
  const float* g0;
  const int* stage;
  const bool* stop;
  const int* n_valid_dev;
  int n_valid_host;
  int cap;
  int d;
  int W;
  int n_stages;
  int bn;
  const float* eps_pos;
  const float* eps_neg;
};

// score(xr, st, j): model j of stage st on the row xr.  `scales` are the
// (n_stages,) per-stage dequantisation scales of the payload P.
template <typename P>
struct TreeLane {
  const int* feats;     // (n_stages, W, depth)
  const float* thrs;    // (n_stages, W, depth)
  const P* leaves;      // (n_stages, W, 2^depth)
  const float* scales;  // (n_stages,)
  int depth;
  int W;
  __device__ float score(const float* xr, int st, int j) const {
    const size_t m = static_cast<size_t>(st) * W + j;
    int idx = 0;
    for (int k = 0; k < depth; ++k) {
      idx = 2 * idx + (xr[feats[m * depth + k]] > thrs[m * depth + k]);
    }
    return dequant(leaves[(m << depth) + idx], scales[st]);
  }
};

template <typename X>
struct MatrixLane {
  const int* t0s;     // (n_stages,) first cascade position of each stage
  const int* widths;  // (n_stages,) true stage widths
  __device__ float score(const X* xr, int st, int j) const {
    return j < widths[st] ? dequant(xr[t0s[st] + j], 1.0f) : 0.0f;
  }
};

template <int S, typename P>
struct LatticeLane {
  const int* feats;     // (n_stages, W, S)
  const P* theta;       // (n_stages, W, 2^S)
  const float* scales;  // (n_stages,)
  int W;
  __device__ float score(const float* xr, int st, int j) const {
    const size_t m = static_cast<size_t>(st) * W + j;
    float xs[S];
#pragma unroll
    for (int k = 0; k < S; ++k) xs[k] = xr[feats[m * S + k]];
    const P* th = theta + (m << S);
    const float scale = scales[st];
    return lattice_interp_with<S>(
        [th, scale](int c) { return dequant(th[c], scale); }, xs);
  }
};

template <typename X, typename Lane>
__global__ void mega_lane_kernel(LaneArgs<X> a, Lane v, Outputs out) {
  __shared__ int s_warp[32];
  const int block_start = blockIdx.x * a.bn;
  const int i = block_start + threadIdx.x;
  const bool lane_ok = threadIdx.x < a.bn && i < a.cap;
  const int nv = live_limit(a.n_valid_dev, a.n_valid_host, a.cap);
  if (block_start >= nv) {
    skip_block(a.g0, i, lane_ok, out);
    return;
  }
  const int st = lane_ok ? min(max(a.stage[i], 0), a.n_stages - 1) : 0;
  const long long r =
      lane_ok ? min(max(a.rows[i], 0LL), static_cast<long long>(a.n_rows - 1))
              : 0;
  const X* xr = a.x + r * a.d;
  const size_t so = static_cast<size_t>(st) * a.W;
  auto score = [&](int j) { return v.score(xr, st, j); };
  walk_and_pack(a.g0, i, lane_ok, nv, a.W, a.eps_pos + so, a.eps_neg + so,
                s_warp, score, out, lane_ok && a.stop[i]);
}

template <typename X, typename Lane>
int launch_lane(const LaneArgs<X>& a, const Lane& v, const Outputs& out,
                cudaStream_t stream) {
  const int threads = ((a.bn + 31) / 32) * 32;  // whole warps for the scan
  const int blocks = (a.cap + a.bn - 1) / a.bn;
  mega_lane_kernel<X, Lane><<<blocks, threads, 0, stream>>>(a, v, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int launch_tree(const float* x, const float* g0, int stage,
                const int* n_valid_dev, int n_valid_host, int cap, int d,
                int W, int depth, int bn, const int* feats, const float* thrs,
                const void* leaves, const float* scales, const float* eps_pos,
                const float* eps_neg, const Outputs& out,
                cudaStream_t stream) {
  const int threads = ((bn + 31) / 32) * 32;  // whole warps for the scan
  const int blocks = (cap + bn - 1) / bn;
  const size_t smem =
      static_cast<size_t>(32 + W * (2 * depth + (1 << depth)) + 2 * W) * 4;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(mega_stage_tree_kernel<P>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  mega_stage_tree_kernel<P><<<blocks, threads, smem, stream>>>(
      x, g0, stage, n_valid_dev, n_valid_host, cap, d, W, depth, bn, feats,
      thrs, static_cast<const P*>(leaves), scales, eps_pos, eps_neg, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename P>
int launch_matrix(const void* x, const float* g0, int stage, int t0,
                  const int* n_valid_dev, int n_valid_host, int cap,
                  int t_pad, int W, int bn, const int* widths,
                  const float* eps_pos, const float* eps_neg,
                  const Outputs& out, cudaStream_t stream) {
  const int threads = ((bn + 31) / 32) * 32;  // whole warps for the scan
  const int blocks = (cap + bn - 1) / bn;
  const size_t smem = static_cast<size_t>(32 + 2 * W) * 4;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(mega_stage_matrix_kernel<P>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  mega_stage_matrix_kernel<P><<<blocks, threads, smem, stream>>>(
      static_cast<const P*>(x), g0, stage, t0, n_valid_dev, n_valid_host,
      cap, t_pad, W, bn, widths, eps_pos, eps_neg, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `quant` is the payload's storage code: 0 f32, 1 bf16, 2 int8 (the matrix
// variant: the operand's, f32 or bf16).  `scales` are the (n_stages,) f32
// per-stage scales (read for int8 only).  Every launcher returns
// cudaErrorInvalidValue for a code it does not take.
extern "C" int mega_stage_tree_launch(
    const float* x, const float* g0, int stage, const int* n_valid_dev,
    int n_valid_host, int cap, int d, int W, int depth, int bn, int quant,
    const int* feats, const float* thrs, const void* leaves,
    const float* scales, const float* eps_pos, const float* eps_neg,
    float* g_out, int* act_out, int* dec_out, int* ex_out, int* pfx_out,
    int* cnt_out, cudaStream_t stream) {
  const Outputs out{g_out, act_out, dec_out, ex_out, pfx_out, cnt_out};
  switch (quant) {
#define TREE_CASE(Q, T)                                                      \
  case Q:                                                                    \
    return launch_tree<T>(x, g0, stage, n_valid_dev, n_valid_host, cap, d,  \
                          W, depth, bn, feats, thrs, leaves, scales,        \
                          eps_pos, eps_neg, out, stream);
    TREE_CASE(0, float)
    TREE_CASE(1, __nv_bfloat16)
    TREE_CASE(2, int8_t)
#undef TREE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int mega_stage_matrix_launch(
    const void* x, const float* g0, int stage, int t0,
    const int* n_valid_dev, int n_valid_host, int cap, int t_pad, int W,
    int bn, int quant, const int* widths, const float* eps_pos,
    const float* eps_neg, float* g_out, int* act_out, int* dec_out,
    int* ex_out, int* pfx_out, int* cnt_out, cudaStream_t stream) {
  const Outputs out{g_out, act_out, dec_out, ex_out, pfx_out, cnt_out};
  switch (quant) {
#define MATRIX_CASE(Q, T)                                                   \
  case Q:                                                                   \
    return launch_matrix<T>(x, g0, stage, t0, n_valid_dev, n_valid_host,   \
                            cap, t_pad, W, bn, widths, eps_pos, eps_neg,   \
                            out, stream);
    MATRIX_CASE(0, float)
    MATRIX_CASE(1, __nv_bfloat16)
#undef MATRIX_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// `s` is the lattices' input count (2^s vertex values each); returns
// cudaErrorInvalidValue for s outside [1, kMaxLatticeDims].
extern "C" int mega_stage_lattice_launch(
    const float* x, const float* g0, int stage, const int* n_valid_dev,
    int n_valid_host, int cap, int d, int W, int s, int bn, int quant,
    const int* feats, const void* theta, const float* scales,
    const float* eps_pos, const float* eps_neg, float* g_out, int* act_out,
    int* dec_out, int* ex_out, int* pfx_out, int* cnt_out,
    cudaStream_t stream) {
  const Outputs out{g_out, act_out, dec_out, ex_out, pfx_out, cnt_out};
  switch (s) {
#define LATTICE_CASE(S)                                                     \
  case S:                                                                   \
    return launch_lattice_quant<S>(quant, x, g0, stage, n_valid_dev,       \
                                   n_valid_host, cap, d, W, bn, feats,     \
                                   theta, scales, eps_pos, eps_neg, out,   \
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

// B7 entry points, one argument layout for the three variants: `aux` is the
// tree depth (tree), the lattices' input count S (lattice) or unused
// (matrix); p0/p1/p2 are the stage-stacked slabs: feats/thrs/leaves (tree),
// t0s/widths/- (matrix), feats/theta/- (lattice); `quant` and `scales` as
// for B4.  Returns cudaErrorInvalidValue for a lattice S outside
// [1, kMaxLatticeDims] or a quant code the variant does not take.
#define LANE_ARGS                                                            \
  const void *x, const long long *rows, int n_rows, const float *g0,         \
      const int *stage, const bool *stop, const int *n_valid_dev,            \
      int n_valid_host, int cap, int d, int W, int n_stages, int bn, int aux, \
      int quant, const void *p0, const void *p1, const void *p2,             \
      const float *scales, const float *eps_pos, const float *eps_neg,       \
      float *g_out, int *act_out, int *dec_out, int *ex_out, int *pfx_out,   \
      int *cnt_out, cudaStream_t stream
#define LANE_PACK(X)                                                         \
  const LaneArgs<X> a{static_cast<const X*>(x), rows, n_rows, g0, stage,     \
                      stop, n_valid_dev, n_valid_host, cap, d, W, n_stages,  \
                      bn, eps_pos, eps_neg};                                 \
  const Outputs out{g_out, act_out, dec_out, ex_out, pfx_out, cnt_out};

#define LANE_CALL                                                          \
  (x, rows, n_rows, g0, stage, stop, n_valid_dev, n_valid_host, cap, d, W, \
   n_stages, bn, aux, quant, p0, p1, p2, scales, eps_pos, eps_neg, g_out,  \
   act_out, dec_out, ex_out, pfx_out, cnt_out, stream)

namespace {

template <typename P>
int lane_tree(LANE_ARGS) {
  LANE_PACK(float)
  const TreeLane<P> v{static_cast<const int*>(p0), static_cast<const float*>(p1),
                      static_cast<const P*>(p2), scales, aux, W};
  return launch_lane(a, v, out, stream);
}

template <typename X>
int lane_matrix(LANE_ARGS) {
  LANE_PACK(X)
  (void)aux;
  (void)p2;
  (void)scales;
  const MatrixLane<X> v{static_cast<const int*>(p0), static_cast<const int*>(p1)};
  return launch_lane(a, v, out, stream);
}

template <int S, typename P>
int lane_lattice(LANE_ARGS) {
  LANE_PACK(float)
  (void)p2;
  const LatticeLane<S, P> v{static_cast<const int*>(p0),
                            static_cast<const P*>(p1), scales, W};
  return launch_lane(a, v, out, stream);
}

template <int S>
int lane_lattice_quant(LANE_ARGS) {
  switch (quant) {
#define LANE_LATTICE_QUANT_CASE(Q, T)                                        \
  case Q:                                                                    \
    return lane_lattice<S, T> LANE_CALL;
    LANE_LATTICE_QUANT_CASE(0, float)
    LANE_LATTICE_QUANT_CASE(1, __nv_bfloat16)
    LANE_LATTICE_QUANT_CASE(2, int8_t)
#undef LANE_LATTICE_QUANT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int mega_lane_tree_launch(LANE_ARGS) {
  switch (quant) {
    case 0:
      return lane_tree<float> LANE_CALL;
    case 1:
      return lane_tree<__nv_bfloat16> LANE_CALL;
    case 2:
      return lane_tree<int8_t> LANE_CALL;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int mega_lane_matrix_launch(LANE_ARGS) {
  switch (quant) {
    case 0:
      return lane_matrix<float> LANE_CALL;
    case 1:
      return lane_matrix<__nv_bfloat16> LANE_CALL;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int mega_lane_lattice_launch(LANE_ARGS) {
  switch (aux) {
#define LANE_LATTICE_CASE(S) \
  case S:                    \
    return lane_lattice_quant<S> LANE_CALL;
    LANE_LATTICE_CASE(1)
    LANE_LATTICE_CASE(2)
    LANE_LATTICE_CASE(3)
    LANE_LATTICE_CASE(4)
    LANE_LATTICE_CASE(5)
    LANE_LATTICE_CASE(6)
    LANE_LATTICE_CASE(7)
    LANE_LATTICE_CASE(8)
#undef LANE_LATTICE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
#undef LANE_CALL
#undef LANE_PACK
#undef LANE_ARGS
