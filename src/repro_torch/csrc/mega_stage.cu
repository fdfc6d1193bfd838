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
// 16 KB of rows and 1.4 KB of slab and writes 5 KB; the matrix variant reads
// 8 KB of scores (4 KB at bf16).  The lattice variant at
// the exp4 shape (256 rows x 30 features, W = 8, S = 8) reads 31 KB of rows
// and 8.4 KB of slab and does 1.6 MFLOP, 23 ns at the card's f32 peak.  The
// fusion is what matters: the unfused stage writes a (cap, W) score buffer
// that the decide kernel reads back, and a cap-wide cumsum makes another
// pass.  B7 reads one stage slab per lane (8.4 KB for a lattice stage at
// f32, half at bf16, a quarter at int8); lanes at one stage read the same
// one, and the whole stacked slab of a T = 500 ensemble (520 KB for the
// lattices at f32) stays in the 50 MB L2.  What a lattice call costs is not
// bytes but latency: 2048 (row, lattice) interpolations, each a chain of S
// dependent halvings, behind a few dependent global reads and barriers; a
// tree call is 2048 (row, tree) leaf selects, each a chain of a feature id,
// a feature value and a leaf read.  A thread that walks its row alone keeps
// 2 warps on each of 4 SMs and serialises its models' chains.
//
// Design: tree and lattice (B4 and B7, step_kernel<Model>): a row block is
// split over a thread-block cluster (TreeModel: kTreeCluster CTAs,
// lattices: up to 8), each CTA owning its share of the rows.  A CTA first
// stages what a chunk of models needs from global memory in one parallel
// pass (trees: each thread with kStageLoads loads in
// flight before it stores them): B4 the stage's feature ids, tree thresholds,
// dequantised leaf tables or vertex values and threshold rows (each CTA of the
// cluster its own copy); B7 each of its rows' feature ids, tree thresholds and
// threshold row (leaves and vertex values are read in place through the caches
// from the lane's own stage slab, and dequantised with its stage's scale as
// they arrive; the TPU kernel's per-lane one-hot gathers and pre-gathered
// per-lane slab copies have no counterpart).  The live count is loaded first
// and used only after the loads that need none (g0, B7's rows, stages and stop
// flags, the first chunk's slab) are issued.  Every (live row, model) pair of
// the chunk is then scored at once, speculatively: a tree pair by one thread,
// with the depth's compares unrolled in groups of kTreeGroup levels (a
// predicated remainder; a deeper tree takes another group), so a group's
// feature ids, thresholds and feature values are all in flight together before
// the leaf index is built MSB first and its one leaf read; a lattice pair by a
// team of min(32, 2^S) lanes of one warp (lattice_interp_team): lane t holds
// vertex values t, t + 32, ..., read as 2^S / 32 coalesced loads of 32
// consecutive values and dequantised as they arrive; the halvings that pair
// values 32 or more apart run in registers, the last five on warp shuffles,
// each rounded operation on the operands of the one-thread order, 4 pairs a
// team at once.  The W scores of a row go to shared memory, and one thread per
// row walks threshold_step over them in model order (an inactive row's later
// scores are computed and ignored; a leaf select and a dequantise are exact
// functions of the inputs, so the walk sees the plain version's bits). Each
// CTA pushes its survivor count into every rank's shared memory (distributed
// shared memory) before one cluster barrier; its prefix is its block scan plus
// the lower ranks' counts, and rank 0 writes the block's count, so
// `_combine_blocks` and block billing see one count per row block. The block
// prefix is a warp scan with shuffles, then a scan of the per-warp totals.
//
// Matrix (B4 and B7, matrix_step_kernel<P, kLanes>): a (row, model) pair is
// one load, so nothing is shared across CTAs: one CTA of whole warps per row
// block (billing's granularity), one thread per row, reading its score row
// in place (B4 through `rows` as B7 does, or a row already gathered).  What
// a call costs is its chain of dependent global reads, so every load that
// does not wait on another is issued at once: the live count, g0, the row
// id (B7: the stage and stop flag), then (B7) the stage's start, width and
// threshold row, then the row's W scores and threshold entries (W up to
// kMatrixGroup, the served width), all before the first threshold_step and
// before the live count is used (a block past it writes inert outputs):
// two dependent levels for B4, three for B7.  The block prefix is a
// ballot's popcount a warp and one barrier.
#include <cuda_bf16.h>

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "lattice.cuh"
#include "threshold_step.cuh"

namespace cg = cooperative_groups;

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

// ---- B4 and B7 tree and lattice: one step kernel over a cluster ------------

constexpr int kMaxCluster = 8;     // CTAs a row block is split over
constexpr int kStepThreads = 512;  // most threads a CTA runs
constexpr int kStepSmem = 48 * 1024;  // a chunk's staging budget
constexpr int kMaxStepSmem = 232448;  // what one CTA may hold (opt-in)
constexpr int kTeamTasks = 4;  // (row, lattice) pairs a team takes at once
constexpr int kStageLoads = 4;  // loads a staging thread keeps in flight
// Trees: CTAs a row block is split over (the card's sweep, PERF.md), and
// levels whose loads are issued together.
constexpr int kTreeCluster = 4;
constexpr int kTreeGroup = 10;
// B4 stages a chunk's dequantised leaf tables: one 2^15-leaf table (128 KB)
// is the deepest that fits a CTA; B7 reads leaves in place (an int index).
constexpr int kMaxStagedDepth = 15;
constexpr int kMaxLaneDepth = 30;

// What the tree and lattice variants of B4 and B7 read.  B4 (kLanes
// false): lane i scores row i of x (cap x d) at stage `stage`.  B7 (kLanes
// true): lane i scores row rows[i] of x (n_rows x d, clamped into range) at
// stage stages[i] (clamped into [0, n_stages)), and a lane flagged stop[i]
// is left out of the prefix and the count.  feats (n_stages, W, dims) are
// the stage-stacked feature ids, thrs (n_stages, W, dims) the tree
// thresholds (trees only), payload the (n_stages, W, 2^dims) leaf tables or
// vertex values, scales the (n_stages,) payload scales, eps_pos/eps_neg the
// (n_stages, W) threshold tables; dims is the tree depth or the lattice
// input count S.  rpc and wc are the launcher's geometry: rows a CTA of the
// cluster owns, models scored per chunk.
struct StepArgs {
  const float* x;
  const long long* rows;
  int n_rows;
  int stage;
  const int* stages;
  const bool* stop;
  int n_stages;
  const float* g0;
  const int* n_valid_dev;
  int n_valid_host;
  int cap;
  int d;
  int W;
  int bn;
  int dims;
  const int* feats;
  const float* thrs;
  const void* payload;  // P: float, __nv_bfloat16 or int8_t
  const float* scales;
  const float* eps_pos;
  const float* eps_neg;
  int rpc;
  int wc;
};

// The shared memory a chunk's model region starts at, and the CTA's view of
// the frame: its first lane r0, the B7 lanes' stages and rows.
struct StepFrame {
  int tid;
  int r0;
  const int* s_st;   // B7: rpc stages
  const int* s_row;  // B7: rpc rows
  float* s_score;    // rpc x wc scores
  unsigned char* region;
};

// A model runs in the frame through two calls: stage(), which copies what
// chunk [j0, j0 + wcc) of the slab needs into the region for the CTA's
// first n_live lanes (B4: for all of them), and score(), which writes the
// scores of every (live row, model) pair of the chunk to s_score[r * wc +
// jj].  Every thread of the CTA calls both.

// Oblivious trees of any depth: one thread per (row, tree) pair.  The
// region holds the chunk's feature ids and thresholds
// level-major (entry e = jj, or r * wc + jj for B7: the threads of a warp
// read consecutive words) and, for B4, its dequantised leaf tables.
struct TreeModel {
  static constexpr int kCluster = kTreeCluster;
  static constexpr int kTeam = 1;  // threads a pair
  static constexpr int kPairs = 1;
  static int words_per_model(int depth, int rpc, bool lanes) {
    return lanes ? rpc * 2 * depth : 2 * depth + (1 << depth);
  }

  // B4's staged words a chunk (its leaf tables; the ids and thresholds, no
  // more of them, ride beside), for which the launch brings threads enough
  // to stage in one round of kStageLoads loads a thread; B7 stages ids and
  // thresholds with the threads its pairs bring
  static int staged_words(int depth, int, int wc, bool lanes) {
    return lanes ? 0 : wc << depth;
  }

  // one round: each thread issues kStageLoads words' loads (an id and a
  // threshold, and for B4 a leaf) before it stores what they bring
  template <typename P, bool kLanes>
  __device__ static void stage(const StepArgs& a, const StepFrame& f, int j0,
                               int wcc, int n_live) {
    constexpr int L = kStageLoads;
    const int D = a.dims;
    const int n_ent = (kLanes ? a.rpc : 1) * a.wc;
    int* s_feats = reinterpret_cast<int*>(f.region);
    float* s_thrs = reinterpret_cast<float*>(s_feats + n_ent * D);
    float* s_leaves = s_thrs + n_ent * D;  // B4
    const size_t m0 = static_cast<size_t>(a.stage) * a.W + j0;  // B4
    const P* leaves = static_cast<const P*>(a.payload) + (m0 << D);
    const float scale = kLanes ? 0.0f : a.scales[a.stage];
    const int n_ft = (kLanes ? n_live : 1) * wcc * D;  // ids and thresholds
    const int n_lv = kLanes ? 0 : wcc << D;             // B4's leaves
    const int n = max(n_ft, n_lv);
    const int bd = blockDim.x;
    for (int k0 = f.tid; k0 < n; k0 += L * bd) {
      int fv[L], ev[L];
      float tv[L], lv[L];
#pragma unroll
      for (int u = 0; u < L; ++u) {
        const int k = k0 + u * bd;
        ev[u] = -1;
        fv[u] = 0;
        tv[u] = lv[u] = 0.0f;
        if (k < n_ft) {  // word k: model rj = (r, jj) at level lvl
          const int rj = k / D;
          const int lvl = k - rj * D;
          const int r = kLanes ? rj / wcc : 0;
          const int jj = rj - r * wcc;
          const size_t m =
              kLanes ? static_cast<size_t>(f.s_st[r]) * a.W + j0 + jj : m0 + jj;
          fv[u] = a.feats[m * D + lvl];
          tv[u] = a.thrs[m * D + lvl];
          ev[u] = lvl * n_ent + r * a.wc + jj;
        }
        if (k < n_lv) lv[u] = dequant(leaves[k], scale);
      }
#pragma unroll
      for (int u = 0; u < L; ++u) {
        const int k = k0 + u * bd;
        if (ev[u] >= 0) {
          s_feats[ev[u]] = fv[u];
          s_thrs[ev[u]] = tv[u];
        }
        if (k < n_lv) s_leaves[k] = lv[u];
      }
    }
  }

  template <typename P, bool kLanes>
  __device__ static void score(const StepArgs& a, const StepFrame& f, int j0,
                               int wcc, int n_live) {
    constexpr int G = kTreeGroup;
    const int D = a.dims;
    const int n_ent = (kLanes ? a.rpc : 1) * a.wc;
    const int* s_feats = reinterpret_cast<const int*>(f.region);
    const float* s_thrs = reinterpret_cast<const float*>(s_feats + n_ent * D);
    const float* s_leaves = s_thrs + n_ent * D;  // B4
    const P* leaves = static_cast<const P*>(a.payload);
    const int n_tasks = n_live * wcc;
    for (int task = f.tid; task < n_tasks; task += blockDim.x) {
      const int r = task / wcc;
      const int jj = task - r * wcc;
      const int e = (kLanes ? r * a.wc : 0) + jj;
      const float* xr =
          a.x + static_cast<size_t>(kLanes ? f.s_row[r] : f.r0 + r) * a.d;
      int idx = 0;
      // levels in groups of G: a group's feature ids and thresholds, then
      // its feature values, are all in flight at once; the bits go into
      // the leaf index most significant first
      for (int k0 = 0; k0 < D; k0 += G) {
        int fid[G];
        float thr[G], xv[G];
#pragma unroll
        for (int k = 0; k < G; ++k) {
          const bool on = k0 + k < D;
          fid[k] = on ? s_feats[(k0 + k) * n_ent + e] : 0;
          thr[k] = on ? s_thrs[(k0 + k) * n_ent + e] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < G; ++k) xv[k] = k0 + k < D ? xr[fid[k]] : 0.0f;
#pragma unroll
        for (int k = 0; k < G; ++k) {
          if (k0 + k < D) idx = 2 * idx + (xv[k] > thr[k]);
        }
      }
      float v;
      if (kLanes) {
        const int st = f.s_st[r];
        const size_t m = static_cast<size_t>(st) * a.W + j0 + jj;
        v = dequant(leaves[(m << D) + idx], a.scales[st]);
      } else {
        v = s_leaves[(jj << D) + idx];
      }
      f.s_score[r * a.wc + jj] = v;
    }
  }
};

// Lattices of S inputs: a (row, lattice) pair is scored by a team of
// min(32, 2^S) lanes of one warp (lattice_interp_team), 4 pairs a team at
// once.  The region holds the chunk's feature ids ((r * wc + jj) * S + k;
// B4: jj * S + k) and, for B4, its dequantised vertex values.
template <int S>
struct LatticeModel {
  static constexpr int kCluster = kMaxCluster;
  static constexpr int kTeam = LatticeTeam<S>::L;
  static constexpr int kPairs = kTeamTasks;
  static int words_per_model(int, int rpc, bool lanes) {
    return lanes ? rpc * S : S + LatticeTeam<S>::V;
  }
  static int staged_words(int, int, int, bool) { return 0; }

  template <typename P, bool kLanes>
  __device__ static void stage(const StepArgs& a, const StepFrame& f, int j0,
                               int wcc, int n_live) {
    constexpr int V = LatticeTeam<S>::V;
    int* s_feats = reinterpret_cast<int*>(f.region);
    if (kLanes) {
      for (int k = f.tid; k < n_live * wcc * S; k += blockDim.x) {
        const int rj = k / S;
        const int r = rj / wcc;
        const int jj = rj - r * wcc;
        const size_t m = static_cast<size_t>(f.s_st[r]) * a.W + j0 + jj;
        s_feats[(r * a.wc + jj) * S + k - rj * S] = a.feats[m * S + k - rj * S];
      }
    } else {
      const size_t m0 = static_cast<size_t>(a.stage) * a.W + j0;
      for (int k = f.tid; k < wcc * S; k += blockDim.x) {
        s_feats[k] = a.feats[m0 * S + k];
      }
      const P* theta = static_cast<const P*>(a.payload);
      float* s_theta = reinterpret_cast<float*>(s_feats + a.wc * S);
      const float scale = a.scales[a.stage];
      for (int k = f.tid; k < wcc * V; k += blockDim.x) {
        s_theta[k] = dequant(theta[(m0 << S) + k], scale);
      }
    }
  }

  // every lane runs every round (the shuffles name the whole warp); a pair
  // past the last only computes
  template <typename P, bool kLanes>
  __device__ static void score(const StepArgs& a, const StepFrame& f, int j0,
                               int wcc, int n_live) {
    using Team = LatticeTeam<S>;
    constexpr int V = Team::V;
    constexpr int L = Team::L;
    constexpr int K = Team::K;
    const P* theta = static_cast<const P*>(a.payload);
    const int* s_feats = reinterpret_cast<const int*>(f.region);
    const float* s_theta = reinterpret_cast<const float*>(s_feats + a.wc * S);
    const int lane = f.tid & 31;
    const int t = lane & (L - 1);  // lane within its team
    const int src0 = lane - t;     // the team's first lane
    const int team = f.tid / L;
    const int n_teams = blockDim.x / L;
    const int n_tasks = n_live * wcc;
    const int per_round = n_teams * kTeamTasks;
    for (int base = 0; base < n_tasks; base += per_round) {
      float v[kTeamTasks][K];
      float xv[kTeamTasks];
      int slot[kTeamTasks];
#pragma unroll
      for (int u = 0; u < kTeamTasks; ++u) {
        const int task = base + u * n_teams + team;
        const bool ok = task < n_tasks;
        const int r = ok ? task / wcc : 0;
        const int jj = task - r * wcc;
        slot[u] = ok ? r * a.wc + jj : -1;
        xv[u] = 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) v[u][k] = 0.0f;
        if (!ok) continue;
        if (kLanes) {
          const int rs = f.s_st[r];
          const size_t m = static_cast<size_t>(rs) * a.W + j0 + jj;
          const float* xr = a.x + static_cast<size_t>(f.s_row[r]) * a.d;
          if (t < S) xv[u] = xr[s_feats[slot[u] * S + t]];
          const P* th = theta + (m << S) + t;
          const float scale = a.scales[rs];
#pragma unroll
          for (int k = 0; k < K; ++k) v[u][k] = dequant(th[k * L], scale);
        } else {
          const float* xr = a.x + static_cast<size_t>(f.r0 + r) * a.d;
          if (t < S) xv[u] = xr[s_feats[jj * S + t]];
          const float* th = s_theta + jj * V + t;
#pragma unroll
          for (int k = 0; k < K; ++k) v[u][k] = th[k * L];
        }
      }
#pragma unroll
      for (int u = 0; u < kTeamTasks; ++u) {
        float xs[S];
#pragma unroll
        for (int k = 0; k < S; ++k) {
          xs[k] = __shfl_sync(0xffffffffu, xv[u], src0 + k);
        }
        const float sc = lattice_interp_team<S>(v[u], xs);
        if (t == 0 && slot[u] >= 0) f.s_score[slot[u]] = sc;
      }
    }
  }
};

// The cluster barrier in two halves (PTX barrier.cluster): arrive early,
// wait where the barrier is needed, and do other work in between.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One CTA per (row block, cluster rank); rank q owns rows [q rpc, (q + 1)
// rpc) of the block.  Per chunk of wc models: stage, score, walk (the
// header's Design paragraph); then the block prefix across the cluster.
template <typename Model, typename P, bool kLanes>
__global__ void __launch_bounds__(kStepThreads, 1)
    step_kernel(const StepArgs a, const Outputs out) {
  const cg::cluster_group cluster = cg::this_cluster();
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int blk = blockIdx.x / n_ranks;
  const int block_start = blk * a.bn;
  const int r0 = block_start + rank * a.rpc;  // this CTA's first lane
  const int nr = max(0, min(a.rpc, a.bn - rank * a.rpc));
  const int tid = threadIdx.x;
  const int i = r0 + tid;
  const bool lane_ok = tid < nr && i < a.cap;

  extern __shared__ unsigned char smem[];
  const int n_eps = (kLanes ? a.rpc : 1) * a.wc;  // threshold entries
  int* s_warp = reinterpret_cast<int*>(smem);     // 32: the block scan
  int* s_cnt = s_warp + 32;                       // kMaxCluster: counts
  int* s_st = s_cnt + kMaxCluster;                // B7: rpc stages
  int* s_row = s_st + (kLanes ? a.rpc : 0);       // B7: rpc rows
  float* s_score = reinterpret_cast<float*>(s_row + (kLanes ? a.rpc : 0));
  float* s_ep = s_score + a.rpc * a.wc;
  float* s_en = s_ep + n_eps;
  const StepFrame f{tid, r0, s_st, s_row, s_score,
                    reinterpret_cast<unsigned char*>(s_en + n_eps)};

  // stage chunk [j0, j0 + wcc) for the CTA's first n_live rows (B7's first
  // chunk: every row it holds, before the live count is known): the
  // threshold rows here (a thread's first entry loaded before the model
  // stages its slab, so both are in flight at once), the slab in
  // Model::stage
  auto stage_chunk = [&](int j0, int wcc, int n_live) {
    const int n_e = (kLanes ? n_live : 1) * wcc;
    auto entry = [&](int k, size_t& m, int& e) {
      const int r = kLanes ? k / wcc : 0;
      const int jj = k - r * wcc;
      m = static_cast<size_t>(kLanes ? s_st[r] : a.stage) * a.W + j0 + jj;
      e = r * a.wc + jj;
    };
    float ep0 = 0.0f, en0 = 0.0f;
    int e0 = -1;
    if (tid < n_e) {
      size_t m;
      entry(tid, m, e0);
      ep0 = a.eps_pos[m];
      en0 = a.eps_neg[m];
    }
    Model::template stage<P, kLanes>(a, f, j0, wcc, n_live);
    if (e0 >= 0) {
      s_ep[e0] = ep0;
      s_en[e0] = en0;
    }
    for (int k = tid + blockDim.x; k < n_e; k += blockDim.x) {
      size_t m;
      int e;
      entry(k, m, e);
      s_ep[e] = a.eps_pos[m];
      s_en[e] = a.eps_neg[m];
    }
  };

  // the live count's load first (live_limit's, with its clamp left until
  // the count is used), then the loads that need none (g0, B7's stop
  // flags, rows and stages, the first chunk's slab), all in flight at once
  int nv_raw = a.n_valid_host;
  if (a.n_valid_dev) nv_raw = *a.n_valid_dev;
  const float g_in = lane_ok ? a.g0[i] : 0.0f;
  const bool stop = kLanes && lane_ok && a.stop[i];
  if (kLanes) {
    if (lane_ok) {
      s_st[tid] = min(max(a.stages[i], 0), a.n_stages - 1);
      s_row[tid] = static_cast<int>(
          min(max(a.rows[i], 0LL), static_cast<long long>(a.n_rows - 1)));
    }
    __syncthreads();
  }
  stage_chunk(0, min(a.wc, a.W), kLanes ? max(0, min(nr, a.cap - r0)) : 0);
  const int nv = min(nv_raw, a.cap);
  if (block_start >= nv) {  // the whole cluster agrees: inert outputs
    if (lane_ok) {
      out.g[i] = g_in;
      out.active[i] = 0;
      out.dec[i] = 0;
      out.exit_rel[i] = 0;
      out.pfx[i] = 0;
    }
    if (rank == 0 && tid == 0) out.cnt[blk] = 0;
    return;
  }
  cluster_arrive_relaxed();  // this CTA runs: its shared memory may be written
  const int n_live = max(0, min(nr, nv - r0));  // live lanes: a prefix
  float g = g_in;
  bool active = tid < n_live;
  bool dec = false;
  int ex = 0;

  for (int j0 = 0; j0 < a.W; j0 += a.wc) {
    const int wcc = min(a.wc, a.W - j0);
    if (j0 > 0) {
      __syncthreads();  // the last chunk's walk has read its thresholds
      stage_chunk(j0, wcc, n_live);
    }
    __syncthreads();
    Model::template score<P, kLanes>(a, f, j0, wcc, n_live);
    __syncthreads();
    if (lane_ok) {
      for (int jj = 0; jj < wcc; ++jj) {
        const int e = kLanes ? tid * a.wc + jj : jj;
        const float sc = active ? s_score[tid * a.wc + jj] : 0.0f;
        threshold_step(g, active, dec, ex, sc, active ? s_ep[e] : 0.0f,
                       active ? s_en[e] : 0.0f, j0 + jj + 1);
      }
    }
  }

  const bool keep = active && !stop;
  int total;
  const int incl = block_inclusive_scan(keep ? 1 : 0, s_warp, &total);
  cluster_wait();  // every CTA of the cluster runs
  if (tid < n_ranks) *cluster.map_shared_rank(s_cnt + rank, tid) = total;
  cluster.sync();  // the counts are in; no CTA reads another's memory after
  int off = 0, all = 0;
  for (int q = 0; q < n_ranks; ++q) {
    off += q < rank ? s_cnt[q] : 0;
    all += s_cnt[q];
  }
  if (lane_ok) {
    out.g[i] = g;
    out.active[i] = active ? 1 : 0;
    out.dec[i] = dec ? 1 : 0;
    out.exit_rel[i] = ex;
    out.pfx[i] = off + incl - 1;
  }
  if (rank == 0 && tid == 0) out.cnt[blk] = all;
}

// The cluster size, rows per CTA, models per chunk, threads and shared
// memory of one launch: a row block of bn rows over Model::kCluster CTAs
// (more where a CTA would own more than kStepThreads rows, fewer where the
// block has fewer rows), each chunk's threshold rows, scores and staged
// slab within 48 KB (more only where one model alone needs it), and
// threads enough to take a chunk's pairs in one round (Model::kPairs pairs
// a team of Model::kTeam threads) and to stage its slab in one round of
// kStageLoads loads a thread (B4 tree), at most kStepThreads, but at least
// one per row.
template <typename Model>
struct StepGeometry {
  int ranks, rpc, wc, threads;
  size_t smem;
  StepGeometry(int bn, int W, int dims, bool lanes) {
    ranks = min(bn, max(Model::kCluster, (bn + kStepThreads - 1) / kStepThreads));
    rpc = (bn + ranks - 1) / ranks;
    ranks = (bn + rpc - 1) / rpc;  // no CTA without rows
    const int fixed = 4 * (32 + kMaxCluster + (lanes ? 2 * rpc : 0));
    // a model's score column, threshold entries and slab
    const int per_model = 4 * (rpc + 2 * (lanes ? rpc : 1) +
                               Model::words_per_model(dims, rpc, lanes));
    const int budget = max(kStepSmem, fixed + per_model);
    wc = max(1, min(W, (budget - fixed) / per_model));
    const int units = (rpc * wc + Model::kPairs - 1) / Model::kPairs;
    const int stagers =
        (Model::staged_words(dims, rpc, wc, lanes) + kStageLoads - 1) / kStageLoads;
    threads = ((max(units * Model::kTeam, stagers) + 31) / 32) * 32;
    threads = min(max(threads, ((rpc + 31) / 32) * 32), kStepThreads);
    smem = static_cast<size_t>(fixed) + static_cast<size_t>(wc) * per_model;
  }
};

template <typename Model, typename P, bool kLanes>
int launch_step(StepArgs a, const Outputs& out, cudaStream_t stream) {
  const StepGeometry<Model> geo(a.bn, a.W, a.dims, kLanes);
  if (geo.smem > static_cast<size_t>(kMaxStepSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.rpc = geo.rpc;
  a.wc = geo.wc;
  const auto kernel = step_kernel<Model, P, kLanes>;
  if (geo.smem > static_cast<size_t>(kStepSmem)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(geo.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.cap + a.bn - 1) / a.bn) * geo.ranks);
  cfg.blockDim = dim3(geo.threads);
  cfg.dynamicSmemBytes = geo.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, out);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Dispatch on the payload code: 0 f32, 1 bf16, 2 int8.
template <typename Model, bool kLanes>
int launch_step_quant(int quant, const StepArgs& a, const Outputs& out,
                      cudaStream_t stream) {
  switch (quant) {
    case 0:
      return launch_step<Model, float, kLanes>(a, out, stream);
    case 1:
      return launch_step<Model, __nv_bfloat16, kLanes>(a, out, stream);
    case 2:
      return launch_step<Model, int8_t, kLanes>(a, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Trees of depth 0..kMaxStagedDepth (B4) or 0..kMaxLaneDepth (B7).
template <bool kLanes>
int launch_tree(int quant, const StepArgs& a, const Outputs& out,
                cudaStream_t stream) {
  if (a.dims < 0 || a.dims > (kLanes ? kMaxLaneDepth : kMaxStagedDepth)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_step_quant<TreeModel, kLanes>(quant, a, out, stream);
}

// Lattices: dispatch on S = a.dims (1..kMaxLatticeDims).
template <bool kLanes>
int launch_lattice(int quant, const StepArgs& a, const Outputs& out,
                   cudaStream_t stream) {
  switch (a.dims) {
#define LATTICE_CASE(S) \
  case S:               \
    return launch_step_quant<LatticeModel<S>, kLanes>(quant, a, out, stream);
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

// ---- B4 and B7 matrix: one thread per row, every load in flight ----------

// Columns a thread holds in registers at once (scores and threshold
// entries: 3 x 8 registers; 16 spill under the 64 registers a thread may
// hold at 1024 threads a CTA).  A stage of W <= kMatrixGroup columns (the
// served width, chunk_t 8) has all its loads issued before the first
// threshold_step; a wider one is walked in groups of this many.
constexpr int kMatrixGroup = 8;

// What the matrix variant of B4 and B7 reads.  x is the (n_rows, t_pad)
// prepared score matrix (P: float or __nv_bfloat16); lane i reads row
// rows[i], clamped into [0, n_rows), or row i where rows is null (B4's
// gathered form, n_rows = cap).  B4 (kLanes false): every lane at stage
// `stage`, its columns from t0.  B7 (kLanes true): lane i at stage
// stages[i] (clamped into [0, n_stages)), its columns from t0s[st], and a
// lane flagged stop[i] is left out of the prefix and the count.  widths
// (n_stages,) are the true stage widths (column j >= width scores 0.0),
// eps_pos/eps_neg the (n_stages, W) threshold tables.
struct MatrixArgs {
  const void* x;
  const long long* rows;
  int n_rows;
  int t_pad;
  int stage;
  int t0;
  const int* stages;
  const bool* stop;
  int n_stages;
  const int* t0s;
  const int* widths;
  const float* g0;
  const int* n_valid_dev;
  int n_valid_host;
  int cap;
  int W;
  int bn;
  const float* eps_pos;
  const float* eps_neg;
};

// Columns [j0, j0 + G) of a row's stage (those below W): its scores from
// xr at t0 + j and its threshold entries, as independent scalar loads,
// unconditionally.  A stage's columns start at any word (t0 = 1 + 8k at
// exp1), so no vector load.  The column is clamped into the row, which the
// wrappers' checks make a no-op for every column walked.
template <typename P, int G>
__device__ __forceinline__ void load_columns(
    const P* xr, int t0, int t_pad, const float* ep_row, const float* en_row,
    int j0, int W, float (&sc)[G], float (&ep)[G], float (&en)[G]) {
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int j = j0 + k;
    const bool on = j < W;
    sc[k] = on ? dequant(xr[min(t0 + j, t_pad - 1)], 1.0f) : 0.0f;
    ep[k] = on ? ep_row[j] : 0.0f;
    en[k] = on ? en_row[j] : 0.0f;
  }
}

// One CTA of whole warps per row block of bn rows, one thread per row.  The
// loads form two dependent levels for B4 (the row id, then its scores) and
// three for B7 (the stage, then its start, width and threshold row, then
// the scores); a row's scores are loaded unconditionally, so an inactive
// row's are loaded and ignored (a load and a bf16 widen are exact: the walk
// sees the plain version's bits).
template <typename P, bool kLanes>
__global__ void __launch_bounds__(1024)
    matrix_step_kernel(const MatrixArgs a, const Outputs out) {
  constexpr int G = kMatrixGroup;
  __shared__ int s_warp[32];
  const int block_start = blockIdx.x * a.bn;
  const int i = block_start + threadIdx.x;
  const bool lane_ok = threadIdx.x < a.bn && i < a.cap;

  // the live count's load first (its clamp left until the count is used),
  // then g0, the row id and B7's stage and stop flag, all in flight at once
  int nv_raw = a.n_valid_host;
  if (a.n_valid_dev) nv_raw = *a.n_valid_dev;
  const float g_in = lane_ok ? a.g0[i] : 0.0f;
  const bool stop = kLanes && lane_ok && a.stop[i];
  long long r = lane_ok ? (a.rows ? a.rows[i] : i) : 0;
  const int st =
      kLanes ? (lane_ok ? min(max(a.stages[i], 0), a.n_stages - 1) : 0)
             : a.stage;
  const int t0 = kLanes ? a.t0s[st] : a.t0;
  const int width = a.widths[st];
  const float* ep_row = a.eps_pos + static_cast<size_t>(st) * a.W;
  const float* en_row = a.eps_neg + static_cast<size_t>(st) * a.W;
  r = min(max(r, 0LL), static_cast<long long>(a.n_rows - 1));
  const P* xr = static_cast<const P*>(a.x) + r * a.t_pad;

  float sc[G], ep[G], en[G];
  load_columns(xr, t0, a.t_pad, ep_row, en_row, 0, a.W, sc, ep, en);

  const int nv = min(nv_raw, a.cap);
  if (block_start >= nv) {  // inert outputs
    if (lane_ok) {
      out.g[i] = g_in;
      out.active[i] = 0;
      out.dec[i] = 0;
      out.exit_rel[i] = 0;
      out.pfx[i] = 0;
    }
    if (threadIdx.x == 0) out.cnt[blockIdx.x] = 0;
    return;
  }
  float g = g_in;
  bool active = lane_ok && i < nv;
  bool dec = false;
  int ex = 0;
  for (int j0 = 0; j0 < a.W; j0 += G) {
    if (j0 > 0) {
      load_columns(xr, t0, a.t_pad, ep_row, en_row, j0, a.W, sc, ep, en);
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int j = j0 + k;
      if (j < a.W) {
        threshold_step(g, active, dec, ex, j < width ? sc[k] : 0.0f, ep[k],
                       en[k], j + 1);
      }
    }
  }

  int total;
  const int incl = block_flag_scan(active && !stop, s_warp, &total);
  if (lane_ok) {
    out.g[i] = g;
    out.active[i] = active ? 1 : 0;
    out.dec[i] = dec ? 1 : 0;
    out.exit_rel[i] = ex;
    out.pfx[i] = incl - 1;
  }
  if (threadIdx.x == 0) out.cnt[blockIdx.x] = total;
}

// Dispatch on the operand's quant code: 0 f32, 1 bf16.
template <bool kLanes>
int launch_matrix(int quant, const MatrixArgs& a, const Outputs& out,
                  cudaStream_t stream) {
  const int threads = ((a.bn + 31) / 32) * 32;  // whole warps for the scan
  const int blocks = (a.cap + a.bn - 1) / a.bn;
  switch (quant) {
    case 0:
      matrix_step_kernel<float, kLanes><<<blocks, threads, 0, stream>>>(a, out);
      break;
    case 1:
      matrix_step_kernel<__nv_bfloat16, kLanes>
          <<<blocks, threads, 0, stream>>>(a, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// StepArgs of one launch; B4 passes no rows, stages or stop flags (lane i
// reads row i at `stage`), B7 no `stage`.
StepArgs step_args(const float* x, const long long* rows, int n_rows,
                   int stage, const int* stages, const bool* stop,
                   int n_stages, const float* g0, const int* n_valid_dev,
                   int n_valid_host, int cap, int d, int W, int bn, int dims,
                   const void* feats, const void* thrs, const void* payload,
                   const float* scales, const float* eps_pos,
                   const float* eps_neg) {
  StepArgs a{};
  a.x = x;
  a.rows = rows;
  a.n_rows = n_rows;
  a.stage = stage;
  a.stages = stages;
  a.stop = stop;
  a.n_stages = n_stages;
  a.g0 = g0;
  a.n_valid_dev = n_valid_dev;
  a.n_valid_host = n_valid_host;
  a.cap = cap;
  a.d = d;
  a.W = W;
  a.bn = bn;
  a.dims = dims;
  a.feats = static_cast<const int*>(feats);
  a.thrs = static_cast<const float*>(thrs);
  a.payload = payload;
  a.scales = scales;
  a.eps_pos = eps_pos;
  a.eps_neg = eps_neg;
  return a;
}

}  // namespace

// `quant` is the payload's storage code: 0 f32, 1 bf16, 2 int8 (the matrix
// variant: the operand's, f32 or bf16).  `scales` are the (n_stages,) f32
// per-stage scales (read for int8 only).  Every launcher returns
// cudaErrorInvalidValue for a code it does not take, and the tree launcher
// for a depth outside [0, kMaxStagedDepth].
extern "C" int mega_stage_tree_launch(
    const float* x, const float* g0, int stage, const int* n_valid_dev,
    int n_valid_host, int cap, int d, int W, int depth, int bn, int quant,
    const int* feats, const float* thrs, const void* leaves,
    const float* scales, const float* eps_pos, const float* eps_neg,
    float* g_out, int* act_out, int* dec_out, int* ex_out, int* pfx_out,
    int* cnt_out, cudaStream_t stream) {
  const StepArgs a =
      step_args(x, nullptr, cap, stage, nullptr, nullptr, 0, g0, n_valid_dev,
                n_valid_host, cap, d, W, bn, depth, feats, thrs, leaves,
                scales, eps_pos, eps_neg);
  const Outputs out{g_out, act_out, dec_out, ex_out, pfx_out, cnt_out};
  return launch_tree<false>(quant, a, out, stream);
}

// `rows` (cap,) the row of x (n_rows x t_pad) each lane reads, or null:
// x is already gathered (n_rows = cap) and lane i reads row i.
extern "C" int mega_stage_matrix_launch(
    const void* x, const long long* rows, int n_rows, const float* g0,
    int stage, int t0, const int* n_valid_dev, int n_valid_host, int cap,
    int t_pad, int W, int bn, int quant, const int* widths,
    const float* eps_pos, const float* eps_neg, float* g_out, int* act_out,
    int* dec_out, int* ex_out, int* pfx_out, int* cnt_out,
    cudaStream_t stream) {
  const MatrixArgs a{x,       rows,   n_rows, t_pad,       stage,
                     t0,      nullptr, nullptr, 0,          nullptr,
                     widths,  g0,     n_valid_dev, n_valid_host, cap,
                     W,       bn,     eps_pos, eps_neg};
  const Outputs out{g_out, act_out, dec_out, ex_out, pfx_out, cnt_out};
  return launch_matrix<false>(quant, a, out, stream);
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
  const StepArgs a =
      step_args(x, nullptr, cap, stage, nullptr, nullptr, 0, g0, n_valid_dev,
                n_valid_host, cap, d, W, bn, s, feats, nullptr, theta, scales,
                eps_pos, eps_neg);
  const Outputs out{g_out, act_out, dec_out, ex_out, pfx_out, cnt_out};
  return launch_lattice<false>(quant, a, out, stream);
}

// B7 entry points, one argument layout for the three variants: `aux` is the
// tree depth (tree), the lattices' input count S (lattice) or unused
// (matrix); p0/p1/p2 are the stage-stacked slabs: feats/thrs/leaves (tree),
// t0s/widths/- (matrix), feats/theta/- (lattice); `quant` and `scales` as
// for B4.  Returns cudaErrorInvalidValue for a tree depth outside [0,
// kMaxLaneDepth], a lattice S outside [1, kMaxLatticeDims] or a quant code
// the variant does not take.
#define LANE_ARGS                                                            \
  const void *x, const long long *rows, int n_rows, const float *g0,         \
      const int *stage, const bool *stop, const int *n_valid_dev,            \
      int n_valid_host, int cap, int d, int W, int n_stages, int bn, int aux, \
      int quant, const void *p0, const void *p1, const void *p2,             \
      const float *scales, const float *eps_pos, const float *eps_neg,       \
      float *g_out, int *act_out, int *dec_out, int *ex_out, int *pfx_out,   \
      int *cnt_out, cudaStream_t stream
#define LANE_CALL                                                          \
  (x, rows, n_rows, g0, stage, stop, n_valid_dev, n_valid_host, cap, d, W, \
   n_stages, bn, aux, quant, p0, p1, p2, scales, eps_pos, eps_neg, g_out,  \
   act_out, dec_out, ex_out, pfx_out, cnt_out, stream)

namespace {

// The StepArgs of a tree (p0/p1/p2: feats/thrs/leaves) or lattice
// (feats/theta/-) B7 launch.
template <bool kTree>
int lane_step(LANE_ARGS) {
  const StepArgs a = step_args(
      static_cast<const float*>(x), rows, n_rows, 0, stage, stop, n_stages, g0,
      n_valid_dev, n_valid_host, cap, d, W, bn, aux, p0, kTree ? p1 : nullptr,
      kTree ? p2 : p1, scales, eps_pos, eps_neg);
  const Outputs out{g_out, act_out, dec_out, ex_out, pfx_out, cnt_out};
  return kTree ? launch_tree<true>(quant, a, out, stream)
               : launch_lattice<true>(quant, a, out, stream);
}

}  // namespace

extern "C" int mega_lane_tree_launch(LANE_ARGS) {
  return lane_step<true> LANE_CALL;
}

// p0/p1: t0s/widths; `d` is the operand's row length t_pad.
extern "C" int mega_lane_matrix_launch(LANE_ARGS) {
  (void)aux;
  (void)p2;
  (void)scales;
  const MatrixArgs a{x,     rows,     n_rows,   d,
                     0,     0,        stage,    stop,
                     n_stages, static_cast<const int*>(p0),
                     static_cast<const int*>(p1), g0, n_valid_dev,
                     n_valid_host, cap, W, bn, eps_pos, eps_neg};
  const Outputs out{g_out, act_out, dec_out, ex_out, pfx_out, cnt_out};
  return launch_matrix<true>(quant, a, out, stream);
}

extern "C" int mega_lane_lattice_launch(LANE_ARGS) {
  return lane_step<false> LANE_CALL;
}
#undef LANE_CALL
#undef LANE_ARGS
