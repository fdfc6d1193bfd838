// B3: oblivious-forest scores for trees [t0, t1) of a stacked forest.
//
// Replaces repro/kernels/tree_kernel.py gbt_scores_pallas (its pallas_call
// at :108).  For output (i, t): `depth` compares x[r, feat] > thr build an
// MSB-first leaf index, then the leaf value is read by that index.  r is
// rows[i] when a row gather is given (clamped into range, as jnp.take
// clamps), else i.  Row blocks of `block_n` rows starting at or past n_valid
// emit 0 without touching x: the survivor buffer is front-packed, so work
// tracks the live count at a fixed shape.  Every feature id must lie in
// [0, d): the wrapper's callers check the width once (tree_stage_scorer).
//
// What bounds it on an H100: bytes.  Each output costs `depth` compares and
// one table read, about 15 integer and compare operations against 4 bytes
// written; at the calibration shape (8000 x 500) the 16 MB of scores
// written set the floor (4.9 us), at the serving shapes (256 x 8 a stage,
// 256 x 1 the sort key) the launch and a chain of three dependent reads do.
//
// Design: one thread per output, trees fastest.  A CTA owns a tile of
// `tile` trees (tk split into near-equal tiles of at most 32) and a run of
// `rp * passes` rows; its tile * rp threads map to (row, tree) pairs with
// the tree fastest, so a thread keeps one tree for every row it scores,
// and a pass writes tile * rp neighbouring scores (all of a row block's
// when the tile is all of [t0, t1)): no lane idles at tk 1 or 8.  The
// launch geometry is a pure function of the shapes and the card on the
// host (tree_kernel.tree_geometry): each tile's passes are spread over as
// many CTAs as one wave of the card holds (the occupancy API's count), so
// at the calibration shape a CTA stages its tile once for 31 passes and
// none waits for a second wave; a serving shape takes one pass a CTA.
// The CTA stages its
// tile's ids and thresholds (level-major, so a warp's reads hit distinct
// banks) and, while they fit 48 KB, its leaf tables (each padded by one
// word, so trees that take the same leaf index read distinct banks) in
// shared memory in one round of coalesced loads, each thread's loads
// issued before it stores them; the live count and the first row id are
// loaded before that, and each pass loads the next pass's row id.  Deeper
// leaf tables are read in place through the read-only path (an int leaf
// index, depths up to 30).  What a row costs is instructions: a depth of
// 1 to 8 is a template parameter, so a thread holds its tree's ids and
// thresholds in registers and a row is its D feature loads, compares and
// one leaf read, with no predicate or loop; a deeper tree reads its ids
// and thresholds from shared memory kGroup levels at a time, their
// feature values in flight together (mega_stage.cu's TreeModel unrolls
// its levels the same way).  The live test is one compare against the
// end of the last live row block.  The TPU kernel turned the leaf lookup
// into a one-hot x table matmul for its matrix unit; that product selects
// one leaf exactly, so an indexed read gives the same bits.
#include "common.cuh"

namespace {

// What a launch reads; tile, rp and passes come from the host's geometry
// (blockDim.x == tile * rp, gridDim.y tiles, gridDim.x row runs).
struct TreeArgs {
  const int* feats;      // (tk, depth) of trees [t0, t1)
  const float* thrs;     // (tk, depth)
  const float* leaves;   // (tk, 2^depth)
  const float* x;        // (n_x, d)
  const long long* rows; // (n,) or null
  long long n_x;
  const int* n_valid_dev;
  int n_valid_host;
  int n;
  int d;
  int tk;
  int depth;
  int block_n;
  int tile;    // trees a CTA
  int rp;      // rows a pass
  int passes;  // passes a CTA
  float* out;  // (n, tk)
};

constexpr int kStageLoads = 4;  // loads a staging thread keeps in flight
constexpr int kGroup = 8;       // levels whose loads are issued together
constexpr int kMaxFixedDepth = 8;  // depths with a kernel of their own

// kD in [1, kMaxFixedDepth]: trees of exactly that depth, ids and
// thresholds in registers; kD == 0: any depth, read from shared memory.
template <int kD, bool kStaged>
__global__ void __launch_bounds__(256) gbt_scores_kernel(const TreeArgs a) {
  static_assert(kD >= 0 && kD <= kMaxFixedDepth, "fixed tree depth");
  extern __shared__ unsigned char smem[];
  const int D = kD > 0 ? kD : a.depth;
  int* s_feats = reinterpret_cast<int*>(smem);  // [D][tile]
  float* s_thrs = reinterpret_cast<float*>(s_feats + D * a.tile);
  float* s_leaves = s_thrs + D * a.tile;  // kStaged: [tile][2^D + 1]
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int jj = tid % a.tile;
  const int tree0 = blockIdx.y * a.tile;
  const int ntt = min(a.tile, a.tk - tree0);
  const bool on = jj < ntt;
  const int run = a.rp * a.passes;
  const int i0 = blockIdx.x * run + tid / a.tile;
  const int row_end = min(a.n, (blockIdx.x + 1) * run);

  // the live count and the first row's id, then the tile's parameters:
  // all in flight before anything waits on them
  int nv = a.n_valid_host;
  if (a.n_valid_dev) nv = *a.n_valid_dev;
  long long r = a.rows && i0 < row_end ? a.rows[i0] : i0;
  const int n_ft = ntt * D;                 // ids (and thresholds), word jj D + lvl
  const int n_lv = kStaged ? ntt << D : 0;  // leaves
  const int n_st = max(n_ft, n_lv);
  const int* feats = a.feats + tree0 * D;
  const float* thrs = a.thrs + tree0 * D;
  const float* leaves = a.leaves + (static_cast<size_t>(tree0) << D);
  for (int k0 = tid; k0 < n_st; k0 += kStageLoads * bd) {
    int fv[kStageLoads];
    float tv[kStageLoads], lv[kStageLoads];
#pragma unroll
    for (int q = 0; q < kStageLoads; ++q) {
      const int k = k0 + q * bd;
      fv[q] = k < n_ft ? feats[k] : 0;
      tv[q] = k < n_ft ? thrs[k] : 0.0f;
      lv[q] = k < n_lv ? leaves[k] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kStageLoads; ++q) {
      const int k = k0 + q * bd;
      if (k < n_ft) {
        const int t = k / D;
        const int e = (k - t * D) * a.tile + t;
        s_feats[e] = fv[q];
        s_thrs[e] = tv[q];
      }
      if (k < n_lv) s_leaves[k + (k >> D)] = lv[q];
    }
  }
  // rows below live_end are live: their block starts below the live count
  const int live_blocks = nv <= 0 ? 0 : (nv - 1) / a.block_n + 1;
  const int live_end =
      live_blocks > (row_end - 1) / a.block_n ? row_end : live_blocks * a.block_n;
  __syncthreads();

  constexpr int kR = kD > 0 ? kD : 1;
  int fid[kR];
  float thr[kR];
#pragma unroll
  for (int k = 0; k < kD; ++k) {
    fid[k] = s_feats[k * a.tile + jj];
    thr[k] = s_thrs[k * a.tile + jj];
  }
  const int tree = tree0 + (on ? jj : 0);
  const float* table = kStaged ? s_leaves + jj * ((1 << D) + 1)
                               : a.leaves + (static_cast<size_t>(tree) << D);
  for (int p = 0; p < a.passes; ++p) {
    const int i = i0 + p * a.rp;
    if (i >= row_end) break;
    const long long r_next = a.rows && i + a.rp < row_end ? a.rows[i + a.rp] : i + a.rp;
    if (on) {
      float v = 0.0f;
      if (i < live_end) {
        const long long rc = !a.rows ? r : (r < 0 ? 0 : (r >= a.n_x ? a.n_x - 1 : r));
        const float* xr = a.x + rc * a.d;
        int idx = 0;
        if constexpr (kD > 0) {
          float xv[kR];
#pragma unroll
          for (int k = 0; k < kD; ++k) xv[k] = __ldg(xr + fid[k]);
#pragma unroll
          for (int k = 0; k < kD; ++k) idx = 2 * idx + (xv[k] > thr[k] ? 1 : 0);
        } else {
          for (int k0 = 0; k0 < D; k0 += kGroup) {
            int gf[kGroup];
            float gt[kGroup], gx[kGroup];
#pragma unroll
            for (int k = 0; k < kGroup; ++k) {
              const bool lvl = k0 + k < D;
              gf[k] = lvl ? s_feats[(k0 + k) * a.tile + jj] : 0;
              gt[k] = lvl ? s_thrs[(k0 + k) * a.tile + jj] : 0.0f;
            }
#pragma unroll
            for (int k = 0; k < kGroup; ++k) gx[k] = k0 + k < D ? __ldg(xr + gf[k]) : 0.0f;
#pragma unroll
            for (int k = 0; k < kGroup; ++k) {
              if (k0 + k < D) idx = 2 * idx + (gx[k] > gt[k] ? 1 : 0);
            }
          }
        }
        v = kStaged ? table[idx] : __ldg(table + idx);
      }
      a.out[static_cast<size_t>(i) * a.tk + tree] = v;
    }
    r = r_next;
  }
}

using Kernel = void (*)(TreeArgs);

// the instantiation for a depth and staging: a kernel of its own for a
// staged depth of 1 to kMaxFixedDepth, else the any-depth one
Kernel pick(int depth, bool staged) {
  if (!staged) return gbt_scores_kernel<0, false>;
  switch (depth) {
    case 1: return gbt_scores_kernel<1, true>;
    case 2: return gbt_scores_kernel<2, true>;
    case 3: return gbt_scores_kernel<3, true>;
    case 4: return gbt_scores_kernel<4, true>;
    case 5: return gbt_scores_kernel<5, true>;
    case 6: return gbt_scores_kernel<6, true>;
    case 7: return gbt_scores_kernel<7, true>;
    case 8: return gbt_scores_kernel<8, true>;
    default: return gbt_scores_kernel<0, true>;
  }
}

}  // namespace

// CTAs of `threads` threads and `smem` bytes an SM holds at once for the
// kernel pick(depth, staged) (tree_geometry's input).
extern "C" int gbt_scores_resident(int depth, int staged, int threads, int smem,
                                   int* ctas) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, pick(depth, staged != 0), threads, smem));
}

// `feats`, `thrs` and `leaves` point at tree t0 of the (T, depth) and
// (T, 2^depth) stacks.  tile, rp, passes, grid_x, grid_y, staged and smem
// (the tile's ids and thresholds, and its leaf tables when staged) are
// tree_geometry's.
extern "C" int gbt_scores_launch(const int* feats, const float* thrs,
                                 const float* leaves, const float* x,
                                 const long long* rows, long long n_x,
                                 const int* n_valid_dev, int n_valid_host,
                                 int n, int d, int tk, int depth, int block_n,
                                 int tile, int rp, int passes, int grid_x,
                                 int grid_y, int staged, int smem, float* out,
                                 cudaStream_t stream) {
  const TreeArgs a{feats, thrs,  leaves, x,       rows, n_x,
                   n_valid_dev,  n_valid_host,    n,    d,
                   tk,   depth,  block_n, tile,   rp,   passes, out};
  pick(depth, staged != 0)<<<dim3(grid_x, grid_y), tile * rp, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
