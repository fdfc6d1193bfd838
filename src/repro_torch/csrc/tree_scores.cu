// B3: oblivious-forest scores for trees [t0, t1) of a stacked forest.
//
// Replaces repro/kernels/tree_kernel.py gbt_scores_pallas (its pallas_call
// at :108).  For output (i, t): `depth` compares x[r, feat] > thr build an
// MSB-first leaf index, then the leaf value is read by that index.  r is
// rows[i] when a row gather is given (clamped into range, as jnp.take
// clamps), else i.  Row blocks of `block_n` rows starting at or past n_valid
// emit 0 without touching x: the survivor buffer is front-packed, so work
// tracks the live count at a fixed shape.
//
// What bounds it on an H100: bytes.  Each output costs `depth` compares and
// one table read, about 15 integer and compare operations against 4 bytes
// written; at the calibration shape (8000 x 500) the 16 MB of scores
// written set the floor, at the serving shape (256 x 8) the launch does.
//
// Design: one thread per (row, tree).  A CTA covers 8 rows x 32 trees;
// threadIdx.x walks trees, so a warp writes 32 neighbouring scores of one
// row.  The CTA's 32 trees' feature ids, thresholds and leaf tables are
// staged in shared memory once and read by every row.  The TPU kernel
// turned the leaf lookup into a one-hot x table matmul for its matrix unit;
// that product selects one leaf exactly, so an indexed read gives the same
// bits.
#include "common.cuh"

constexpr int kTrees = 32;  // trees per CTA (threadIdx.x)
constexpr int kRows = 8;    // rows per CTA (threadIdx.y)

__global__ void gbt_scores_kernel(const int* __restrict__ feats,
                                  const float* __restrict__ thrs,
                                  const float* __restrict__ leaves,
                                  const float* __restrict__ x,
                                  const long long* __restrict__ rows,
                                  long long n_x, const int* n_valid_dev,
                                  int n_valid_host, int n, int d, int tk,
                                  int depth, int block_n,
                                  float* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  const int n_leaves = 1 << depth;
  int* s_feats = reinterpret_cast<int*>(smem);
  float* s_thrs = reinterpret_cast<float*>(s_feats + kTrees * depth);
  float* s_leaves = s_thrs + kTrees * depth;

  const int tree0 = blockIdx.y * kTrees;
  const int n_trees = min(kTrees, tk - tree0);
  const int tid = threadIdx.y * kTrees + threadIdx.x;
  for (int k = tid; k < n_trees * depth; k += kTrees * kRows) {
    s_feats[k] = feats[tree0 * depth + k];
    s_thrs[k] = thrs[tree0 * depth + k];
  }
  for (int k = tid; k < n_trees * n_leaves; k += kTrees * kRows) {
    s_leaves[k] = leaves[static_cast<size_t>(tree0) * n_leaves + k];
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int i = blockIdx.x * kRows + threadIdx.y;
  if (t >= n_trees || i >= n) return;
  const int nv = n_valid_dev ? *n_valid_dev : n_valid_host;
  float v = 0.0f;
  if ((i / block_n) * block_n < nv) {
    long long r = rows ? rows[i] : i;
    r = r < 0 ? 0 : (r >= n_x ? n_x - 1 : r);
    const float* xr = x + r * d;
    int idx = 0;
    for (int k = 0; k < depth; ++k) {
      const int f = s_feats[t * depth + k];
      idx = 2 * idx + (xr[f] > s_thrs[t * depth + k] ? 1 : 0);
    }
    v = s_leaves[t * n_leaves + idx];
  }
  out[static_cast<size_t>(i) * tk + tree0 + t] = v;
}

extern "C" int gbt_scores_launch(const int* feats, const float* thrs,
                                 const float* leaves, const float* x,
                                 const long long* rows, long long n_x,
                                 const int* n_valid_dev, int n_valid_host,
                                 int n, int d, int tk, int depth, int block_n,
                                 float* out, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, (tk + kTrees - 1) / kTrees);
  const dim3 block(kTrees, kRows);
  const size_t smem =
      static_cast<size_t>(kTrees) * (2 * depth + (1 << depth)) * 4;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(gbt_scores_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  gbt_scores_kernel<<<grid, block, smem, stream>>>(
      feats, thrs, leaves, x, rows, n_x, n_valid_dev, n_valid_host, n, d, tk,
      depth, block_n, out);
  return static_cast<int>(cudaGetLastError());
}
