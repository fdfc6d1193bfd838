// B5: multilinear lattice scores for lattices [t0, t1) of a stacked ensemble.
//
// Replaces repro/kernels/lattice_kernel.py lattice_scores_pallas (its
// pallas_call at :103).  For output (i, t): gather the S inputs
// x[r, feats[t, j]] and interpolate lattice t's 2^S vertex values at them
// (lattice.cuh).  r is rows[i] when a row gather is given (clamped into
// range, as jnp.take clamps), else i.  Row blocks of `block_n` rows starting
// at or past n_valid emit 0 without touching x: the survivor buffer is
// front-packed, so work tracks the live count at a fixed shape.
//
// What bounds it on an H100: operations.  An output costs 3 (2^S - 1) f32
// operations against 4 bytes written and S floats gathered; at the
// calibration shape (8000 rows x 500 lattices, S = 8) that is 3.1 GFLOP
// against about 17 MB, 46 us at the card's published 67 TFLOP/s of f32 on
// CUDA cores (an FMA counted as two) and 5 us at its 3.35 TB/s.  Built with
// -fmad=false for bit parity, every halving is two rounded multiplies and
// a rounded add, none an FMA: the FP32 pipe's 132 x 128 operations a clock
// put the real floor near 91 us at 1.98 GHz.  At the serving shapes (256
// rows x 8 lattices a stage, x 1 the sort key) the launch is the cost.
//
// Design: two regimes, chosen on the host by the (row, lattice) pairs
// against the card's SMs (lattice_kernel.lattice_regime, a pure function of
// the shapes).
// - Team (serving shapes: a team's threads for every pair fit one wave of
//   the card): a pair is scored by a team of min(32, 2^S) lanes of one warp
//   (lattice_interp_team, the form of B4 lattice in mega_stage.cu), pairs
//   numbered lattice fastest, so the team leaders of a CTA write
//   neighbouring scores.  Lane t reads vertex values t, t + 32, ... in place
//   (coalesced), the S team lanes t < S gather one input each, and the
//   inputs go to every lane by shuffles.  The live count, the row id, the
//   feature ids and the vertex values are all loaded before anything waits
//   on them.  CTAs are sized so the launch spreads over the SMs.
// - Thread (the calibration and eager matrices): a CTA covers 32 rows x 8
//   lattices, each warp one lattice and its lanes 32 rows, one thread a
//   pair (lattice_interp): every theta read from shared memory is a
//   broadcast, the 2^(S-1) partial values live in registers, and the
//   8 lattices' vertex values (8 KB at S = 8) and feature ids are staged
//   once per CTA.  The results go through a 32 x 8 tile in shared memory,
//   so each row's 8 neighbouring scores are written as one 32-byte sector.
//   One thread a pair does the fewest operations, which is what the FP32
//   pipe bounds at these shapes; a team spends a shuffle and three
//   operations on every lane at each of its last five halvings.
// Both run the halvings in the dimension order with the operands of the
// plain version, so the scores are bit-identical to it.  The TPU kernel's
// corner-weight matrix and matmul are not used.
#include "common.cuh"
#include "lattice.cuh"

namespace {

constexpr int kRows = 32;     // thread regime: rows per CTA (threadIdx.x)
constexpr int kLattices = 8;  // thread regime: lattices per CTA (threadIdx.y)

// Team regime: blockDim.x / L pairs a CTA, pair p = blockIdx.x * (blockDim.x
// / L) + threadIdx.x / L is (row p / tk, lattice p % tk).  Every lane of a
// warp runs the interpolation (its shuffles name the whole warp); a pair
// past the last only computes.
template <int S>
__global__ void lattice_scores_team_kernel(
    const float* __restrict__ theta, const int* __restrict__ feats,
    const float* __restrict__ x, const long long* __restrict__ rows,
    long long n_x, const int* n_valid_dev, int n_valid_host, int n, int d,
    int tk, int block_n, float* __restrict__ out) {
  using Team = LatticeTeam<S>;
  constexpr int L = Team::L;
  constexpr int K = Team::K;
  int nv = n_valid_host;
  if (n_valid_dev) nv = *n_valid_dev;
  const int lane = threadIdx.x & 31;
  const int t = lane & (L - 1);  // lane within its team
  // n * tk fits an int here: the team form's threads fit one wave
  const int pair = blockIdx.x * (blockDim.x / L) + threadIdx.x / L;
  const bool ok = pair < n * tk;
  const int i = ok ? pair / tk : 0;
  const int lat = ok ? pair - i * tk : 0;
  long long r = i;
  if (ok && rows) r = rows[i];
  const int f = ok && t < S ? feats[lat * S + t] : 0;
  float v[K];
  const float* th = theta + (static_cast<size_t>(lat) << S) + t;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = ok ? __ldg(th + k * L) : 0.0f;
  const bool live = ok && (i / block_n) * block_n < nv;
  float xv = 0.0f;
  if (live && t < S) {
    r = r < 0 ? 0 : (r >= n_x ? n_x - 1 : r);
    xv = x[r * d + f];
  }
  float xs[S];
#pragma unroll
  for (int k = 0; k < S; ++k) xs[k] = __shfl_sync(0xffffffffu, xv, lane - t + k);
  const float sc = lattice_interp_team<S>(v, xs);
  if (ok && t == 0) out[pair] = live ? sc : 0.0f;
}

// Thread regime: one thread a (row, lattice) pair.
template <int S>
__global__ void lattice_scores_kernel(const float* __restrict__ theta,
                                      const int* __restrict__ feats,
                                      const float* __restrict__ x,
                                      const long long* __restrict__ rows,
                                      long long n_x, const int* n_valid_dev,
                                      int n_valid_host, int n, int d, int tk,
                                      int block_n, float* __restrict__ out) {
  constexpr int P = 1 << S;
  __shared__ float s_theta[kLattices * P];
  __shared__ int s_feats[kLattices * S];
  __shared__ float s_out[kRows][kLattices + 1];

  const int lat0 = blockIdx.y * kLattices;
  const int n_lat = min(kLattices, tk - lat0);
  const int tid = threadIdx.y * kRows + threadIdx.x;
  for (int k = tid; k < n_lat * P; k += kRows * kLattices) {
    s_theta[k] = theta[static_cast<size_t>(lat0) * P + k];
  }
  for (int k = tid; k < n_lat * S; k += kRows * kLattices) {
    s_feats[k] = feats[lat0 * S + k];
  }
  __syncthreads();

  const int row0 = blockIdx.x * kRows;
  const int i = row0 + threadIdx.x;
  const int t = threadIdx.y;
  const int nv = n_valid_dev ? *n_valid_dev : n_valid_host;
  float v = 0.0f;
  if (i < n && t < n_lat && (i / block_n) * block_n < nv) {
    long long r = rows ? rows[i] : i;
    r = r < 0 ? 0 : (r >= n_x ? n_x - 1 : r);
    const float* xr = x + r * d;
    float xs[S];
#pragma unroll
    for (int j = 0; j < S; ++j) xs[j] = xr[s_feats[t * S + j]];
    v = lattice_interp<S>(s_theta + t * P, xs);
  }
  s_out[threadIdx.x][t] = v;
  __syncthreads();
  const int orow = tid / kLattices;
  const int olat = tid % kLattices;
  if (row0 + orow < n && olat < n_lat) {
    out[static_cast<size_t>(row0 + orow) * tk + lat0 + olat] =
        s_out[orow][olat];
  }
}

template <int S>
int launch(const float* theta, const int* feats, const float* x,
           const long long* rows, long long n_x, const int* n_valid_dev,
           int n_valid_host, int n, int d, int tk, int block_n, int team,
           int threads, int grid_x, float* out, cudaStream_t stream) {
  if (team) {
    lattice_scores_team_kernel<S><<<grid_x, threads, 0, stream>>>(
        theta, feats, x, rows, n_x, n_valid_dev, n_valid_host, n, d, tk,
        block_n, out);
  } else {
    const dim3 grid((n + kRows - 1) / kRows, (tk + kLattices - 1) / kLattices);
    const dim3 block(kRows, kLattices);
    lattice_scores_kernel<S><<<grid, block, 0, stream>>>(
        theta, feats, x, rows, n_x, n_valid_dev, n_valid_host, n, d, tk,
        block_n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `theta` and `feats` point at lattice t0 of the (T, 2^S) and (T, S) stacks;
// team, threads and grid_x are lattice_regime's (the thread regime's grid
// follows from n and tk); returns cudaErrorInvalidValue for S outside
// [1, kMaxLatticeDims].
extern "C" int lattice_scores_launch(const float* theta, const int* feats,
                                     const float* x, const long long* rows,
                                     long long n_x, const int* n_valid_dev,
                                     int n_valid_host, int n, int d, int tk,
                                     int s, int block_n, int team, int threads,
                                     int grid_x, float* out,
                                     cudaStream_t stream) {
  switch (s) {
#define LATTICE_CASE(S)                                                     \
  case S:                                                                   \
    return launch<S>(theta, feats, x, rows, n_x, n_valid_dev, n_valid_host, \
                     n, d, tk, block_n, team, threads, grid_x, out, stream);
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
