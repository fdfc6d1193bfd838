// B5: multilinear lattice scores for lattices [t0, t1) of a stacked ensemble.
//
// Replaces repro/kernels/lattice_kernel.py lattice_scores_pallas (its
// pallas_call at :103).  For output (i, t): gather the S inputs
// x[r, feats[t, j]] and interpolate lattice t's 2^S vertex values at them
// (lattice_interp, lattice.cuh).  r is rows[i] when a row gather is given
// (clamped into range, as jnp.take clamps), else i.  Row blocks of `block_n`
// rows starting at or past n_valid emit 0 without touching x: the survivor
// buffer is front-packed, so work tracks the live count at a fixed shape.
//
// What bounds it on an H100: operations.  An output costs 3 (2^S - 1) f32
// operations against 4 bytes written and S floats gathered; at the
// calibration shape (8000 rows x 500 lattices, S = 8) that is 3.1 GFLOP
// against about 17 MB, 46 us at the card's 67 TFLOP/s of f32 on CUDA cores
// and 5 us at its 3.35 TB/s.  At the serving shape (256 rows x 8 lattices)
// the launch is the cost.
//
// Design: a CTA covers 32 rows x 8 lattices.  Each warp takes one lattice
// and its 32 lanes take 32 rows, so every theta read from shared memory is a
// broadcast, and the 2^(S-1) partial values live in registers (S is a
// template parameter, the halving loops are unrolled).  The 8 lattices'
// vertex values (8 KB at S = 8) and feature ids are staged in shared memory
// once per CTA.  The results go through a 32 x 8 tile in shared memory, so
// each row's 8 neighbouring scores are written as one 32-byte sector.  The
// TPU kernel's corner-weight matrix and matmul are not used: f32 CUDA cores
// in the dimension order keep the scores bit-identical to the plain version.
#include "common.cuh"
#include "lattice.cuh"

namespace {

constexpr int kRows = 32;     // rows per CTA (threadIdx.x, one warp's lanes)
constexpr int kLattices = 8;  // lattices per CTA (threadIdx.y, one per warp)

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
           int n_valid_host, int n, int d, int tk, int block_n, float* out,
           cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, (tk + kLattices - 1) / kLattices);
  const dim3 block(kRows, kLattices);
  lattice_scores_kernel<S><<<grid, block, 0, stream>>>(
      theta, feats, x, rows, n_x, n_valid_dev, n_valid_host, n, d, tk,
      block_n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `theta` and `feats` point at lattice t0 of the (T, 2^S) and (T, S) stacks;
// returns cudaErrorInvalidValue for S outside [1, kMaxLatticeDims].
extern "C" int lattice_scores_launch(const float* theta, const int* feats,
                                     const float* x, const long long* rows,
                                     long long n_x, const int* n_valid_dev,
                                     int n_valid_host, int n, int d, int tk,
                                     int s, int block_n, float* out,
                                     cudaStream_t stream) {
  switch (s) {
#define LATTICE_CASE(S)                                                     \
  case S:                                                                   \
    return launch<S>(theta, feats, x, rows, n_x, n_valid_dev, n_valid_host, \
                     n, d, tk, block_n, out, stream);
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
