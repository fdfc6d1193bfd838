// Multilinear interpolation of one lattice at one point: the single source of
// the lattice arithmetic for every lattice kernel of repro_torch (B5
// lattice_scores.cu, B4's lattice variant in mega_stage.cu).  Mirrored by
// repro_torch.ensembles.lattice.apply_lattice_scores, and taken from
// repro.ensembles.lattice._interp_one / repro.kernels.ref.lattice_scores_ref.
//
// The order is dimension by dimension, feature 0 first (the most significant
// bit of the theta index, as theta.reshape((2,) * S) lays it out): S halvings
//   v_c <- v_c * (1 - x_j) + v_{c + half} * x_j,   c < half,
// each a rounded multiply, a rounded multiply and a rounded add.  The sources
// are built with -fmad=false, so no multiply contracts into the add, and the
// score is bit-identical to the plain PyTorch version and to the JAX
// reference on the CPU.  The TPU kernel's corner-weight matrix times theta
// sums in another order and is not reproduced here.
//
// `theta` holds the lattice's 2^S vertex values (shared memory in both
// kernels, read by a whole warp at one address: a broadcast); `xs` the S
// inputs in [0, 1].  The 2^(S-1) partial values stay in registers: S is a
// template parameter and every loop is unrolled, so no index is dynamic.
// The build log (-Xptxas=-v) shows "0 bytes stack frame" for each kernel
// when that holds.
#pragma once

constexpr int kMaxLatticeDims = 8;  // 128 registers of partial values

// The halvings after the first: v_c <- v_c * (1 - x) + v_{c + H} * x for
// c < H, then the next halving of the lower half.  H is a template
// parameter at every level, so each loop's trip count is a constant and
// every index into v is resolved at compile time: the array stays in
// registers (a loop over the levels leaves the inner trip count unknown
// when the compiler unrolls, and v then goes to local memory).
template <int H>
struct LatticeHalvings {
  __device__ __forceinline__ static float run(float* v, const float* xs) {
    const float x = xs[0];
    const float w = 1.0f - x;
#pragma unroll
    for (int c = 0; c < H; ++c) {
      v[c] = v[c] * w + v[c + H] * x;
    }
    return LatticeHalvings<H / 2>::run(v, xs + 1);
  }
};

template <>
struct LatticeHalvings<0> {
  __device__ __forceinline__ static float run(float* v, const float*) {
    return v[0];
  }
};

// `vertex(c)` gives vertex value c as a float; it is read once per vertex,
// in the first halving (mega_stage.cu's B7 dequantises a bf16 or int8
// vertex value there, in place).
template <int S, typename Vertex>
__device__ __forceinline__ float lattice_interp_with(Vertex vertex,
                                                     const float* xs) {
  static_assert(S >= 1 && S <= kMaxLatticeDims, "lattice inputs S");
  constexpr int kHalf = 1 << (S - 1);
  float v[kHalf];
  const float x = xs[0];
  const float w = 1.0f - x;
#pragma unroll
  for (int c = 0; c < kHalf; ++c) {
    v[c] = vertex(c) * w + vertex(c + kHalf) * x;
  }
  return LatticeHalvings<kHalf / 2>::run(v, xs + 1);
}

template <int S>
__device__ __forceinline__ float lattice_interp(const float* theta,
                                                const float* xs) {
  return lattice_interp_with<S>([theta](int c) { return theta[c]; }, xs);
}
