// Multilinear interpolation of one lattice at one point: the single source of
// the lattice arithmetic for every lattice kernel of repro_torch (B5
// lattice_scores.cu, B4's and B7's lattice variants in mega_stage.cu).
// Mirrored by repro_torch.ensembles.lattice.apply_lattice_scores, and taken
// from repro.ensembles.lattice._interp_one / repro.kernels.ref.lattice_scores_ref.
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
// Two ways to run the same halvings:
// - lattice_interp: one thread, the 2^S vertex values read from `theta`
//   (B5: shared memory, read by a whole warp at one address, a broadcast),
//   the 2^(S-1) partial values in registers.
// - lattice_interp_team: a team of L = min(32, 2^S) lanes of one warp, lane
//   t holding the K = 2^S / L vertex values c = t + L k.  Halvings whose
//   half is a multiple of L pair two values of one lane and run in
//   registers; the last log2(L) pair lane t with lane t + half and run on
//   __shfl_down_sync.  Each rounded operation has the operands of the
//   one-thread form, so the two give the same bits.
// S is a template parameter and every loop is unrolled, so no index into
// the partial values is dynamic; the build log (-Xptxas=-v) shows "0 bytes
// stack frame" for each kernel when they stay in registers.
#pragma once

constexpr int kMaxLatticeDims = 8;  // 128 registers of partial values

// The halvings v_c <- v_c * (1 - x) + v_{c + H} * x for c < H, then the
// next halving of the lower half.  H is a template parameter at every
// level, so each loop's trip count is a constant and every index into v is
// resolved at compile time: the array stays in registers (a loop over the
// levels leaves the inner trip count unknown when the compiler unrolls, and
// v then goes to local memory).
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

template <int S>
__device__ __forceinline__ float lattice_interp(const float* theta,
                                                const float* xs) {
  static_assert(S >= 1 && S <= kMaxLatticeDims, "lattice inputs S");
  constexpr int kHalf = 1 << (S - 1);
  float v[kHalf];
  const float x = xs[0];
  const float w = 1.0f - x;
#pragma unroll
  for (int c = 0; c < kHalf; ++c) {
    v[c] = theta[c] * w + theta[c + kHalf] * x;
  }
  return LatticeHalvings<kHalf / 2>::run(v, xs + 1);
}

// The team geometry of lattice_interp_team for S inputs.
template <int S>
struct LatticeTeam {
  static_assert(S >= 1 && S <= kMaxLatticeDims, "lattice inputs S");
  static constexpr int V = 1 << S;            // vertex values
  static constexpr int L = V < 32 ? V : 32;   // lanes of a team
  static constexpr int K = V / L;             // values a lane holds
  static constexpr int kRegLevels = S - (S < 5 ? S : 5);  // log2(K)
};

// The halvings whose half H is below the team's width: lane t < H pairs its
// partial value with lane t + H's, then the next halving.
template <int H>
struct ShuffleHalvings {
  __device__ __forceinline__ static float run(float v, const float* xs) {
    const float hi = __shfl_down_sync(0xffffffffu, v, H);
    const float x = xs[0];
    const float w = 1.0f - x;
    return ShuffleHalvings<H / 2>::run(v * w + hi * x, xs + 1);
  }
};

template <>
struct ShuffleHalvings<0> {
  __device__ __forceinline__ static float run(float v, const float*) {
    return v;
  }
};

// `v` holds this lane's K vertex values (c = t + L k for its team lane t),
// `xs` the S inputs; the score is returned in the team's first lane (the
// other lanes return partial values).  Every lane of the warp must call it
// together: the shuffles name the whole warp.
template <int S>
__device__ __forceinline__ float lattice_interp_team(
    float (&v)[LatticeTeam<S>::K], const float* xs) {
  using Team = LatticeTeam<S>;
  const float r = LatticeHalvings<Team::K / 2>::run(v, xs);
  return ShuffleHalvings<Team::L / 2>::run(r, xs + Team::kRegLevels);
}
