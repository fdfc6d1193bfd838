// One cascade threshold test: the single source of the step semantics for
// every decide kernel of repro_torch (B1 cascade.cu, B2 cascade_chunk.cu, B4,
// B7 mega_stage.cu, B6 cascade_lane.cu).
// Mirrored by repro_torch.kernels.cascade_kernel.threshold_step (the plain
// PyTorch version) and repro_torch.core.executor.decide_chunk_reference, and
// taken from repro.kernels.cascade_kernel.threshold_step.
//
// The add is a plain f32 add of the selected score.  The sources are built
// with -fmad=false, so no neighbouring multiply contracts into it and the
// partial sums stay bit-identical to the plain version.  Negative exit wins
// the tie.
#pragma once

__device__ __forceinline__ void threshold_step(float& g, bool& active,
                                               bool& decided_pos,
                                               int& exit_step, float f,
                                               float eps_pos, float eps_neg,
                                               int step_1b) {
  g += active ? f : 0.0f;
  const bool out_neg = active && (g < eps_neg);
  const bool out_pos = active && (g > eps_pos) && !out_neg;
  const bool newly = out_neg || out_pos;
  decided_pos = decided_pos || out_pos;
  exit_step = newly ? step_1b : exit_step;
  active = active && !newly;
}

// The same test for a walk that marks where a row would exit instead of
// retiring it at once (B1, whose outputs are decisions and exit steps
// only).  threshold_mark adds f to g with no select on the row's state and
// sets bit j of `marks` where the new partial sum leaves [eps_neg, eps_pos]
// (threshold_step's out_neg || out_pos; a NaN sum marks nothing, as
// there).  No step's mark depends on an earlier one, so a step's
// loop-carried chain is one f32 add.  The caller retires an active row at
// its first marked step with threshold_take, given the partial sum there
// (re-added from the group's start: the same adds in the same order).  Up
// to a row's exit its g, exit step and decision are threshold_step's bit
// for bit; after it, g is never read again.
__device__ __forceinline__ void threshold_mark(float& g, unsigned& marks,
                                               float f, float eps_pos,
                                               float eps_neg, int j) {
  g += f;
  const bool out = (g < eps_neg) | (g > eps_pos);
  marks |= static_cast<unsigned>(out) << j;
}

// threshold_step's decision at a step where the partial sum g left the
// thresholds (negative exit first)
__device__ __forceinline__ void threshold_take(float g, float eps_pos,
                                               float eps_neg, int step_1b,
                                               bool& active, bool& decided_pos,
                                               int& exit_step) {
  decided_pos = !(g < eps_neg) && (g > eps_pos);
  exit_step = step_1b;
  active = false;
}
