// One cascade threshold test: the single source of the step semantics for
// every decide kernel of repro_torch (B2 cascade_chunk.cu, B4 mega_stage.cu).
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
