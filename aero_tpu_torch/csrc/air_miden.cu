// GENERATED FILE, do not edit: the entry point of kernel K5 for
// aero_tpu_torch.air.miden.MidenAir.evaluate_transitions,
// traced by aero_tpu_torch/air/symbolic.py and written by
//   python -m aero_tpu_torch.air.codegen --write
// 112 constraints; 585 mul, 461 add, 164 sub, 0 neg; 134 frame loads, 16 rands, 21 constants;
// at most 85 values live at once in this order.
// emission: 79 values computed at their uses (again after a re-read), reuse window 32 sites;
// a point: 116 extra ops, 349 frame reads, 22 rand reads; at most 27 values live.
// air-class: aero_tpu_torch.air.miden.MidenAir
// dag-digest: 888d99d1c9031673d45ce158aafdc2354791bfd84512820477c06b30d3ad855f

#include "air_miden_transitions.cuh"

// Kernel K5 over one fragment of m points: mode 0 writes the merged row,
// mode 1 the (T, m) constraint values (csrc/frag_eval.cuh).
extern "C" int miden_frag_eval(FRAG_EVAL_PARAMS) {
  return frag_eval_launch<MidenTransitions>(FRAG_EVAL_ARGS);
}
