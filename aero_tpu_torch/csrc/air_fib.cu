// GENERATED FILE, do not edit: the entry point of kernel K5 for
// aero_tpu_torch.air.fib.FibAir.evaluate_transitions,
// traced by aero_tpu_torch/air/symbolic.py and written by
//   python -m aero_tpu_torch.air.codegen --write
// 3 constraints; 3 mul, 4 add, 3 sub, 0 neg; 6 frame loads, 2 rands, 1 constants;
// at most 7 values live at once in this order.
// emission: 0 values computed at their uses (again after a re-read), reuse window 32 sites;
// a point: 0 extra ops, 6 frame reads, 2 rand reads; at most 5 values live.
// air-class: aero_tpu_torch.air.fib.FibAir
// dag-digest: 8314a8a08ba34cce171c5b92c9451f22bd438c4f16145f9c578bec5328d51b69

#include "air_fib_transitions.cuh"

// Kernel K5 over one fragment of m points: mode 0 writes the merged row,
// mode 1 the (T, m) constraint values (csrc/frag_eval.cuh).
extern "C" int fib_frag_eval(FRAG_EVAL_PARAMS) {
  return frag_eval_launch<FibTransitions>(FRAG_EVAL_ARGS);
}
