// GENERATED FILE, do not edit: the entry point of kernel K6 for
// aero_tpu_torch.air.miden._bus_row_factors,
// traced by aero_tpu_torch/air/symbolic.py and written by
//   python -m aero_tpu_torch.air.codegen --write
// 8 outputs; 137 mul, 155 add, 32 sub, 0 neg; 51 frame loads, 16 rands, 14 constants;
// at most 50 values live at once in this order.
// emission: 27 values computed at their uses (again after a re-read), reuse window 32 sites;
// a row: 16 extra ops, 90 frame reads, 27 rand reads; at most 24 values live.
// air-class: aero_tpu_torch.air.miden.MidenAir
// traced: aero_tpu_torch.air.miden._bus_row_factors
// dag-digest: ec318b771b499d30a5004f889855408585ae02fc6f731d2008358437d4f79223

#include "aux_miden_factors.cuh"

// Kernel K6 over the n rows of the main trace: the (outputs, n) values,
// one thread a row (csrc/frag_eval.cuh).
extern "C" int miden_aux_factors(ROW_EVAL_PARAMS) {
  return row_eval_launch<MidenAuxFactors>(ROW_EVAL_ARGS);
}
