// GENERATED FILE, do not edit: the per-point constraint values of kernel K5 for
// aero_tpu_torch.air.fib.FibAir.evaluate_transitions,
// traced by aero_tpu_torch/air/symbolic.py and written by
//   python -m aero_tpu_torch.air.codegen --write
// 3 constraints; 3 mul, 4 add, 3 sub, 0 neg; 6 frame loads, 2 rands, 1 constants;
// at most 7 values live at once in this order.
// air-class: aero_tpu_torch.air.fib.FibAir
// dag-digest: 8314a8a08ba34cce171c5b92c9451f22bd438c4f16145f9c578bec5328d51b69
#pragma once

#include "frag_eval.cuh"

struct FibTransitions {
  static constexpr int kConstraints = 3;
  static constexpr int kClasses = 2;
  static constexpr int kMainWidth = 2;
  static constexpr int kAuxWidth = 1;
  static constexpr int kRands = 2;

  // constraint k's value goes to out.put<k, c>(), c the index of its
  // degree in {1, 2}, the row of its x^adj in the merge
  template <class In, class Out>
  static GL_FN void eval(const In& in, Out& out) {
    const u64 v0 = in.main_nxt(0);
    const u64 v1 = in.main_cur(0);
    const u64 v2 = in.main_cur(1);
    const u64 v3 = gl_add(v1, v2);
    const u64 v4 = gl_sub(v0, v3);
    out.template put<0, 0>(v4);
    const u64 v5 = in.main_nxt(1);
    const u64 v7 = gl_mul(v2, 0x2ULL);
    const u64 v8 = gl_add(v1, v7);
    const u64 v9 = gl_sub(v5, v8);
    out.template put<1, 0>(v9);
    const u64 v10 = in.aux_nxt(0);
    const u64 v11 = in.aux_cur(0);
    const u64 v12 = in.rand(0);
    const u64 v13 = in.rand(1);
    const u64 v14 = gl_mul(v2, v13);
    const u64 v15 = gl_add(v1, v14);
    const u64 v16 = gl_add(v12, v15);
    const u64 v17 = gl_mul(v11, v16);
    const u64 v18 = gl_sub(v10, v17);
    out.template put<2, 1>(v18);
  }
};
