// GENERATED FILE, do not edit: the per-point constraint values of kernel K5 for
// aero_tpu_torch.air.fib.FibAir.evaluate_transitions,
// traced by aero_tpu_torch/air/symbolic.py and written by
//   python -m aero_tpu_torch.air.codegen --write
// 3 constraints; 3 mul, 4 add, 3 sub, 0 neg; 6 frame loads, 2 rands, 1 constants;
// at most 7 values live at once in this order.
// emission: 0 values computed at their uses (again after a re-read), reuse window 32 sites;
// a point: 0 extra ops, 6 frame reads, 2 rand reads; at most 5 values live.
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
  // degree in {1, 2}, the slot of its x^adj in the merge
  template <class In, class Out>
  static GL_FN void eval(const In& in, Out& out) {
    const u64 r0 = in.main_cur(0);
    const u64 r1 = in.main_cur(1);
    const u64 v3 = gl_add(r0, r1);
    const u64 r2 = in.main_nxt(0);
    const u64 v4 = gl_sub(r2, v3);
    out.template put<0, 0>(v4);
    const u64 v7 = gl_mul(r1, 0x2ULL);
    const u64 v8 = gl_add(r0, v7);
    const u64 r3 = in.main_nxt(1);
    const u64 v9 = gl_sub(r3, v8);
    out.template put<1, 0>(v9);
    const u64 r4 = in.rand(1);
    const u64 v14 = gl_mul(r1, r4);
    const u64 v15 = gl_add(r0, v14);
    const u64 r5 = in.rand(0);
    const u64 v16 = gl_add(r5, v15);
    const u64 r6 = in.aux_cur(0);
    const u64 v17 = gl_mul(r6, v16);
    const u64 r7 = in.aux_nxt(0);
    const u64 v18 = gl_sub(r7, v17);
    out.template put<2, 1>(v18);
  }
};
