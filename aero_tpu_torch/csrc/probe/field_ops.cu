// The machine code of one Goldilocks field op, for the bounds that count
// the field ops a function needs (chip_smoke.py: kernel 1, K5, the scan and
// the batch inversion). Kernel probe_<op>_<operands> applies one op of
// goldilocks.cuh kOps times, straight-line, to kValues values held in
// registers, between the same loads and stores as probe_none, which copies
// in to out and applies none; (its instructions - probe_none's) / kOps are
// one op's, pipe by pipe, with no loop, address or memory instruction among
// them. "vv": both
// operands vary; "vc": the second is a constant, as where a traced program
// adds or multiplies by one. probe_mul_pow2: the multiply by a root of unity
// of order at most 64, +-2^e with e = 3, 6, .., 93 (`gl_mul_pow2`), the
// 31 exponents in turn; kernel 1's bound prices those twiddles at the
// cheaper of it and probe_mul_vv. probe_{add,sub,mul}_lazy_vv: the lazy
// forms kernel 1 computes with inside a pass, logged beside the canonical
// ops; no bound prices them (a bound counts the ops a function needs, at
// the canonical forms' counts).
//
// chip_smoke.py builds this file into a cubin of its own and reads its SASS;
// it is not part of the kernel library and is never launched.
#include "../goldilocks.cuh"

constexpr int kValues = 8;
constexpr int kOps = 64;

#define FIELD_OP_PROBE(NAME, EXPR)                                          \
  extern "C" __global__ void NAME(const u64* in, u64* out) {               \
    const long long base =                                                  \
        (long long)blockIdx.x * blockDim.x * kValues + threadIdx.x;         \
    u64 v[kValues];                                                         \
    _Pragma("unroll") for (int i = 0; i < kValues; ++i)                     \
        v[i] = in[base + i * blockDim.x];                                   \
    _Pragma("unroll") for (int r = 0; r < kOps; ++r) {                      \
      const u64 a = v[r % kValues];                                         \
      const u64 b = v[(r + 3) % kValues];                                   \
      const u64 c = 0x9E3779B97F4A7C15ULL + r;                              \
      (void)b;                                                              \
      (void)c;                                                              \
      v[r % kValues] = EXPR;                                                \
    }                                                                       \
    _Pragma("unroll") for (int i = 0; i < kValues; ++i)                     \
        out[base + i * blockDim.x] = v[i];                                  \
  }

FIELD_OP_PROBE(probe_none, a)
FIELD_OP_PROBE(probe_add_vv, gl_add(a, b))
FIELD_OP_PROBE(probe_add_vc, gl_add(a, c))
FIELD_OP_PROBE(probe_sub_vv, gl_sub(a, b))
FIELD_OP_PROBE(probe_sub_vc, gl_sub(a, c))
FIELD_OP_PROBE(probe_mul_vv, gl_mul(a, b))
FIELD_OP_PROBE(probe_mul_vc, gl_mul(a, c))
FIELD_OP_PROBE(probe_mul_pow2, gl_mul_pow2(a, 3 * (1 + r % 31)))
FIELD_OP_PROBE(probe_add_lazy_vv, gl_add_lazy(a, b))
FIELD_OP_PROBE(probe_sub_lazy_vv, gl_sub_lazy(a, b))
FIELD_OP_PROBE(probe_mul_lazy_vv, gl_mul_lazy(a, b))
