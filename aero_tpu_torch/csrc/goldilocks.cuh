// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) as device functions.
//
// The counterpart of the limb algebra in aero_tpu/field/jax_gl.py: a TPU
// has no 64-bit vector multiply, so the JAX package built the 128-bit
// product from 16 u32 partial products. Here it is `a * b` and
// `__umul64hi(a, b)`, followed by the same reduction (_reduce128):
// 2^64 = 2^32 - 1 and 2^96 = -1 (mod p). Inputs and outputs are canonical,
// in [0, p), the invariant of the int64 tensors of aero_tpu_torch.
#pragma once

typedef unsigned long long u64;

constexpr u64 GL_P = 0xFFFFFFFF00000001ULL;
constexpr u64 GL_EPS = 0xFFFFFFFFULL;   // 2^64 mod p

__device__ __forceinline__ u64 gl_canon(u64 a) {
  return a >= GL_P ? a - GL_P : a;
}

__device__ __forceinline__ u64 gl_add(u64 a, u64 b) {
  u64 s = a + b;
  if (s < a) s += GL_EPS;        // wrapped: + 2^64 = + EPS (mod p), no overflow
  return gl_canon(s);
}

__device__ __forceinline__ u64 gl_sub(u64 a, u64 b) {
  const u64 d = a - b;
  return a < b ? d + GL_P : d;   // wraps to a - b + p
}

// the 128-bit hi * 2^64 + lo reduced to [0, p): 2^64 = 2^32 - 1 and
// 2^96 = -1 (mod p)
__device__ __forceinline__ u64 gl_reduce128(u64 lo, u64 hi) {
  const u64 hh = hi >> 32, hl = hi & GL_EPS;
  u64 t = lo - hh;
  if (lo < hh) t -= GL_EPS;      // borrow: - 2^64 = - EPS (mod p)
  const u64 r0 = t + ((hl << 32) - hl);   // + hl * (2^32 - 1)
  const u64 r = r0 < t ? r0 + GL_EPS : r0;
  return gl_canon(r);
}

__device__ __forceinline__ u64 gl_mul(u64 a, u64 b) {
  return gl_reduce128(a * b, __umul64hi(a, b));
}

// a * 2^e (mod p) for 0 < e < 96, by shifts. A root of unity of order at
// most 64 is +-2^e (2 has order 192, 2^96 = -1), and in a butterfly the
// sign only swaps its add and subtract, so a multiply by such a twiddle
// may take this form instead of gl_mul. Not used by a kernel: the field-op
// probe (csrc/probe/field_ops.cu) counts it, and kernel 1's bound takes
// the cheaper of the two forms. For e >= 64: a * 2^(e-64) = yh * 2^64 +
// yl, and yl * 2^64 + yh * 2^128 = yl * 2^64 - yh * 2^32 (mod p).
__device__ __forceinline__ u64 gl_mul_pow2(u64 a, int e) {
  if (e < 64) return gl_reduce128(a << e, a >> (64 - e));
  const int s = e - 64;
  const u64 yl = a << s, yh = s ? a >> (64 - s) : 0;
  return gl_sub(gl_reduce128(0, yl), yh << 32);
}
