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

__device__ __forceinline__ u64 gl_mul(u64 a, u64 b) {
  const u64 lo = a * b;
  const u64 hi = __umul64hi(a, b);
  const u64 hh = hi >> 32, hl = hi & GL_EPS;
  u64 t = lo - hh;
  if (lo < hh) t -= GL_EPS;      // borrow: - 2^64 = - EPS (mod p)
  const u64 r0 = t + ((hl << 32) - hl);   // + hl * (2^32 - 1)
  const u64 r = r0 < t ? r0 + GL_EPS : r0;
  return gl_canon(r);
}
