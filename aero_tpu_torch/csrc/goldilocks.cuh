// Goldilocks field arithmetic (p = 2^64 - 2^32 + 1) as device functions.
//
// The counterpart of the limb algebra in aero_tpu/field/jax_gl.py: a TPU
// has no 64-bit vector multiply, so the JAX package built the 128-bit
// product from 16 u32 partial products. Here it is `a * b` and
// `__umul64hi(a, b)`, followed by the same reduction (_reduce128):
// 2^64 = 2^32 - 1 and 2^96 = -1 (mod p). Inputs and outputs are canonical,
// in [0, p), the invariant of the int64 tensors of aero_tpu_torch, but for
// the lazy forms below, which kernel 1 computes with between a load and a
// store.
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

// The lazy forms: the inputs are any words, the result is a word congruent
// mod p to the field op's result, not always below p; one gl_canon makes
// it canonical. Each takes the same steps as its canonical form, with the
// last canonicalisation left out; a carry or borrow is read from a 128-bit
// sum or difference, which keeps it in the add's carry chain, and its
// correction of EPS (2^64 = EPS, mod p) is the high word masked to EPS.
// Kernel 1 uses them where gl_add, gl_sub and gl_mul spend a compare and a
// select a result on canonicalising (csrc/ntt.cu).

// a + b (mod p). a + b = s + c 2^64, c in {0, 1}: s + c EPS. That sum
// carries only if c = 1 and s >= p. Then s <= 2^64 - 2, so the sum less
// 2^64 is at most EPS - 2, and its + EPS cannot carry.
__device__ __forceinline__ u64 gl_add_lazy(u64 a, u64 b) {
  const unsigned __int128 s = (unsigned __int128)a + b;
  const unsigned __int128 t =
      (unsigned __int128)(u64)s + (-(u64)(s >> 64) & GL_EPS);
  return (u64)t + (-(u64)(t >> 64) & GL_EPS);
}

// a - b (mod p). On a borrow the word is d = a - b + 2^64 >= 1: d - EPS.
// That borrows only if d < EPS, and then d - EPS + 2^64 >= p + 1 > EPS, so
// the second - EPS cannot borrow.
__device__ __forceinline__ u64 gl_sub_lazy(u64 a, u64 b) {
  const unsigned __int128 d = (unsigned __int128)a - b;
  const unsigned __int128 t =
      (unsigned __int128)(u64)d - ((u64)(d >> 64) & GL_EPS);
  return (u64)t - ((u64)(t >> 64) & GL_EPS);
}

// a * b (mod p): gl_reduce128's steps on the product, without its
// gl_canon, for any product. lo - hh borrows to lo - hh + 2^64 >= p, so its
// - EPS cannot borrow again; t + hl EPS carries to at most 2^64 - 2^33, so
// its + EPS cannot carry again.
__device__ __forceinline__ u64 gl_mul_lazy(u64 a, u64 b) {
  const unsigned __int128 ab = (unsigned __int128)a * b;
  const u64 lo = (u64)ab, hi = (u64)(ab >> 64);
  const unsigned __int128 d = (unsigned __int128)lo - (hi >> 32);
  const u64 t = (u64)d - ((u64)(d >> 64) & GL_EPS);
  const unsigned __int128 r =
      (unsigned __int128)t + (u64)(unsigned)hi * GL_EPS;
  return (u64)r + (-(u64)(r >> 64) & GL_EPS);
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
