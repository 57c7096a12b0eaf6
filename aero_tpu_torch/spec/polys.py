"""Polynomial helpers over Goldilocks (pure Python specification)."""

from __future__ import annotations

from typing import List, Sequence

from .field import P, inv, batch_inv, get_root_of_unity


def lagrange_eval(xs: Sequence[int], ys: Sequence[int], at: int) -> int:
    """Evaluate the interpolant through (xs, ys) at `at`
    (reference: src/stark_verifier/fri/polynomials.cairo:8-54)."""
    n = len(xs)
    total = 0
    for i in range(n):
        num, den = 1, 1
        for j in range(n):
            if i == j:
                continue
            num = num * ((at - xs[j]) % P) % P
            den = den * ((xs[i] - xs[j]) % P) % P
        total = (total + ys[i] * num % P * inv(den)) % P
    return total


def poly_eval(coeffs: Sequence[int], x: int) -> int:
    """Horner evaluation; coeffs[i] is the x^i coefficient."""
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def interpolate(xs: Sequence[int], ys: Sequence[int]) -> List[int]:
    """Dense Lagrange interpolation -> coefficient form (O(n^2), spec only)."""
    n = len(xs)
    coeffs = [0] * n
    for i in range(n):
        # numerator poly prod_{j != i} (x - xs[j]), built incrementally
        num = [1]
        den = 1
        for j in range(n):
            if i == j:
                continue
            num = _mul_linear(num, (-xs[j]) % P)
            den = den * ((xs[i] - xs[j]) % P) % P
        scale = ys[i] * inv(den) % P
        for k, c in enumerate(num):
            coeffs[k] = (coeffs[k] + scale * c) % P
    return coeffs


def _mul_linear(poly: List[int], c0: int) -> List[int]:
    """poly(x) * (x + c0)"""
    out = [0] * (len(poly) + 1)
    for i, c in enumerate(poly):
        out[i] = (out[i] + c * c0) % P
        out[i + 1] = (out[i + 1] + c) % P
    return out


def ntt_naive(values: Sequence[int], invert: bool = False) -> List[int]:
    """O(n log n) recursive radix-2 NTT, natural order. Spec/test oracle.

    Forward: coefficients -> evaluations over the size-n subgroup (in natural
    order: result[i] = poly(w^i)). Inverse: evaluations -> coefficients.
    """
    n = len(values)
    assert n & (n - 1) == 0
    logn = n.bit_length() - 1
    w = get_root_of_unity(logn)
    if invert:
        w = inv(w)
    out = _fft_rec(list(values), w)
    if invert:
        n_inv = inv(n)
        out = [v * n_inv % P for v in out]
    return out


def _fft_rec(a: List[int], w: int) -> List[int]:
    n = len(a)
    if n == 1:
        return a
    even = _fft_rec(a[0::2], w * w % P)
    odd = _fft_rec(a[1::2], w * w % P)
    out = [0] * n
    wk = 1
    for k in range(n // 2):
        t = wk * odd[k] % P
        out[k] = (even[k] + t) % P
        out[k + n // 2] = (even[k] - t) % P
        wk = wk * w % P
    return out


def eval_poly_on_coset(coeffs: Sequence[int], log_blowup: int, offset: int) -> List[int]:
    """LDE: evaluate the degree-<n polynomial over the coset
    offset * <w_{n*blowup}> in natural order. Spec oracle for the TPU path."""
    n = len(coeffs)
    m = n << log_blowup
    scaled = list(coeffs) + [0] * (m - n)
    # incorporate the coset offset into coefficients: c_i * offset^i
    o = 1
    for i in range(n):
        scaled[i] = scaled[i] * o % P
        o = o * offset % P
    return ntt_naive(scaled)
