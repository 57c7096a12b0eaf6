"""Lagrange evaluation over Goldilocks (pure Python specification).

Frozen copy of `lagrange_eval` from the port's `spec/polys.py`, for the benchmark's plain
reference: it imports nothing of the program, and a change to the
program does not change it.
"""

from __future__ import annotations

from typing import Sequence

from .field import P, inv


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
