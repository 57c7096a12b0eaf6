"""Goldilocks field p = 2^64 - 2^32 + 1, scalar (pure Python) specification.

Matches the reference semantics (reference: src/utils/math_goldilocks.cairo:4
`PG`, src/stark_verifier/fri/fri_verifier.cairo:154-155 TWO_ADICITY, root).
Used for host-side small math (Fiat-Shamir follow-on values, FRI query checks)
and as the oracle for the vectorized JAX/Pallas field kernels.

Frozen copy of the port's `spec/field.py` for the benchmark's plain
reference: it imports nothing of the program, and a change to the
program does not change it.
"""

from __future__ import annotations

GOLDILOCKS_PRIME = (1 << 64) - (1 << 32) + 1
P = GOLDILOCKS_PRIME

TWO_ADICITY = 32
# 2^32-th root of unity (fri_verifier.cairo:155)
TWO_ADIC_ROOT_OF_UNITY = 1753635133440165772
# LDE/coset domain offset (fri_verifier.cairo:23)
DOMAIN_OFFSET = 7

MULTIPLICATIVE_GENERATOR = 7  # generator of the multiplicative group


def add(a: int, b: int) -> int:
    return (a + b) % P


def sub(a: int, b: int) -> int:
    return (a - b) % P


def mul(a: int, b: int) -> int:
    return (a * b) % P


def neg(a: int) -> int:
    return (-a) % P


def exp(a: int, e: int) -> int:
    return pow(a, e, P)


def inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero in Goldilocks field")
    return pow(a, P - 2, P)


def div(a: int, b: int) -> int:
    return mul(a, inv(b))


def batch_inv(xs):
    """Montgomery batch inversion; one field inversion total."""
    n = len(xs)
    out = [0] * n
    acc = 1
    prefix = [0] * n
    for i, x in enumerate(xs):
        if x % P == 0:
            raise ZeroDivisionError("inverse of zero in Goldilocks field")
        prefix[i] = acc
        acc = acc * x % P
    acc = inv(acc)
    for i in range(n - 1, -1, -1):
        out[i] = acc * prefix[i] % P
        acc = acc * xs[i] % P
    return out


def get_root_of_unity(log_n: int) -> int:
    """Generator of the order-2^log_n subgroup (fri_verifier.cairo:157-168)."""
    if log_n == 0:
        return 1
    if log_n > TWO_ADICITY:
        raise ValueError(f"order cannot exceed 2^{TWO_ADICITY}")
    return pow(TWO_ADIC_ROOT_OF_UNITY, 1 << (TWO_ADICITY - log_n), P)
