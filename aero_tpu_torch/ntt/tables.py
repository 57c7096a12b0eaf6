"""NTT twiddle and index tables, built on the host in numpy.

Carries `aero_tpu/ntt/gl_np.py` (u64 Goldilocks arithmetic on numpy
arrays) and the table builders of `aero_tpu/ntt/ntt_pallas.py:64-119`
(`_bitrev`, `_tables_np`, `_expanded_stage_tw`), which the JAX package
cannot lend without importing jax. Two changes: a pass may be 4096 long
(the TPU kernel stopped at 2048), so two passes cover n up to 2^24; and
`pack_stage_tw` packs the per-stage twiddles the way the CUDA kernel
reads them.
"""

from __future__ import annotations

import functools

import numpy as np

from aero_tpu.spec import field as F

MAX_L = 4096            # longest single-pass NTT (4096 x 8 B of shared memory)

_P = np.uint64(F.P)
_M32 = np.uint64(0xFFFFFFFF)
_EPS = np.uint64(0xFFFFFFFF)
_32 = np.uint64(32)


# ------------------------------------------------ u64 Goldilocks in numpy

def _mul128(a: np.ndarray, b: np.ndarray):
    """u64 x u64 -> (lo64, hi64) numpy uint64 arrays."""
    al, ah = a & _M32, a >> _32
    bl, bh = b & _M32, b >> _32
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    mid = lh + hl
    mid_carry = (mid < lh).astype(np.uint64)
    lo = ll + (mid << _32)
    lo_carry = (lo < ll).astype(np.uint64)
    hi = hh + (mid >> _32) + (mid_carry << _32) + lo_carry
    return lo, hi


def np_mul(a, b) -> np.ndarray:
    """(a * b) mod p, canonical, elementwise on uint64 arrays."""
    with np.errstate(over="ignore"):
        lo, hi = _mul128(np.asarray(a, np.uint64), np.asarray(b, np.uint64))
        hi_lo = hi & _M32
        hi_hi = hi >> _32
        t = lo - hi_hi
        t = t - np.where(lo < hi_hi, _EPS, np.uint64(0))
        e = (hi_lo << _32) - hi_lo
        r = t + e
        r = r + np.where(r < t, _EPS, np.uint64(0))
        return r - np.where(r >= _P, _P, np.uint64(0))


def np_power_series(base: int, n: int, scale: int = 1) -> np.ndarray:
    """[scale, scale*base, ..., scale*base^(n-1)] mod p as uint64 (n = 2^k)."""
    out = np.empty(n, dtype=np.uint64)
    out[0] = scale % F.P
    length = 1
    b = base % F.P
    while length < n:
        out[length:2 * length] = np_mul(out[:length], np.uint64(b))
        b = b * b % F.P
        length *= 2
    return out


# ------------------------------------------------------------------ tables

def bitrev(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int32)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def expanded_stage_tw(L: int, wL: int) -> np.ndarray:
    """Per-stage twiddle rows: (log2(L), L) where row s-1, entry i =
    w_m^(i mod m/2) for m = 2^s (`ntt_pallas._expanded_stage_tw`)."""
    log_L = L.bit_length() - 1
    out = np.zeros((max(log_L, 1), L), dtype=np.uint64)
    for s in range(1, log_L + 1):
        m = 1 << s
        half = m >> 1
        wm = pow(wL, L // m, F.P)
        out[s - 1] = np.tile(np_power_series(wm, half), L // half)
    return out


def pack_stage_tw(expanded: np.ndarray, L: int) -> np.ndarray:
    """The first m/2 entries of each stage row of an `expanded_stage_tw`
    table, packed: stage s (half = 2^(s-1)) starts at offset half - 1, so
    butterfly j of stage s reads tw[half - 1 + j]. Length max(L - 1, 1)."""
    log_L = L.bit_length() - 1
    if log_L == 0:
        return np.ones(1, dtype=np.uint64)
    return np.concatenate([expanded[s - 1, :1 << (s - 1)]
                           for s in range(1, log_L + 1)])


@functools.lru_cache(maxsize=48)
def tables_np(n: int, invert: bool):
    """Table set of the two-pass 4-step NTT of size n:
    (n1, n2, rev1, rev2, p1, p2, ctw), as `ntt_pallas._tables_np`.

    x[j1 + n1*j2] = M[j2][j1]. Pass 1 is a size-n2 NTT down each column of
    M with root w^n1 (stage table p2), then the cross twiddle
    ctw[k2, j1] = w^(j1*k2) (times 1/n for the inverse); pass 2 is a size-n1
    NTT over j1 with root w^n2 (stage table p1), landing on D[k1][k2], whose
    row-major flattening is the natural-order result."""
    log_n = n.bit_length() - 1
    log1 = (log_n + 1) // 2
    n1, n2 = 1 << log1, n >> log1
    if n1 > MAX_L or n2 > MAX_L:
        raise ValueError(f"NTT size {n} exceeds two passes of {MAX_L}")
    w = F.get_root_of_unity(log_n)
    if invert:
        w = F.inv(w)
    p2 = expanded_stage_tw(n2, pow(w, n1, F.P)).T
    p1 = expanded_stage_tw(n1, pow(w, n2, F.P)).T
    scale = F.inv(n) if invert else 1
    ctw = np.empty((n2, n1), dtype=np.uint64)
    ctw[0] = np_power_series(1, n1, scale)
    if n2 > 1:
        ctw[1] = np_power_series(w, n1, scale)
    m = 2
    while m < n2:
        row_m = np_power_series(pow(w, m, F.P), n1)
        ctw[m:2 * m] = np_mul(ctw[:m], row_m[None, :])
        m *= 2
    return n1, n2, bitrev(log1), bitrev(log_n - log1), p1, p2, ctw


@functools.lru_cache(maxsize=64)
def radix2_twiddles(n: int, invert: bool) -> np.ndarray:
    """Packed stage twiddles of a single size-n radix-2 DIT transform."""
    w = F.get_root_of_unity(n.bit_length() - 1)
    if invert:
        w = F.inv(w)
    return pack_stage_tw(expanded_stage_tw(n, w), n)
