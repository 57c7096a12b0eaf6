"""NTT twiddle and index tables, built on the host in numpy.

Carries `aero_tpu/ntt/gl_np.py` (u64 Goldilocks arithmetic on numpy
arrays) and the table builders of `aero_tpu/ntt/ntt_pallas.py:64-119`
(`_bitrev`, `_tables_np`, `_expanded_stage_tw`), which the JAX package
cannot lend without importing jax. Three changes: a pass may be 4096 long
(the TPU kernel stopped at 2048), so two passes cover n up to 2^24;
`pack_stage_tw` packs the per-stage twiddles into one table, the way the
plain radix-2 transform (`ntt.ntt_plain`, through `radix2_twiddles`)
reads them; and `three_level_split` says how a longer transform is cut
into an outer pass and a two-pass inner transform. The CUDA kernel reads
none of these arrays: its tables (a pass's w_L^e, the cross tables, the
LDE's offset powers) are made on the card (`ntt_cuda.py`), and
`tables_np` is their plain version. These functions take the
pass limit as an argument (`MAX_L` by default), so that the levels can be
exercised at small sizes. The last section holds the tables of the
int8-limb 4-step transform (`ntt_mxu.py`; `aero_tpu/ntt/ntt_mxu.py:46-79`).
"""

from __future__ import annotations

import functools

import numpy as np

from ..spec import field as F

MAX_L = 4096            # longest pass of kernel 1 (csrc/ntt.cu: L * TC <= 2^14)

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


def two_pass_split(n: int, max_l: int = MAX_L):
    """(n1, n2) of the two-pass transform of size n: n1 = 2^ceil(log2(n)/2)
    columns, n2 = n / n1 rows. Raises past two passes of `max_l`."""
    log_n = n.bit_length() - 1
    log1 = (log_n + 1) // 2
    n1, n2 = 1 << log1, n >> log1
    if n1 > max_l or n2 > max_l:
        raise ValueError(f"NTT size {n} exceeds two passes of {max_l}")
    return n1, n2


def pass_lengths(n: int, max_l: int = MAX_L) -> list:
    """The lengths of kernel 1's passes of a size-n transform, first pass
    first: [n2, n1] where two passes of `max_l` reach n, else the outer
    pass and the inner transform's two, [n3, n2, n1]; [] for n = 1."""
    if n == 1:
        return []
    log_n = n.bit_length() - 1
    if (log_n + 1) // 2 <= max_l.bit_length() - 1:
        n1, n2 = two_pass_split(n, max_l)
        return [n2, n1]
    n3, n_inner = three_level_split(n, max_l)
    n1, n2 = two_pass_split(n_inner, max_l)
    return [n3, n2, n1]


def three_level_split(n: int, max_l: int = MAX_L):
    """(n3, n_inner) of a transform too long for two passes of `max_l`:
    n = n3 * n_inner, an outer pass of size n3 <= max_l and an inner
    two-pass transform of size n_inner <= max_l^2, the three passes about
    equally long. Raises for a size that three passes do not reach."""
    log_n = n.bit_length() - 1
    if n < 1 or n != 1 << log_n:
        raise ValueError(f"NTT size {n} is not a power of two")
    if log_n > 3 * (max_l.bit_length() - 1):
        raise ValueError(f"NTT size {n} exceeds three passes of {max_l}")
    log3 = log_n // 3
    return 1 << log3, n >> log3


@functools.lru_cache(maxsize=48)
def tables_np(n: int, invert: bool, max_l: int = MAX_L):
    """Table set of the two-pass 4-step NTT of size n:
    (n1, n2, rev1, rev2, p1, p2, ctw), as `ntt_pallas._tables_np`.

    x[j1 + n1*j2] = M[j2][j1]. Pass 1 is a size-n2 NTT down each column of
    M with root w^n1 (stage table p2), then the cross twiddle
    ctw[k2, j1] = w^(j1*k2) (times 1/n for the inverse); pass 2 is a size-n1
    NTT over j1 with root w^n2 (stage table p1), landing on D[k1][k2], whose
    row-major flattening is the natural-order result."""
    log_n = n.bit_length() - 1
    n1, n2 = two_pass_split(n, max_l)
    log1 = n1.bit_length() - 1
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


# ----------------------------------- tables of the int8-limb 4-step (ntt_mxu)

NLIMB = 16              # 4-bit limbs per 64-bit element


@functools.lru_cache(maxsize=32)
def dft_matrix(k: int, invert: bool, scale: int = 1) -> np.ndarray:
    """uint64 (k, k): scale * W[o, i], W = w_k^(o*i) (w_k^-1 for invert)."""
    w = F.get_root_of_unity(k.bit_length() - 1)
    if invert:
        w = F.inv(w)
    pw = np_power_series(w, k, scale)
    oi = np.outer(np.arange(k, dtype=np.int64), np.arange(k, dtype=np.int64))
    return pw[oi % k]


@functools.lru_cache(maxsize=32)
def dft_matrix_limbs(k: int, invert: bool, scale: int = 1) -> np.ndarray:
    """int8 (NLIMB, k, k): limb a of `dft_matrix(k, invert, scale)`. The
    inverse transform folds its 1/n into the second matrix via `scale`."""
    W = dft_matrix(k, invert, scale)
    out = np.empty((NLIMB, k, k), dtype=np.int8)
    for a in range(NLIMB):
        out[a] = ((W >> np.uint64(4 * a)) & np.uint64(0xF)).astype(np.int8)
    return out


@functools.lru_cache(maxsize=32)
def cross_twiddles(k1: int, k2: int, invert: bool) -> np.ndarray:
    """uint64 (k1, k2): T[o1, i2] = w_n^(i2*o1), n = k1*k2, the twiddles
    between the two DFT passes."""
    n = k1 * k2
    w = F.get_root_of_unity(n.bit_length() - 1)
    if invert:
        w = F.inv(w)
    pw = np_power_series(w, n)
    return pw[np.outer(np.arange(k1, dtype=np.int64),
                       np.arange(k2, dtype=np.int64)) % n]
