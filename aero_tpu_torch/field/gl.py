"""Goldilocks arithmetic on int64 tensors, for any torch device.

The counterpart of `aero_tpu/field/jax_gl.py`. A field array is ONE
`torch.int64` tensor holding the u64 bit pattern of each element (the TPU
package needed lo/hi u32 limb pairs; the GPU has 64-bit integers).
Every op returns canonical values in [0, p), so a tensor can be hashed or
serialized without a canonicalization pass.

torch has no unsigned 64-bit arithmetic to speak of, so the ops work on the
bit patterns: additions and products wrap mod 2^64 exactly as u64 would;
`>>` is arithmetic, so every right shift is masked; comparisons are signed,
so an unsigned compare XORs the sign bit into both operands first
(`_ult`). Products use 32-bit limbs, whose partial products fit a u64.

These are plain tensor ops on CPU and CUDA alike. The hot transforms that
use them on the card (the NTT, blake2s) are CUDA kernels under `ntt/` and
`hash/`; everything here is the algebra around them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

P = (1 << 64) - (1 << 32) + 1
EPSILON = (1 << 32) - 1            # 2^64 mod p

_M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)
_P_I64 = P - (1 << 64)             # p's bit pattern as an int64
_P_FLIP = _P_I64 ^ _SIGN           # p with its sign bit flipped (for _ult)


# ----------------------------------------------------------------- conversion

def as_i64(v: int) -> int:
    """Python int -> the int64 holding the bit pattern of v mod p."""
    v %= P
    return v - (1 << 64) if v >= (1 << 63) else v


def scalar(v: int, device) -> torch.Tensor:
    """0-d field element (broadcasts against any field tensor). Made by a
    fill, not a host copy: a pageable host-to-device copy would stall the
    host until the stream drains."""
    return torch.full((), as_i64(int(v)), dtype=torch.int64, device=device)


def from_u64(arr, device) -> torch.Tensor:
    """numpy uint64 array (any u64, not necessarily < p) -> canonical tensor."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint64))
    t = torch.from_numpy(a.view(np.int64).copy()).to(device)
    return canonicalize(t)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """Field tensor -> numpy uint64 (host copy)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64).copy()


def from_limbs(lo, hi, device) -> torch.Tensor:
    """The numpy lo/hi u32 limb arrays of an `aero_tpu` GF -> tensor."""
    lo = np.asarray(lo).astype(np.uint64)
    hi = np.asarray(hi).astype(np.uint64)
    return from_u64(lo | (hi << np.uint64(32)), device)


def gf_full(shape, value: int, device) -> torch.Tensor:
    return torch.full(tuple(shape), as_i64(value), dtype=torch.int64,
                      device=device)


def gf_zeros(shape, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=torch.int64, device=device)


def gf_concat(parts: Sequence[torch.Tensor], axis: int = 0) -> torch.Tensor:
    return torch.cat(list(parts), dim=axis)


def gf_take(x: torch.Tensor, idx, axis: int = 0) -> torch.Tensor:
    idx = torch.as_tensor(np.asarray(idx, dtype=np.int64), device=x.device)
    return torch.index_select(x, axis, idx)


# ------------------------------------------------------------------ field ops

def _ult(x: torch.Tensor, y) -> torch.Tensor:
    """Unsigned x < y on u64 bit patterns."""
    return (x ^ _SIGN) < (y ^ _SIGN)


def canonicalize(a: torch.Tensor) -> torch.Tensor:
    """Any u64 bit pattern -> [0, p) (one subtraction: 2^64 - 1 < 2p)."""
    return torch.where((a ^ _SIGN) < _P_FLIP, a, a - _P_I64)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    nb = _P_I64 - b                       # p - b, in [1, p]
    return torch.where(_ult(a, nb), a + b, a - nb)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.where(_ult(a, b), d + _P_I64, d)


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def _reduce(lo: torch.Tensor, c2: torch.Tensor, c3: torch.Tensor
            ) -> torch.Tensor:
    """(lo + c2 * 2^64 + c3 * 2^96) mod p for c2, c3 < 2^32, canonical:
    2^64 = 2^32 - 1 and 2^96 = -1 (mod p), the identity of
    `jax_gl._reduce128`."""
    t = lo - c3
    t = torch.where(_ult(lo, c3), t - EPSILON, t)
    r = t + ((c2 << 32) - c2)
    r = torch.where(_ult(r, t), r + EPSILON, r)
    return canonicalize(r)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    al, ah = a & _M32, (a >> 32) & _M32
    bl, bh = b & _M32, (b >> 32) & _M32
    ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh   # u64 each
    # the 128-bit product as 32-bit limbs; the sums stay below 2^35
    t1 = ((ll >> 32) & _M32) + (lh & _M32) + (hl & _M32)
    t2 = ((lh >> 32) & _M32) + ((hl >> 32) & _M32) + (hh & _M32) + (t1 >> 32)
    c3 = ((hh >> 32) & _M32) + (t2 >> 32)
    lo = (ll & _M32) | ((t1 & _M32) << 32)
    return _reduce(lo, t2 & _M32, c3)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_scalar(a: torch.Tensor, c: int) -> torch.Tensor:
    return mul(a, scalar(c, a.device))


def pow_loop(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e by square-and-multiply over the bits of a host exponent."""
    res = torch.full_like(a, 1)
    base = a
    while e:
        if e & 1:
            res = mul(res, base)
        e >>= 1
        if e:
            base = square(base)
    return res


def inv(a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a^(p-2) (0 maps to 0)."""
    return pow_loop(a, P - 2)


# ----------------------------------------------------- scans and reductions

def _scan(x: torch.Tensor, op, axis: int) -> torch.Tensor:
    """Inclusive prefix scan by log-depth doubling (Hillis-Steele)."""
    x = x.movedim(axis, -1)
    n = x.shape[-1]
    d = 1
    while d < n:
        x = torch.cat([x[..., :d], op(x[..., d:], x[..., :-d])], dim=-1)
        d *= 2
    return x.movedim(-1, axis)


def gf_cumprod(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return _scan(x, mul, axis)


def gf_cumsum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return _scan(x, add, axis)


def batch_inv(a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Montgomery batch inversion along `axis`: one Fermat inversion per
    lane plus prefix/suffix product scans (`jax_gl.batch_inv`)."""
    x = a.movedim(axis, -1)
    prod = gf_cumprod(x)
    total_inv = inv(prod[..., -1:])
    suffix = gf_cumprod(x.flip(-1)).flip(-1)
    one = torch.ones_like(x[..., :1])
    suffix_excl = torch.cat([suffix[..., 1:], one], dim=-1)
    inv_prefix = mul(suffix_excl, total_inv)            # 1 / prod_i
    shifted = torch.cat([one, prod[..., :-1]], dim=-1)  # prod_{i-1}
    return mul(inv_prefix, shifted).movedim(-1, axis)


def gf_sum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Field sum along `axis` (pairwise tree; the axis is removed)."""
    x = x.movedim(axis, 0)
    while x.shape[0] > 1:
        n = x.shape[0]
        half = n // 2
        s = add(x[:half], x[half:2 * half])
        if n % 2:
            s = torch.cat([s, x[2 * half:]], dim=0)
        x = s
    return x[0]


def power_series(base: int, n: int, scale: int = 1,
                 device="cpu") -> torch.Tensor:
    """[scale, scale*base, scale*base^2, ...] of length n (a power of 2),
    by log-doubling: one elementwise multiply per doubling."""
    if n & (n - 1):
        raise ValueError("power_series length must be a power of 2")
    out = gf_full((1,), scale, device)
    b = base % P
    while out.shape[0] < n:
        out = torch.cat([out, mul(out, scalar(b, device))])
        b = b * b % P
    return out


def power_series_rows(bases: torch.Tensor, n: int) -> torch.Tensor:
    """[b^0 .. b^(n-1)] for each element of bases (k,) -> (k, n)."""
    out = torch.ones_like(bases).reshape(-1, 1)
    b = bases.reshape(-1, 1)
    while out.shape[1] < n:
        out = torch.cat([out, mul(out, b)], dim=1)
        b = square(b)
    return out


def eval_polys_multi(polys: torch.Tensor, zs) -> np.ndarray:
    """Evaluate coefficient rows (w, n) at every scalar in `zs`: returns
    uint64 (k, w). Chunked over w so the (k, w_chunk, n) term array stays
    near 2^25 elements."""
    w, n = polys.shape
    k = len(zs)
    bases = from_u64(np.array([int(z) % P for z in zs], dtype=np.uint64),
                     polys.device)
    zps = power_series_rows(bases, n)                      # (k, n)
    cw = max(1, (1 << 25) // max(n * k, 1))
    parts = [gf_sum(mul(polys[None, i:i + cw, :], zps[:, None, :]), axis=-1)
             for i in range(0, w, cw)]
    return to_u64(torch.cat(parts, dim=1))
