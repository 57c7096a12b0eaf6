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

The field ops (`add`, `sub`, `neg`, `mul`, `square`, `mul_scalar`,
`pow_loop`, `inv`) and the scans (`gf_cumprod`, `gf_cumsum`) send a CUDA
tensor to the kernels of `csrc/field.cu` through `gl_cuda` (K1, K2) and a
CPU tensor to their plain versions here (`add_plain`, ..., written in the
torch ops described above), which are also the oracle the kernels are held
to. `batch_inv` sends a CUDA tensor to K2's fused batch inversion and a
CPU tensor to `batch_inv_plain`, the Montgomery scans in the plain ops.
Other composite functions (`gf_sum`, `power_series`, ...) are written over
the dispatching ops and so run on either; `gf_sum_plain` is its rendering
in the plain ops alone.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .._device import index_tensor, to_host, upload
from . import gl_cuda
from .sym import Sym, SymGraph
from . import sym

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
    host until the stream drains. On a symbolic device (`sym.SymGraph`) a
    constant node, or the rand node `v` itself."""
    if type(device) is SymGraph:
        return sym.scalar(v, device)
    return torch.full((), as_i64(int(v)), dtype=torch.int64, device=device)


def from_u64(arr, device) -> torch.Tensor:
    """numpy uint64 array (any u64, not necessarily < p) -> canonical tensor."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.uint64))
    t = upload(torch.from_numpy(a.view(np.int64).copy()), device)
    return canonicalize(t)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """Field tensor -> numpy uint64 (host copy)."""
    return to_host(t.detach()).contiguous().numpy().view(np.uint64).copy()


def from_limbs(lo, hi, device) -> torch.Tensor:
    """The numpy lo/hi u32 limb arrays of an `aero_tpu` GF -> tensor."""
    lo = np.asarray(lo).astype(np.uint64)
    hi = np.asarray(hi).astype(np.uint64)
    return from_u64(lo | (hi << np.uint64(32)), device)


def gf_full(shape, value: int, device) -> torch.Tensor:
    if type(device) is SymGraph:
        return device.const(value)
    return torch.full(tuple(shape), as_i64(value), dtype=torch.int64,
                      device=device)


def gf_zeros(shape, device) -> torch.Tensor:
    if type(device) is SymGraph:
        return device.const(0)
    return torch.zeros(tuple(shape), dtype=torch.int64, device=device)


def gf_concat(parts: Sequence[torch.Tensor], axis: int = 0) -> torch.Tensor:
    return torch.cat(list(parts), dim=axis)


def gf_take(x: torch.Tensor, idx, axis: int = 0) -> torch.Tensor:
    idx = index_tensor(idx, x.device)
    return torch.index_select(x, axis, idx)


def gf_where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    return torch.where(mask, a, b)


def gf_reshape(x: torch.Tensor, shape) -> torch.Tensor:
    return x.reshape(tuple(shape))


# ------------------------------------------------------------------ field ops

def _ult(x: torch.Tensor, y) -> torch.Tensor:
    """Unsigned x < y on u64 bit patterns."""
    return (x ^ _SIGN) < (y ^ _SIGN)


def canonicalize(a: torch.Tensor) -> torch.Tensor:
    """Any u64 bit pattern -> [0, p) (one subtraction: 2^64 - 1 < 2p)."""
    return torch.where((a ^ _SIGN) < _P_FLIP, a, a - _P_I64)


def add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    nb = _P_I64 - b                       # p - b, in [1, p]
    return torch.where(_ult(a, nb), a + b, a - nb)


def sub_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.where(_ult(a, b), d + _P_I64, d)


def neg_plain(a: torch.Tensor) -> torch.Tensor:
    return sub_plain(torch.zeros_like(a), a)


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


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    al, ah = a & _M32, (a >> 32) & _M32
    bl, bh = b & _M32, (b >> 32) & _M32
    ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh   # u64 each
    # the 128-bit product as 32-bit limbs; the sums stay below 2^35
    t1 = ((ll >> 32) & _M32) + (lh & _M32) + (hl & _M32)
    t2 = ((lh >> 32) & _M32) + ((hl >> 32) & _M32) + (hh & _M32) + (t1 >> 32)
    c3 = ((hh >> 32) & _M32) + (t2 >> 32)
    lo = (ll & _M32) | ((t1 & _M32) << 32)
    return _reduce(lo, t2 & _M32, c3)


def pow_loop_plain(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e by square-and-multiply over the bits of a host exponent."""
    res = torch.full_like(a, 1)
    base = a
    while e:
        if e & 1:
            res = mul_plain(res, base)
        e >>= 1
        if e:
            base = mul_plain(base, base)
    return res


def inv_plain(a: torch.Tensor) -> torch.Tensor:
    return pow_loop_plain(a, P - 2)


# The ops below take a CUDA tensor to kernel K1 (`gl_cuda`, csrc/field.cu):
# one launch an op, operands read as they lie (a 0-d scalar from device
# memory, a broadcast or a strided view through the kernel's indexing).
# A CPU tensor takes the plain version above. A symbolic operand (`sym.Sym`,
# an AIR under `air.symbolic.trace`) records a node instead.

def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if type(a) is Sym or type(b) is Sym:
        return sym.add(a, b)
    if gl_cuda.on_cuda(a, b):
        return gl_cuda.elementwise(a, b, gl_cuda.ADD)
    return add_plain(a, b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if type(a) is Sym or type(b) is Sym:
        return sym.sub(a, b)
    if gl_cuda.on_cuda(a, b):
        return gl_cuda.elementwise(a, b, gl_cuda.SUB)
    return sub_plain(a, b)


def neg(a: torch.Tensor) -> torch.Tensor:
    if type(a) is Sym:
        return sym.neg(a)
    if gl_cuda.on_cuda(a):
        return sub(torch.zeros((), dtype=torch.int64, device=a.device), a)
    return neg_plain(a)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if type(a) is Sym or type(b) is Sym:
        return sym.mul(a, b)
    if gl_cuda.on_cuda(a, b):
        return gl_cuda.elementwise(a, b, gl_cuda.MUL)
    return mul_plain(a, b)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_scalar(a: torch.Tensor, c: int) -> torch.Tensor:
    return mul(a, scalar(c, a.device))


def mul_pow2_const(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * 2^k mod p for a host integer k, by shifts and folds, no multiply
    (`jax_gl.mul_pow2_const`). 2 has order 192 in Goldilocks (2^96 = -1), so
    k is taken mod 192 and k >= 96 negates. With k = 32q + r the product
    a * 2^r is a 96-bit value whose 32-bit limbs land at limb offset q of a
    160-bit one; the limbs past the second fold with 2^64 = 2^32 - 1,
    2^96 = -1 and 2^128 = -2^32. `a` may be any u64 bit pattern."""
    k %= 192
    negate = k >= 96
    q, r = divmod(k % 96, 32)
    s = a << r                                    # low 64 bits of a * 2^r
    zero = torch.zeros_like(a)
    top = (a >> (64 - r)) & ((1 << r) - 1) if r else zero    # bits 64..95
    l0, l1 = s & _M32, (s >> 32) & _M32
    if q == 0:
        out = _reduce(s, top, zero)
    elif q == 1:
        out = _reduce(l0 << 32, l1, top)
    else:
        out = _reduce(zero, l0, l1)
        if r:
            out = sub(out, top << 32)             # top < 2^31: canonical
    return neg(out) if negate else out


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a host exponent; a^0 is 1. The JAX package kept an unrolled
    and a loop form apart for the sake of compile times; here both are
    `pow_loop`."""
    return pow_loop(a, e)


def pow_loop(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e by square-and-multiply over the bits of a host exponent."""
    if gl_cuda.on_cuda(a):
        return gl_cuda.power(a, e)
    return pow_loop_plain(a, e)


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


def gf_cumprod_plain(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return _scan(x, mul_plain, axis)


def gf_cumsum_plain(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return _scan(x, add_plain, axis)


def gf_cumprod(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inclusive prefix products along `axis`: kernel K2 on the card."""
    if gl_cuda.on_cuda(x):
        return gl_cuda.scan(x.movedim(axis, -1), gl_cuda.MUL).movedim(-1, axis)
    return gf_cumprod_plain(x, axis)


def gf_cumsum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inclusive prefix sums along `axis`: kernel K2 on the card."""
    if gl_cuda.on_cuda(x):
        return gl_cuda.scan(x.movedim(axis, -1), gl_cuda.ADD).movedim(-1, axis)
    return gf_cumsum_plain(x, axis)


def batch_inv_plain(a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Montgomery batch inversion along `axis` in the plain ops: one Fermat
    inversion per lane plus prefix/suffix product scans
    (`jax_gl.batch_inv`). A zero anywhere in a lane makes the whole lane
    zero (its total has no inverse), as in the JAX package."""
    x = a.movedim(axis, -1)
    prod = gf_cumprod_plain(x)
    total_inv = inv_plain(prod[..., -1:])
    suffix = gf_cumprod_plain(x.flip(-1)).flip(-1)
    one = torch.ones_like(x[..., :1])
    suffix_excl = torch.cat([suffix[..., 1:], one], dim=-1)
    inv_prefix = mul_plain(suffix_excl, total_inv)       # 1 / prod_i
    shifted = torch.cat([one, prod[..., :-1]], dim=-1)   # prod_{i-1}
    return mul_plain(inv_prefix, shifted).movedim(-1, axis)


def batch_inv(a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Montgomery batch inversion along `axis`: on the card one call of
    K2's `gl_batch_inv` (three launches), on the CPU `batch_inv_plain`.
    Both give `jax_gl.batch_inv`'s values: each inverse is unique, and a
    row with a zero is all zero."""
    if gl_cuda.on_cuda(a):
        return gl_cuda.batch_inv(a.movedim(axis, -1)).movedim(-1, axis)
    return batch_inv_plain(a, axis)


def _tree_sum(x: torch.Tensor, axis: int, add_) -> torch.Tensor:
    """Field sum along `axis` by a pairwise tree over halves of the axis
    (element k meets element k + half); the axis is removed."""
    axis %= x.dim()
    while x.shape[axis] > 1:
        n = x.shape[axis]
        half = n // 2
        s = add_(x.narrow(axis, 0, half), x.narrow(axis, half, half))
        if n % 2:
            s = torch.cat([s, x.narrow(axis, 2 * half, 1)], dim=axis)
        x = s
    return x.select(axis, 0)


def gf_sum(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Field sum along `axis` (pairwise tree; the axis is removed). On the
    card each level is one launch of K1 on the two halves as they lie."""
    return _tree_sum(x, axis, add)


def gf_sum_plain(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return _tree_sum(x, axis, add_plain)


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


def eval_polys_at(polys: torch.Tensor, z: int) -> np.ndarray:
    """Evaluate coefficient rows (..., n) at the scalar z: returns uint64 of
    shape polys.shape[:-1] (`jax_gl.eval_polys_at`)."""
    rows = polys.reshape(-1, polys.shape[-1])
    return eval_polys_multi(rows, [z])[0].reshape(polys.shape[:-1])


def _blocks(polys) -> list:
    return [polys] if isinstance(polys, torch.Tensor) else list(polys)


def eval_polys_multi(polys, zs) -> np.ndarray:
    """Evaluate coefficient rows at every scalar in `zs` (`jax_gl.
    eval_polys_multi`): `polys` one (w, n) tensor or a list of (w_i, n)
    row blocks, taken in order as one (sum w_i, n) without a copy; returns
    uint64 (k, w). On the card one call of kernel K7 (at most four blocks
    and four points), on the CPU `eval_polys_multi_plain`."""
    blocks = _blocks(polys)
    if gl_cuda.on_cuda(*blocks):
        return to_u64(gl_cuda.eval_multi(blocks, zs))
    return eval_polys_multi_plain(blocks, zs)


def eval_polys_multi_plain(polys, zs) -> np.ndarray:
    """`eval_polys_multi` in the plain ops: the power row [z^0 .. z^(n-1)]
    of each point by log-doubling, then each block's terms, chunked over
    its rows so a (rows, n) term array stays near 2^25 elements, summed
    by a pairwise tree."""
    blocks = _blocks(polys)
    n = blocks[0].shape[-1]
    w = sum(blk.shape[0] for blk in blocks)
    if n == 0 or w == 0:
        return np.zeros((len(zs), w), dtype=np.uint64)
    device = blocks[0].device
    bases = from_u64(np.array([int(z) % P for z in zs], dtype=np.uint64),
                     device).reshape(-1, 1)
    zps = torch.ones_like(bases)
    while zps.shape[1] < n:
        zps = torch.cat([zps, mul_plain(zps, bases)], dim=1)
        bases = mul_plain(bases, bases)
    zps = zps[:, :n]
    cw = max(1, (1 << 25) // max(n, 1))
    cols = [gf_sum_plain(mul_plain(blk[i:i + cw], zp), axis=-1)
            for zp in zps for blk in blocks
            for i in range(0, blk.shape[0], cw)]
    return to_u64(torch.cat(cols).reshape(len(zs), w))
