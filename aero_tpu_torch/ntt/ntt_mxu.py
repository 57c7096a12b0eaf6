"""4-step NTT whose DFT tiles are exact int8 limb matmuls on the tensor
cores: the counterpart of `aero_tpu/ntt/ntt_mxu.py`, same names.

A size-n NTT with n = k1*k2 factors into
    A = F1 @ X          (k1-point DFTs down the columns)     <- int8 matmuls
    B = A * T           (n twiddle multiplies, w^(i2*o1))    <- field algebra
    C = B @ F2^T        (k2-point DFTs along the rows)       <- int8 matmuls
    out = C^T flattened
(Bailey's 4-step algorithm). The matmuls are exact over GF(p): every field
element splits into sixteen 4-bit limbs, the DFT matrix likewise, and the
limb-pair products accumulate in int32 (below 2^31 for k <= 2^13). The 31
diagonal channel sums ch_c = sum_{a+b=c} F_a @ X_b recombine with the
shift-only folds of `field.mul_pow2_const`.

The limb products are the one library call of the port, as
`jax.lax.dot(int8, int8) -> int32` is in the JAX module: `torch._int_mm` for
a CUDA tensor, `a.to(int32) @ b.to(int32)` for a CPU tensor, chosen by the
tensor's device (`_int8_matmul`). `_int_mm` wants more than 16 rows and inner
and outer sizes that are multiples of 8; sizes that are not multiples of 32
(tiles below 32 only) are padded with zeros, explicitly, and nothing else is
tried. Everything around the products is plain torch over the port's field
type; there is no hand-written kernel here because the JAX module has none.

Memory: a DFT pass works on column chunks of `CHUNK_POINTS` points, so the
int32 channels and the Karatsuba tree's intermediates are bounded by the
chunk and not by the transform. Peak device memory above the input, measured
by `chip_smoke.py` phase 8 on an NVIDIA H100 80GB HBM3: 10.4 GB at 72 x 2^20
(input 0.6 GB; the transform's own int64 arrays, the Karatsuba channels of a
chunk and the temporaries of the folds), 0.32 GB at 8 x 2^18.

Dispatch: `ntt_mxu` and `intt_mxu` are public and bit-exact, and
`ntt.ntt` / `ntt.intt` do NOT route through them: on that card the int8
products alone take 58.0 ms at 72 x 2^20 where the NTT kernel takes 3.30 ms
for the whole transform (the docstring of `ntt.py` has the rest).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..spec import field as F

from ..field import P, add, from_u64, mul, mul_pow2_const
from . import tables

NLIMB = tables.NLIMB          # 4-bit limbs per 64-bit element
NCHAN = 2 * NLIMB - 1
MAX_K = 1 << 13               # int32 channel sums stay below 2^31 up to here
CHUNK_POINTS = 1 << 24        # points of one DFT-pass chunk (k * columns)

PRODUCTS = {"int8_matmul": 0}     # `torch._int_mm` launches


def reset_products() -> None:
    PRODUCTS["int8_matmul"] = 0


# -------------------------------------------------------------------- tables

def _dft_matrix_limbs(k: int, invert: bool, scale: int = 1) -> np.ndarray:
    """int8[NLIMB, k, k]: limb a of scale * W[o, i], W = w_k^(o*i)."""
    return tables.dft_matrix_limbs(k, invert, scale)


def _twiddle_limbs(k1: int, k2: int, invert: bool) -> np.ndarray:
    """T[o1, i2] = w_n^(i2*o1), n = k1*k2, as uint64 (k1, k2): one word an
    element where the JAX module returns its (lo, hi) u32 limb arrays."""
    return tables.cross_twiddles(k1, k2, invert)


@functools.lru_cache(maxsize=32)
def _f_limbs_on(k: int, invert: bool, scale: int,
                device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_dft_matrix_limbs(k, invert, scale)).to(device)


@functools.lru_cache(maxsize=32)
def _twiddles_on(k1: int, k2: int, invert: bool,
                 device: torch.device) -> torch.Tensor:
    return from_u64(_twiddle_limbs(k1, k2, invert), device)


# ----------------------------------------------------------- the int8 product

def _int8_matmul(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """int8 a (r, k) @ bt.T, bt (m, k) -> int32 (r, m), exact. The second
    operand comes transposed, each of its columns contiguous: the layout
    cuBLASLt's int8 tensor-core kernels take (row-major it ran at a fifth of
    the rate on an H100, `chip_smoke.py` phase 8, and some small shapes were
    refused). On the card this
    is `torch._int_mm`; sizes that are not multiples of 32 are zero-padded
    to the next one here and the result cut back."""
    if a.device.type == "cpu":
        return a.to(torch.int32) @ bt.to(torch.int32).t()
    if a.device.type != "cuda":
        raise ValueError(f"_int8_matmul: unsupported device {a.device}")
    (r, k), m = a.shape, bt.shape[0]
    rp, kp, mp = (-(-v // 32) * 32 for v in (r, k, m))
    padded = (rp, kp, mp) != (r, k, m)
    if padded:
        a = torch.nn.functional.pad(a, (0, kp - k, 0, rp - r))
        bt = torch.nn.functional.pad(bt, (0, kp - k, 0, mp - m))
    out = torch._int_mm(a.contiguous(), bt.contiguous().t())
    PRODUCTS["int8_matmul"] += 1
    return out[:r, :m] if padded else out


def _split_limbs(x: torch.Tensor) -> torch.Tensor:
    """Field tensor [...] -> int8[NLIMB, ...] of 4-bit limbs, contiguous
    whatever the strides of x."""
    out = torch.empty((NLIMB,) + tuple(x.shape), dtype=torch.int8,
                      device=x.device)
    for a in range(NLIMB):
        out[a] = (x >> (4 * a)) & 0xF
    return out


def _check_tile(k: int) -> None:
    if k > MAX_K:
        raise ValueError(f"DFT tile {k} exceeds {MAX_K}: the int32 channel "
                         "sums could overflow")


def _gf_dft_matmul(f_limbs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Exact Y = W @ X over GF(p), schoolbook: f_limbs int8[NLIMB, k, k],
    x a field tensor (k, m). 256 int8 products, summed per channel in int32;
    channel PAIRS fold in int32 first (ch_c + 16*ch_{c+1} < 2^31 for
    k <= 2^13), which halves the shift-and-reduce work."""
    _check_tile(x.shape[0])
    xl = _split_limbs(x.t())                  # (NLIMB, m, k)

    def chan(c):
        ch = None
        for a in range(max(0, c - NLIMB + 1), min(NLIMB, c + 1)):
            p = _int8_matmul(f_limbs[a], xl[c - a])
            ch = p if ch is None else ch.add_(p)
        return ch

    acc = None
    for c in range(0, NCHAN, 2):
        ch = chan(c)
        if c + 1 < NCHAN:
            ch = ch.add_(chan(c + 1) << 4)
        term = mul_pow2_const(ch.to(torch.int64), 4 * c)
        acc = term if acc is None else add(acc, term)
    return acc


# --------------------------- Karatsuba limb convolution (108 vs 256 products)

def _sum_pairs(parts):
    """[p0..p_{L-1}] -> [p0 + p_{L/2}, ...] elementwise."""
    half = len(parts) // 2
    return [parts[i] + parts[half + i] for i in range(half)]


@functools.lru_cache(maxsize=32)
def _f_tree(k: int, invert: bool, scale: int, device: torch.device):
    """The static F side of the Karatsuba tree: at every level the
    half-sums of the limb matrices (three levels down the sums reach
    15 * 8 = 120, still int8)."""
    f = _f_limbs_on(k, invert, scale, device)

    def build(parts):
        if len(parts) <= 2:
            return tuple(parts)
        half = len(parts) // 2
        return (build(parts[:half]), build(parts[half:]),
                build(_sum_pairs(parts)))

    return build([f[a] for a in range(NLIMB)])


def _kara_channels(ftree, xparts):
    """Recursive Karatsuba product of the limb polynomials: the 2L - 1
    signed int32 channel arrays of F(y) * X(y), y = 2^4."""
    if not isinstance(ftree[0], tuple):       # leaf: 1-2 limb matrices
        if len(xparts) == 1:
            return [_int8_matmul(ftree[0], xparts[0])]
        d = [_int8_matmul(ftree[a], xparts[b])
             for a in range(2) for b in range(2)]
        return [d[0], d[1].add_(d[2]), d[3]]
    flo, fhi, fmid = ftree
    half = len(xparts) // 2
    p0 = _kara_channels(flo, xparts[:half])
    p2 = _kara_channels(fhi, xparts[half:])
    p1 = _kara_channels(fmid, _sum_pairs(xparts))
    out = [None] * (2 * len(xparts) - 1)

    def acc(i, v, sign):
        if out[i] is None:
            out[i] = v.clone() if sign > 0 else -v
        elif sign > 0:
            out[i] += v
        else:
            out[i] -= v

    for i, v in enumerate(p0):
        acc(i, v, 1)
        acc(i + half, v, -1)              # -P0 shifted by y^half
    for i, v in enumerate(p2):
        acc(i + 2 * half, v, 1)
        acc(i + half, v, -1)              # -P2 shifted by y^half
    for i, v in enumerate(p1):
        acc(i + half, v, 1)
    return out


def _gf_dft_matmul_kara(ftree, x: torch.Tensor) -> torch.Tensor:
    """Exact Y = W @ X by the 3-level Karatsuba limb convolution: 108 int8
    products instead of 256. The channels are SIGNED. The JAX module reads
    the int32 as a u32 and takes 2^(32+4c) off every negative lane; an int64
    holds the signed channel as it is, so a negative lane is lifted by p
    before its shift."""
    _check_tile(x.shape[0])
    xl = _split_limbs(x.t())                  # (NLIMB, m, k)
    chans = _kara_channels(ftree, [xl[a] for a in range(NLIMB)])
    del xl
    p = P - (1 << 64)                     # p's bit pattern as an int64
    acc = None
    for c in range(NCHAN):
        ch = chans[c].to(torch.int64)
        chans[c] = None
        term = mul_pow2_const(torch.where(ch < 0, ch + p, ch), 4 * c)
        acc = term if acc is None else add(acc, term)
    return acc


# ------------------------------------------------------------------ transform

def _dft(k: int, invert: bool, scale: int, x: torch.Tensor) -> torch.Tensor:
    """W_k @ x for a field tensor x (k, m), column chunk by column chunk.
    The schoolbook pair-folded convolution serves k <= 512 and the 3-level
    Karatsuba k >= 1024, where the number of products dominates: the JAX
    module's choice, kept."""
    if k >= 1024:
        ftree = _f_tree(k, invert, scale, x.device)
        route = functools.partial(_gf_dft_matmul_kara, ftree)
    else:
        route = functools.partial(_gf_dft_matmul,
                                  _f_limbs_on(k, invert, scale, x.device))
    m = x.shape[1]
    step = max(8, CHUNK_POINTS // k)
    if m <= step:
        return route(x)
    return torch.cat([route(x[:, a:a + step]) for a in range(0, m, step)],
                     dim=1)


def _four_step(x: torch.Tensor, k1: int, k2: int, invert: bool
               ) -> torch.Tensor:
    """Natural-order size-(k1*k2) NTT of a field tensor (..., n): two
    int8-matmul DFT passes and one twiddle pass between them, batched over
    the leading axes. The inverse has its 1/n folded into the second
    matrix."""
    n = k1 * k2
    batch = tuple(x.shape[:-1])
    nb = len(batch)
    T = _twiddles_on(k1, k2, invert, x.device)
    # the batch joins the free matmul axis: (k1, *batch, k2) -> (k1, B*k2)
    xf = x.reshape(batch + (k1, k2)).movedim(-2, 0).reshape(k1, -1)
    A = _dft(k1, invert, 1, xf).reshape((k1,) + batch + (k2,))
    B_ = mul(A, T.reshape((k1,) + (1,) * nb + (k2,)))
    # second pass contracts i2: (k2, k1, *batch) -> (k2, k1*B)
    Bf = B_.movedim(-1, 0).reshape(k2, -1)
    C = _dft(k2, invert, F.inv(n) if invert else 1, Bf)
    C = C.reshape((k2, k1) + batch)                   # (o2, o1, *batch)
    # out[o1 + k1*o2]: axis order (*batch, o2, o1)
    return C.movedim((0, 1), (nb, nb + 1)).reshape(batch + (n,))


def _factor(n: int) -> Tuple[int, int]:
    logn = n.bit_length() - 1
    k1 = 1 << (logn // 2)
    return k1, n // k1


def _transform(x: torch.Tensor, invert: bool) -> torch.Tensor:
    n = x.shape[-1]
    if x.dtype != torch.int64 or n < 1 or n & (n - 1):
        raise ValueError("ntt_mxu: needs an int64 tensor whose last axis is "
                         f"a power of two, got {x.dtype} {tuple(x.shape)}")
    if n == 1:
        return x.clone()
    k1, k2 = _factor(n)
    return _four_step(x, k1, k2, invert)


def ntt_mxu(coeffs: torch.Tensor) -> torch.Tensor:
    """Coefficients -> evaluations (natural order), int8-matmul 4-step."""
    return _transform(coeffs, False)


def intt_mxu(evals: torch.Tensor) -> torch.Tensor:
    """Evaluations (natural order) -> coefficients."""
    return _transform(evals, True)
