"""NTT / iNTT / coset low-degree extension over Goldilocks, batched.

The counterpart of `aero_tpu/ntt/ntt.py:187-259`. Results are in natural
order (evals[i] = poly(w^i)), batched over the leading axes. A CUDA tensor
goes through kernel 1 (`ntt_cuda.ntt_cuda`: two passes up to 2^24 points,
three beyond, the size alone decides); a CPU tensor takes the plain
radix-2 decimation-in-time transform below. Both are the same DFT, so
their canonical outputs are equal bit for bit.

The coset LDE is the single-NTT formulation of `aero_tpu.ntt.lde` (its
coset-by-coset TPU formulation gives the same values): the offset folded
into the coefficients (c_i * offset^i), zero-padded to n*blowup points and
transformed, at every size (2^24 coefficients at blowup 8 are one
transform of 2^27 points). On the card that is `ntt_cuda.lde_cuda`, whose
first pass reads the coefficients and never the padding; `coset_pad` is
its plain rendering, which the CPU path runs.

No size goes to the int8 tensor-core 4-step (`ntt_mxu.py`), which
`aero_tpu.ntt` dispatches 2^16..2^20 to on the TPU. On an NVIDIA H100 80GB
HBM3 at 700 W (`chip_smoke.py` phase 8) its int8 products alone take
58.0 ms at 72 x 2^20, 29 % of the 16.9 ms that the card's dense int8 rate
allows, and 6.7-12.1 ms at 8 x 2^18 (launch-bound); the whole transform
takes 1417-1432 ms and 23-44 ms; kernel 1 takes 3.30 ms and 0.124 ms at the
same shapes. The TPU's reason for the matmul route, a vector unit with a
weak 32-bit multiplier, does not hold on a card with a full-rate integer
multiply-add. `ntt_mxu` and `intt_mxu` are public, bit-exact and checked on
the card; there is no switch that routes `ntt` / `intt` through them.
"""

from __future__ import annotations

import torch

from ..spec import field as F

from ..field import from_u64, mul, power_series, scalar
from ..field.gl import add_plain, mul_plain, sub_plain
from . import tables
from .ntt_cuda import lde_cuda, ntt_cuda


def ntt_plain(x: torch.Tensor, invert: bool = False) -> torch.Tensor:
    """Radix-2 DIT (i)NTT over the last axis, plain PyTorch, any device."""
    shape = x.shape
    n = shape[-1]
    log_n = n.bit_length() - 1
    tw = from_u64(tables.radix2_twiddles(n, invert), x.device)
    rev = torch.as_tensor(tables.bitrev(log_n).astype("int64"),
                          device=x.device)
    x = x.reshape(-1, n)[:, rev]
    B = x.shape[0]
    for s in range(1, log_n + 1):
        half = 1 << (s - 1)
        xr = x.reshape(B, n >> s, 2, half)
        u, v = xr[:, :, 0], xr[:, :, 1]
        t = mul_plain(v, tw[half - 1:2 * half - 1])
        x = torch.stack([add_plain(u, t), sub_plain(u, t)],
                        dim=2).reshape(B, n)
    if invert:
        x = mul_plain(x, scalar(F.inv(n), x.device))
    return x.reshape(shape)


def _transform(x: torch.Tensor, invert: bool) -> torch.Tensor:
    if x.is_cuda:
        return ntt_cuda(x.contiguous(), invert)
    return ntt_plain(x, invert)


def ntt(coeffs: torch.Tensor) -> torch.Tensor:
    """Coefficients -> evaluations over the size-n subgroup."""
    return _transform(coeffs, False)


def intt(evals: torch.Tensor) -> torch.Tensor:
    """Evaluations (natural order) -> coefficients."""
    return _transform(evals, True)


def coset_pad(coeffs: torch.Tensor, log_blowup: int,
              offset: int = F.DOMAIN_OFFSET) -> torch.Tensor:
    """c_i * offset^i, zero-padded to n << log_blowup: the input of the
    size-m transform that evaluates over the coset offset*<w_m>. The
    offset powers are made where the coefficients lie, by log-doubling
    (`power_series`), so nothing crosses from the host."""
    n = coeffs.shape[-1]
    sc = power_series(offset, n, device=coeffs.device)
    out = torch.zeros(coeffs.shape[:-1] + (n << log_blowup,),
                      dtype=torch.int64, device=coeffs.device)
    out[..., :n] = mul(coeffs, sc)
    return out


def lde(coeffs: torch.Tensor, log_blowup: int,
        offset: int = F.DOMAIN_OFFSET) -> torch.Tensor:
    """Evaluate degree-<n polynomials (..., n) over the coset
    offset*<w_{n*blowup}>; returns (..., n << log_blowup), natural order."""
    if coeffs.is_cuda:
        return lde_cuda(coeffs.contiguous(), log_blowup, offset)
    return ntt_plain(coset_pad(coeffs, log_blowup, offset))


def lde_from_evals(evals: torch.Tensor, log_blowup: int,
                   offset: int = F.DOMAIN_OFFSET) -> torch.Tensor:
    """Trace evaluations over the size-n subgroup -> evaluations over the
    blown-up coset (interpolate, then extend)."""
    return lde(intt(evals), log_blowup, offset)
