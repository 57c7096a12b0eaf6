"""NTT / iNTT / coset low-degree extension over Goldilocks, batched.

The counterpart of `aero_tpu/ntt/ntt.py:187-259`. Results are in natural
order (evals[i] = poly(w^i)), batched over the leading axes. A CUDA tensor
goes through kernel 1 (`ntt_cuda.ntt_cuda`); a CPU tensor takes the plain
radix-2 decimation-in-time transform below. Both are the same DFT, so
their canonical outputs are equal bit for bit.

The coset LDE folds the offset into the coefficients (c_i * offset^i) and
runs one zero-padded size-n*blowup transform, the single-NTT formulation
of `aero_tpu.ntt.lde` (its coset-by-coset TPU formulation gives the same
values).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aero_tpu.spec import field as F

from ..field import add, from_u64, mul, scalar, sub
from . import tables
from .ntt_cuda import ntt_cuda


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
        t = mul(v, tw[half - 1:2 * half - 1])
        x = torch.stack([add(u, t), sub(u, t)], dim=2).reshape(B, n)
    if invert:
        x = mul(x, scalar(F.inv(n), x.device))
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


@functools.lru_cache(maxsize=32)
def _offset_powers(n: int, offset: int) -> np.ndarray:
    return tables.np_power_series(offset, n)


def coset_pad(coeffs: torch.Tensor, log_blowup: int,
              offset: int = F.DOMAIN_OFFSET) -> torch.Tensor:
    """c_i * offset^i, zero-padded to n << log_blowup: the input of the
    size-m transform that evaluates over the coset offset*<w_m>."""
    n = coeffs.shape[-1]
    sc = from_u64(_offset_powers(n, offset), coeffs.device)
    scaled = mul(coeffs, sc)
    pad = torch.zeros(coeffs.shape[:-1] + ((n << log_blowup) - n,),
                      dtype=torch.int64, device=coeffs.device)
    return torch.cat([scaled, pad], dim=-1)


def lde(coeffs: torch.Tensor, log_blowup: int,
        offset: int = F.DOMAIN_OFFSET) -> torch.Tensor:
    """Evaluate degree-<n polynomials (..., n) over the coset
    offset*<w_{n*blowup}>; returns (..., n << log_blowup), natural order."""
    return ntt(coset_pad(coeffs, log_blowup, offset))


def lde_from_evals(evals: torch.Tensor, log_blowup: int,
                   offset: int = F.DOMAIN_OFFSET) -> torch.Tensor:
    """Trace evaluations over the size-n subgroup -> evaluations over the
    blown-up coset (interpolate, then extend)."""
    return lde(intt(evals), log_blowup, offset)
