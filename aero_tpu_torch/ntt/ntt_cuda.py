"""Kernel 1: the Goldilocks NTT on the card (`csrc/ntt.cu`).

Replaces the TPU kernel `aero_tpu/ntt/ntt_pallas.py:131`/`:172` (the
column NTT `_colntt`, composed into a 4-step transform by `ntt_pallas`).
A size-n transform is two passes of one kernel, with the tables of
`tables.tables_np` (n = n1 * n2, both at most 4096):

    pass 1: size-n2 NTT down each column of M[j2][j1] = x[j1 + n1*j2],
            times the cross twiddle w^(j1*k2)          -> C[k2][j1]
    pass 2: size-n1 NTT over j1 for each k2, read from C transposed and
            written as D[k1][k2]                        = X[k1*n2 + k2]

Each pass does its own bit-reversed load, so no butterfly, field multiply,
gather or transpose happens outside the kernel. The inverse transform uses
w^-1 and has 1/n folded into the cross table.

`colntt_plain` and `ntt_four_step_plain` render the same passes in plain
PyTorch; `ntt_cuda` takes them for a CPU tensor, launches the kernel for a
CUDA tensor and raises for anything else. `LAUNCHES` counts the launches.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from ..field import add, from_u64, mul, sub
from . import tables

LAUNCHES = {"gl_colntt": 0}

_LOG_MAX_TILE = 12          # csrc/ntt.cu: L * TC <= 4096


def reset_launches() -> None:
    LAUNCHES["gl_colntt"] = 0


# ----------------------------------------------------------- plain version

def colntt_plain(x: torch.Tensor, tw: torch.Tensor,
                 cross: torch.Tensor | None) -> torch.Tensor:
    """One pass, as the kernel computes it: x (B, L, C) -> size-L NTT down
    axis 1 of every column (rows read bit-reversed), times cross (L, C)."""
    B, L, C = x.shape
    log_L = L.bit_length() - 1
    rev = torch.as_tensor(tables.bitrev(log_L).astype("int64"),
                          device=x.device)
    x = x[:, rev, :]
    for s in range(1, log_L + 1):
        half = 1 << (s - 1)
        xr = x.reshape(B, L >> s, 2, half, C)
        u, v = xr[:, :, 0], xr[:, :, 1]
        t = mul(v, tw[half - 1:2 * half - 1].reshape(1, 1, half, 1))
        x = torch.stack([add(u, t), sub(u, t)], dim=2).reshape(B, L, C)
    if cross is not None:
        x = mul(x, cross)
    return x


@functools.lru_cache(maxsize=48)
def _tables(n: int, invert: bool, device: torch.device):
    """(n1, n2, pass-1 twiddles, pass-2 twiddles, cross) on `device`."""
    n1, n2, _, _, p1, p2, ctw = tables.tables_np(n, invert)
    return (n1, n2,
            from_u64(tables.pack_stage_tw(p2.T, n2), device),
            from_u64(tables.pack_stage_tw(p1.T, n1), device),
            from_u64(ctw, device))


def ntt_four_step_plain(x: torch.Tensor, invert: bool) -> torch.Tensor:
    """Natural-order (i)NTT over the last axis, two plain passes."""
    shape = x.shape
    n = shape[-1]
    if n == 1:
        return x.clone()
    n1, n2, tw2, tw1, ctw = _tables(n, invert, x.device)
    c = colntt_plain(x.reshape(-1, n2, n1), tw2, ctw)       # C[k2][j1]
    d = colntt_plain(c.transpose(1, 2), tw1, None)          # D[k1][k2]
    return d.reshape(shape)


# ------------------------------------------------------------------ kernel

def _pass(src, dst, tw, cross, log_L, log_C, B, in_s, out_s, cross_ld):
    log_TC = min(_LOG_MAX_TILE - log_L, log_C)
    _build.launch("gl_colntt", src.data_ptr(), dst.data_ptr(), tw.data_ptr(),
                  cross.data_ptr() if cross is not None else None,
                  log_L, log_TC, 1 << log_C, B, in_s[0], in_s[1],
                  out_s[0], out_s[1], cross_ld,
                  torch.cuda.current_stream(src.device).cuda_stream)
    LAUNCHES["gl_colntt"] += 1


def ntt_cuda(x: torch.Tensor, invert: bool = False) -> torch.Tensor:
    """Natural-order NTT (or iNTT) over the last axis of an int64 tensor
    (..., n), n a power of two up to 2^24."""
    if x.device.type == "cpu":
        return ntt_four_step_plain(x, invert)
    if x.device.type != "cuda":
        raise ValueError(f"ntt_cuda: unsupported device {x.device}")
    n = x.shape[-1]
    if x.dtype != torch.int64 or not x.is_contiguous() or n & (n - 1):
        raise ValueError("ntt_cuda: needs a contiguous int64 tensor whose "
                         f"last axis is a power of two, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if n == 1:
        return x.clone()
    n1, n2, tw2, tw1, ctw = _tables(n, invert, x.device)
    log1, log2 = n1.bit_length() - 1, n2.bit_length() - 1
    B = x.numel() // n
    mid = torch.empty_like(x)
    out = torch.empty_like(x)
    # pass 1: element (j2, j1) at j2*n1 + j1; cross ctw[k2, j1]
    _pass(x, mid, tw2, ctw, log2, log1, B, (n1, 1), (n1, 1), n1)
    # pass 2: element (j1, k2) of C at k2*n1 + j1; D[k1][k2] at k1*n2 + k2
    _pass(mid, out, tw1, None, log1, log2, B, (1, n1), (n2, 1), 0)
    return out
