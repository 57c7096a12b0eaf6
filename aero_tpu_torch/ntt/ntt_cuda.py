"""Kernel 1: the Goldilocks NTT on the card (`csrc/ntt.cu`).

Replaces the TPU kernel `aero_tpu/ntt/ntt_pallas.py:131`/`:172` (the
column NTT `_colntt`, composed into a 4-step transform by `ntt_pallas`).
A size-n transform up to 2^24 points is two passes of one kernel, with the
tables of `tables.tables_np` (n = n1 * n2, both at most 4096):

    pass 1: size-n2 NTT down each column of M[j2][j1] = x[j1 + n1*j2],
            times the cross twiddle w^(j1*k2)          -> C[k2][j1]
    pass 2: size-n1 NTT over j1 for each k2, read from C transposed and
            written as D[k1][k2]                        = X[k1*n2 + k2]

A longer one (up to 2^36, as far as the card's memory goes) is three
passes of the same kernel, n = n1 * n2 * n3 (`tables.three_level_split`),
j = j1 + n1*j2 + n1*n2*j3 and k = k3 + n3*k2 + n3*n2*k1:

    pass 1: size-n3 NTT over j3 down each of the n1*n2 contiguous columns,
            times the outer cross twiddle w^(k3 * (j1 + n1*j2))
    pass 2, 3: for each k3 the two passes above of the size-n1*n2
            transform with root w^n3; the last pass takes its columns
            across k3, so it writes runs that are contiguous in the result

Each pass does its own bit-reversed load, so no butterfly, field multiply,
gather or transpose happens outside the kernel. The inverse transform uses
w^-1 and has 1/n folded into the cross tables. The outer cross table has n
elements (1 GiB at 2^27): it is built on the tensor's device by
log-doubling, not on the host. The device copies of all tables sit in a
cache bounded by bytes (`TABLE_CACHE_BYTES`), least recently used out first.

`colntt_plain` is one pass in plain PyTorch and `ntt_four_step_plain` the
whole transform by reshapes and transposes. `ntt_cuda` launches the kernel
for a CUDA tensor, runs the same strided passes through `colntt_plain` for
a CPU tensor (so the stride arithmetic is tested where there is no card)
and raises for anything else. `LAUNCHES` counts the launches.
"""

from __future__ import annotations

import collections
import threading

import torch

from .. import _build
from ..field import from_u64, gf_full, mul, power_series, square
from ..field.gl import add_plain, mul_plain, sub_plain
from ..spec import field as F
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
        t = mul_plain(v, tw[half - 1:2 * half - 1].reshape(1, 1, half, 1))
        x = torch.stack([add_plain(u, t), sub_plain(u, t)],
                        dim=2).reshape(B, L, C)
    if cross is not None:
        x = mul_plain(x, cross)
    return x


# ------------------------------------------------------------------ tables

# Device bytes the table cache may hold: the forward and the inverse set of
# one 2^27-point transform (an outer cross table of 1 GiB each, and the small
# tables) with room to spare, so that a caller that alternates `ntt` and
# `intt` at that size rebuilds neither.
TABLE_CACHE_BYTES = 3 << 30

_cache: "collections.OrderedDict" = collections.OrderedDict()
_cache_lock = threading.Lock()


def _nbytes(entry) -> int:
    return sum(t.numel() * t.element_size() for t in entry
               if isinstance(t, torch.Tensor))


def table_cache_bytes() -> int:
    """Bytes of device tables the cache holds now."""
    with _cache_lock:
        return sum(_nbytes(e) for e in _cache.values())


def clear_table_cache() -> None:
    with _cache_lock:
        _cache.clear()


def _cached(key, build):
    """The table set under `key`, built at first use. The cache keeps at
    most `TABLE_CACHE_BYTES` and drops the least recently used sets first;
    a set larger than the whole budget is handed out and not kept."""
    with _cache_lock:
        if key in _cache:
            _cache.move_to_end(key)
            return _cache[key]
    entry = build()
    size = _nbytes(entry)
    with _cache_lock:
        if size <= TABLE_CACHE_BYTES:
            _cache[key] = entry
            total = sum(_nbytes(e) for e in _cache.values())
            while total > TABLE_CACHE_BYTES:
                _, old = _cache.popitem(last=False)
                total -= _nbytes(old)
    return entry


def _tables(n: int, invert: bool, device: torch.device,
            max_l: int = tables.MAX_L):
    """(n1, n2, pass-1 twiddles, pass-2 twiddles, cross) on `device`."""
    def build():
        n1, n2, _, _, p1, p2, ctw = tables.tables_np(n, invert, max_l)
        return (n1, n2,
                from_u64(tables.pack_stage_tw(p2.T, n2), device),
                from_u64(tables.pack_stage_tw(p1.T, n1), device),
                from_u64(ctw, device))
    return _cached((n, invert, device, max_l), build)


def _outer_tables(n: int, invert: bool, device: torch.device,
                  max_l: int = tables.MAX_L):
    """(n3, n_inner, outer-pass twiddles, outer cross) on `device` for a
    three-level transform: cross[k3, c] = w^(k3*c) for c < n_inner, times
    1/n3 for the inverse (the inner transform's tables carry 1/n_inner).
    The cross has n elements, so it is made where it is used: row k3 is the
    power series of w^k3, all rows doubled together."""
    def build():
        n3, n_inner = tables.three_level_split(n, max_l)
        w = F.get_root_of_unity(n.bit_length() - 1)
        if invert:
            w = F.inv(w)
        base = power_series(w, n3, device=device).reshape(n3, 1)
        cross = gf_full((n3, 1), F.inv(n3) if invert else 1, device)
        while cross.shape[1] < n_inner:
            cross = torch.cat([cross, mul(cross, base)], dim=1)
            base = square(base)
        tw3 = from_u64(tables.radix2_twiddles(n3, invert), device)
        return n3, n_inner, tw3, cross
    return _cached((n, invert, device, max_l, "outer"), build)


def _two_pass(n: int, max_l: int) -> bool:
    log_n = n.bit_length() - 1
    return (log_n + 1) // 2 <= max_l.bit_length() - 1


def ntt_four_step_plain(x: torch.Tensor, invert: bool,
                        max_l: int = tables.MAX_L) -> torch.Tensor:
    """Natural-order (i)NTT over the last axis in plain passes: two where
    both fit `max_l`, else three."""
    shape = x.shape
    n = shape[-1]
    if n == 1:
        return x.clone()
    if _two_pass(n, max_l):
        n1, n2, tw2, tw1, ctw = _tables(n, invert, x.device, max_l)
        c = colntt_plain(x.reshape(-1, n2, n1), tw2, ctw)       # C[k2][j1]
        d = colntt_plain(c.transpose(1, 2), tw1, None)          # D[k1][k2]
        return d.reshape(shape)
    n3, n_inner, tw3, cross3 = _outer_tables(n, invert, x.device, max_l)
    n1, n2, tw2, tw1, ctw = _tables(n_inner, invert, x.device, max_l)
    a = colntt_plain(x.reshape(-1, n3, n_inner), tw3, cross3)   # [k3][j2 j1]
    c = colntt_plain(a.reshape(-1, n2, n1), tw2, ctw)           # [k3][k2][j1]
    d = colntt_plain(c.transpose(1, 2), tw1, None)              # [k3][k1][k2]
    d = d.reshape(-1, n3, n1, n2).permute(0, 2, 3, 1)           # [k1][k2][k3]
    return d.reshape(shape)


# ------------------------------------------------------------------ kernel

def _pass(src, dst, tw, cross, log_L, log_C, B, in_s, out_s, cross_ld):
    """One launch: B batches of (2^log_L, 2^log_C) tiles; `in_s` and `out_s`
    are the (batch, row, column) strides in elements."""
    log_TC = min(_LOG_MAX_TILE - log_L, log_C)
    _build.launch("gl_colntt", src.data_ptr(), dst.data_ptr(), tw.data_ptr(),
                  cross.data_ptr() if cross is not None else None,
                  log_L, log_TC, 1 << log_C, B, *in_s, *out_s, cross_ld,
                  torch.cuda.current_stream(src.device).cuda_stream)
    LAUNCHES["gl_colntt"] += 1


def _pass_plain(src, dst, tw, cross, log_L, log_C, B, in_s, out_s, cross_ld):
    """What one launch computes, in plain PyTorch on strided views."""
    shape = (B, 1 << log_L, 1 << log_C)
    if cross is not None:
        cross = torch.as_strided(cross, shape[1:], (cross_ld, 1))
    res = colntt_plain(
        torch.as_strided(src, shape, in_s, src.storage_offset()), tw, cross)
    torch.as_strided(dst, shape, out_s, dst.storage_offset()).copy_(res)


def _log(n: int) -> int:
    return n.bit_length() - 1


def ntt_cuda(x: torch.Tensor, invert: bool = False,
             max_l: int = tables.MAX_L) -> torch.Tensor:
    """Natural-order NTT (or iNTT) over the last axis of an int64 tensor
    (..., n), n a power of two: two launches up to max_l^2 points, beyond
    that two and one more for each batch row. A CPU tensor goes through the
    same passes with the same strides, each in plain PyTorch."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ntt_cuda: unsupported device {x.device}")
    n = x.shape[-1]
    if x.dtype != torch.int64 or not x.is_contiguous() or n & (n - 1):
        raise ValueError("ntt_cuda: needs a contiguous int64 tensor whose "
                         f"last axis is a power of two, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if max_l > tables.MAX_L:
        raise ValueError(f"ntt_cuda: a pass of {max_l} exceeds the kernel's "
                         f"{tables.MAX_L}")
    if n == 1:
        return x.clone()
    run = _pass if x.is_cuda else _pass_plain
    B = x.numel() // n
    mid = torch.empty_like(x)
    out = torch.empty_like(x)
    if _two_pass(n, max_l):
        n1, n2, tw2, tw1, ctw = _tables(n, invert, x.device, max_l)
        # pass 1: element (j2, j1) at j2*n1 + j1; cross ctw[k2, j1]
        run(x, mid, tw2, ctw, _log(n2), _log(n1), B, (n, n1, 1), (n, n1, 1),
            n1)
        # pass 2: element (j1, k2) of C at k2*n1 + j1; D[k1][k2] at k1*n2 + k2
        run(mid, out, tw1, None, _log(n1), _log(n2), B, (n, 1, n1),
            (n, n2, 1), 0)
        return out
    n3, ni, tw3, cross3 = _outer_tables(n, invert, x.device, max_l)
    n1, n2, tw2, tw1, ctw = _tables(ni, invert, x.device, max_l)
    # pass 1: element (j3, c) at j3*ni + c, c = j1 + n1*j2; cross3[k3, c]
    run(x, out, tw3, cross3, _log(n3), _log(ni), B, (n, ni, 1), (n, ni, 1),
        ni)
    # pass 2: every (batch row, k3) is a batch of the inner transform
    run(out, mid, tw2, ctw, _log(n2), _log(n1), B * n3, (ni, n1, 1),
        (ni, n1, 1), n1)
    # pass 3, one batch row a launch: batch k2, rows j1 -> k1, columns k3;
    # in (j1, k3) at k3*ni + k2*n1 + j1, out (k1, k3) at k1*n2*n3 + k2*n3 + k3
    src, dst = mid.view(B, n), out.view(B, n)
    for b in range(B):
        run(src[b], dst[b], tw1, None, _log(n1), _log(n3), n2, (n1, 1, ni),
            (n3, n2 * n3, 1), 0)
    return out
