"""Kernel 1: the Goldilocks NTT on the card (`csrc/ntt.cu`).

Replaces the TPU kernel `aero_tpu/ntt/ntt_pallas.py:131`/`:172` (the
column NTT `_colntt`, composed into a 4-step transform by `ntt_pallas`).
A size-n transform up to 2^24 points is two passes of one kernel, split
as `tables.tables_np` splits it (n = n1 * n2, both at most 4096):

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
gather or transpose happens outside the kernel. A pass runs in the radix-16
steps of `step_plan` over tiles of L x TC (`tile_log_cols`). The coset LDE
(`lde_cuda`) is the same transform of the zero-padded, offset-scaled
coefficients, whose first pass is the kernel's LDE entry: it reads the
coefficients where they lie, scales them as it loads them and skips the
stages that only copy, so no padded input exists.

The tables are made on the tensor's device, by log-doubling: a pass's
twiddles w_L^e (e < L), the cross tables (n elements, 1 GiB at 2^27) and
the LDE's offset powers. `tables.tables_np` is the plain version they are
tested against. They sit in a cache bounded by bytes (`TABLE_CACHE_BYTES`),
least recently used out first; each build is a tracing span
("ntt_tables").

`colntt_plain` is one pass in plain PyTorch, in the kernel's steps, and
`ntt_four_step_plain` the whole transform by reshapes and transposes.
`ntt_cuda` and `lde_cuda` launch the kernel for a CUDA tensor, run the same
strided passes through `colntt_plain` a column tile at a time for a CPU
tensor (so the stride arithmetic and the tile plan are tested where there
is no card) and raise for anything else. `LAUNCHES` counts the launches.
"""

from __future__ import annotations

import collections
import threading

import torch

from .. import _build
from ..field import gf_full, mul, power_series, square
from ..field.gl import add_plain, mul_plain, sub_plain
from ..spec import field as F
from .._device import synchronize
from ..utils.tracing import span
from . import tables

LAUNCHES = {"gl_colntt": 0, "gl_colntt_lde": 0}

_LOG_TILE = 13              # tiles of 2^13 elements (csrc/ntt.cu allows 2^14)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _log(n: int) -> int:
    return n.bit_length() - 1


# ------------------------------------------------------------ the tile plan

def step_plan(log_L: int) -> list:
    """The radix-2^r steps of a size-2^log_L pass (csrc/ntt.cu): a first
    step of log_L - 4(K-1) stages, then radix-16 steps."""
    k = max(1, -(-log_L // 4))
    return [log_L - 4 * (k - 1)] + [4] * (k - 1)


def tile_log_cols(log_L: int, log_C: int) -> int:
    """log2 of the columns a block takes: L * TC = 2^_LOG_TILE where the
    C columns allow, so that a row of a tile spans whole 32-byte sectors."""
    return min(_LOG_TILE - log_L, log_C)


def zero_stages(n: int, L: int, C: int) -> int:
    """Stages of an LDE's first step that only copy: the padded (L, C)
    matrix holds the n coefficients in its first max(n / C, 1) rows, so
    after the bit-reversed load a group of the first step has 2^(r - z)
    nonzero inputs, z <= r."""
    rows = max(n // C, 1)
    return min(step_plan(_log(L))[0], _log(L // rows))


# ----------------------------------------------------------- plain version

def colntt_plain(x: torch.Tensor, tw: torch.Tensor,
                 cross: torch.Tensor | None, z: int = 0) -> torch.Tensor:
    """One pass, as the kernel computes it: x (B, L, C) -> size-L NTT down
    axis 1 of every column (rows read bit-reversed), times cross (L, C).
    tw[e] = w_L^e. The steps of `step_plan`: a step after the first
    multiplies element m of group (hi, lo) by w_T^(rev(m) lo), then a
    radix-2 DIT over its 2^r elements. z: the first step's leading stages
    copy (the LDE's first pass; rows >= L >> z of x are zero)."""
    B, L, C = x.shape
    lg = _log(L)
    rev = torch.as_tensor(tables.bitrev(lg).astype("int64"), device=x.device)
    a = x[:, rev, :]
    s0 = 0
    for k, r in enumerate(step_plan(lg)):
        R, S = 1 << r, 1 << s0
        T = R * S
        v = a.reshape(B, L // T, R, S, C)
        if s0:
            rr = torch.as_tensor(tables.bitrev(r).astype("int64"),
                                 device=x.device)
            e = rr[:, None] * torch.arange(S, device=x.device)[None, :]
            v = mul_plain(v, tw[e * (L // T)].reshape(1, 1, R, S, 1))
        zk = z if k == 0 else 0
        if zk:
            v = v.reshape(B, L // T, R >> zk, 1 << zk, S, C)[:, :, :, :1]
            v = v.expand(B, L // T, R >> zk, 1 << zk, S, C)
        for t in range(zk, r):
            half = 1 << t
            vv = v.reshape(B, L // T, R // (2 * half), 2, half, S, C)
            u, w = vv[:, :, :, 0], vv[:, :, :, 1]
            tws = tw[torch.arange(half, device=x.device) * (L // (2 * half))]
            w = mul_plain(w, tws.reshape(1, 1, 1, half, 1, 1))
            v = torch.stack([add_plain(u, w), sub_plain(u, w)], dim=3)
        a = v.reshape(B, L, C)
        s0 += r
    if cross is not None:
        a = mul_plain(a, cross)
    return a


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
    # a span of its own, closed by a synchronize: what a cold proof's stage
    # spends building tables
    with span("ntt_tables"):
        entry = build()
        for t in entry:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                synchronize(t.device)
    size = _nbytes(entry)
    with _cache_lock:
        if size <= TABLE_CACHE_BYTES:
            _cache[key] = entry
            total = sum(_nbytes(e) for e in _cache.values())
            while total > TABLE_CACHE_BYTES:
                _, old = _cache.popitem(last=False)
                total -= _nbytes(old)
    return entry


def _root(n: int, invert: bool) -> int:
    w = F.get_root_of_unity(_log(n))
    return F.inv(w) if invert else w


def _cross(w: int, rows: int, cols: int, scale: int,
           device: torch.device) -> torch.Tensor:
    """(rows, cols): scale * w^(r*c), made on `device` by log-doubling over
    the columns (row r is the power series of w^r)."""
    base = power_series(w, rows, device=device).reshape(rows, 1)
    cross = gf_full((rows, 1), scale, device)
    while cross.shape[1] < cols:
        cross = torch.cat([cross, mul(cross, base)], dim=1)
        base = square(base)
    return cross


def _tables(n: int, invert: bool, device: torch.device,
            max_l: int = tables.MAX_L):
    """(n1, n2, pass-1 twiddles, pass-2 twiddles, cross) of the two-pass
    transform (`tables.tables_np`'s split), made on `device`: the pass
    tables are w_L^e for e < L, the cross ctw[k2, j1] = w^(j1*k2) (times
    1/n for the inverse)."""
    def build():
        n1, n2 = tables.two_pass_split(n, max_l)
        w = _root(n, invert)
        return (n1, n2, power_series(pow(w, n1, F.P), n2, device=device),
                power_series(pow(w, n2, F.P), n1, device=device),
                _cross(w, n2, n1, F.inv(n) if invert else 1, device))
    return _cached((n, invert, device, max_l), build)


def _outer_tables(n: int, invert: bool, device: torch.device,
                  max_l: int = tables.MAX_L):
    """(n3, n_inner, outer-pass twiddles, outer cross) on `device` for a
    three-level transform: cross[k3, c] = w^(k3*c) for c < n_inner, times
    1/n3 for the inverse (the inner transform's tables carry 1/n_inner).
    The cross has n elements (1 GiB at 2^27)."""
    def build():
        n3, n_inner = tables.three_level_split(n, max_l)
        w = _root(n, invert)
        return (n3, n_inner,
                power_series(pow(w, n_inner, F.P), n3, device=device),
                _cross(w, n3, n_inner, F.inv(n3) if invert else 1, device))
    return _cached((n, invert, device, max_l, "outer"), build)


def _lde_tables(offset: int, L: int, C: int, device: torch.device):
    """(rowpow, colpow) of an LDE's first pass over the padded (L, C)
    matrix: offset^(C*r) for r < L and offset^c for c < C, so that
    coefficient i = r*C + c is scaled by colpow[c] * rowpow[r]."""
    def build():
        return (power_series(pow(offset, C, F.P), L, device=device),
                power_series(offset, C, device=device))
    return _cached((offset % F.P, L, C, device, "lde"), build)


def _two_pass(n: int, max_l: int) -> bool:
    return len(tables.pass_lengths(n, max_l)) < 3


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

def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _pass(src, dst, tw, cross, log_L, log_C, B, in_s, out_s, cross_ld):
    """One launch: B batches of (2^log_L, 2^log_C) tiles; `in_s` and `out_s`
    are the (batch, row, column) strides in elements."""
    _build.launch("gl_colntt", src.data_ptr(), dst.data_ptr(), tw.data_ptr(),
                  cross.data_ptr() if cross is not None else None,
                  log_L, tile_log_cols(log_L, log_C), 1 << log_C, B, *in_s,
                  *out_s, cross_ld, _stream(src))
    LAUNCHES["gl_colntt"] += 1


def _column_tiles(log_L, log_C):
    """The column ranges of the kernel's blocks, in order."""
    tc = 1 << tile_log_cols(log_L, log_C)
    return [(c0, c0 + tc) for c0 in range(0, 1 << log_C, tc)]


def _pass_plain(src, dst, tw, cross, log_L, log_C, B, in_s, out_s, cross_ld):
    """What one launch computes, in plain PyTorch on strided views, a
    column tile of the kernel's plan at a time."""
    shape = (B, 1 << log_L, 1 << log_C)
    x = torch.as_strided(src, shape, in_s, src.storage_offset())
    y = torch.as_strided(dst, shape, out_s, dst.storage_offset())
    if cross is not None:
        cross = torch.as_strided(cross, shape[1:], (cross_ld, 1))
    for a, b in _column_tiles(log_L, log_C):
        y[:, :, a:b].copy_(colntt_plain(
            x[:, :, a:b], tw, cross[:, a:b] if cross is not None else None))


def _pass_lde(coef, dst, tw, cross, rowpow, colpow, log_L, log_C, B, n, z,
              out_s, cross_ld):
    """One launch of the LDE's first pass: B rows of n coefficients, read
    as the zero-padded (2^log_L, 2^log_C) matrix without its padding."""
    _build.launch("gl_colntt_lde", coef.data_ptr(), dst.data_ptr(),
                  tw.data_ptr(), cross.data_ptr(), rowpow.data_ptr(),
                  colpow.data_ptr(), log_L, tile_log_cols(log_L, log_C),
                  1 << log_C, B, n, z, *out_s, cross_ld, _stream(coef))
    LAUNCHES["gl_colntt_lde"] += 1


def _pass_lde_plain(coef, dst, tw, cross, rowpow, colpow, log_L, log_C, B,
                    n, z, out_s, cross_ld):
    """What one launch of the LDE's first pass computes: the nonzero rows
    of the padded matrix, scaled, then `colntt_plain` with its z copy
    stages."""
    L, C = 1 << log_L, 1 << log_C
    rows = max(n // C, 1)
    scaled = torch.zeros((B, rows * C), dtype=torch.int64, device=coef.device)
    scaled[:, :n] = coef.reshape(B, n)
    scaled = mul_plain(mul_plain(scaled.reshape(B, rows, C), colpow[:C]),
                       rowpow[:rows].reshape(rows, 1))
    x = torch.zeros((B, L, C), dtype=torch.int64, device=coef.device)
    x[:, :rows] = scaled
    y = torch.as_strided(dst, (B, L, C), out_s, dst.storage_offset())
    cross = torch.as_strided(cross, (L, C), (cross_ld, 1))
    for a, b in _column_tiles(log_L, log_C):
        y[:, :, a:b].copy_(colntt_plain(x[:, :, a:b], tw, cross[:, a:b], z))


def _check(x: torch.Tensor, who: str, max_l: int) -> None:
    n = x.shape[-1]
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {x.device}")
    if x.dtype != torch.int64 or not x.is_contiguous() or n & (n - 1):
        raise ValueError(f"{who}: needs a contiguous int64 tensor whose "
                         f"last axis is a power of two, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if max_l > tables.MAX_L:
        raise ValueError(f"{who}: a pass of {max_l} exceeds the kernel's "
                         f"{tables.MAX_L}")


def _passes(x, n, B, invert, max_l, first):
    """The transform's launches after its first: `first(dst, tw, cross,
    log_L, log_C, out_s, cross_ld)` makes the first pass, whose input is
    x (or the coefficients it stands for). Returns the natural-order
    output (B, n)."""
    run = _pass if x.is_cuda else _pass_plain
    mid = torch.empty((B, n), dtype=torch.int64, device=x.device)
    out = torch.empty((B, n), dtype=torch.int64, device=x.device)
    if _two_pass(n, max_l):
        n1, n2, tw2, tw1, ctw = _tables(n, invert, x.device, max_l)
        # pass 1: element (j2, j1) at j2*n1 + j1; cross ctw[k2, j1]
        first(mid, tw2, ctw, _log(n2), _log(n1), (n, n1, 1), n1)
        # pass 2: element (j1, k2) of C at k2*n1 + j1; D[k1][k2] at k1*n2 + k2
        run(mid, out, tw1, None, _log(n1), _log(n2), B, (n, 1, n1),
            (n, n2, 1), 0)
        return out
    n3, ni, tw3, cross3 = _outer_tables(n, invert, x.device, max_l)
    n1, n2, tw2, tw1, ctw = _tables(ni, invert, x.device, max_l)
    # pass 1: element (j3, c) at j3*ni + c, c = j1 + n1*j2; cross3[k3, c]
    first(out, tw3, cross3, _log(n3), _log(ni), (n, ni, 1), ni)
    # pass 2: every (batch row, k3) is a batch of the inner transform
    run(out, mid, tw2, ctw, _log(n2), _log(n1), B * n3, (ni, n1, 1),
        (ni, n1, 1), n1)
    # pass 3, one batch row a launch: batch k2, rows j1 -> k1, columns k3;
    # in (j1, k3) at k3*ni + k2*n1 + j1, out (k1, k3) at k1*n2*n3 + k2*n3 + k3
    for b in range(B):
        run(mid[b], out[b], tw1, None, _log(n1), _log(n3), n2, (n1, 1, ni),
            (n3, n2 * n3, 1), 0)
    return out


def ntt_cuda(x: torch.Tensor, invert: bool = False,
             max_l: int = tables.MAX_L) -> torch.Tensor:
    """Natural-order NTT (or iNTT) over the last axis of an int64 tensor
    (..., n), n a power of two: two launches up to max_l^2 points, beyond
    that two and one more for each batch row. A CPU tensor goes through the
    same passes with the same strides, each in plain PyTorch."""
    _check(x, "ntt_cuda", max_l)
    n = x.shape[-1]
    if n == 1:
        return x.clone()
    B = x.numel() // n
    run = _pass if x.is_cuda else _pass_plain

    def first(dst, tw, cross, log_L, log_C, out_s, cross_ld):
        run(x, dst, tw, cross, log_L, log_C, B, out_s, out_s, cross_ld)

    return _passes(x, n, B, invert, max_l, first).reshape(x.shape)


def lde_cuda(coeffs: torch.Tensor, log_blowup: int,
             offset: int = F.DOMAIN_OFFSET,
             max_l: int = tables.MAX_L) -> torch.Tensor:
    """Coset LDE of coefficient rows (..., n): the evaluations over
    offset * <w_m>, m = n << log_blowup, in natural order. The transform
    of the zero-padded, offset-scaled rows of m points, whose first pass
    (`gl_colntt_lde`) reads the n coefficients where they lie: nothing is
    padded. A CPU tensor takes the same passes in plain PyTorch."""
    _check(coeffs, "lde_cuda", max_l)
    n = coeffs.shape[-1]
    m = n << log_blowup
    shape = coeffs.shape[:-1] + (m,)
    if m == 1:
        return coeffs.clone()
    B = coeffs.numel() // n
    lde_run = _pass_lde if coeffs.is_cuda else _pass_lde_plain

    def first(dst, tw, cross, log_L, log_C, out_s, cross_ld):
        L, C = 1 << log_L, 1 << log_C
        rowpow, colpow = _lde_tables(offset, L, C, coeffs.device)
        lde_run(coeffs, dst, tw, cross, rowpow, colpow, log_L, log_C, B, n,
                zero_stages(n, L, C), out_s, cross_ld)

    return _passes(coeffs, m, B, False, max_l, first).reshape(shape)
