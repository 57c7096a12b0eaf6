"""The field-algebra kernels on the card (`csrc/field.cu`).

Four kernels stand where `aero_tpu` had XLA fuse its limb algebra
(`aero_tpu/field/jax_gl.py`) under `jax.jit`; none has a Pallas
counterpart:

- K1 `gl_elementwise`: add, sub, mul mod p of two operands, or a^e for a
  host exponent e (`jax_gl.add / sub / mul / pow_loop`);
- K2 `gl_scan`: inclusive prefix sum or product along the last axis
  (`lax.associative_scan` under `gf_cumsum`, `gf_cumprod`), one launch
  after a memset of its scratch, a single pass with decoupled look-back;
  and `gl_batch_inv`, Montgomery's
  batch inversion along the last axis (`jax_gl.batch_inv`), one call of
  three launches;
- K4 `gl_deep_combine`: one fragment's DEEP quotient from its LDE rows
  (`_deep_core_jit`, `prover.py:556-589`);
- K5 `<air>_frag_eval`: one fragment's constraint evaluation and merge in
  one pass, a kernel generated for each AIR class from its own constraints
  (`air/codegen.py`, `csrc/frag_eval.cuh`): the whole of
  `jax.jit(frag_fn)`, `prover.py:407-446`;
- K6 `<air>_aux_factors`: the per-row bus factors of an AIR's aux build, a
  kernel generated from the row function (`MidenAir`'s
  `_bus_row_factors`) by the same generator: `_aux_factors_jit`,
  `aero_tpu/air/miden.py:1073`;
- K7 `gl_eval_multi` (`csrc/eval_multi.cu`): coefficient rows evaluated at
  a few points, one call of two launches: `power_series_dyn` and
  `_eval_multi_core`, `aero_tpu/field/jax_gl.py:437`, `:456`.

The wrappers here take CUDA tensors only; `field/gl.py` and
`prover/prover.py` send a CPU tensor to the plain versions beside them
(`add_plain`, `constraint_merge_plain`, ...). `on_cuda` decides and raises
on what no path takes. Every launch goes on the current stream and adds one
to `LAUNCHES` under its kernel's name; `gl_elementwise_copies` counts the
operands K1, K4 or K5 had to copy first (a broadcast or stride that the
kernel's indexing does not cover), so a profile shows how often that fires.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import _build
from .sym import P

LAUNCHES = {"gl_elementwise": 0, "gl_scan": 0, "gl_batch_inv": 0,
            "gl_deep_combine": 0,
            **{f"{n}_frag_eval": 0 for n in _build.FRAG_EVAL_AIRS},
            **{f"{n}_aux_factors": 0 for n in _build.ROW_EVAL_AIRS},
            "gl_eval_multi": 0, "gl_elementwise_copies": 0}

ADD, SUB, MUL, POW = 0, 1, 2, 3          # csrc/field.cu `Op`
SCAN_TILE = 4096                         # csrc/field.cu kScanTile
INV_TILE = 2048                          # csrc/field.cu kInvTile
# csrc/eval_multi.cu: a block's threads, a thread's coefficients of a row,
# the row blocks and points a call takes, the bits of z's power table
EVAL_THREADS, EVAL_STEPS = 256, 32
EVAL_MAX_BLOCKS, EVAL_MAX_POINTS, EVAL_POW_BITS = 4, 4, 32
MODE_FULL, MODE_ONE, MODE_STRIDED = 0, 1, 2


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def on_cuda(*operands) -> bool:
    """False when no operand is a CUDA tensor (the plain version takes the
    call); True when every operand is an int64 tensor on one CUDA device;
    raises for anything else (mixed devices, another device type, another
    dtype on the card, a Python number beside a CUDA tensor)."""
    tensors = [t for t in operands if isinstance(t, torch.Tensor)]
    for t in tensors:
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"field: unsupported device {t.device}")
    if not any(t.is_cuda for t in tensors):
        return False
    dev = next(t.device for t in tensors if t.is_cuda)
    for t in operands:
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"field: every operand of a card call must be a "
                             f"tensor on {dev}, got {_what(t)}")
        if t.dtype != torch.int64:
            raise ValueError(f"field: needs int64 tensors, got {t.dtype}")
    return True


def _what(t) -> str:
    if isinstance(t, torch.Tensor):
        return f"a {t.dtype} tensor on {t.device}"
    return type(t).__name__


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------- K1

def operand_plan(shape, stride, out_shape) -> Optional[tuple]:
    """How K1 reads an operand of `shape` / `stride` (elements) broadcast to
    `out_shape`: (mode, d1, s1, m0, s0), element i of the output at
    (i // d1) * s1 + (i % m0) * s0 in MODE_STRIDED; None where the view
    does not collapse to two dims (the wrapper then copies)."""
    nd = len(out_shape)
    shape = (1,) * (nd - len(shape)) + tuple(shape)
    stride = (0,) * (nd - len(stride)) + tuple(stride)
    dims: List[list] = []               # [size, stride], innermost first
    for size, own, st in reversed(list(zip(out_shape, shape, stride))):
        if size == 1:
            continue
        st = st if own == size else 0   # a broadcast dim reads one place
        if dims and st == dims[-1][1] * dims[-1][0]:
            dims[-1][0] *= size
        else:
            dims.append([size, st])
    if not dims or (len(dims) == 1 and dims[0][1] == 0):
        return (MODE_ONE, 1, 0, 1, 0)
    if len(dims) == 1:
        if dims[0][1] == 1:
            return (MODE_FULL, 1, 0, 1, 0)
        return (MODE_STRIDED, 1, dims[0][1], 1, 0)
    if len(dims) == 2:
        (n0, s0), (_, s1) = dims
        return (MODE_STRIDED, n0, s1, n0, s0)
    return None


def _operand(t: torch.Tensor, out_shape, keep: list) -> tuple:
    """(pointer, mode, d1, s1, m0, s0) of K1's operand `t`."""
    plan = operand_plan(t.shape, t.stride(), out_shape)
    if plan is None:
        t = t.expand(out_shape).contiguous()
        keep.append(t)
        LAUNCHES["gl_elementwise_copies"] += 1
        plan = (MODE_FULL, 1, 0, 1, 0)
    return (t.data_ptr(),) + plan


_UNUSED = (None, MODE_ONE, 1, 0, 1, 0)


def elementwise(a: torch.Tensor, b: torch.Tensor, op: int) -> torch.Tensor:
    """a op b mod p (op ADD, SUB or MUL), broadcast as torch broadcasts,
    into a new contiguous tensor: one launch of K1."""
    if op not in (ADD, SUB, MUL):
        raise ValueError(f"elementwise: unknown op {op}")
    shape = torch.broadcast_shapes(a.shape, b.shape)
    out = torch.empty(shape, dtype=torch.int64, device=a.device)
    if out.numel() == 0:
        return out
    keep: list = []
    _build.launch("gl_elementwise", *_operand(a, shape, keep),
                  *_operand(b, shape, keep), out.data_ptr(), out.numel(), op,
                  0, _stream(a))
    LAUNCHES["gl_elementwise"] += 1
    return out


def power(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e mod p for a host exponent 0 <= e < 2^64 (a^0 is 1), square and
    multiply in the kernel: one launch of K1."""
    if not 0 <= e < 1 << 64:
        raise ValueError(f"power: exponent {e} outside [0, 2^64)")
    out = torch.empty(a.shape, dtype=torch.int64, device=a.device)
    if out.numel() == 0:
        return out
    keep: list = []
    _build.launch("gl_elementwise", *_operand(a, a.shape, keep), *_UNUSED,
                  out.data_ptr(), out.numel(), POW, e, _stream(a))
    LAUNCHES["gl_elementwise"] += 1
    return out


# ---------------------------------------------------------------------- K2

def _rows(x: torch.Tensor, what: str) -> tuple:
    """(x contiguous, rows, n) for K2 along the last axis of `x`, a CUDA
    int64 tensor with at least one dim; a view that is not contiguous is
    copied first and counted."""
    if not on_cuda(x) or x.dim() == 0:
        raise ValueError(f"{what}: needs a CUDA tensor with at least one "
                         f"dim, got {_what(x)} of {x.dim()} dims")
    if not x.is_contiguous():
        x = x.contiguous()
        LAUNCHES["gl_elementwise_copies"] += 1
    n = x.shape[-1]
    return x, (x.numel() // n if n else 0), n


def tiles(rows: int, n: int, tile: int) -> int:
    """Tiles of `tile` elements that K2 takes for (rows, n)."""
    return rows * -(-n // tile)


def scan_scratch_words(rows: int, n: int) -> int:
    """int64 words of `gl_scan`'s scratch (csrc/field.cu
    `scan_scratch_words`): the ticket, then two values a tile."""
    return 1 + 2 * tiles(rows, n, SCAN_TILE)


def scan(x: torch.Tensor, op: int) -> torch.Tensor:
    """Inclusive prefix sum (op ADD) or product (op MUL) mod p along the
    last axis: one launch of `gl_scan` over every row."""
    if op not in (ADD, MUL):
        raise ValueError(f"scan: unknown op {op}")
    x, rows, n = _rows(x, "scan")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    words = scan_scratch_words(rows, n)
    scratch = torch.empty(words, dtype=torch.int64, device=x.device)
    _build.launch("gl_scan", x.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), words, rows, n, op, _stream(x))
    LAUNCHES["gl_scan"] += 1
    return out


def batch_inv(x: torch.Tensor) -> torch.Tensor:
    """1 / x mod p along the last axis, a row with a zero all zero (the rule
    of `jax_gl.batch_inv`): one call of `gl_batch_inv`, three launches (the
    tiles' products, each row's factors, the tiles' inverses)."""
    x, rows, n = _rows(x, "batch_inv")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    words = 2 * tiles(rows, n, INV_TILE)
    scratch = torch.empty(words, dtype=torch.int64, device=x.device)
    _build.launch("gl_batch_inv", x.data_ptr(), out.data_ptr(),
                  scratch.data_ptr(), words, rows, n, _stream(x))
    LAUNCHES["gl_batch_inv"] += 3
    return out


# --------------------------------------- rows, arrays and vectors of K4-K6

def _row(t: torch.Tensor, m: int, keep: list) -> int:
    """The pointer of `t` as m contiguous elements, copied first if it is
    a broadcast or a strided view."""
    if tuple(t.shape) != (m,) or (m > 1 and t.stride(0) != 1):
        t = t.expand(m).contiguous()
        keep.append(t)
        LAUNCHES["gl_elementwise_copies"] += 1
    return t.data_ptr()


def _dense(t: torch.Tensor, numel: int, what: str) -> int:
    """The pointer of a contiguous tensor of `numel` elements."""
    if t.numel() != numel or not t.is_contiguous():
        raise ValueError(f"{what}: needs {numel} contiguous elements, got "
                         f"{tuple(t.shape)}")
    return t.data_ptr()


def device_vector(values: Sequence[int], device) -> torch.Tensor:
    """Field elements (ints) as a device int64 array of their canonical bit
    patterns, copied from pinned host memory without waiting for the
    stream."""
    canon = [int(v) % P for v in values]
    host = torch.tensor([v - (1 << 64) if v >= 1 << 63 else v
                         for v in canon], dtype=torch.int64).pin_memory()
    return host.to(device, non_blocking=True)


# ---------------------------------------------------------------------- K4

def _matrix(t: Optional[torch.Tensor], m: int, keep: list) -> tuple:
    """(pointer, row stride, rows) of a (w, m) view whose rows are
    contiguous; other views are copied first."""
    if t is None:
        return None, 0, 0
    if t.dim() != 2 or t.shape[1] != m:
        raise ValueError(f"deep_combine: needs (w, {m}) rows, got "
                         f"{tuple(t.shape)}")
    if t.stride(1) != 1 and m > 1:
        t = t.contiguous()
        keep.append(t)
        LAUNCHES["gl_elementwise_copies"] += 1
    return t.data_ptr(), t.stride(0), t.shape[0]


def deep_combine(main_lde, aux_lde, constraint_lde, x_dom, cur, nxt, ood,
                 a_vec, b_vec, c_vec, dinv, lam, mu) -> torch.Tensor:
    """K4 over one fragment of m points: the LDE rows (w, m) are read at
    their own row stride (fragments of the whole domain, no copy); `dinv`
    (3, m) are the inverses of x - z, x - zg, x - z^ce; `lam`, `mu` single
    elements."""
    m = x_dom.shape[-1]
    on_cuda(main_lde, constraint_lde, x_dom, cur, nxt, ood, a_vec, b_vec,
            c_vec, dinv, lam, mu, *([aux_lde] if aux_lde is not None else []))
    keep: list = []
    mp, mld, wm = _matrix(main_lde, m, keep)
    ap, ald, wa = _matrix(aux_lde, m, keep)
    cp, cld, wc = _matrix(constraint_lde, m, keep)
    dp, dld, wd = _matrix(dinv, m, keep)
    if wd != 3 or lam.numel() != 1 or mu.numel() != 1:
        raise ValueError("deep_combine: needs three divisor rows and "
                         "single-element lam, mu")
    vecs = [_dense(v, n, "deep_combine")
            for v, n in ((cur, wm + wa), (nxt, wm + wa), (ood, wc),
                         (a_vec, wm + wa), (b_vec, wm + wa), (c_vec, wc))]
    out = torch.empty(m, dtype=torch.int64, device=x_dom.device)
    _build.launch("gl_deep_combine", mp, mld, wm, ap, ald, wa, cp, cld, wc,
                  *vecs, dp, dld, _row(x_dom, m, keep), lam.data_ptr(),
                  mu.data_ptr(), out.data_ptr(), m, _stream(x_dom))
    LAUNCHES["gl_deep_combine"] += 1
    return out


# ---------------------------------------------------------------------- K5

def _rows_in_place(t: Optional[torch.Tensor], m: int, what: str,
                   keep: list) -> tuple:
    """(pointer, row stride) of a (w, m) view read in place; a view whose
    rows are not contiguous is copied first and counted."""
    if t is None:
        return None, 0
    if t.dim() != 2 or t.shape[1] != m:
        raise ValueError(f"{what}: needs (w, {m}) rows, got "
                         f"{tuple(t.shape)}")
    if t.stride(1) != 1 and m > 1:
        t = t.contiguous()
        keep.append(t)
        LAUNCHES["gl_elementwise_copies"] += 1
    return t.data_ptr(), t.stride(0)


class XPow(NamedTuple):
    """What K5 makes a point's x^adj values from (`csrc/frag_eval.cuh`
    `XPow`): x = offset w^i at domain position i, w of order `m_dom` (a
    power of two), so x^adj = offset^adj w^k, k = adj i mod m_dom, and
    w^k = lo[k mod len(lo)] hi[k // len(lo)]. Row r of `pw` (X, 2) holds
    slot r's adj mod m_dom and offset^adj: the degree classes' slots first,
    then the assertions'. `first` is the domain position of the fragment's
    point 0."""
    lo: torch.Tensor        # (2^h,) w^j
    hi: torch.Tensor        # (m_dom >> h,) w^(j 2^h)
    pw: torch.Tensor        # (X, 2)
    m_dom: int
    first: int


def _next_frame(f, m: int, what: str, keep: list) -> tuple:
    """(body pointer, body stride, tail pointer, tail stride, points in the
    body) of a next-row frame: a (w, m) view, or a (body, tail) pair of
    views whose points add up to m, each read where it lies."""
    if not isinstance(f, tuple):
        return (*_rows_in_place(f, m, what, keep), None, 0, m)
    body, tail = f
    nb = body.shape[-1]
    if body.shape[0] != tail.shape[0] or nb + tail.shape[-1] != m:
        raise ValueError(f"{what}: a frame's body {tuple(body.shape)} and "
                         f"tail {tuple(tail.shape)} are not {m} points")
    return (*_rows_in_place(body, nb, what, keep),
            *_rows_in_place(tail, m - nb, what, keep), nb)


def frag_eval(name: str, frames, rands, cc_t, cc_b, bvals, zt, dinv,
              xpow: XPow, idx, n_constraints: int, transitions: bool = False
              ) -> torch.Tensor:
    """K5 for AIR `name` over one fragment of m points: `frames` the four
    views main at x, main at x g, aux at x, aux at x g (aux None without an
    aux segment), (w, m) each, read in place at their row stride; a frame
    at x g may instead be a (body, tail) pair, (w, nb) and (w, m - nb), the
    two pieces where it runs past the end of the domain, each read where it
    lies. `rands` (R,), `cc_t` (T, 2), `cc_b` (B, 2), `bvals` (B,), `zt`
    (m,), `dinv` (D, m) rows, `xpow` the x^adj tables (`XPow`), `idx` the
    int32 table of `csrc/frag_eval.cuh` `MergeArgs`. Returns the merged row
    (m,), or with `transitions` the T constraint values (T, m). One
    launch."""
    key = f"{name}_frag_eval"
    if key not in LAUNCHES:
        raise ValueError(f"frag_eval: no generated kernel {key}")
    m = zt.shape[-1]
    present = [t for f in frames if f is not None
               for t in (f if isinstance(f, tuple) else (f,))]
    on_cuda(zt, rands, cc_t, cc_b, bvals, dinv, xpow.lo, xpow.hi, xpow.pw,
            *present)
    if idx.dtype != torch.int32 or idx.device != zt.device:
        raise ValueError("frag_eval: idx must be int32 on the card")
    B = bvals.shape[0]
    keep: list = []
    main_cur, main_nxt, aux_cur, aux_nxt = frames
    mn = _next_frame(main_nxt, m, "frag_eval", keep)
    an = ((None, 0, None, 0, mn[4]) if aux_nxt is None
          else _next_frame(aux_nxt, m, "frag_eval", keep))
    if mn[4] != an[4]:
        raise ValueError("frag_eval: the main and aux frames at x g are cut "
                         "at different points")
    rows = [*_rows_in_place(main_cur, m, "frag_eval", keep), *mn[:2],
            *_rows_in_place(aux_cur, m, "frag_eval", keep), *an[:2],
            *mn[2:4], *an[2:4], mn[4]]
    dp, dld = _rows_in_place(dinv, m, "frag_eval", keep)
    n_lo = xpow.lo.shape[0]
    shape = (n_constraints, m) if transitions else (m,)
    out = torch.empty(shape, dtype=torch.int64, device=zt.device)
    _build.launch(key, *rows, _dense(rands, rands.numel(), "frag_eval"),
                  _dense(cc_t, 2 * n_constraints, "frag_eval"),
                  _dense(cc_b, 2 * B, "frag_eval"),
                  _dense(bvals, B, "frag_eval"), _row(zt, m, keep), dp, dld,
                  _dense(xpow.lo, n_lo, "frag_eval"),
                  _dense(xpow.hi, xpow.m_dom // n_lo, "frag_eval"),
                  _dense(xpow.pw, xpow.pw.numel(), "frag_eval"),
                  xpow.pw.shape[0], n_lo.bit_length() - 1, xpow.m_dom,
                  xpow.first, _dense(idx, idx.numel(), "frag_eval"), B,
                  out.data_ptr(), m, int(transitions), _stream(zt))
    LAUNCHES[key] += 1
    return out


# ---------------------------------------------------------------------- K6

def aux_factors(name: str, trace: torch.Tensor, rands: torch.Tensor,
                n_outputs: int) -> torch.Tensor:
    """K6 of AIR `name` over the (width, n) main trace, read in place at its
    row stride (row i and row (i + 1) mod n), with `rands` (R,): the
    (n_outputs, n) per-row values. One launch."""
    key = f"{name}_aux_factors"
    if key not in LAUNCHES:
        raise ValueError(f"aux_factors: no generated kernel {key}")
    if not on_cuda(trace, rands):
        raise ValueError("aux_factors: needs CUDA tensors (the plain "
                         "version takes a CPU trace)")
    n = trace.shape[-1]
    keep: list = []
    ptr, stride = _rows_in_place(trace, n, "aux_factors", keep)
    out = torch.empty((n_outputs, n), dtype=torch.int64, device=trace.device)
    _build.launch(key, ptr, stride, _dense(rands, rands.numel(),
                                           "aux_factors"),
                  out.data_ptr(), n, _stream(trace))
    LAUNCHES[key] += 1
    return out


# ---------------------------------------------------------------------- K7

def eval_chunks(n: int) -> int:
    """Blocks of coefficients K7 takes along a row of n."""
    return -(-n // (EVAL_THREADS * EVAL_STEPS))


def power_table(zs) -> np.ndarray:
    """(k, EVAL_POW_BITS) uint64: z^(2^b) of each point, the table K7
    makes its powers from."""
    out = np.zeros((len(zs), EVAL_POW_BITS), dtype=np.uint64)
    for t, z in enumerate(zs):
        v = int(z) % P
        for b in range(EVAL_POW_BITS):
            out[t, b] = v
            v = v * v % P
    return out


def eval_multi(blocks: Sequence[torch.Tensor], zs) -> torch.Tensor:
    """K7: the rows of `blocks` ((w_i, n) each, read in place at their row
    stride, in order) evaluated at each of the k <= 4 points `zs`, as
    (k, sum w_i). One call, two launches (the blocks' partial sums, their
    fold)."""
    blocks = list(blocks)
    if not 1 <= len(blocks) <= EVAL_MAX_BLOCKS:
        raise ValueError(f"eval_multi: takes 1 to {EVAL_MAX_BLOCKS} row "
                         f"blocks, got {len(blocks)}")
    if not 1 <= len(zs) <= EVAL_MAX_POINTS:
        raise ValueError(f"eval_multi: takes 1 to {EVAL_MAX_POINTS} points, "
                         f"got {len(zs)}")
    if not on_cuda(*blocks):
        raise ValueError("eval_multi: needs CUDA tensors (the plain "
                         "version takes CPU rows)")
    n = blocks[0].shape[-1]
    keep: list = []
    args = []
    for blk in blocks:
        ptr, stride = _rows_in_place(blk, n, "eval_multi", keep)
        args += [ptr, stride, blk.shape[0]]
    args += [None, 0, 0] * (EVAL_MAX_BLOCKS - len(blocks))
    w = sum(blk.shape[0] for blk in blocks)
    device = blocks[0].device
    if w == 0 or n == 0:
        return torch.zeros((len(zs), w), dtype=torch.int64, device=device)
    pows = power_table(zs)
    out = torch.empty((len(zs), w), dtype=torch.int64, device=device)
    partial = torch.empty(len(zs) * w * eval_chunks(n), dtype=torch.int64,
                          device=device)
    _build.launch("gl_eval_multi", *args, pows.ctypes.data, len(zs),
                  partial.data_ptr(), out.data_ptr(), n, _stream(blocks[0]))
    LAUNCHES["gl_eval_multi"] += 2
    return out
