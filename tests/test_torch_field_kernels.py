"""The plain versions of the field kernels (csrc/field.cu, K1, K2, K4) and
of the constraint merge against `aero_tpu` (JAX, CPU), and the CPU side of
their wrappers.

K1 (field ops), K2 (scans, batch_inv) and K4 (the DEEP combination) run on
the card only; here each wrapper takes its plain version, which is what the
card's kernels are held to by `tests/test_torch_gpu.py` and
`chip_smoke.py`. Inputs come from numpy with a fixed seed, every comparison
is exact, and every case stays at 2^8 points or fewer, the JAX side op by
op (`jax.disable_jit`).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from aero_tpu.air import miden as JM
from aero_tpu.field import jax_gl as J
from aero_tpu.prover import prover as JP
from aero_tpu.sdk import DEFAULT_OPTIONS
from aero_tpu.vm import execute_full, fibonacci_source, program_hash
from aero_tpu_torch.air import miden as TM
from aero_tpu_torch.field import gl, gl_cuda
from aero_tpu_torch.ntt import lde
from aero_tpu_torch.prover import prover as TP
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


P = gl.P
EDGE = [0, 1, P - 1, 1 << 32, (1 << 32) - 1, P - 2]


def _vals(rng, shape, zero_free=False):
    """Canonical felts, the edge values first."""
    v = rng.integers(0, P, size=shape, dtype=np.uint64).reshape(-1)
    k = min(len(EDGE), v.size)
    v[:k] = np.array(EDGE[:k], dtype=np.uint64)
    if zero_free:
        v[v == 0] = 3
    return v.reshape(shape)


def _t(arr):
    return gl.from_u64(arr, "cpu")


# ---------------------------------------------------------------------- K1

@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_k1_plain_binary_ops_match_jax(op):
    rng = np.random.default_rng(1)
    ea = np.repeat(np.array(EDGE, np.uint64), len(EDGE))
    eb = np.tile(np.array(EDGE, np.uint64), len(EDGE))
    a = np.concatenate([ea, _vals(rng, (256 - ea.size,))])
    b = np.concatenate([eb, _vals(rng, (256 - eb.size,))])
    plain = getattr(gl, op + "_plain")(_t(a), _t(b))
    want = J.from_gf(getattr(J, op)(J.to_gf(a), J.to_gf(b)))
    assert np.array_equal(gl.to_u64(plain), want)
    # on the CPU the dispatching op is the plain version
    assert torch.equal(getattr(gl, op)(_t(a), _t(b)), plain)


@pytest.mark.parametrize("e", [0, 1, 2, 7, (1 << 23) + 5, P - 2])
def test_k1_plain_pow_matches_jax(e):
    a = _vals(np.random.default_rng(e % 1000), (64,))
    got = gl.pow_loop_plain(_t(a), e)
    with jax.disable_jit():
        want = J.from_gf(J.pow_loop(J.to_gf(a), e))
    assert np.array_equal(gl.to_u64(got), want)
    assert torch.equal(gl.pow_loop(_t(a), e), got)
    if e == P - 2:
        assert torch.equal(gl.inv_plain(_t(a)), got)
        assert int(gl.to_u64(got)[0]) == 0          # 0 maps to 0


def test_k1_neg_square_mul_scalar_match_their_plain_renderings():
    a = _t(_vals(np.random.default_rng(5), (200,)))
    assert torch.equal(gl.neg(a), gl.neg_plain(a))
    assert np.array_equal(gl.to_u64(gl.neg_plain(a)),
                          J.from_gf(J.neg(J.to_gf(gl.to_u64(a)))))
    assert torch.equal(gl.square(a), gl.mul_plain(a, a))
    assert torch.equal(gl.mul_scalar(a, P - 1),
                       gl.mul_plain(a, gl.scalar(P - 1, "cpu")))


def _gather(t: torch.Tensor, out_shape) -> torch.Tensor:
    """What K1 reads for `t` broadcast to `out_shape`, by its plan."""
    mode, d1, s1, m0, s0 = gl_cuda.operand_plan(t.shape, t.stride(),
                                                out_shape)
    n = int(np.prod(out_shape))
    i = torch.arange(n)
    off = {gl_cuda.MODE_FULL: i, gl_cuda.MODE_ONE: torch.zeros_like(i),
           gl_cuda.MODE_STRIDED: (i // d1) * s1 + (i % m0) * s0}[mode]
    flat = torch.as_strided(t, (t.untyped_storage().nbytes() // 8
                                - t.storage_offset(),), (1,))
    return flat[off].reshape(out_shape)


_VIEWS = {
    "same": (lambda b: b[:6, :40], (6, 40)),
    "scalar": (lambda b: b[2, 3], (6, 40)),
    "one_element": (lambda b: b[2:3, 3:4], (6, 40)),
    "row_broadcast": (lambda b: b[:6, :1].contiguous(), (6, 40)),
    "cyclic": (lambda b: b[0, :40], (6, 40)),
    "column_slice": (lambda b: b[:6, 10:50], (6, 40)),
    "every_other": (lambda b: b[:6, ::2], (6, 32)),
    "transposed": (lambda b: b[:40, :6].T, (6, 40)),
    "leading_broadcast": (lambda b: b[:4, :5].contiguous(), (3, 4, 5)),
    "strided_scalars": (lambda b: b[:, -1:], (64, 1)),
    "three_dims": (lambda b: b[:3, :64].reshape(3, 1, 64), (3, 5, 64)),
}


@pytest.mark.parametrize("case", sorted(_VIEWS))
def test_k1_operand_plan_reads_every_view(case):
    """The kernel's indexing, emulated: an operand is read in place exactly
    where the plan says, or the plan is None and the wrapper copies."""
    base = torch.arange(64 * 64, dtype=torch.int64).reshape(64, 64)
    make, out_shape = _VIEWS[case]
    t = make(base)
    plan = gl_cuda.operand_plan(t.shape, t.stride(), out_shape)
    if case == "three_dims":
        assert plan is None
        return
    assert plan is not None
    assert torch.equal(_gather(t, out_shape), t.expand(out_shape))


def test_on_cuda_takes_the_cpu_path_and_refuses_other_devices():
    a = _t(_vals(np.random.default_rng(2), (8,)))
    assert gl_cuda.on_cuda(a, a) is False
    assert gl_cuda.on_cuda(a, 3) is False
    meta = torch.empty(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gl.add(meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        gl.pow_loop(meta, 3)


# ---------------------------------------------------------------------- K2

@pytest.mark.parametrize("n", [1, 7, 256])
@pytest.mark.parametrize("fn", ["gf_cumprod", "gf_cumsum", "batch_inv"])
def test_k2_plain_scans_match_jax_with_a_zero_in_a_row(n, fn):
    """Three rows; the middle one holds a zero. batch_inv's zero rule: that
    whole row comes out zero, the others are the inverses."""
    x = _vals(np.random.default_rng(n), (3, n), zero_free=True)
    x[1, n // 2] = 0
    got = getattr(gl, fn + "_plain")(_t(x), axis=-1)
    with jax.disable_jit():
        want = J.from_gf(getattr(J, fn)(J.to_gf(x), axis=-1))
    assert np.array_equal(gl.to_u64(got), want)
    assert torch.equal(getattr(gl, fn)(_t(x), axis=-1), got)
    if fn == "batch_inv":
        assert not bool(got[1].any())
        assert torch.equal(gl.mul_plain(got[::2], _t(x[::2])),
                           torch.ones((2, n), dtype=torch.int64))


def test_k2_plain_scans_along_the_first_axis():
    x = _vals(np.random.default_rng(9), (7, 3), zero_free=True)
    for fn in ("gf_cumprod", "gf_cumsum", "batch_inv"):
        got = getattr(gl, fn + "_plain")(_t(x), axis=0)
        with jax.disable_jit():
            want = J.from_gf(getattr(J, fn)(J.to_gf(x), axis=0))
        assert np.array_equal(gl.to_u64(got), want), fn


# The algebra of K2's kernels (csrc/field.cu), emulated with Python ints at
# a small tile: a tile of `threads` runs of `items` elements, as on the card
# (256 runs of 8 there, 4 x 2 or 2 x 4 here).

def _fmul(a, b):
    return a * b % P


def _prod(vals):
    r = 1
    for v in vals:
        r = r * v % P
    return r


def _emulate_batch_inv(row, threads, items):
    """gl_batch_inv on one row: (a) each tile's product; (b) the row's
    factor of tile k, F_k = (tiles before k)(tiles after k) / (the row's
    product), the inverse as x^(p-2) (0 for 0); (c) in tile k, thread t's
    run: e_i the product of the run before i, g = F_k (runs before t)
    (runs after t), then from the run's end out_i = e_i g, g *= x_i."""
    tile = threads * items
    n = len(row)
    ntiles = -(-n // tile)
    x = list(row) + [1] * (ntiles * tile - n)          # identity past n
    tiles = [x[k * tile:(k + 1) * tile] for k in range(ntiles)]
    tp = [_prod(t) for t in tiles]                                 # (a)
    tinv = pow(_prod(tp), P - 2, P)                                # (b)
    factor = [_prod(tp[:k]) * _prod(tp[k + 1:]) * tinv % P
              for k in range(ntiles)]
    out = []
    for k, t in enumerate(tiles):                                  # (c)
        runs = [t[r * items:(r + 1) * items] for r in range(threads)]
        tot = [_prod(r) for r in runs]
        for r, run in enumerate(runs):
            e = [_prod(run[:i]) for i in range(items)]
            g = factor[k] * _prod(tot[:r]) * _prod(tot[r + 1:]) % P
            res = [0] * items
            for i in reversed(range(items)):
                res[i] = _fmul(e[i], g)
                g = _fmul(g, run[i])
            out += res
    return out[:n]


def _rows_with_zeros(n, rng, tile):
    """A row without a zero, then one with a zero at its first element, at
    its last, at each side of the first tile edge (7, 8, 9) where the row
    reaches, and one with a zero in every tile."""
    where = [None, [0], [n - 1]] + [[j] for j in (7, 8, 9) if j < n]
    where.append(list(range(0, n, tile)))
    rows = []
    for w in where:
        r = [int(v) for v in _vals(rng, (n,), zero_free=True)]
        for j in w or ():
            r[j] = 0
        rows.append(r)
    return rows


@functools.lru_cache(maxsize=None)
def _batch_inv_case(n):
    """The rows of one length and `jax_gl.batch_inv` of them (both tile
    layouts below take the same rows)."""
    x = np.array(_rows_with_zeros(n, np.random.default_rng(n), 8),
                 dtype=np.uint64)
    with jax.disable_jit():
        return x, J.from_gf(J.batch_inv(J.to_gf(x), axis=-1))


@pytest.mark.parametrize("threads,items", [(4, 2), (2, 4)])
@pytest.mark.parametrize("n", [1, 7, 8, 9, 17, 64])
def test_k2_batch_inv_kernel_algebra_matches_jax(n, threads, items):
    """The three launches of gl_batch_inv, emulated at a tile of 8, give
    `jax_gl.batch_inv`'s values: the inverses, and a row with a zero
    anywhere all zero (its product is 0, and so is 0^(p-2))."""
    x, want = _batch_inv_case(n)
    got = np.array([_emulate_batch_inv([int(v) for v in r], threads, items)
                    for r in x], dtype=np.uint64)
    assert np.array_equal(got, want)
    assert np.array_equal(gl.to_u64(gl.batch_inv_plain(_t(x))), want)
    assert not got[1:].any() and got[0].all()


def _emulate_chained_scan(row, tile, op, identity, prefix_known, window=4):
    """gl_scan on one row: each tile's aggregate, then, tile by tile, the
    look-back: the statuses of its predecessors, nearest first, `window` at
    a time, folded until an inclusive prefix (the row's first tile always
    publishes one); a predecessor k > 0 shows its inclusive prefix where
    `prefix_known(k)`, else only its aggregate."""
    n = len(row)
    ntiles = -(-n // tile)
    x = list(row) + [identity] * (ntiles * tile - n)
    agg, inclusive, out = [], [], []
    for k in range(ntiles):
        t = x[k * tile:(k + 1) * tile]
        a = identity
        scanned = []
        for v in t:
            a = op(a, v)
            scanned.append(a)
        agg.append(a)
        excl, top, done = identity, k - 1, k == 0
        while not done:
            for j in range(top, top - window, -1):
                if j < 0:
                    done = True
                    break
                is_prefix = j == 0 or prefix_known(j)
                excl = op(excl, inclusive[j] if is_prefix else agg[j])
                if is_prefix:
                    done = True
                    break
            top -= window
        inclusive.append(op(excl, a))
        out += [op(excl, s) for s in scanned]
    return out[:n]


@pytest.mark.parametrize("n", [1, 8, 9, 33, 64, 100])
@pytest.mark.parametrize("fn", ["gf_cumprod", "gf_cumsum"])
def test_k2_chained_scan_combine_matches_jax(fn, n):
    """Tiles of 8, look-back windows of 4: whichever predecessors show their
    inclusive prefix (none, all, every third, a seeded draw), the combine
    gives `jax_gl`'s scan."""
    rng = np.random.default_rng(100 + n)
    x = _vals(rng, (3, n))
    op = _fmul if fn == "gf_cumprod" else (lambda a, b: (a + b) % P)
    identity = 1 if fn == "gf_cumprod" else 0
    draw = rng.random(64) < 0.5
    patterns = [lambda k: False, lambda k: True, lambda k: k % 3 == 0,
                lambda k: bool(draw[k])]
    with jax.disable_jit():
        want = J.from_gf(getattr(J, fn)(J.to_gf(x), axis=-1))
    for known in patterns:
        got = np.array([_emulate_chained_scan([int(v) for v in r], 8, op,
                                              identity, known)
                        for r in x], dtype=np.uint64)
        assert np.array_equal(got, want)


# ------------------------------------------------------- constraint merge

@pytest.fixture(scope="module")
def miden_frames():
    """A real 64-row Miden trace with its aux segment, extended to the
    512-point LDE domain; the port's merger over it, and the JAX air."""
    src = fibonacci_source(10)
    trace, out, ovf = execute_full(src, [0, 1], min_rows=64)
    pub_j = JM.make_public_inputs(program_hash(src), [0, 1], out,
                                  overflow=ovf)
    pub_t = TM.make_public_inputs(program_hash(src), [0, 1], out,
                                  overflow=ovf)
    jair = JM.MidenAir(64, pub_j, DEFAULT_OPTIONS, program=src)
    tair = TM.MidenAir(64, pub_t, DEFAULT_OPTIONS, program=src)
    rng = np.random.default_rng(6)
    rands = [int(r) for r in rng.integers(0, P, size=16, dtype=np.uint64)]
    tair._aux_rand = jair._aux_rand = rands
    main = gl.from_u64(trace, "cpu")
    aux = tair.build_aux_trace(main, rands)
    main_lde = lde(TP.intt(main), 3)
    aux_lde = lde(TP.intt(aux), 3)
    cc_t = [tuple(int(v) for v in rng.integers(0, P, 2, np.uint64))
            for _ in range(tair.num_transition_constraints)]
    cc_b = [tuple(int(v) for v in rng.integers(0, P, 2, np.uint64))
            for _ in range(tair.num_assertions)]
    merger = TP.ConstraintMerger(tair, rands, cc_t, cc_b,
                                 TP.ceval_domain(tair, "cpu"), "cpu")
    return jair, merger, main_lde, aux_lde, rands


def _jax_merge(jair, merger, frames, inputs, rands):
    """The merge of `aero_tpu`'s fragment runner (prover.py:407-429),
    written with jax_gl ops on the same frames and rows."""
    g = [J.to_gf(gl.to_u64(f)) for f in frames]
    t_evals = jair.evaluate_transitions(*g, rands)
    x = J.to_gf(gl.to_u64(merger.x_dom))
    xp = {adj: J.pow_loop(x, adj)
          for adj in set(merger.t_adjust) | set(merger.b_adjust)}
    cc_t, cc_b = (J.to_gf(gl.to_u64(c)) for c in (inputs.cc_t, inputs.cc_b))
    bvals = J.to_gf(gl.to_u64(inputs.bvals))
    zt = J.to_gf(gl.to_u64(inputs.zt))
    dinv = J.to_gf(gl.to_u64(merger.denom_inv))
    merged = J.gf_full(x.shape, 0)
    for i, (ev, adj) in enumerate(zip(t_evals, merger.t_adjust)):
        k = J.add(cc_t[i, 0], J.mul(xp[adj], cc_t[i, 1]))
        merged = J.add(merged, J.mul(J.mul(k, ev), zt))
    for j, ((is_main, c, prow), adj) in enumerate(zip(merger.asrt_route,
                                                      merger.b_adjust)):
        col = g[0][c] if is_main else g[2][c]
        k = J.add(cc_b[j, 0], J.mul(xp[adj], cc_b[j, 1]))
        merged = J.add(merged, J.mul(J.mul(k, J.sub(col, bvals[j])),
                                     dinv[prow]))
    return J.from_gf(merged)


def test_k3_plain_merge_matches_jax_on_the_same_frames(miden_frames):
    """`constraint_merge_plain`, and `merger.fragment`'s CPU route, against
    JAX's merge on the same frames. The name is kept from the merge kernel
    K3, which the port no longer has: K5 merges on the card."""
    jair, merger, main_lde, aux_lde, rands = miden_frames
    m = main_lde.shape[-1]
    frames = tuple(TP.joined(TP._frame(x, a, m))
                   for x in (main_lde, aux_lde) for a in (0, 8))
    inputs = merger.merge_inputs(*frames, 0)
    # every term a full (m,) row
    assert len(inputs.t_evals) == 112 and len(inputs.cols) == 46
    for r in (*inputs.t_evals, *inputs.t_xp, *inputs.cols, *inputs.b_xp,
              *inputs.dinv, inputs.zt):
        assert tuple(r.shape) == (m,) and r.stride(0) == 1
    got = TP.constraint_merge_plain(*inputs)
    assert torch.equal(merger.fragment(*frames, 0), got)
    with jax.disable_jit():
        want = _jax_merge(jair, merger, frames, inputs, rands)
    assert np.array_equal(gl.to_u64(got), want)


# ---------------------------------------------------------------------- K4

@pytest.mark.parametrize("aux_width", [2, 0])
def test_k4_plain_deep_core_matches_jax(aux_width):
    """5 main + 2 aux + 2 composition columns at 2^8 points, read as a
    fragment of a wider domain (row stride 2^9)."""
    rng = np.random.default_rng(40 + aux_width)
    m, wm, wc = 256, 5, 2
    w = wm + aux_width
    main = _vals(rng, (wm, 2 * m))
    aux = _vals(rng, (aux_width, 2 * m)) if aux_width else None
    comp = _vals(rng, (wc, 2 * m))
    x = _vals(rng, (m,), zero_free=True)
    vecs = [_vals(rng, (k,)) for k in (w, w, wc, w, w, wc)]
    zs = [int(v) for v in rng.integers(0, P, 5, np.uint64)]
    zs[0] = int(x[17])            # x - z is 0 once: batch_inv's zero rule
    sl = slice(m // 2, m // 2 + m)

    got = TP._deep_core(_t(main)[:, sl],
                        _t(aux)[:, sl] if aux_width else None,
                        _t(comp)[:, sl], _t(x), *map(_t, vecs),
                        *(gl.scalar(z, "cpu") for z in zs))
    plain = TP._deep_core_plain(_t(main)[:, sl],
                                _t(aux)[:, sl] if aux_width else None,
                                _t(comp)[:, sl], _t(x), *map(_t, vecs),
                                *(gl.scalar(z, "cpu") for z in zs))
    assert torch.equal(got, plain)
    with jax.disable_jit():
        want = JP._deep_core(
            J.to_gf(main[:, sl]),
            J.to_gf(aux[:, sl]) if aux_width else None,
            J.to_gf(comp[:, sl]), J.to_gf(x), *map(J.to_gf, vecs),
            *(J.to_gf(np.uint64(z)) for z in zs))
    assert np.array_equal(gl.to_u64(got), J.from_gf(want))
