"""aero_tpu_torch.field vs aero_tpu.field (JAX, CPU) and the spec oracle.

Inputs come from numpy with a fixed seed and go through both packages;
every comparison is exact equality (finite-field arithmetic).
"""

import numpy as np
import pytest
import torch

from aero_tpu import field as J
from aero_tpu.spec import field as F
from aero_tpu_torch import field as T
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


P = F.P
RNG = np.random.default_rng(1)
EDGE = [0, 1, P - 1, 1 << 32, (1 << 32) - 1, (1 << 63) % P, P - 2, P // 2]


def _vals(n=300, seed=0):
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, P, size=n - len(EDGE), dtype=np.uint64)
    return np.concatenate([np.array(EDGE, dtype=np.uint64), rand])


def _pair():
    a = _vals(seed=2)
    b = np.roll(_vals(seed=3), 5)
    # every edge value against every edge value, then random pairs
    ea = np.repeat(np.array(EDGE, np.uint64), len(EDGE))
    eb = np.tile(np.array(EDGE, np.uint64), len(EDGE))
    return np.concatenate([ea, a]), np.concatenate([eb, b])


def _t(arr):
    return T.from_u64(arr, "cpu")


def _u(t):
    return T.to_u64(t)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops(op):
    a, b = _pair()
    got = _u(getattr(T, op)(_t(a), _t(b)))
    want = J.from_gf(getattr(J, op)(J.to_gf(a), J.to_gf(b)))
    assert np.array_equal(got, want)
    spec = getattr(F, op)
    assert [int(x) for x in got[:200]] == [spec(int(x), int(y))
                                           for x, y in zip(a[:200], b[:200])]


@pytest.mark.parametrize("op", ["neg", "square"])
def test_unary_ops(op):
    a = _vals(seed=4)
    got = _u(getattr(T, op)(_t(a)))
    want = J.from_gf(getattr(J, op)(J.to_gf(a)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("c", [0, 1, 2, P - 1, 1 << 40, (1 << 63) % P])
def test_mul_scalar(c):
    a = _vals(seed=5)
    got = _u(T.mul_scalar(_t(a), c))
    assert np.array_equal(got, J.from_gf(J.mul_scalar(J.to_gf(a), c)))


def test_canonicalize_non_canonical_patterns():
    raw = np.array([P, P + 1, P + 12345, (1 << 64) - 1, 0, P - 1, 1 << 63],
                   dtype=np.uint64)
    got = _u(T.canonicalize(torch.from_numpy(raw.view(np.int64).copy())))
    want = J.from_gf(J.canonicalize(J.to_gf(raw)))
    assert np.array_equal(got, want)
    assert [int(x) for x in got] == [int(x) % P for x in raw]
    assert np.array_equal(_u(_t(raw)), want)        # from_u64 canonicalizes


def test_from_limbs_takes_a_jax_gf():
    a = _vals(seed=6)
    g = J.to_gf(a)
    got = T.from_limbs(np.asarray(g.lo), np.asarray(g.hi), "cpu")
    assert np.array_equal(_u(got), a)


@pytest.mark.parametrize("e", [0, 1, 2, 7, 255, 1 << 33, P - 2])
def test_pow_loop(e):
    a = _vals(n=40, seed=7)
    got = _u(T.pow_loop(_t(a), e))
    assert np.array_equal(got, J.from_gf(J.pow_loop(J.to_gf(a), e)))


def test_inv_and_batch_inv():
    a = _vals(n=64, seed=8)
    a[a == 0] = 3
    got = _u(T.inv(_t(a)))
    assert np.array_equal(got, J.from_gf(J.inv(J.to_gf(a))))
    assert [int(x) for x in got[:20]] == [F.inv(int(x)) for x in a[:20]]
    m = a.reshape(4, 16)
    for axis in (-1, 0):
        got = _u(T.batch_inv(_t(m), axis=axis))
        want = J.from_gf(J.batch_inv(J.to_gf(m), axis=axis))
        assert np.array_equal(got, want), axis


def test_power_series():
    for base, n, scale in ((3, 1, 1), (F.get_root_of_unity(5), 32, 7),
                           (P - 1, 64, 5)):
        got = _u(T.power_series(base, n, scale))
        assert np.array_equal(got, J.from_gf(J.power_series(base, n, scale)))


def test_gf_sum_take_concat_full_zeros():
    a = _vals(n=7 * 11, seed=9).reshape(7, 11)
    for axis in (0, 1, -1):
        got = _u(T.gf_sum(_t(a), axis=axis))
        want = J.from_gf(J.gf_sum(J.to_gf(a), axis=axis))
        assert np.array_equal(got, np.squeeze(want, axis=axis)), axis
    idx = [3, 0, 10, 3]
    assert np.array_equal(_u(T.gf_take(_t(a), idx, axis=1)),
                          J.from_gf(J.gf_take(J.to_gf(a), np.array(idx),
                                              axis=1)))
    assert np.array_equal(
        _u(T.gf_concat([_t(a), _t(a[:2])], axis=0)),
        J.from_gf(J.gf_concat([J.to_gf(a), J.to_gf(a[:2])], axis=0)))
    assert np.array_equal(_u(T.gf_full((2, 3), P + 5, "cpu")),
                          J.from_gf(J.gf_full((2, 3), P + 5)))
    assert np.array_equal(_u(T.gf_zeros((4,), "cpu")),
                          J.from_gf(J.gf_zeros((4,))))


@pytest.mark.parametrize("axis", [-1, 0])
def test_prefix_scans(axis):
    a = _vals(n=5 * 13, seed=10).reshape(5, 13)
    for tf, jf in ((T.gf_cumprod, J.gf_cumprod), (T.gf_cumsum, J.gf_cumsum)):
        got = _u(tf(_t(a), axis=axis))
        assert np.array_equal(got, J.from_gf(jf(J.to_gf(a), axis=axis)))


def test_eval_polys_multi():
    polys = _vals(n=9 * 64, seed=11).reshape(9, 64)
    zs = [5, P - 3, F.get_root_of_unity(9)]
    got = T.eval_polys_multi(_t(polys), zs)
    want = J.eval_polys_multi(J.to_gf(polys), zs)
    assert got.shape == (3, 9)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("e", [0, 1, 2, 7, 255, 1 << 33, P - 2])
def test_pow_const(e):
    a = _vals(n=40, seed=12)
    got = _u(T.pow_const(_t(a), e))
    assert np.array_equal(got, J.from_gf(J.pow_const(J.to_gf(a), e)))
    assert [int(x) for x in got] == [F.exp(int(x), e) for x in a]


def test_gf_where_and_gf_reshape():
    a, b = _vals(n=60, seed=13), _vals(n=60, seed=14)
    mask = np.random.default_rng(15).integers(0, 2, size=60).astype(bool)
    got = _u(T.gf_where(torch.from_numpy(mask), _t(a), _t(b)))
    want = J.from_gf(J.gf_where(mask, J.to_gf(a), J.to_gf(b)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.where(mask, a, b))
    for shape in ((6, 10), (3, 4, 5), (60,)):
        assert np.array_equal(_u(T.gf_reshape(_t(a), shape)),
                              J.from_gf(J.gf_reshape(J.to_gf(a), shape)))


@pytest.mark.parametrize("shape", [(64,), (9, 64), (2, 3, 32)])
def test_eval_polys_at(shape):
    polys = _vals(n=int(np.prod(shape)), seed=16).reshape(shape)
    for z in (0, 1, 5, P - 3, F.get_root_of_unity(9)):
        got = T.eval_polys_at(_t(polys), z)
        want = J.eval_polys_at(J.to_gf(polys), z)
        assert got.shape == shape[:-1]
        assert np.array_equal(got, want), z
    row = polys.reshape(-1, shape[-1])[0]
    assert int(T.eval_polys_at(_t(polys), 5).reshape(-1)[0]) == \
        sum(int(c) * pow(5, i, P) for i, c in enumerate(row)) % P
