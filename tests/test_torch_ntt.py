"""aero_tpu_torch.ntt vs aero_tpu.ntt (JAX, CPU), and the NTT tables.

The port's plain radix-2 path and its plain rendering of kernel 1's
two-pass algorithm (same tables, same pass structure) are both held equal
to the JAX transforms on the same numpy inputs; exact equality. The JAX
transforms run op by op (`jax.disable_jit`): XLA:CPU takes about a minute
to compile each jitted size, op-by-op dispatch a few seconds.
"""

import jax
import numpy as np
import pytest
import torch

from aero_tpu import field as J
from aero_tpu import ntt as JN
from aero_tpu.ntt.ntt_pallas import _tables_np as jax_tables_np
from aero_tpu.spec import field as F
from aero_tpu.spec.polys import ntt_naive
from aero_tpu_torch import field as T
from aero_tpu_torch import ntt as TN
from aero_tpu_torch.ntt import ntt_cuda, tables
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


P = F.P


def _jax(fn, x, *args):
    with jax.disable_jit():
        return J.from_gf(fn(J.to_gf(x), *args))


def _cols(logn, cols=3, seed=0):
    rng = np.random.default_rng(seed + logn)
    return rng.integers(0, P, size=(cols, 1 << logn), dtype=np.uint64)


@pytest.mark.parametrize("logn", [1, 2, 5, 8, 12])
def test_ntt_intt_match_jax(logn):
    x = _cols(logn)
    t = T.from_u64(x, "cpu")
    want_f = _jax(JN.ntt, x)
    want_i = _jax(JN.intt, x)
    for got, want in ((TN.ntt(t), want_f), (TN.intt(t), want_i)):
        assert np.array_equal(T.to_u64(got), want)
    # the plain rendering of the kernel's two passes
    assert np.array_equal(T.to_u64(ntt_cuda.ntt_four_step_plain(t, False)),
                          want_f)
    assert np.array_equal(T.to_u64(ntt_cuda.ntt_four_step_plain(t, True)),
                          want_i)
    # the CUDA wrapper on a CPU tensor takes the plain version
    assert np.array_equal(T.to_u64(ntt_cuda.ntt_cuda(t, False)), want_f)


@pytest.mark.parametrize("logn", range(1, 13))
def test_every_size_plain_paths_agree(logn):
    """n = 2^1..2^12: radix-2, the kernel's two-pass rendering and (up to
    2^8) the spec's naive DFT agree; the inverse undoes the forward."""
    x = _cols(logn, seed=11)
    t = T.from_u64(x, "cpu")
    fwd = TN.ntt(t)
    assert torch.equal(fwd, ntt_cuda.ntt_four_step_plain(t, False))
    assert torch.equal(TN.intt(t), ntt_cuda.ntt_four_step_plain(t, True))
    assert torch.equal(TN.intt(fwd), t)
    if logn <= 8:
        got = T.to_u64(fwd[0])
        assert [int(v) for v in got] == ntt_naive([int(v) for v in x[0]])


@pytest.mark.parametrize("logn,log_blowup", [(1, 1), (4, 2), (6, 3)])
def test_lde_matches_jax(logn, log_blowup):
    x = _cols(logn, seed=7)
    t = T.from_u64(x, "cpu")
    want = _jax(JN.lde, x, log_blowup)
    assert np.array_equal(T.to_u64(TN.lde(t, log_blowup)), want)
    want_e = _jax(JN.lde_from_evals, x, log_blowup)
    assert np.array_equal(T.to_u64(TN.lde_from_evals(t, log_blowup)), want_e)


@pytest.mark.parametrize("n", [2, 8, 1 << 13, 1 << 16, 1 << 22])
@pytest.mark.parametrize("invert", [False, True])
def test_tables_equal_pallas_tables(n, invert):
    got = tables.tables_np(n, invert)
    want = jax_tables_np(n, invert)
    assert got[:2] == want[:2]
    for g, w in zip(got[2:], want[2:]):
        assert np.array_equal(g, w)


def test_tables_reach_two_passes_of_4096():
    n1, n2, *_ = tables.tables_np(1 << 24, False)
    assert (n1, n2) == (4096, 4096)
    with pytest.raises(ValueError):
        tables.tables_np(1 << 25, False)


def test_colntt_plain_is_one_pass_of_the_kernel():
    """One pass equals a size-L NTT down each column, times the cross; the
    pass table is w_L^e for e < L."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, P, size=(2, 16, 4), dtype=np.uint64)
    cross = rng.integers(0, P, size=(16, 4), dtype=np.uint64)
    tw = T.power_series(F.get_root_of_unity(4), 16)
    got = T.to_u64(ntt_cuda.colntt_plain(T.from_u64(x, "cpu"), tw,
                                         T.from_u64(cross, "cpu")))
    cols = np.ascontiguousarray(np.transpose(x, (0, 2, 1)))   # (B, C, L)
    want = np.transpose(T.to_u64(TN.ntt(T.from_u64(cols, "cpu"))), (0, 2, 1))
    want = J.from_gf(J.mul(J.to_gf(np.ascontiguousarray(want)),
                           J.to_gf(np.broadcast_to(cross, want.shape).copy())))
    assert np.array_equal(got, want)


def test_wrapper_refuses_other_devices():
    x = torch.empty((2, 8), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        ntt_cuda.ntt_cuda(x)


# ------------------------------------------- past two passes: three levels

THREE_LEVEL = [(4, 5), (4, 6), (8, 7), (8, 8), (8, 9), (16, 9), (16, 10),
               (16, 12)]


@pytest.mark.parametrize("max_l,logn", THREE_LEVEL)
@pytest.mark.parametrize("invert", [False, True])
def test_three_levels_with_the_pass_limit_lowered(max_l, logn, invert):
    """n > max_l^2: the strided three-pass route of the wrapper, its plain
    rendering by reshapes, the two-pass rendering and radix-2 agree, on a
    batch of rows (the last pass runs once a row)."""
    n = 1 << logn
    assert (logn + 1) // 2 > max_l.bit_length() - 1      # not two passes
    n3, n_inner = tables.three_level_split(n, max_l)
    assert n3 * n_inner == n and n3 <= max_l and n_inner <= max_l * max_l
    x = _cols(logn, cols=6, seed=21).reshape(2, 3, n)
    t = T.from_u64(x, "cpu")
    got = ntt_cuda.ntt_cuda(t, invert, max_l=max_l)
    assert torch.equal(got, TN.ntt_plain(t, invert))
    assert torch.equal(got, ntt_cuda.ntt_four_step_plain(t, invert, max_l))
    assert torch.equal(got, ntt_cuda.ntt_four_step_plain(t, invert))
    assert torch.equal(got, ntt_cuda.ntt_cuda(t, invert))


@pytest.mark.parametrize("max_l,logn", [(4, 6), (8, 7), (8, 9), (16, 10)])
def test_three_levels_match_jax(max_l, logn):
    x = _cols(logn, cols=2, seed=23)
    t = T.from_u64(x, "cpu")
    for invert, jfn in ((False, JN.ntt), (True, JN.intt)):
        got = ntt_cuda.ntt_cuda(t, invert, max_l=max_l)
        assert np.array_equal(T.to_u64(got), _jax(jfn, x))


@pytest.mark.parametrize("max_l,logn,log_blowup", [(4, 3, 3), (8, 4, 3),
                                                   (8, 6, 3), (16, 8, 2)])
def test_lde_past_the_two_pass_limit_matches_jax(max_l, logn, log_blowup):
    """What `lde` hands the transform on the card, a zero-padded row of
    n << log_blowup points, through three levels: equal to `aero_tpu`'s
    coset-by-coset LDE and to the port's `lde`."""
    assert logn + log_blowup > 2 * (max_l.bit_length() - 1)
    x = _cols(logn, seed=29)
    t = T.from_u64(x, "cpu")
    got = ntt_cuda.ntt_cuda(TN.coset_pad(t, log_blowup), False, max_l=max_l)
    assert np.array_equal(T.to_u64(got), _jax(JN.lde, x, log_blowup))
    assert torch.equal(got, TN.lde(t, log_blowup))


def test_three_level_split_sizes():
    assert tables.three_level_split(1 << 25) == (1 << 8, 1 << 17)
    assert tables.three_level_split(1 << 27) == (1 << 9, 1 << 18)
    assert tables.three_level_split(1 << 36) == (1 << 12, 1 << 24)
    with pytest.raises(ValueError, match=str(1 << 37)):
        tables.three_level_split(1 << 37)
    with pytest.raises(ValueError, match="96"):
        tables.three_level_split(96)


def test_a_size_that_cannot_be_served_raises_with_its_size():
    t = T.from_u64(_cols(7), "cpu")
    with pytest.raises(ValueError, match="128"):
        ntt_cuda.ntt_cuda(t, False, max_l=2)             # four levels
    with pytest.raises(ValueError, match="96"):
        ntt_cuda.ntt_cuda(t[:, :96].contiguous())        # not a power of two
    with pytest.raises(ValueError, match="contiguous"):
        ntt_cuda.ntt_cuda(t[:, ::2])
    with pytest.raises(ValueError, match="8192"):
        ntt_cuda.ntt_cuda(t, False, max_l=8192)          # beyond the kernel


def test_table_cache_is_bounded_by_bytes(monkeypatch):
    """The cache of device tables keeps at most TABLE_CACHE_BYTES, drops the
    least recently used set first and does not keep a set that is larger
    than the whole budget."""
    ntt_cuda.clear_table_cache()
    assert ntt_cuda.table_cache_bytes() == 0
    dev = torch.device("cpu")
    one = ntt_cuda._nbytes(ntt_cuda._tables(1 << 10, False, dev))
    assert one >= (1 << 10) * 8                          # the cross table
    monkeypatch.setattr(ntt_cuda, "TABLE_CACHE_BYTES", 2 * one + 64)
    ntt_cuda._tables(1 << 10, True, dev)
    assert ntt_cuda.table_cache_bytes() == 2 * one
    first = ntt_cuda._tables(1 << 10, False, dev)        # now the newest
    ntt_cuda._outer_tables(1 << 9, False, dev, 8)        # 512-element cross
    keys = list(ntt_cuda._cache)
    assert (1 << 10, True, dev, tables.MAX_L) not in keys
    assert ntt_cuda._tables(1 << 10, False, dev) is first
    assert ntt_cuda.table_cache_bytes() <= ntt_cuda.TABLE_CACHE_BYTES
    big = ntt_cuda._tables(1 << 12, False, dev)          # over the budget
    assert ntt_cuda._nbytes(big) > ntt_cuda.TABLE_CACHE_BYTES
    assert (1 << 12, False, dev, tables.MAX_L) not in ntt_cuda._cache
    assert ntt_cuda._tables(1 << 12, False, dev) is not big
    ntt_cuda.clear_table_cache()
    assert ntt_cuda.table_cache_bytes() == 0
