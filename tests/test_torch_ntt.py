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

torch.set_num_threads(1)   # one thread per xdist worker: no oversubscription

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
    """One pass equals a size-L NTT down each column, times the cross."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, P, size=(2, 16, 4), dtype=np.uint64)
    cross = rng.integers(0, P, size=(16, 4), dtype=np.uint64)
    tw = T.from_u64(tables.radix2_twiddles(16, False), "cpu")
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

