"""aero_tpu_torch.ntt.ntt_mxu (the int8-limb 4-step NTT) and
field.mul_pow2_const vs aero_tpu (JAX, CPU) and the spec oracle.

Inputs come from numpy with a fixed seed and go through both packages;
every comparison is exact equality (field elements). On the CPU the limb
products are int32 matmuls; `torch._int_mm` on the card is held against the
NTT kernel in tests/test_torch_gpu.py and chip_smoke.py. The JAX transforms
run op by op (`jax.disable_jit`), which keeps XLA:CPU compiles out.
"""

import jax
import numpy as np
import pytest
import torch

from aero_tpu import field as J
from aero_tpu import ntt as JN
from aero_tpu.ntt import ntt_mxu as JM
from aero_tpu.spec import field as F
from aero_tpu_torch import field as T
from aero_tpu_torch import ntt as TN
from aero_tpu_torch.ntt import ntt_mxu as TM
from aero_tpu_torch.ntt import tables
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


P = F.P
CPU = torch.device("cpu")
EDGE = [0, 1, P - 1, 1 << 32, (1 << 32) - 1, (1 << 63) % P, P - 2, P // 2]


def _vals(n, seed):
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, P, size=n - len(EDGE), dtype=np.uint64)
    return np.concatenate([np.array(EDGE, dtype=np.uint64), rand])


# ------------------------------------------------------------ mul_pow2_const

@pytest.mark.parametrize("k", range(192))
def test_mul_pow2_const(k):
    a = _vals(48, seed=k)
    got = T.to_u64(T.mul_pow2_const(T.from_u64(a, "cpu"), k))
    want = J.from_gf(J.mul_pow2_const(J.to_gf(a), k))
    assert np.array_equal(got, want)
    w = pow(2, k, P)
    assert [int(x) for x in got] == [F.mul(int(x), w) for x in a]


def test_mul_pow2_const_wraps_k_and_takes_any_u64_pattern():
    raw = np.array([P, P + 1, (1 << 64) - 1, 1 << 63, 0, 5], dtype=np.uint64)
    t = torch.from_numpy(raw.view(np.int64).copy())
    for k in (0, 17, 95, 96, 191, 192, 193, 400):
        got = T.to_u64(T.mul_pow2_const(t, k))
        assert [int(x) for x in got] == \
            [int(x) % P * pow(2, k, P) % P for x in raw], k


# -------------------------------------------------------------------- tables

@pytest.mark.parametrize("k,invert,scale", [(8, False, 1), (32, True, 1),
                                            (16, True, F.inv(256)),
                                            (64, False, 12345)])
def test_dft_matrix_limbs_equal_aero_tpus(k, invert, scale):
    got = TM._dft_matrix_limbs(k, invert, scale)
    want = JM._dft_matrix_limbs(k, invert, scale)
    assert got.dtype == want.dtype == np.int8
    assert np.array_equal(got, want)
    # the limbs put together again are the matrix
    W = sum(got[a].astype(np.uint64) << np.uint64(4 * a)
            for a in range(TM.NLIMB))
    assert np.array_equal(W, tables.dft_matrix(k, invert, scale))


@pytest.mark.parametrize("k1,k2,invert", [(8, 8, False), (16, 32, True),
                                          (32, 32, False)])
def test_twiddle_limbs_equal_aero_tpus(k1, k2, invert):
    lo, hi = JM._twiddle_limbs(k1, k2, invert)
    want = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    assert np.array_equal(TM._twiddle_limbs(k1, k2, invert), want)


def test_constants_and_factor():
    assert (TM.NLIMB, TM.NCHAN) == (JM.NLIMB, JM.NCHAN) == (16, 31)
    for logn in range(1, 21):
        assert TM._factor(1 << logn) == JM._factor(1 << logn)


# ----------------------------------------------- the two DFT-matmul routes

def _naive_matmul(W, x):
    k, m = x.shape
    return np.array([[sum(int(W[o, i]) * int(x[i, c]) for i in range(k)) % P
                      for c in range(m)] for o in range(k)], dtype=np.uint64)


@pytest.mark.parametrize("route", ["schoolbook", "karatsuba"])
@pytest.mark.parametrize("k,invert,scale", [(16, False, 1), (32, False, 1),
                                            (16, True, F.inv(1 << 8)),
                                            (32, True, F.inv(1 << 10))])
def test_dft_matmul_routes_against_a_naive_product(route, k, invert, scale):
    x = _vals(k * 24, seed=k + invert).reshape(k, 24)
    t = T.from_u64(x, "cpu")
    if route == "karatsuba":
        got = TM._gf_dft_matmul_kara(TM._f_tree(k, invert, scale, CPU), t)
    else:
        got = TM._gf_dft_matmul(TM._f_limbs_on(k, invert, scale, CPU), t)
    want = _naive_matmul(tables.dft_matrix(k, invert, scale), x)
    assert np.array_equal(T.to_u64(got), want)


@pytest.mark.parametrize("k", [16, 32])
def test_dft_matmul_routes_equal_aero_tpus(k):
    x = _vals(k * 16, seed=3 * k).reshape(k, 16)
    t = T.from_u64(x, "cpu")
    with jax.disable_jit():
        want_s = J.from_gf(JM._gf_dft_matmul(
            jax.numpy.asarray(JM._dft_matrix_limbs(k, False, 1)),
            J.to_gf(x)))
        want_k = J.from_gf(JM._gf_dft_matmul_kara(JM._f_tree(k, False, 1),
                                                  J.to_gf(x)))
    got_s = TM._gf_dft_matmul(TM._f_limbs_on(k, False, 1, CPU), t)
    got_k = TM._gf_dft_matmul_kara(TM._f_tree(k, False, 1, CPU), t)
    assert np.array_equal(T.to_u64(got_s), want_s)
    assert np.array_equal(T.to_u64(got_k), want_k)
    assert np.array_equal(want_s, want_k)


def test_split_limbs_equal_aero_tpus():
    x = _vals(64, seed=5).reshape(4, 16)
    got = TM._split_limbs(T.from_u64(x, "cpu"))
    assert got.dtype == torch.int8 and got.shape == (16, 4, 16)
    assert np.array_equal(got.numpy(), np.asarray(JM._split_limbs(J.to_gf(x))))
    # a strided view comes out contiguous
    assert TM._split_limbs(T.from_u64(x, "cpu").t())[0].is_contiguous()


def test_int8_matmul_is_exact_over_the_full_int8_range():
    rng = np.random.default_rng(11)
    a = rng.integers(-128, 128, size=(33, 40), dtype=np.int8)
    bt = rng.integers(-128, 128, size=(50, 40), dtype=np.int8)
    got = TM._int8_matmul(torch.from_numpy(a), torch.from_numpy(bt))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          a.astype(np.int64) @ bt.astype(np.int64).T)
    with pytest.raises(ValueError):
        TM._int8_matmul(torch.empty((8, 8), dtype=torch.int8, device="meta"),
                        torch.empty((8, 8), dtype=torch.int8, device="meta"))


def test_tiles_past_the_int32_bound_are_refused():
    x = torch.zeros((2 * TM.MAX_K, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="overflow"):
        TM._gf_dft_matmul(None, x)
    with pytest.raises(ValueError, match="overflow"):
        TM._gf_dft_matmul_kara(None, x)


# ---------------------------------------------------------------- transforms

@pytest.mark.parametrize("logn,cols", [(6, 3), (8, 2), (10, 4)])
def test_ntt_mxu_equals_aero_tpu_and_the_plain_ntt(logn, cols):
    rng = np.random.default_rng(100 + logn)
    x = rng.integers(0, P, size=(2, cols, 1 << logn), dtype=np.uint64)
    x[0, 0, :3] = [0, 1, P - 1]
    t = T.from_u64(x, "cpu")
    got_f, got_i = TM.ntt_mxu(t), TM.intt_mxu(t)
    with jax.disable_jit():
        g = J.to_gf(x)
        assert np.array_equal(T.to_u64(got_f), J.from_gf(JM.ntt_mxu(g)))
        assert np.array_equal(T.to_u64(got_i), J.from_gf(JM.intt_mxu(g)))
        assert np.array_equal(T.to_u64(got_f), J.from_gf(JN.ntt(g)))
        assert np.array_equal(T.to_u64(got_i), J.from_gf(JN.intt(g)))
    assert torch.equal(got_f, TN.ntt_plain(t))
    assert torch.equal(got_i, TN.ntt_plain(t, True))
    assert torch.equal(TM.intt_mxu(got_f), t)          # round trip
    assert torch.equal(TM.ntt_mxu(got_i), t)


@pytest.mark.parametrize("logn", [0, 1, 2, 3, 5, 12])
def test_ntt_mxu_small_and_odd_sizes(logn):
    rng = np.random.default_rng(200 + logn)
    x = T.from_u64(rng.integers(0, P, size=(1 << logn,), dtype=np.uint64),
                   "cpu")
    assert torch.equal(TM.ntt_mxu(x), TN.ntt_plain(x))
    assert torch.equal(TM.intt_mxu(x), TN.ntt_plain(x, True))


def test_ntt_mxu_chunks_the_columns(monkeypatch):
    """With a chunk smaller than a pass, the DFT runs chunk by chunk and the
    result does not move."""
    rng = np.random.default_rng(7)
    x = T.from_u64(rng.integers(0, P, size=(5, 256), dtype=np.uint64), "cpu")
    whole = TM.ntt_mxu(x)
    monkeypatch.setattr(TM, "CHUNK_POINTS", 16 * 24)
    assert torch.equal(TM.ntt_mxu(x), whole)


def test_ntt_mxu_refuses_what_it_cannot_transform():
    with pytest.raises(ValueError):
        TM.ntt_mxu(torch.zeros((2, 12), dtype=torch.int64))
    with pytest.raises(ValueError):
        TM.ntt_mxu(torch.zeros((2, 16), dtype=torch.int32))


def test_the_dispatch_of_ntt_does_not_reach_ntt_mxu(monkeypatch):
    """`ntt.ntt` / `ntt.intt` take the NTT kernel's path at every size; the
    int8 route is reached only by its own public names."""
    def boom(*a, **k):
        raise AssertionError("ntt_mxu reached from the dispatch")
    monkeypatch.setattr(TM, "_four_step", boom)
    x = T.from_u64(np.arange(1 << 16, dtype=np.uint64), "cpu")
    assert torch.equal(TN.intt(TN.ntt(x)), x)
