"""aero_tpu_torch blake2s (plain path, kernel 2's wrappers on CPU tensors)
vs hashlib and aero_tpu.hash: the cases of tests/test_pallas_kernels.py.

The JAX functions run op by op (`jax.disable_jit`) to keep XLA:CPU
compiles out of the lane. Exact equality throughout.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aero_tpu.field import to_gf
from aero_tpu.hash import blake2s_jax as JBJ
from aero_tpu.hash import blake2s_pallas as JB
from aero_tpu.spec.coin import RandomCoin
from aero_tpu.spec.hashing import merge_with_int
from aero_tpu.spec.merkle import MerkleTree
from aero_tpu_torch.field import from_u64
from aero_tpu_torch.hash import blake2s as TB
from aero_tpu_torch.hash import blake2s_cuda as TK

torch.set_num_threads(1)   # one thread per xdist worker: no oversubscription

RNG = np.random.default_rng(7)


def _words(arr):
    return torch.from_numpy(np.ascontiguousarray(arr, np.uint64)
                            .view(np.int64))


def _np(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("nbytes,batch", [(40, 64), (64, 130), (96, 64),
                                          (2304, 16)])
def test_blake2s_words_vs_hashlib(nbytes, batch):
    nwords = -(-nbytes // 4)
    msgs = RNG.integers(0, 2**32, size=(batch, nwords), dtype=np.uint64)
    for fn in (TB.blake2s_words, TK.blake2s_words):   # plain, wrapper
        d = _np(fn(_words(msgs.T), nbytes))
        for i in range(batch):
            ref = hashlib.blake2s(msgs[i].astype("<u4").tobytes()[:nbytes])
            assert d[:, i].astype("<u4").tobytes() == ref.digest()


@pytest.mark.parametrize("w", [1, 2, 9, 72])
def test_hash_columns_matches_jax(w):
    vals = RNG.integers(0, 2**64 - 1, size=(w, 40), dtype=np.uint64)
    got = _np(TB.hash_columns_t(from_u64(vals, "cpu")))
    with jax.disable_jit():
        # the statically unrolled form: the fori_loop of the multi-block
        # blake2s_t path does not run op by op
        want = np.stack([np.asarray(x) for x in
                         JBJ.hash_rows_tuple(to_gf(vals.T.copy()))])
        if w <= 2:
            assert np.array_equal(
                want, np.asarray(JB.hash_columns_t(to_gf(vals))))
    assert np.array_equal(got, want)
    assert np.array_equal(_np(TK.hash_columns(from_u64(vals, "cpu"))), want)


def test_merge_level_matches_jax_and_hashlib():
    d = RNG.integers(0, 2**32, size=(8, 64), dtype=np.uint64)
    got = _np(TB.merge_level_t(_words(d)))
    with jax.disable_jit():
        want = np.asarray(JB.merge_level_t(jnp.asarray(d.astype(np.uint32))))
    assert np.array_equal(got, want)
    assert np.array_equal(_np(TK.merge_level(_words(d))), want)
    for i in range(32):
        ref = hashlib.blake2s(d[:, 2 * i].astype("<u4").tobytes()
                              + d[:, 2 * i + 1].astype("<u4").tobytes())
        assert got[:, i].astype("<u4").tobytes() == ref.digest()


def test_levels_root_matches_spec():
    n = 32
    leaves = RNG.integers(0, 2**32, size=(8, n), dtype=np.uint64)
    cur = _words(leaves)
    while cur.shape[1] > 1:
        cur = TB.merge_level_t(cur)
    host_leaves = [leaves[:, i].astype("<u4").tobytes() for i in range(n)]
    assert _np(cur)[:, 0].astype("<u4").tobytes() == \
        MerkleTree(host_leaves).root


def test_leading_zeros_matches_jax():
    d = RNG.integers(0, 2**32, size=(8, 50), dtype=np.uint64)
    d[:, 7] = 0                       # all-zero prefix -> 128
    d[0, 9], d[1, 9] = 0, 1 << 24     # 32 + 7 zero bits, big-endian
    got = TB.leading_zeros_t(_words(d)).numpy()
    with jax.disable_jit():
        want = np.asarray(JB.leading_zeros_t(jnp.asarray(
            d.astype(np.uint32))))
    assert np.array_equal(got, want)
    for i in range(50):
        prefix = d[:4, i].astype("<u4").tobytes()
        assert got[i] == 128 - int.from_bytes(prefix, "big").bit_length()


@pytest.mark.parametrize("tag", [b"grind-a", b"grind-b", b"grind-c"])
def test_grind_matches_aero_tpu(tag):
    from aero_tpu.prover.prover import _grind_pow
    seed = hashlib.blake2s(tag).digest()
    want = _grind_pow(_coin_with_seed(seed), 8)
    assert TB.grind_pow(seed, 8, "cpu", batch=256) == want
    assert TK.grind_pow(seed, 8, "cpu") == want
    d = merge_with_int(seed, want)
    assert 128 - int.from_bytes(d[:16], "big").bit_length() >= 8


def _coin_with_seed(seed: bytes) -> RandomCoin:
    coin = RandomCoin(b"")
    coin.seed = seed
    return coin


def test_wrappers_refuse_other_devices():
    meta = torch.empty((2, 8), dtype=torch.int64, device="meta")
    for fn in (TK.hash_columns, TK.merge_level):
        with pytest.raises(ValueError):
            fn(meta)
    with pytest.raises(ValueError):
        TK.blake2s_words(meta, 8)
    with pytest.raises(ValueError):
        TK.grind_pow(b"\0" * 32, 4, "meta")

