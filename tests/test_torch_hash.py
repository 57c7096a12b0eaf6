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
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


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


def _host_batch(seed, bits):
    """A batch of the search rendered with hashlib: the smallest qualifying
    nonce of base .. base + count - 1, or NOT_FOUND."""
    def run(base, count):
        for nonce in range(base, base + count):
            d = merge_with_int(seed, nonce)
            if 128 - int.from_bytes(d[:16], "big").bit_length() >= bits:
                return nonce
        return TK.NOT_FOUND
    return run


def test_grind_batches_are_sized_from_the_bits():
    for bits, want in ((0, TK.WAVE), (8, TK.WAVE), (16, TK.WAVE),
                       (17, 4 << 17), (20, 4 << 20), (40, TK.MAX_BATCH)):
        gen = TK.grind_batches(bits)
        got = [next(gen) for _ in range(3)]
        assert got == [(i * want, want) for i in range(3)], bits
        assert want % 256 == 0
    gen = TK.grind_batches(2, wave=100)        # whole blocks of 256
    assert [next(gen) for _ in range(2)] == [(0, 256), (256, 256)]


@pytest.mark.parametrize("tag", [b"sched-a", b"sched-b", b"sched-c",
                                 b"sched-d"])
def test_grind_schedule_returns_the_minimal_nonce_from_a_later_batch(tag):
    """The kernel wrapper's batch walk, with the batch rendered on the host:
    batches of 256 nonces at 10 bits put the hit in a later batch for these
    seeds, and the walk still returns the plain version's minimal nonce."""
    seed = hashlib.blake2s(tag).digest()
    want = TB.grind_pow(seed, 10, "cpu", batch=1024)
    seen = []

    def run(base, count):
        seen.append((base, count))
        return _host_batch(seed, 10)(base, count)

    got = TK.grind_search(TK.grind_batches(0, wave=256), run)
    assert got == want
    assert seen == [(256 * i, 256) for i in range(want // 256 + 1)]
    assert len(seen) >= 2          # nonces 772, 797, 1891 and 1842


def test_grind_search_stops_at_the_first_batch_with_a_hit():
    calls = []

    def run(base, count):
        calls.append(base)
        return TK.NOT_FOUND if base < 512 else base + 7

    assert TK.grind_search(TK.grind_batches(0, wave=256), run) == 519
    assert calls == [0, 256, 512]
    with pytest.raises(RuntimeError):
        TK.grind_search([(0, 4)], lambda b, c: TK.NOT_FOUND)


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


# ------------------------------------------------- the row-major front ends

@pytest.mark.parametrize("w", [1, 2, 5, 9])
def test_hash_elements_rows_matches_jax_and_the_spec(w):
    from aero_tpu.spec.hashing import hash_elements
    rows = RNG.integers(0, 2**64 - 1, size=(24, w), dtype=np.uint64)
    got = TB.hash_elements_rows(from_u64(rows, "cpu"))
    assert got.shape == (24, 8) and got.is_contiguous()
    with jax.disable_jit():
        # the unrolled form again; `JBJ.hash_elements_rows` itself where one
        # block (w <= 2) keeps it off the fori_loop
        want = np.stack([np.asarray(x) for x in
                         JBJ.hash_rows_tuple(to_gf(rows))], axis=1)
        if w <= 2:
            assert np.array_equal(
                want, np.asarray(JBJ.hash_elements_rows(to_gf(rows))))
    assert np.array_equal(_np(got), want)
    digests = TB.digests_to_bytes(got)
    assert digests == JBJ.digests_to_bytes(want)
    canon = rows % np.uint64((1 << 64) - (1 << 32) + 1)
    assert digests == [hash_elements([int(v) for v in r]) for r in canon]
    # the same words through the word-major message path
    words = TB.felt_rows_to_words(from_u64(rows, "cpu"))
    assert np.array_equal(_np(words),
                          np.asarray(JBJ.felt_rows_to_words(to_gf(rows))))
    assert torch.equal(TB.blake2s_words(words.T.contiguous(), 32 * w).T, got)


@pytest.mark.parametrize("n", [1, 2, 32])
def test_merge_pairs_matches_jax_and_hashlib(n):
    d = RNG.integers(0, 2**32, size=(2 * n, 8), dtype=np.uint64)
    got = TB.merge_pairs(_words(d))
    assert got.shape == (n, 8) and got.is_contiguous()
    with jax.disable_jit():
        want = np.asarray(JBJ.merge_pairs(jnp.asarray(d.astype(np.uint32))))
    assert np.array_equal(_np(got), want)
    raw = d.astype("<u4")
    assert TB.digests_to_bytes(got) == [
        hashlib.blake2s(raw[2 * i].tobytes() + raw[2 * i + 1].tobytes())
        .digest() for i in range(n)]
    # a numpy array goes the same way as a tensor
    assert TB.digests_to_bytes(want) == TB.digests_to_bytes(got)
