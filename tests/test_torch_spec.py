"""The port's protocol layer (`aero_tpu_torch.spec`) against `aero_tpu.spec`.

The same seeded inputs go through both packages; every comparison is exact
(integers and bytes, tolerance 0): field ops, `hash_elements`, `RandomCoin`
draws, Merkle batch proofs, the proof file round trip and verification of
the golden proof `tests/golden/fib.bin`. The malformed-proof cases of
`tests/test_spec_protocol.py::TestMalformedProofsFailClosed` run here
against the port's verifier from that same golden file.
"""

import os

import numpy as np
import pytest
import torch

import test_spec_protocol as original
from aero_tpu.spec import coin as JC
from aero_tpu.spec import field as JF
from aero_tpu.spec import hashing as JH
from aero_tpu.spec import merkle as JM
from aero_tpu.spec import polys as JP
from aero_tpu.spec import proof as JPR
from aero_tpu.spec import verifier as JV
from aero_tpu_torch.spec import coin as TC
from aero_tpu_torch.spec import field as TF
from aero_tpu_torch.spec import hashing as TH
from aero_tpu_torch.spec import merkle as TM
from aero_tpu_torch.spec import polys as TP
from aero_tpu_torch.spec import proof as TPR
from aero_tpu_torch.spec import verifier as TV
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "fib.bin")


def _felts(seed, n):
    rng = np.random.default_rng(seed)
    edge = [0, 1, JF.P - 1, JF.P - 2, 2**32, 2**32 - 1, 2**63]
    return edge + [int(v) for v in rng.integers(0, JF.P, size=n,
                                                dtype=np.uint64)]


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_binary_field_ops_equal(op):
    xs, ys = _felts(1, 64), _felts(2, 64)
    for a, b in zip(xs, reversed(ys)):
        if op == "div" and b == 0:
            continue
        assert getattr(TF, op)(a, b) == getattr(JF, op)(a, b)


def test_inverse_exp_roots_and_batch_inv_equal():
    xs = [x for x in _felts(3, 32) if x]
    assert [TF.inv(x) for x in xs] == [JF.inv(x) for x in xs]
    assert [TF.exp(x, 65537) for x in xs] == [JF.exp(x, 65537) for x in xs]
    assert TF.batch_inv(xs) == JF.batch_inv(xs)
    assert (TF.P, TF.DOMAIN_OFFSET) == (JF.P, JF.DOMAIN_OFFSET)
    for logn in (1, 2, 10, 23, 32):
        assert TF.get_root_of_unity(logn) == JF.get_root_of_unity(logn)


def test_polys_equal():
    coeffs = _felts(4, 25)            # 32 values
    assert TP.ntt_naive(coeffs) == JP.ntt_naive(coeffs)
    assert TP.ntt_naive(coeffs, invert=True) == JP.ntt_naive(coeffs,
                                                             invert=True)
    assert TP.eval_poly_on_coset(coeffs, 3, 7) == \
        JP.eval_poly_on_coset(coeffs, 3, 7)
    xs, ys = _felts(5, 1), _felts(6, 1)
    assert TP.interpolate(xs, ys) == JP.interpolate(xs, ys)
    assert TP.lagrange_eval(xs, ys, 12345) == JP.lagrange_eval(xs, ys, 12345)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 72])
def test_hash_elements_equal(n):
    vals = _felts(10 + n, 80)[:n]
    assert TH.hash_elements(vals) == JH.hash_elements(vals)


def test_merges_equal():
    a, b = JH.hash_elements([1]), JH.hash_elements([2])
    assert TH.merge(a, b) == JH.merge(a, b)
    for v in (0, 1, 2**16, 2**64 - 1):
        assert TH.merge_with_int(a, v) == JH.merge_with_int(a, v)


def test_random_coin_draws_equal():
    seed = JH.hash_elements(_felts(20, 10))
    t, j = TC.RandomCoin(seed), JC.RandomCoin(seed)
    assert [t.draw() for _ in range(5)] == [j.draw() for _ in range(5)]
    assert t.draw_pair() == j.draw_pair()
    assert t.draw_elements(9) == j.draw_elements(9)
    root = JH.hash_elements([7, 8, 9])
    t.reseed(root)
    j.reseed(root)
    assert t.draw() == j.draw()
    t.reseed_with_int(4242)
    j.reseed_with_int(4242)
    assert t.draw_integers(27, 1 << 13) == j.draw_integers(27, 1 << 13)
    assert t.leading_zeros() == j.leading_zeros()


def test_coin_kats():
    coin = TC.RandomCoin(TH.hash_elements(original.FIB_PUB_ELEMENTS))
    assert coin.draw() == 15636605459427237624
    assert coin.draw_integers(20, 64) == [
        55, 46, 17, 44, 61, 8, 43, 39, 19, 3, 26, 31, 30, 4, 37, 40,
        49, 7, 56, 29]


def test_merkle_batch_proofs_equal():
    rng = np.random.default_rng(30)
    leaves = [JH.hash_elements([i, i + 1]) for i in range(256)]
    t, j = TM.MerkleTree(leaves), JM.MerkleTree(leaves)
    assert t.root == j.root and t.depth == j.depth
    for _ in range(5):
        k = int(rng.integers(1, 40))
        idxs = [int(i) for i in rng.choice(256, size=k, replace=False)]
        tp, jp = t.prove_batch(idxs), j.prove_batch(idxs)
        assert tp.serialize_nodes() == jp.serialize_nodes()
        assert tp.leaves == jp.leaves
        assert tp.get_root(idxs) == j.root
        assert tp.into_paths(idxs) == jp.into_paths(idxs)
        back = TM.BatchMerkleProof.deserialize_nodes(
            jp.serialize_nodes(), jp.leaves, j.depth)
        assert back.get_root(idxs) == j.root
        assert TM.batch_proof_coords(256, t.depth, idxs) == \
            JM.batch_proof_coords(256, j.depth, idxs)
    assert t.prove(77) == j.prove(77)


def test_golden_proof_file_round_trip_equal():
    with open(GOLDEN, "rb") as f:
        raw = f.read()
    tpub, tproof = TPR.load_proof_file(GOLDEN)
    jpub, jproof = JPR.load_proof_file(GOLDEN)
    assert TPR.dump_proof_file(tpub, tproof) == raw
    assert tproof.to_bytes() == jproof.to_bytes()
    assert tpub.elements() == jpub.elements()
    assert tpub.program_hash == original.FIB_PROGRAM_HASH
    assert tproof.pow_nonce == 45692


def test_port_verifier_accepts_the_golden_proof_like_aero_tpu():
    tt = TV.verify(*reversed(TPR.load_proof_file(GOLDEN)))
    jt = JV.verify(*reversed(JPR.load_proof_file(GOLDEN)))
    assert tt.query_positions == jt.query_positions
    assert len(tt.query_positions) == 27


def test_port_verifier_rejects_tampered_pow():
    pub, proof = TPR.load_proof_file(GOLDEN)
    proof.pow_nonce += 1
    with pytest.raises(TV.VerificationError):
        TV.verify(proof, pub)


MALFORMED = sorted(n for n in vars(original.TestMalformedProofsFailClosed)
                   if n.startswith("test_"))


@pytest.mark.parametrize("name", MALFORMED)
def test_malformed_proof_fails_closed_in_the_port(name, monkeypatch):
    """Each case calls the original test method with the module's loader,
    verifier and golden path pointed at the port and at the committed
    golden proof."""
    monkeypatch.setattr(original, "GOLDEN", GOLDEN)
    monkeypatch.setattr(original, "load_proof_file", TPR.load_proof_file)
    monkeypatch.setattr(original, "verify", TV.verify)

    def expect(self, mutate):
        pub, proof = original.load_proof_file(original.GOLDEN)
        mutate(proof)
        with pytest.raises(TV.VerificationError):
            original.verify(proof, pub)
    monkeypatch.setattr(original.TestMalformedProofsFailClosed, "_expect",
                        expect)
    getattr(original.TestMalformedProofsFailClosed(), name)()


def test_every_malformed_case_is_covered():
    assert len(MALFORMED) == 12
