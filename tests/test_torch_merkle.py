"""aero_tpu_torch.merkle vs aero_tpu.merkle.commit_columns (JAX, CPU):
the root and the serialized batch openings, for the widths the prover
commits (FRI layers 8 use the same path). Exact equality."""

import numpy as np
import pytest
import torch

from aero_tpu.field import to_gf
from aero_tpu.merkle import commit_columns as jax_commit
from aero_tpu.spec.hashing import hash_elements
from aero_tpu.spec.merkle import MerkleTree
from aero_tpu_torch.field import from_u64
from aero_tpu_torch.merkle import commit_columns
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


P = (1 << 64) - (1 << 32) + 1


@pytest.mark.parametrize("w", [2, 9, 72])
def test_root_and_openings_match_jax(w):
    rng = np.random.default_rng(100 + w)
    n = 64
    vals = rng.integers(0, P, size=(w, n), dtype=np.uint64)
    tree = commit_columns(from_u64(vals, "cpu"))
    ref = jax_commit(to_gf(vals))
    assert tree.root == ref.root
    assert tree.depth == ref.depth == 6
    for idxs in ([3, 17, 40], [0, 1, 63], list(range(0, 64, 5))):
        assert tree.prove_batch(idxs).serialize_nodes() == \
            ref.prove_batch(idxs).serialize_nodes()
        assert tree.prove_batch(idxs).leaves == ref.prove_batch(idxs).leaves
    # and the spec's host tree over hash_elements leaves
    spec = MerkleTree([hash_elements([int(v) for v in vals[:, i]])
                       for i in range(n)])
    assert tree.root == spec.root


def test_fri_layer_shape():
    """A folding-factor-8 layer: leaf fp is column fp of (8, m/8)."""
    rng = np.random.default_rng(5)
    evals = rng.integers(0, P, size=512, dtype=np.uint64)
    cols = evals.reshape(8, 64)
    tree = commit_columns(from_u64(evals, "cpu").reshape(8, 64))
    spec = MerkleTree([hash_elements([int(v) for v in cols[:, i]])
                       for i in range(64)])
    assert tree.root == spec.root
    assert tree.prove_batch([9, 2]).serialize_nodes() == \
        spec.prove_batch([9, 2]).serialize_nodes()


@pytest.mark.parametrize("w,n", [(2, 16), (9, 64), (5, 1)])
def test_commit_rows_and_digests_match_jax(w, n):
    import jax
    from aero_tpu.hash import blake2s_jax as JBJ
    from aero_tpu.merkle import commit_digests as jax_commit_digests
    from aero_tpu_torch.hash import hash_elements_rows
    from aero_tpu_torch.merkle import commit_digests, commit_rows
    rng = np.random.default_rng(200 + w)
    vals = rng.integers(0, P, size=(w, n), dtype=np.uint64)
    rows = from_u64(vals.T.copy(), "cpu")
    tree = commit_rows(rows)
    assert tree.root == commit_columns(from_u64(vals, "cpu")).root
    assert tree.root == commit_digests(hash_elements_rows(rows)).root
    with jax.disable_jit():
        leaves = np.stack([np.asarray(x) for x in
                           JBJ.hash_rows_tuple(to_gf(vals.T.copy()))], axis=1)
        ref = jax_commit_digests(jax.numpy.asarray(leaves))
    assert tree.root == ref.root and tree.depth == ref.depth
    leaf_t = torch.from_numpy(leaves.astype(np.int64))
    assert commit_digests(leaf_t).root == ref.root
    for index in sorted({0, n // 3, n - 1}):
        assert tree.prove(index) == ref.prove(index)
    if n > 1:
        assert tree.prove_batch([0, n - 1]).serialize_nodes() == \
            ref.prove_batch([0, n - 1]).serialize_nodes()


def test_prove_opens_to_the_root():
    from aero_tpu.spec.hashing import merge
    from aero_tpu_torch.merkle import commit_rows
    rng = np.random.default_rng(9)
    vals = rng.integers(0, P, size=(32, 3), dtype=np.uint64)
    tree = commit_rows(from_u64(vals, "cpu"))
    spec = MerkleTree([hash_elements([int(v) for v in r]) for r in vals])
    for index in (0, 5, 31):
        path = tree.prove(index)
        assert path == spec.prove(index) and len(path) == tree.depth + 1
        node, i = path[0], index
        for sib in path[1:]:
            node = merge(sib, node) if i & 1 else merge(node, sib)
            i >>= 1
        assert node == tree.root


def _index_sets(n):
    """The index sets a batch opening of an n-leaf tree is held on."""
    sets = {"one_leaf": [n // 3],
            "two_siblings": [(n // 2) & ~1, ((n // 2) & ~1) + 1],
            "right_child_alone": [(n // 4) * 2 + 1],
            "last_leaf": [n - 1]}
    if n == 8:
        sets["every_leaf"] = list(range(8))
    if n >= 27:
        sets["random_27_unsorted"] = [int(i) for i in np.random.default_rng(
            n).choice(n, size=27, replace=False)]
    return sets


_TREES = {}


def _trees(n):
    """The port's tree on the CPU and the spec's host tree over the same n
    random leaf digests."""
    if n not in _TREES:
        from aero_tpu_torch.merkle import commit_digests
        words = np.random.default_rng(n).integers(0, 1 << 32, size=(n, 8),
                                                 dtype=np.int64)
        spec = MerkleTree([w.astype("<u4").tobytes() for w in words])
        _TREES[n] = (commit_digests(torch.from_numpy(words)), spec)
    return _TREES[n]


@pytest.mark.parametrize("n,name,indexes", [
    (n, name, idxs) for n in (2, 4, 8, 256, 1 << 17)
    for name, idxs in _index_sets(n).items()])
def test_openings_equal_the_spec_tree_byte_for_byte(n, name, indexes):
    """One gather over all of a tree's levels: `prove_batch`'s leaves and
    serialized nodes, and `prove` of each index, equal the spec's."""
    tree, spec = _trees(n)
    assert tree.root == spec.root
    got, want = tree.prove_batch(indexes), spec.prove_batch(indexes)
    assert got.leaves == want.leaves
    assert got.serialize_nodes() == want.serialize_nodes()
    assert got.depth == want.depth
    for i in indexes:
        assert tree.prove(i) == spec.prove(i)


def test_an_opening_outside_the_tree_raises():
    tree, _ = _trees(8)
    with pytest.raises(IndexError):
        tree.prove(8)
    with pytest.raises(IndexError):
        tree.prove_batch([3, 8])
