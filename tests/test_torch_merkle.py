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

torch.set_num_threads(1)   # one thread per xdist worker: no oversubscription

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
