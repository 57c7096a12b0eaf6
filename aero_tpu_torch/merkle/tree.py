"""Merkle commitments whose node levels stay on the device.

The counterpart of `aero_tpu/merkle/tree.py` (`commit_columns`,
`commit_rows`, `commit_digests`, `ResidentMerkleTree`). One tree class:
`aero_tpu` keeps a `DeviceMerkleTree` beside it because its TPU path
downloaded the levels to the host; here `ResidentMerkleTree` serves every
commit, with `prove` and `prove_batch` both. Leaves are the hash_elements
digests of the rows of column-major felts (w, m); every level is an
(8, size) int64 tensor of u32 digest words. A batch opening gathers only the
digests the proof ships (`spec.merkle.batch_proof_coords`) in one gather
over all the levels (`hash.blake2s_cuda.merkle_gather`), under the tracing
span `merkle_open`: on a card the kernel reads the indexes from pinned host
memory and writes the digests' bytes back into it, so an opening is one
launch and one wait for the stream (one `syncs`), with no copy.

The TPU package chunked the leaf axis to bound an 8x word message in HBM
and finished the levels below 2^15 on the host to dodge relay module
loads (`tree.py:160-187`); neither is carried over. The hashing goes
through kernel 2 for CUDA tensors (`hash.blake2s_cuda`).
"""

from __future__ import annotations

from typing import List

import torch

from .._device import to_host, wait_stream
from ..spec.merkle import BatchMerkleProof, batch_proof_coords
from ..utils import span

from ..hash.blake2s import digests_to_bytes
from ..hash.blake2s_cuda import hash_columns, merge_level, merkle_gather


class ResidentMerkleTree:
    """API of `spec.merkle.MerkleTree` (root / depth / prove_batch) over
    device-resident levels: levels[k] is (8, n >> k), levels[-1] the root."""

    def __init__(self, levels: List[torch.Tensor]):
        self.levels = levels
        self.n = int(levels[0].shape[1])
        self._root = digests_to_bytes(to_host(levels[-1]).t())[0]

    @property
    def root(self) -> bytes:
        return self._root

    @property
    def depth(self) -> int:
        return self.n.bit_length() - 1

    def _fetch(self, flat_coords: List[int]) -> List[bytes]:
        """Flat-tree indices (root 1, leaves [n, 2n)) -> their digests, in
        order: one gather over every level and, on a card, one wait."""
        if not flat_coords:
            return []
        if min(flat_coords) < 1 or max(flat_coords) >= 2 * self.n:
            raise IndexError(f"flat-tree index outside 1 .. {2 * self.n - 1}")
        dev = self.levels[0].device
        coords = torch.tensor(flat_coords, dtype=torch.int64,
                              pin_memory=dev.type == "cuda")
        words = merkle_gather(self.levels, coords)
        if dev.type == "cuda":
            wait_stream(dev)       # `coords` and `words` held until it returns
        raw = words.numpy().tobytes()
        return [raw[i:i + 32] for i in range(0, len(raw), 32)]

    def prove(self, index: int) -> List[bytes]:
        """The opening of one leaf: its digest, then the sibling at each
        level up to the root (`spec.merkle.MerkleTree.prove`)."""
        coords = [self.n + index]
        i = self.n + index
        while i > 1:
            coords.append(i ^ 1)
            i >>= 1
        return self._fetch(coords)

    def prove_batch(self, indexes) -> BatchMerkleProof:
        with span("merkle_open"):
            leaf_coords, node_coords = batch_proof_coords(self.n, self.depth,
                                                          indexes)
            got = self._fetch(leaf_coords
                              + [c for lst in node_coords for c in lst])
            nodes, k = [], len(leaf_coords)
            for lst in node_coords:
                nodes.append(got[k:k + len(lst)])
                k += len(lst)
            return BatchMerkleProof(leaves=got[:len(leaf_coords)],
                                    nodes=nodes, depth=self.depth)

    def to(self, device) -> "ResidentMerkleTree":
        """Move the levels (checkpointing: ProverState.to_host/to_device).
        The gather takes the level pointers afresh at every call, so nothing
        else needs rebuilding."""
        self.levels = [lvl.to(device) for lvl in self.levels]
        return self


def _tree_over(leaves_t: torch.Tensor) -> ResidentMerkleTree:
    """The tree over word-major leaf digests (8, n)."""
    cur = leaves_t
    levels = [cur]
    while cur.shape[1] > 1:
        cur = merge_level(cur)
        levels.append(cur)
    return ResidentMerkleTree(levels)


def commit_columns(cols: torch.Tensor) -> ResidentMerkleTree:
    """Commit to the rows of column-major felts (w, n_leaves)."""
    return _tree_over(hash_columns(cols.contiguous()))


def commit_digests(leaf_digests: torch.Tensor) -> ResidentMerkleTree:
    """The tree over row-major leaf digests (n_leaves, 8)."""
    return _tree_over(leaf_digests.t().contiguous())


def commit_rows(rows: torch.Tensor) -> ResidentMerkleTree:
    """Commit to row-major felts (n_leaves, row_width)."""
    return commit_columns(rows.t())
