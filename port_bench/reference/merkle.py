"""Merkle tree + batch openings (blake2s-256), protocol specification.

Node hash = blake2s(left || right) over 32-byte digests; leaf hash =
hash_elements(row) (reference: src/stark_verifier/channel.cairo:206-231,
random.cairo:41-63). Batch proofs use winterfell-0.4-style shared-node
compression: per normalized leaf-pair group, a list of sibling digests,
consumed level-by-level in ascending active-node order (validated bit-exactly
against the golden proof's trace/constraint/FRI openings).

Serialized form (Queries.paths blob in the proof): u8 number of groups, then
per group u8 digest count + that many 32-byte digests.

Frozen copy of the port's `spec/merkle.py` for the benchmark's plain
reference: it imports nothing of the program, and a change to the
program does not change it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

from .hashing import merge


class MerkleError(Exception):
    pass


class MerkleTree:
    """Full binary Merkle tree over pre-hashed leaves.

    Stored winterfell-style as a flat 1-indexed array: nodes[1] is the root,
    node i has children 2i, 2i+1; leaves occupy [n, 2n).
    """

    def __init__(self, leaves: Sequence[bytes]):
        n = len(leaves)
        if n < 2 or n & (n - 1):
            raise MerkleError("number of leaves must be a power of 2, >= 2")
        self.n = n
        nodes: List[bytes] = [b""] * n + list(leaves)
        for i in range(n - 1, 0, -1):
            nodes[i] = merge(nodes[2 * i], nodes[2 * i + 1])
        self.nodes = nodes

    @property
    def root(self) -> bytes:
        return self.nodes[1]

    @property
    def depth(self) -> int:
        return self.n.bit_length() - 1

    def prove(self, index: int) -> List[bytes]:
        """Single authentication path: [leaf, sibling_0, ..., sibling_{d-1}]."""
        path = [self.nodes[self.n + index]]
        i = self.n + index
        while i > 1:
            path.append(self.nodes[i ^ 1])
            i >>= 1
        return path

    def prove_batch(self, indexes: Sequence[int]) -> "BatchMerkleProof":
        """Winterfell-compatible batch proof for `indexes` (arbitrary order,
        no duplicates). leaves[i] corresponds to indexes[i]."""
        leaf_coords, node_coords = batch_proof_coords(self.n, self.depth,
                                                      indexes)
        return BatchMerkleProof(
            leaves=[self.nodes[c] for c in leaf_coords],
            nodes=[[self.nodes[c] for c in lst] for lst in node_coords],
            depth=self.depth)


@dataclass
class BatchMerkleProof:
    leaves: List[bytes]       # leaf digest per queried index, in query order
    nodes: List[List[bytes]]  # per normalized group, shared-node-compressed
    depth: int

    def get_root(self, indexes: Sequence[int]) -> bytes:
        """Reconstruct the root; raises MerkleError on malformed proofs."""
        index_map = _map_indexes(indexes)
        groups = _normalize_indexes(indexes)
        if len(groups) != len(self.nodes):
            raise MerkleError("group count mismatch")

        offset = 1 << self.depth
        v: Dict[int, bytes] = {}
        pointers: List[int] = []
        active: List[int] = []
        for i, g in enumerate(groups):
            if g in index_map:
                left = self.leaves[index_map[g]]
                if (g + 1) in index_map:
                    right = self.leaves[index_map[g + 1]]
                    pointers.append(0)
                else:
                    if not self.nodes[i]:
                        raise MerkleError("missing sibling node")
                    right = self.nodes[i][0]
                    pointers.append(1)
            else:
                if not self.nodes[i] or (g + 1) not in index_map:
                    raise MerkleError("missing node for right-only group")
                left = self.nodes[i][0]
                right = self.leaves[index_map[g + 1]]
                pointers.append(1)
            parent_index = (offset + g) >> 1
            v[parent_index] = merge(left, right)
            active.append(parent_index)

        for _ in range(self.depth - 1):
            next_active: List[int] = []
            i = 0
            while i < len(active):
                node = active[i]
                slot = i  # winterfell: raw scan index selects the node list
                if i + 1 < len(active) and active[i + 1] == (node ^ 1):
                    sibling = v[node ^ 1]
                    i += 1
                else:
                    lst = self.nodes[slot]
                    ptr = pointers[slot]
                    if ptr >= len(lst):
                        raise MerkleError("ran out of proof nodes")
                    sibling = lst[ptr]
                    pointers[slot] = ptr + 1
                    v[node ^ 1] = sibling
                if node & 1:
                    parent = merge(sibling, v[node])
                else:
                    parent = merge(v[node], sibling)
                parent_index = node >> 1
                v[parent_index] = parent
                next_active.append(parent_index)
                i += 1
            active = next_active

        if len(active) != 1 or active[0] != 1:
            raise MerkleError("failed to converge to root")
        return v[1]

    def into_paths(self, indexes: Sequence[int]) -> List[List[bytes]]:
        """Decompress into one full path per index: [leaf, sib_0, ...]."""
        known = self._reconstruct_nodes(indexes)
        index_map = _map_indexes(indexes)
        offset = 1 << self.depth
        paths = []
        for idx in indexes:
            path = [self.leaves[index_map[idx]]]
            node = offset + idx
            while node > 1:
                sib = node ^ 1
                if sib not in known:
                    raise MerkleError(f"node {sib} not derivable")
                path.append(known[sib])
                node >>= 1
            paths.append(path)
        return paths

    def _reconstruct_nodes(self, indexes: Sequence[int]) -> Dict[int, bytes]:
        """Run get_root, returning every flat-tree node encountered."""
        index_map = _map_indexes(indexes)
        groups = _normalize_indexes(indexes)
        offset = 1 << self.depth
        v: Dict[int, bytes] = {}
        pointers: List[int] = []
        active: List[int] = []
        for i, g in enumerate(groups):
            if g in index_map:
                left = self.leaves[index_map[g]]
                if (g + 1) in index_map:
                    right = self.leaves[index_map[g + 1]]
                    pointers.append(0)
                else:
                    right = self.nodes[i][0]
                    pointers.append(1)
            else:
                left = self.nodes[i][0]
                right = self.leaves[index_map[g + 1]]
                pointers.append(1)
            v[offset + g] = left
            v[offset + g + 1] = right
            parent_index = (offset + g) >> 1
            v[parent_index] = merge(left, right)
            active.append(parent_index)
        for _ in range(self.depth - 1):
            next_active: List[int] = []
            i = 0
            while i < len(active):
                node = active[i]
                slot = i
                if i + 1 < len(active) and active[i + 1] == (node ^ 1):
                    sibling = v[node ^ 1]
                    i += 1
                else:
                    sibling = self.nodes[slot][pointers[slot]]
                    pointers[slot] += 1
                    v[node ^ 1] = sibling
                if node & 1:
                    parent = merge(sibling, v[node])
                else:
                    parent = merge(v[node], sibling)
                v[node >> 1] = parent
                next_active.append(node >> 1)
                i += 1
            active = next_active
        return v

    # --- serialization of the nodes section (Queries.paths blob) ---

    def serialize_nodes(self) -> bytes:
        out = bytearray([len(self.nodes)])
        for lst in self.nodes:
            out.append(len(lst))
            for d in lst:
                out += d
        return bytes(out)

    @classmethod
    def deserialize_nodes(cls, data: bytes, leaves: List[bytes], depth: int
                          ) -> "BatchMerkleProof":
        n = data[0]
        off = 1
        node_lists = []
        for _ in range(n):
            cnt = data[off]
            off += 1
            lst = [data[off + 32 * j: off + 32 * (j + 1)] for j in range(cnt)]
            off += 32 * cnt
            node_lists.append(lst)
        if off != len(data):
            raise MerkleError(f"trailing bytes in batch proof: {len(data) - off}")
        return cls(leaves=leaves, nodes=node_lists, depth=depth)


def batch_proof_coords(n: int, depth: int, indexes: Sequence[int]):
    """Flat-tree coordinates of every digest a batch proof ships — pure
    index arithmetic (no digest values), so a device-resident tree can
    gather exactly these nodes instead of downloading all 2n of them.

    Returns (leaf_coords, node_coords): leaf_coords[i] is the flat index of
    the leaf for indexes[i]; node_coords mirrors BatchMerkleProof.nodes
    (per normalized group, in consumption order)."""
    index_map = _map_indexes(indexes)
    groups = _normalize_indexes(indexes)
    leaf_coords = [n + idx for idx in indexes]
    node_coords: List[List[int]] = []

    active: List[int] = []  # flat-tree indices at the current level
    for g in groups:
        lst: List[int] = []
        if g in index_map:
            if (g + 1) not in index_map:
                lst.append(n + g + 1)
        else:
            # only the right child queried: include the left leaf
            lst.append(n + g)
        node_coords.append(lst)
        active.append((n + g) >> 1)

    for _ in range(depth - 1):
        next_active: List[int] = []
        i = 0
        while i < len(active):
            node = active[i]
            # winterfell assignment rule: the raw scan index (which skips
            # ahead by 2 on pair merges) selects the receiving node list
            slot = i
            if i + 1 < len(active) and active[i + 1] == (node ^ 1):
                i += 1  # sibling is itself an active node; nothing to add
            else:
                node_coords[slot].append(node ^ 1)
            next_active.append(node >> 1)
            i += 1
        active = next_active
    return leaf_coords, node_coords


def _map_indexes(indexes: Sequence[int]) -> Dict[int, int]:
    m = {}
    for i, idx in enumerate(indexes):
        if idx in m:
            raise MerkleError("duplicate index")
        m[idx] = i
    return m


def _normalize_indexes(indexes: Sequence[int]) -> List[int]:
    return sorted({idx & ~1 for idx in indexes})
