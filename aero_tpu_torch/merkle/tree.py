"""Merkle commitments whose node levels stay on the device.

The counterpart of `aero_tpu/merkle/tree.py` (`commit_columns`,
`ResidentMerkleTree`). Leaves are the hash_elements digests of the rows of
column-major felts (w, m); every level is an (8, size) int64 tensor of u32
digest words. A batch opening gathers only the digests the proof ships
(`spec.merkle.batch_proof_coords`), one device gather per level.

The TPU package chunked the leaf axis to bound an 8x word message in HBM
and finished the levels below 2^15 on the host to dodge relay module
loads (`tree.py:160-187`); neither is carried over. The hashing goes
through kernel 2 for CUDA tensors (`hash.blake2s_cuda`).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from aero_tpu.spec.merkle import BatchMerkleProof, batch_proof_coords

from ..hash.blake2s_cuda import hash_columns, merge_level


def _digest_bytes(words: np.ndarray) -> bytes:
    return words.astype("<u4").tobytes()


class ResidentMerkleTree:
    """API of `spec.merkle.MerkleTree` (root / depth / prove_batch) over
    device-resident levels: levels[k] is (8, n >> k), levels[-1] the root."""

    def __init__(self, levels: List[torch.Tensor]):
        self.levels = levels
        self.n = int(levels[0].shape[1])
        self._root = _digest_bytes(levels[-1][:, 0].cpu().numpy())

    @property
    def root(self) -> bytes:
        return self._root

    @property
    def depth(self) -> int:
        return self.n.bit_length() - 1

    def _fetch(self, flat_coords: List[int]) -> Dict[int, bytes]:
        """flat-tree indices (root 1, leaves [n, 2n)) -> digest bytes."""
        by_level: Dict[int, List[int]] = {}
        for c in flat_coords:
            by_level.setdefault(c.bit_length() - 1, []).append(c)
        out = {}
        for log_size, coords in by_level.items():
            lvl = self.levels[self.depth - log_size]
            offs = torch.as_tensor([c - (1 << log_size) for c in coords],
                                   dtype=torch.int64, device=lvl.device)
            got = lvl[:, offs].cpu().numpy()
            for j, c in enumerate(coords):
                out[c] = _digest_bytes(got[:, j])
        return out

    def prove_batch(self, indexes) -> BatchMerkleProof:
        leaf_coords, node_coords = batch_proof_coords(self.n, self.depth,
                                                      indexes)
        got = self._fetch(list(leaf_coords)
                          + [c for lst in node_coords for c in lst])
        return BatchMerkleProof(
            leaves=[got[c] for c in leaf_coords],
            nodes=[[got[c] for c in lst] for lst in node_coords],
            depth=self.depth)

    def to(self, device) -> "ResidentMerkleTree":
        """Move the levels (checkpointing: ProverState.to_host/to_device)."""
        self.levels = [lvl.to(device) for lvl in self.levels]
        return self


def commit_columns(cols: torch.Tensor) -> ResidentMerkleTree:
    """Commit to the rows of column-major felts (w, n_leaves)."""
    cur = hash_columns(cols.contiguous())
    levels = [cur]
    while cur.shape[1] > 1:
        cur = merge_level(cur)
        levels.append(cur)
    return ResidentMerkleTree(levels)
