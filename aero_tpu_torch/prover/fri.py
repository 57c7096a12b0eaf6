"""FRI prover: commit and fold layers on the device.

The counterpart of `aero_tpu/prover/fri.py`. At each layer the degree-(ff-1)
interpolant through a fiber, evaluated at alpha, becomes the next layer's
value; in coefficient form that is one iNTT, a weighted fold of
coefficient groups with weights (alpha/offset)^j, and one NTT. Each layer
is committed as a Merkle tree whose leaf fp holds the ff values at
positions {fp + t*(m/ff)}: the rows of evals.reshape(ff, m/ff) read
column-major, which the leaf hasher takes without a transpose.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from aero_tpu.spec import field as F

from ..field import from_u64, gf_sum, mul, to_u64
from ..merkle import ResidentMerkleTree, commit_columns
from ..ntt import intt, ntt
from ..ntt.tables import np_power_series


def fold_evals(evals: torch.Tensor, alpha: int, ff: int,
               offset: int = F.DOMAIN_OFFSET) -> torch.Tensor:
    """One FRI fold: (m,) -> (m/ff,)."""
    m = evals.shape[-1]
    groups = intt(evals).reshape(m // ff, ff)
    w = F.mul(alpha, F.inv(offset))
    weights = from_u64(np_power_series(w, ff), evals.device)
    return ntt(gf_sum(mul(groups, weights), axis=-1).contiguous())


@dataclass
class FriLayer:
    evals: torch.Tensor            # evaluations over this layer's domain
    tree: ResidentMerkleTree       # transposed-leaf commitment
    ff: int                        # folding factor (leaf row width)

    def rows_at(self, positions) -> torch.Tensor:
        """Leaf rows (len(positions), ff), gathered on the device."""
        m = self.evals.shape[-1]
        cols = self.evals.reshape(self.ff, m // self.ff)
        idx = torch.as_tensor(np.asarray(list(positions), dtype=np.int64),
                              device=cols.device)
        return cols[:, idx].T


def commit_fri(deep_evals: torch.Tensor, coin, ff: int, max_remainder: int
               ) -> Tuple[List[FriLayer], List[int], List[int],
                          ResidentMerkleTree]:
    """The FRI commit phase: (layers, alphas, remainder values, remainder
    tree). The coin is reseeded with each layer root and an alpha drawn
    after each, the remainder's included (drawn but unused, as the
    verifier does)."""
    layers: List[FriLayer] = []
    alphas: List[int] = []
    evals = deep_evals
    m = evals.shape[-1]
    while m > max_remainder:
        tree = commit_columns(evals.reshape(ff, m // ff))
        coin.reseed(tree.root)
        alpha = coin.draw()
        alphas.append(alpha)
        layers.append(FriLayer(evals, tree, ff))
        evals = fold_evals(evals, alpha, ff)
        m = evals.shape[-1]

    rem_tree = commit_columns(evals.reshape(ff, m // ff))
    coin.reseed(rem_tree.root)
    alphas.append(coin.draw())
    remainder = [int(v) for v in to_u64(evals)]
    return layers, alphas, remainder, rem_tree
