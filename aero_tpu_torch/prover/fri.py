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

import torch

from .._device import index_tensor
from ..spec import field as F

from ..field import from_u64, gf_sum, mul, scalar, to_u64
from ..merkle import ResidentMerkleTree, commit_columns
from ..ntt import intt, ntt
from ..ntt.tables import np_power_series


def transposed_rows(evals: torch.Tensor, ff: int) -> torch.Tensor:
    """(m,) evaluations -> (m/ff, ff) leaf rows: leaf fp is the strided
    fiber {fp + t*(m/ff)}."""
    m = evals.shape[-1]
    return evals.reshape(ff, m // ff).T


def _fold_with(evals: torch.Tensor, weights: torch.Tensor, ff: int
               ) -> torch.Tensor:
    m = evals.shape[-1]
    groups = intt(evals).reshape(m // ff, ff)
    return ntt(gf_sum(mul(groups, weights), axis=-1).contiguous())


def fold_evals(evals: torch.Tensor, alpha: int, ff: int,
               offset: int = F.DOMAIN_OFFSET) -> torch.Tensor:
    """One FRI fold: (m,) -> (m/ff,)."""
    w = F.mul(alpha, F.inv(offset))
    return _fold_with(evals, from_u64(np_power_series(w, ff), evals.device),
                      ff)


def fold_evals_gf(evals: torch.Tensor, alpha: torch.Tensor, ff: int,
                  offset: int = F.DOMAIN_OFFSET) -> torch.Tensor:
    """`fold_evals` with the challenge as a 0-d field tensor on the device:
    the weights (alpha/offset)^j come from device multiplies and nothing is
    read back to the host."""
    w = mul(alpha, scalar(F.inv(offset), evals.device))
    weights = [scalar(1, evals.device)]
    for _ in range(ff - 1):
        weights.append(mul(weights[-1], w))
    return _fold_with(evals, torch.stack(weights), ff)


@dataclass
class FriLayer:
    evals: torch.Tensor            # evaluations over this layer's domain
    tree: ResidentMerkleTree       # transposed-leaf commitment
    ff: int                        # folding factor (leaf row width)

    def rows_at(self, positions) -> torch.Tensor:
        """Leaf rows (len(positions), ff), gathered on the device."""
        m = self.evals.shape[-1]
        cols = self.evals.reshape(self.ff, m // self.ff)
        return cols[:, index_tensor(list(positions), cols.device)].T


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
