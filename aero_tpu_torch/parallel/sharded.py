"""The prover's compute stages on the local shards of a mesh.

The counterpart of `aero_tpu/parallel/sharded.py`. Every stage takes a
`Mesh` and this rank's contiguous block `(..., m / D)` of the domain axis
and returns local blocks again; what crosses the block boundary is
written out as an exchange:

- `stage_lde`          iNTT + coset LDE through the distributed NTT, in
                       chunks of columns (`dist_ntt.lde_chunk_cols`);
- `stage_commit`       leaf hashing and the lower Merkle levels are local
                       (the blake2s kernels on a CUDA device); the D block
                       digests are nodes of the global tree, so one
                       all-gather and log2(D) more levels finish the root
                       on every rank;
- `stage_composition`  constraint evaluation on the local block; the frame
                       shift x -> x * g reads `blowup` points of the next
                       rank's block (`next_points`, a halo exchange); the
                       composition's iNTT and LDE go through the distributed
                       NTT and its split into columns is a redistribution
                       (`deinterleave_columns`);
- `stage_deep`         elementwise on the local block, the algebra of the
                       prover's `_deep_core`;
- `stage_fri_fold`     one FRI fold, its iNTT and NTT distributed, the
                       weighted fold of coefficient groups local;
- `fold_leaf_columns`  the redistribution that puts the ff values of each
                       leaf of a folded layer on one rank before its commit.

The JAX module's fixed-shape Merkle scan over garbage lanes, its jit and
SPMD caches, the padding of its column chunks to a uniform width and its
eager-versus-jit split answer XLA's compile times and are not carried
over. `gf_scalar` has no
counterpart: a scalar is a Python int here.

Every value is an exact field element or digest word, so the results equal
the single-device prover's bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..air.air import Air
from ..field import from_u64, gf_sum, mul, power_series, scalar
from ..hash.blake2s_cuda import hash_columns, merge_level
from ..ntt.tables import np_power_series
from ..prover.prover import (FRAG, ConstraintMerger, Wrapped, _deep_core,
                             ceval_domain)
from ..spec import field as F
from .dist_ntt import dist_lde, dist_lde_coeffs, dist_ntt
from .mesh import Mesh, all_gather, all_to_all, send_to_rank


# --------------------------------------------------------------- stage: LDE

def dist_lde_cols(mesh: Mesh, trace: torch.Tensor, log_blowup: int,
                  offset: int = F.DOMAIN_OFFSET,
                  cols_per_chunk: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coefficients, coset LDE) of sharded evaluation columns (w, n / D):
    the iNTT, the scaling, the padding and the forward transform run one
    chunk of `cols_per_chunk` columns at a time (None: the width
    `dist_ntt.lde_chunk_cols` gives; all columns on the CPU), each written into
    the two outputs, (w, n / D) and (w, m / D), allocated once."""
    polys = torch.empty_like(trace)
    return polys, dist_lde(mesh, trace, log_blowup, offset,
                           cols_per_chunk=cols_per_chunk, coeffs=polys)


def stage_lde(mesh: Mesh, trace: torch.Tensor, log_blowup: int,
              cols_per_chunk: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """iNTT + coset LDE in chunks of columns, domain axis sharded."""
    return dist_lde_cols(mesh, trace, log_blowup, F.DOMAIN_OFFSET,
                         cols_per_chunk)


# ------------------------------------------------------------ stage: commit

def _merge_to_one(d: torch.Tensor) -> torch.Tensor:
    while d.shape[1] > 1:
        d = merge_level(d)
    return d


def stage_commit(mesh: Mesh, cols: torch.Tensor) -> torch.Tensor:
    """Commit to sharded columns (w, m / D): hash the local rows, reduce
    them to the block's digest, gather the D digests and finish the top of
    the tree. Returns the root as (8,) int64 digest words, equal on every
    rank."""
    leaves = cols.shape[1]
    if leaves < 1 or leaves & (leaves - 1):
        raise ValueError(f"stage_commit: {leaves} local leaves")
    block = _merge_to_one(hash_columns(cols.contiguous()))       # (8, 1)
    tops = all_gather(mesh, block[:, 0], "roots")                # (D, 8)
    return _merge_to_one(tops.T.contiguous())[:, 0]


# -------------------------------------------- stage: constraints/composition

def next_points(mesh: Mesh, x: torch.Tensor, shift: int) -> torch.Tensor:
    """The first `shift` points (..., :shift) of the NEXT rank's block (the
    last rank gets rank 0's): what `roll(x, -shift)` over the whole domain
    reads across this block's end."""
    D, r = mesh.world, mesh.rank
    if shift > x.shape[-1]:
        raise ValueError("next_points: the shift exceeds the local block")
    head = x[..., :shift].contiguous()
    return send_to_rank(mesh, head, (r - 1) % D, [(r + 1) % D], "halo")[0]


def deinterleave_columns(mesh: Mesh, coeffs: torch.Tensor, n: int, ce: int
                         ) -> torch.Tensor:
    """Split the composition polynomial into its `ce` columns. `coeffs` is
    this rank's block of the sharded (m,) coefficient vector; column j is
    the stride-ce subsequence c[j + ce*i], i < n, of its first ce*n entries
    (`c[:ce*n].reshape(n, ce).T`). Returns this rank's block (ce, n / D).

    Rank r's block of the result reads the contiguous global range
    [r*ce*u, (r+1)*ce*u), u = n / D, while source rank s holds
    [s*B*u, (s+1)*B*u), B = m / n. ce divides B, so each destination reads
    from one source, rank r*ce // B, and a source serves the B / ce
    destinations from s*B/ce on: one all-to-all with uneven pieces."""
    D, r = mesh.world, mesh.rank
    m_blk = coeffs.shape[-1]
    u = n // D
    if n % D or m_blk % u or (m_blk // u) % ce:
        raise ValueError("deinterleave_columns: sizes do not divide")
    B = m_blk // u
    per = B // ce                       # destinations served by one source
    pieces = coeffs.reshape(B // ce, ce * u)       # row k -> rank r*per + k
    dests = [d for d in range(r * per, (r + 1) * per) if d < D]
    ins = [1 if d in dests else 0 for d in range(D)]
    outs = [1 if s == r // per else 0 for s in range(D)]
    got = all_to_all(mesh, pieces[:len(dests)], "deinterleave", ins, outs)
    return got.reshape(u, ce).T.contiguous()


def _merged_block(mesh: Mesh, air: Air, main_lde: torch.Tensor,
                  aux_lde: Optional[torch.Tensor], aux_rand: Sequence[int],
                  cc_t: Sequence, cc_b: Sequence) -> torch.Tensor:
    """The merged constraint evaluations (m / D,) of this rank's block, in
    fragments of FRAG points. A fragment's frames are slices of the LDE
    blocks, read where they lie; where the frame at x * g runs past the
    block's end (the last fragment), it is the block's tail and the next
    block's first `blowup` points (`next_points`) as a `Wrapped` pair of
    views, which K5 reads in place."""
    blowup = air.options.blowup_factor
    m_blk = main_lde.shape[-1]
    first = mesh.rank * m_blk
    merger = ConstraintMerger(
        air, aux_rand, cc_t, cc_b,
        ceval_domain(air, main_lde.device, first, m_blk), main_lde.device,
        first=first)
    halo_main = next_points(mesh, main_lde, blowup)
    halo_aux = None if aux_lde is None else next_points(mesh, aux_lde,
                                                        blowup)
    m_frag = min(m_blk, FRAG)

    def frames(x, halo, a0):
        """The cur and nxt frames of the fragment at a0: nxt is the window
        [a0 + blowup, a0 + blowup + m_frag) of the block followed by the
        halo."""
        if x is None:
            return None, None
        lo, hi = a0 + blowup, a0 + blowup + m_frag
        if hi <= m_blk:
            nxt = x[:, lo:hi]
        elif lo >= m_blk:                   # a fragment shorter than blowup
            nxt = halo[:, lo - m_blk:hi - m_blk]
        else:
            nxt = Wrapped(x[:, lo:], halo[:, :hi - m_blk])
        return x[:, a0:a0 + m_frag], nxt

    return torch.cat([
        merger.fragment(*frames(main_lde, halo_main, a0),
                        *frames(aux_lde, halo_aux, a0), a0)
        for a0 in range(0, m_blk, m_frag)])


def stage_composition(mesh: Mesh, air: Air, main_lde: torch.Tensor,
                      aux_lde: Optional[torch.Tensor],
                      aux_rand: Sequence[int], cc_t: Sequence, cc_b: Sequence,
                      log_blowup: int,
                      cols_per_chunk: Optional[int] = None) -> torch.Tensor:
    """Constraint evaluation over this rank's block of the LDE domain, in
    fragments of FRAG points (`_merged_block`), and the composition
    columns: returns the block (ce, m / D) of their LDE, in chunks of
    `cols_per_chunk` columns (None: `dist_ntt.lde_chunk_cols`). cc_t /
    cc_b: one (alpha, beta) pair of ints per constraint."""
    n = air.trace_length
    m_blk = main_lde.shape[-1]
    if m_blk * mesh.world != n * air.options.blowup_factor:
        raise ValueError("stage_composition: the blocks do not add up to the"
                         " LDE domain")
    # rand-dependent assertions (MidenAir's ROM product) read the rands
    air._aux_rand = [int(x) % F.P for x in aux_rand] or None
    merged = _merged_block(mesh, air, main_lde, aux_lde, aux_rand, cc_t,
                           cc_b)

    # iNTT over the coset: divide out the offset powers
    first = mesh.rank * m_blk
    inv_off = F.inv(F.DOMAIN_OFFSET)
    unscale = power_series(inv_off, m_blk, F.exp(inv_off, first),
                           main_lde.device)
    c_coeffs = mul(dist_ntt(mesh, merged, invert=True), unscale)
    col_coeffs = deinterleave_columns(mesh, c_coeffs, n, air.ce_blowup)
    return dist_lde_coeffs(mesh, col_coeffs, log_blowup, F.DOMAIN_OFFSET,
                           cols_per_chunk)


# ---------------------------------------------------------------- stage: DEEP

def stage_deep(mesh: Mesh, main_lde: torch.Tensor,
               aux_lde: Optional[torch.Tensor], constraint_lde: torch.Tensor,
               z: int, zg: int, zm: int, cur_vals: Sequence[int],
               nxt_vals: Sequence[int], ood_vals: Sequence[int],
               deep_a: Sequence[int], deep_b: Sequence[int],
               deep_c: Sequence[int], lam: int, mu: int,
               w_lde: int) -> torch.Tensor:
    """DEEP composition over this rank's block of the LDE domain; the
    Fiat-Shamir values arrive as Python ints (scalars or per-column lists,
    main columns first). Returns the block (m / D,)."""
    device = main_lde.device
    m_blk = main_lde.shape[-1]
    first = mesh.rank * m_blk
    x_dom = power_series(w_lde, m_blk,
                         F.mul(F.DOMAIN_OFFSET, F.exp(w_lde, first)), device)

    def vec(ints):
        return from_u64(np.array([int(v) % F.P for v in ints],
                                 dtype=np.uint64), device)

    args = (vec(cur_vals), vec(nxt_vals), vec(ood_vals), vec(deep_a),
            vec(deep_b), vec(deep_c), scalar(z, device), scalar(zg, device),
            scalar(zm, device), scalar(lam, device), scalar(mu, device))
    m_frag = min(m_blk, FRAG)
    parts = []
    for a0 in range(0, m_blk, m_frag):
        sl = slice(a0, a0 + m_frag)
        parts.append(_deep_core(
            main_lde[:, sl], aux_lde[:, sl] if aux_lde is not None else None,
            constraint_lde[:, sl], x_dom[sl], *args))
    return torch.cat(parts)


# ---------------------------------------------------------------- stage: FRI

def stage_fri_fold(mesh: Mesh, evals: torch.Tensor, alpha: int, ff: int,
                   offset: int = F.DOMAIN_OFFSET) -> torch.Tensor:
    """One FRI fold of a sharded layer: block (m / D,) -> block
    (m / ff / D,), contiguously sharded again. The groups of ff
    consecutive coefficients are local because ff divides m / D."""
    m_blk = evals.shape[-1]
    if m_blk % ff:
        raise ValueError(f"stage_fri_fold: folding factor {ff} does not "
                         f"divide the local block of {m_blk}")
    groups = dist_ntt(mesh, evals, invert=True).reshape(m_blk // ff, ff)
    w = F.mul(alpha, F.inv(offset))
    weights = from_u64(np_power_series(w, ff), evals.device)
    return dist_ntt(mesh, gf_sum(mul(groups, weights), axis=-1).contiguous())


def fold_leaf_columns(mesh: Mesh, layer: torch.Tensor, ff: int
                      ) -> torch.Tensor:
    """The leaf columns of a sharded FRI layer of length L * ff: leaf fp
    holds the values at positions fp + t*L, t < ff (`layer.reshape(ff, L)`
    read by columns), which lie on different ranks. Returns this rank's
    block (ff, L / D) of that matrix, ready for `stage_commit`.

    In units of v = L / D points, source rank s holds units s*ff .. s*ff +
    ff - 1 and destination r needs units t*D + r. D divides ff, so unit
    k = a*D + j of a source goes to rank j as row t = s*ff/D + a: an
    all-to-all with equal pieces."""
    D = mesh.world
    blk = layer.shape[-1]
    if ff % D or blk % ff:
        raise ValueError(f"fold_leaf_columns: {D} ranks, folding factor "
                         f"{ff}, local block {blk}")
    v = blk // ff
    sent = layer.reshape(ff // D, D, v).permute(1, 0, 2)   # (D, ff/D, v)
    got = all_to_all(mesh, sent, "fold_leaves")            # [s][a][v]
    return got.reshape(ff, v)
