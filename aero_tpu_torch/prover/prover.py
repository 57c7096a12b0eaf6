"""The STARK prover pipeline: device tensors plus host Fiat-Shamir glue.

The counterpart of `aero_tpu/prover/prover.py`, stage for stage:

 1. trace_commit       iNTT + coset LDE of the main trace, Merkle commit
 2. aux_commit         draw rands, build + LDE + commit the aux segment
 3. constraint_eval    constraints over the LDE domain, composition
                       polynomial -> columns -> LDE -> commit
 4. ood_frames         trace and composition polynomials at z, z*g, z^ce
 5. deep_composition   DEEP quotient over the LDE domain
 6. fri_pow            FRI commit/fold, proof-of-work grinding
 7. queries_serialize  query openings, winterfell-format StarkProof

Each stage reads and writes a `ProverState`, which `prove_resumable`
checkpoints after every stage. Stages run under the tracing spans of
`..utils`, named as the JAX package names them; on a CUDA device each stage ends
in a synchronize, so a span measures the stage's device work. The bulk
Fiat-Shamir draws on the host run under spans `coin_draws`, the Merkle
openings under `merkle_open`, and every wait of the host for the CUDA
stream counts one `syncs` on the innermost span (`.._device`).

The transcript is `..spec.coin.RandomCoin`, seeded only from
public inputs and commitments, and the PoW search returns the minimal
nonce, so on the same trace and options the proof bytes equal those of
`aero_tpu.prover.prove`.

Left out on purpose (TPU or relay workarounds of the JAX package): the
uniform 12-column LDE chunking and the donated in-place row writes
(`prover.py:56-119`, `:165-191`), the per-air jit caches, and the
backend switches. The domain fragmentation of constraint evaluation and
DEEP stays: it bounds peak device memory and does not change a value.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field as dfield
from typing import Any, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..spec import field as F
from ..spec.coin import RandomCoin
from ..spec.hashing import hash_elements
from ..spec.proof import (FriProof, FriProofLayer, OodFrame, Queries,
                                 StarkProof, felts_to_bytes)
from .._device import index_tensor, synchronize, to_host, upload
from ..utils import count, span

from ..air import generated, symbolic
from ..air.air import Air
from ..field import (batch_inv, eval_polys_multi, from_u64, gl_cuda, mul,
                     pow_loop, power_series, scalar, sub, to_u64)
from ..field.gl import (add_plain, batch_inv_plain, gf_sum_plain, mul_plain,
                        pow_loop_plain, sub_plain)
from ..hash.blake2s_cuda import grind_pow
from ..merkle import ResidentMerkleTree, commit_columns
from ..ntt import intt, lde
from ..ntt.tables import np_power_series
from .fri import FriLayer, commit_fri

FRAG = 1 << 20      # domain points per constraint-eval / DEEP fragment


def _vec(ints, device) -> torch.Tensor:
    return from_u64(np.array([int(v) % F.P for v in ints], dtype=np.uint64),
                    device)


class Wrapped(NamedTuple):
    """A frame that runs past the end of the points it is cut from, as the
    two views where its points lie: `body` up to that end, `tail` the
    points after it (the domain's first points, or the next mesh block's
    halo). K5 reads both in place; every other route joins them."""
    body: torch.Tensor
    tail: torch.Tensor


def _frame(x: torch.Tensor, a: int, m_frag: int):
    """x[..., a:a + m_frag], wrapping around the end of the domain: a view,
    or where it wraps a `Wrapped` of two views."""
    m = x.shape[-1]
    a %= m
    if a + m_frag <= m:
        return x[..., a:a + m_frag]
    return Wrapped(x[..., a:], x[..., :m_frag - (m - a)])


def joined(frame):
    """A frame as one tensor: a `Wrapped` one copied into one piece."""
    if isinstance(frame, Wrapped):
        return torch.cat(list(frame), dim=-1)
    return frame


def ceval_domain(air: Air, device, first: int = 0,
                 length: Optional[int] = None) -> tuple:
    """Transcript-independent constraint-eval inputs over the LDE-domain
    points first .. first + length - 1 (the whole domain by default): x,
    the transition-divisor inverse and the boundary-divisor inverses (one
    row per distinct assertion point). `first` and `length` are multiples
    of the blowup, the period of 1 / (x^n - 1) along the domain."""
    n = air.trace_length
    blowup = air.options.blowup_factor
    length = n * blowup if length is None else length
    if first % blowup or length % blowup:
        raise ValueError("ceval_domain: the range must be whole periods")
    offset = F.DOMAIN_OFFSET
    g_trace = air.trace_generator
    w_lde = air.lde_generator
    wn, on = F.exp(w_lde, n), F.exp(offset, n)
    # 1 / (x^n - 1) takes `blowup` values, periodic in the position
    zt_vals = F.batch_inv([F.sub(F.mul(on, F.exp(wn, t)), 1)
                           for t in range(blowup)])
    points = tuple(sorted({F.exp(g_trace, a.step)
                           for a in air.get_assertions()}))
    x_dom = power_series(w_lde, length, F.mul(offset, F.exp(w_lde, first)),
                         device)
    shifted = sub(x_dom, scalar(F.exp(g_trace, n - 1), device))
    zt_inv = mul(shifted.reshape(length // blowup, blowup),
                 _vec(zt_vals, device)).reshape(length)
    denom = torch.stack([sub(x_dom, scalar(p, device)) for p in points])
    return x_dom, zt_inv, batch_inv(denom, axis=-1), points


def _ceval_static(air: Air, device) -> tuple:
    """`ceval_domain` over the whole domain, cached per air and device."""
    cache = air.__dict__.setdefault("_prover_cache", {})
    key = ("ceval_static", str(device))
    if key not in cache:
        cache[key] = ceval_domain(air, device)
    return cache[key]


def _xpow_static(air: Air, prog: symbolic.Program, device) -> tuple:
    """What K5 makes its x^adj values from, cached per air and device:
    (lo, hi, pw, adjs) of `gl_cuda.XPow`. `lo` and `hi` are the powers w^j
    (j < 2^h) and w^(j 2^h) (j < m >> h) of the LDE generator w, with h
    half of log2 of the domain's m points, rounded up: 2^12 + 2^11 words at
    m = 2^23. `adjs` are the slots' exponents, one a degree class of the
    AIR's traced program (its constraints' adjustment), then each
    assertion adjustment that no class has; `pw` (X, 2) holds each one mod
    m beside offset^adj. Made on the host; on the card one copy from pinned
    memory, without a wait."""
    cache = air.__dict__.setdefault("_prover_cache", {})
    key = ("_xpow_static", str(device))
    if key not in cache:
        t_adjust = air.transition_adjustments()
        cls_adj = [None] * len(prog.degrees)
        for k, c in enumerate(prog.classes):
            if cls_adj[c] is None:
                cls_adj[c] = t_adjust[k]
            elif cls_adj[c] != t_adjust[k]:
                raise ValueError("frag_eval: constraints of one degree have "
                                 "different adjustments")
        adjs = cls_adj + [a for a in dict.fromkeys(air.boundary_adjustments())
                          if a not in cls_adj]
        m = air.trace_length * air.options.blowup_factor
        h = m.bit_length() // 2            # ceil(log2(m) / 2)
        w = air.lde_generator
        words = np.concatenate([
            np_power_series(w, 1 << h), np_power_series(F.exp(w, 1 << h),
                                                        m >> h),
            np.array([v for a in adjs
                      for v in (a % m, F.exp(F.DOMAIN_OFFSET, a))],
                     dtype=np.uint64)])
        if torch.device(device).type == "cuda":
            t = gl_cuda.device_vector(words.tolist(), device)
        else:
            t = from_u64(words, device)
        n_lo, n_hi = 1 << h, m >> h
        cache[key] = (t[:n_lo], t[n_lo:n_lo + n_hi],
                      t[n_lo + n_hi:].reshape(len(adjs), 2), adjs)
    return cache[key]


class MergeInputs(NamedTuple):
    """What the merge of one fragment of m points reads: one row of m
    elements for each term, and the coefficients. Transition term i:
    `t_evals[i]`, `t_xp[i]` (x^adj_i), `cc_t[i]`; assertion j: `cols[j]`,
    `b_xp[j]`, `cc_b[j]`, `bvals[j]`, `dinv[j]` (1 / (x - g^step_j))."""
    t_evals: Sequence[torch.Tensor]
    t_xp: Sequence[torch.Tensor]
    cc_t: torch.Tensor              # (T, 2)
    cols: Sequence[torch.Tensor]
    b_xp: Sequence[torch.Tensor]
    cc_b: torch.Tensor              # (B, 2)
    bvals: torch.Tensor             # (B,)
    zt: torch.Tensor                # (m,) 1 / the transition divisor
    dinv: Sequence[torch.Tensor]


def constraint_merge_plain(t_evals, t_xp, cc_t, cols, b_xp, cc_b, bvals, zt,
                           dinv) -> torch.Tensor:
    """The merge in plain torch ops: sum_i (cc_t[i,0] + x^adj_i cc_t[i,1])
    ev_i zt + sum_j (cc_b[j,0] + x^adj_j cc_b[j,1]) (col_j - b_j) dinv_j."""
    merged = torch.zeros_like(zt)
    for i, (ev, xp) in enumerate(zip(t_evals, t_xp)):
        k = add_plain(cc_t[i, 0], mul_plain(xp, cc_t[i, 1]))
        merged = add_plain(merged, mul_plain(mul_plain(k, ev), zt))
    for j, (col, xp, d) in enumerate(zip(cols, b_xp, dinv)):
        ev = sub_plain(col, bvals[j])
        k = add_plain(cc_b[j, 0], mul_plain(xp, cc_b[j, 1]))
        merged = add_plain(merged, mul_plain(mul_plain(k, ev), d))
    return merged


class ConstraintMerger:
    """The random linear combination of all constraint evaluations over a
    range of the LDE domain, evaluated fragment by fragment: one fragment's
    temporaries bound the peak memory. Constraints are local (nxt =
    +blowup positions), so the result is that of one evaluation over the
    whole range.

    Two routes: on the card, kernel K5, one launch a fragment, generated
    for the AIR's class (`air.generated.kernel_for`; a class without one
    raises there); on the CPU, `merge_inputs` (the AIR's
    `evaluate_transitions`) and `constraint_merge_plain`."""

    def __init__(self, air: Air, aux_rand, cc_transition, cc_boundary,
                 domain: tuple, device, first: int = 0):
        """`domain` is `ceval_domain(air, device, first, length)`: the range
        starts at domain position `first`, which K5 reads from here."""
        self.air = air
        self.first = first
        self.x_dom, self.zt_inv, self.denom_inv, points = domain
        g_trace = air.trace_generator
        assertions = air.get_assertions()
        point_row = {p: i for i, p in enumerate(points)}
        self.t_adjust = air.transition_adjustments()
        self.b_adjust = air.boundary_adjustments()
        self.asrt_route = [(a.column < air.main_width,
                            a.column if a.column < air.main_width
                            else a.column - air.main_width,
                            point_row[F.exp(g_trace, a.step)])
                           for a in assertions]
        self.cc_t = from_u64(np.array(cc_transition, dtype=np.uint64), device)
        self.cc_b = from_u64(np.array(cc_boundary, dtype=np.uint64), device)
        self.bvals = _vec([a.value for a in assertions], device)
        self.rands = [int(r) % F.P for r in aux_rand]
        self._k5 = None

    def merge_inputs(self, main_cur, main_nxt, aux_cur, aux_nxt,
                     a0: int) -> MergeInputs:
        """The constraint evaluations and the rows the merge reads for the
        `m_frag` points from position a0 of the range; cur and nxt are
        (width, m_frag) frames."""
        t_evals = self.air.evaluate_transitions(
            main_cur, joined(main_nxt), aux_cur, joined(aux_nxt), self.rands)
        return self._merge_rows(t_evals, main_cur, aux_cur, a0, pow_loop)

    def _merge_rows(self, t_evals, main_cur, aux_cur, a0: int,
                    pow_) -> MergeInputs:
        """MergeInputs around the constraint values `t_evals`, the x^adj
        rows raised by `pow_`."""
        m_frag = main_cur.shape[-1]
        sl = slice(a0, a0 + m_frag)
        x_frag = self.x_dom[sl]
        xp = {adj: pow_(x_frag, adj)
              for adj in sorted(set(self.t_adjust) | set(self.b_adjust))}
        return MergeInputs(
            t_evals, [xp[adj] for adj in self.t_adjust], self.cc_t,
            [main_cur[c] if is_main else aux_cur[c]
             for is_main, c, _ in self.asrt_route],
            [xp[adj] for adj in self.b_adjust], self.cc_b, self.bvals,
            self.zt_inv[sl],
            [self.denom_inv[prow, sl] for _, _, prow in self.asrt_route])

    def fragment(self, main_cur, main_nxt, aux_cur, aux_nxt,
                 a0: int) -> torch.Tensor:
        """The merged evaluations of the `m_frag` points from position a0
        of the range; cur and nxt are (width, m_frag) frames, a nxt frame
        that wraps possibly a `Wrapped`. The device chooses the route: K5
        reads a `Wrapped` frame in place (counted as `frames_in_place` on
        the innermost span), the plain route joins it."""
        if gl_cuda.on_cuda(main_cur):
            args = self.k5_inputs(main_cur, main_nxt, aux_cur, aux_nxt, a0)
            if isinstance(main_nxt, Wrapped):
                count("frames_in_place")
            return gl_cuda.frag_eval(*args)
        return constraint_merge_plain(*self.merge_inputs(
            main_cur, main_nxt, aux_cur, aux_nxt, a0))

    def _k5_static(self, prog: symbolic.Program, device) -> tuple:
        """What K5 reads that no fragment changes: the rands on the card,
        the slots' x^adj exponents (`_xpow_static`), and the index table of
        `csrc/frag_eval.cuh`."""
        if self._k5 is None:
            adjs = _xpow_static(self.air, prog, device)[3]
            w = self.air.main_width
            idx = ([adjs.index(a) for a in self.b_adjust]
                   + [prow for _, _, prow in self.asrt_route]
                   + [c if is_main else w + c
                      for is_main, c, _ in self.asrt_route])
            self._k5 = (_vec(self.rands, device), adjs,
                        upload(torch.tensor(idx, dtype=torch.int32), device))
        return self._k5

    def k5_inputs(self, main_cur, main_nxt, aux_cur, aux_nxt,
                  a0: int) -> tuple:
        """The arguments of `gl_cuda.frag_eval` for one fragment on the
        card: the frames as they lie (a `Wrapped` one as its two views), and
        the x^adj tables (`_xpow_static`) with the fragment's first domain
        position, `first` + a0. A generated file that the AIR no longer
        traces to raises."""
        found = generated.kernel_for(self.air)
        if found is None:
            raise ValueError(f"frag_eval: {type(self.air).__name__} has no "
                             "generated kernel")
        name, prog = found
        frames = (main_cur, main_nxt, aux_cur, aux_nxt)
        widths = (prog.main_width,) * 2 + (prog.aux_width,) * 2
        rows = [0 if f is None else (f.body if isinstance(f, Wrapped)
                                     else f).shape[0] for f in frames]
        if rows != list(widths) or len(self.rands) != prog.rands:
            raise ValueError(f"frag_eval: {name} reads frames of {widths} "
                             f"rows and {prog.rands} rands")
        m = main_cur.shape[-1]
        sl = slice(a0, a0 + m)
        device = main_cur.device
        rands, _, idx = self._k5_static(prog, device)
        lo, hi, pw, _ = _xpow_static(self.air, prog, device)
        m_dom = self.air.trace_length * self.air.options.blowup_factor
        xpow = gl_cuda.XPow(lo, hi, pw, m_dom, self.first + a0)
        return (name, frames, rands, self.cc_t, self.cc_b, self.bvals,
                self.zt_inv[sl], self.denom_inv[:, sl], xpow, idx,
                len(prog.outputs))

    def fragment_plain(self, main_cur, main_nxt, aux_cur, aux_nxt,
                       a0: int) -> torch.Tensor:
        """K5 (`fragment` on the card) in plain torch ops alone, on any
        device: the AIR's traced program interpreted with the plain ops
        (`symbolic.interpret`), then `constraint_merge_plain`."""
        prog = symbolic.trace(type(self.air))
        t_evals = symbolic.interpret(prog, main_cur, joined(main_nxt),
                                     aux_cur, joined(aux_nxt), self.rands)
        return constraint_merge_plain(*self._merge_rows(
            t_evals, main_cur, aux_cur, a0, pow_loop_plain))


# ------------------------------------------------------------- prover state

STAGES = ("trace_commit", "aux_commit", "constraint_eval", "ood_frames",
          "deep_composition", "fri_pow", "queries_serialize")


@dataclass
class ProverState:
    """Everything a stage needs from its predecessors. Checkpointable:
    to_host() moves the tensors (and tree levels) to the CPU, to_device()
    moves them back to `device`."""
    pub_inputs: Any
    device: str = "cpu"
    stage: int = 0                      # number of completed stages
    coin: Optional[RandomCoin] = None
    commitments: List[bytes] = dfield(default_factory=list)
    main_trace: Optional[torch.Tensor] = None
    main_polys: Optional[torch.Tensor] = None
    main_lde: Optional[torch.Tensor] = None
    main_tree: Optional[ResidentMerkleTree] = None
    aux_rand: List[int] = dfield(default_factory=list)
    aux_polys: Optional[torch.Tensor] = None
    aux_lde: Optional[torch.Tensor] = None
    aux_tree: Optional[ResidentMerkleTree] = None
    col_coeffs: Optional[torch.Tensor] = None
    constraint_lde: Optional[torch.Tensor] = None
    constraint_tree: Optional[ResidentMerkleTree] = None
    z: int = 0
    cur_row: List[int] = dfield(default_factory=list)
    nxt_row: List[int] = dfield(default_factory=list)
    ood_evals: List[int] = dfield(default_factory=list)
    deep: Optional[torch.Tensor] = None
    fri_layers: Optional[List[FriLayer]] = None
    fri_remainder: List[int] = dfield(default_factory=list)
    rem_tree: Optional[ResidentMerkleTree] = None
    pow_nonce: int = 0
    positions: List[int] = dfield(default_factory=list)
    proof: Optional[StarkProof] = None

    _TENSORS = ("main_trace", "main_polys", "main_lde", "aux_polys",
                "aux_lde", "col_coeffs", "constraint_lde", "deep")
    _TREES = ("main_tree", "aux_tree", "constraint_tree", "rem_tree")

    def _move(self, device) -> "ProverState":
        for name in self._TENSORS:
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, v.to(device))
        trees = [getattr(self, name) for name in self._TREES]
        for layer in self.fri_layers or []:
            layer.evals = layer.evals.to(device)
            trees.append(layer.tree)
        for t in trees:
            if t is not None:
                t.to(device)
        return self

    def to_host(self) -> "ProverState":
        return self._move("cpu")

    def to_device(self) -> "ProverState":
        return self._move(self.device)


# ------------------------------------------------------------------ stages

def stage_trace_commit(air: Air, st: ProverState) -> None:
    log_blowup = air.options.blowup_factor.bit_length() - 1
    st.coin = RandomCoin(hash_elements(st.pub_inputs.elements()))
    st.main_polys = intt(st.main_trace)
    st.main_lde = lde(st.main_polys, log_blowup, F.DOMAIN_OFFSET)
    st.main_tree = commit_columns(st.main_lde)
    st.commitments.append(st.main_tree.root)
    st.coin.reseed(st.main_tree.root)


def stage_aux_commit(air: Air, st: ProverState) -> None:
    if not air.aux_width:
        return
    log_blowup = air.options.blowup_factor.bit_length() - 1
    with span("coin_draws"):
        st.aux_rand = st.coin.draw_elements(air.aux_rands)
    aux_trace = air.build_aux_trace(st.main_trace, st.aux_rand)
    st.aux_polys = intt(aux_trace)
    st.aux_lde = lde(st.aux_polys, log_blowup, F.DOMAIN_OFFSET)
    st.aux_tree = commit_columns(st.aux_lde)
    st.commitments.append(st.aux_tree.root)
    st.coin.reseed(st.aux_tree.root)
    st.main_trace = None        # never read past this stage


def stage_constraint_eval(air: Air, st: ProverState) -> None:
    n = air.trace_length
    blowup = air.options.blowup_factor
    log_blowup = blowup.bit_length() - 1
    m = n * blowup
    ce = air.ce_blowup
    offset = F.DOMAIN_OFFSET
    device = st.main_lde.device

    # rand-dependent assertions (MidenAir's ROM product) need the aux
    # rands on the air, also when resuming past aux_commit
    air._aux_rand = [int(x) % F.P for x in st.aux_rand] or None

    with span("coin_draws"):
        cc_transition = [st.coin.draw_pair()
                         for _ in range(air.num_transition_constraints)]
        cc_boundary = [st.coin.draw_pair()
                       for _ in range(air.num_assertions)]

    with span("constraint_prelude"):
        merger = ConstraintMerger(air, st.aux_rand, cc_transition,
                                  cc_boundary, _ceval_static(air, device),
                                  device)

    m_frag = min(m, FRAG)
    parts = []
    with span("frag_eval", n_frags=m // m_frag):
        for a0 in range(0, m, m_frag):
            parts.append(merger.fragment(
                _frame(st.main_lde, a0, m_frag),
                _frame(st.main_lde, a0 + blowup, m_frag),
                _frame(st.aux_lde, a0, m_frag)
                if st.aux_lde is not None else None,
                _frame(st.aux_lde, a0 + blowup, m_frag)
                if st.aux_lde is not None else None, a0))
        merged = torch.cat(parts)

    with span("composition_intt_lde"):
        # iNTT over the coset: divide out the offset powers
        cc = mul(intt(merged), power_series(F.inv(offset), m, 1, device))
        if bool(to_host((cc[ce * n:] != 0).any())):
            raise ValueError("composition degree overflow: the trace does "
                             "not satisfy the AIR")
        st.col_coeffs = cc[:ce * n].reshape(n, ce).T.contiguous()
        st.constraint_lde = lde(st.col_coeffs, log_blowup, offset)
    with span("constraint_commit"):
        st.constraint_tree = commit_columns(st.constraint_lde)
    st.commitments.append(st.constraint_tree.root)
    st.coin.reseed(st.constraint_tree.root)


def stage_ood_frames(air: Air, st: ProverState) -> None:
    ce = air.ce_blowup
    st.z = st.coin.draw()
    zg = F.mul(st.z, air.trace_generator)
    z_m = F.exp(st.z, ce)
    segs = [st.main_polys]
    if air.aux_width:
        segs.append(st.aux_polys)
    segs.append(st.col_coeffs)
    # the row blocks as they lie: on the card one call of kernel K7
    evals = eval_polys_multi(segs, [st.z, zg, z_m])   # (3, w+ce)
    w_trace = air.main_width + (air.aux_width or 0)
    st.cur_row = [int(v) for v in evals[0, :w_trace]]
    st.nxt_row = [int(v) for v in evals[1, :w_trace]]
    st.coin.reseed(hash_elements(st.cur_row))
    st.coin.reseed(hash_elements(st.nxt_row))
    st.ood_evals = [int(v) for v in evals[2, w_trace:]]
    st.coin.reseed(hash_elements(st.ood_evals))
    # the coefficients are never read past this stage
    st.main_polys = st.aux_polys = st.col_coeffs = None


def deep_combine_plain(main_lde, aux_lde, constraint_lde, x_dom, cur, nxt,
                       ood, a_vec, b_vec, c_vec, dinv, lam, mu
                       ) -> torch.Tensor:
    """The DEEP quotient of one fragment in plain torch ops, given the
    inverses `dinv` (3, m) of x - z, x - zg, x - z^ce: weighted column
    sums of the trace rows against cur and nxt and of the composition rows
    against the OOD values, times (lam + x mu)."""
    def wsum(lde_, vals, weights):
        return gf_sum_plain(mul_plain(sub_plain(lde_, vals[:, None]),
                                      weights[:, None]), axis=0)

    w_main = main_lde.shape[0]
    num_cur = wsum(main_lde, cur[:w_main], a_vec[:w_main])
    num_nxt = wsum(main_lde, nxt[:w_main], b_vec[:w_main])
    if aux_lde is not None:
        num_cur = add_plain(num_cur, wsum(aux_lde, cur[w_main:],
                                          a_vec[w_main:]))
        num_nxt = add_plain(num_nxt, wsum(aux_lde, nxt[w_main:],
                                          b_vec[w_main:]))
    deep = add_plain(mul_plain(num_cur, dinv[0]), mul_plain(num_nxt, dinv[1]))
    deep = add_plain(deep, mul_plain(wsum(constraint_lde, ood, c_vec),
                                     dinv[2]))
    return mul_plain(deep, add_plain(lam, mul_plain(x_dom, mu)))


def deep_combine(main_lde, aux_lde, constraint_lde, x_dom, cur, nxt, ood,
                 a_vec, b_vec, c_vec, dinv, lam, mu) -> torch.Tensor:
    """Kernel K4 (`gl_cuda.deep_combine`) on the card,
    `deep_combine_plain` on the CPU."""
    args = (main_lde, aux_lde, constraint_lde, x_dom, cur, nxt, ood, a_vec,
            b_vec, c_vec, dinv, lam, mu)
    if gl_cuda.on_cuda(x_dom):
        return gl_cuda.deep_combine(*args)
    return deep_combine_plain(*args)


def _deep_core(main_lde, aux_lde, constraint_lde, x_dom, cur, nxt, ood,
               a_vec, b_vec, c_vec, z, zg, zm, lam, mu) -> torch.Tensor:
    """DEEP composition of one domain fragment as weighted column sums: the
    divisors' inverses by `batch_inv` (K2's batch inversion on the card),
    then `deep_combine` (K4)."""
    dinv = batch_inv(torch.stack([sub(x_dom, z), sub(x_dom, zg),
                                  sub(x_dom, zm)]), axis=-1)
    return deep_combine(main_lde, aux_lde, constraint_lde, x_dom, cur, nxt,
                        ood, a_vec, b_vec, c_vec, dinv, lam, mu)


def _deep_core_plain(main_lde, aux_lde, constraint_lde, x_dom, cur, nxt, ood,
                     a_vec, b_vec, c_vec, z, zg, zm, lam, mu) -> torch.Tensor:
    """`_deep_core` in plain torch ops alone, on any device."""
    dinv = batch_inv_plain(torch.stack([sub_plain(x_dom, z),
                                        sub_plain(x_dom, zg),
                                        sub_plain(x_dom, zm)]), axis=-1)
    return deep_combine_plain(main_lde, aux_lde, constraint_lde, x_dom, cur,
                              nxt, ood, a_vec, b_vec, c_vec, dinv, lam, mu)


def stage_deep_composition(air: Air, st: ProverState) -> None:
    n = air.trace_length
    m = n * air.options.blowup_factor
    ce = air.ce_blowup
    n_cols = air.main_width + air.aux_width
    device = st.main_lde.device
    zg = F.mul(st.z, air.trace_generator)
    z_m = F.exp(st.z, ce)

    with span("coin_draws"):
        deep_trace = [st.coin.draw_elements(3) for _ in range(n_cols)]
        deep_constraints = st.coin.draw_elements(ce)
        lam, mu = st.coin.draw_pair()

    x_dom = _ceval_static(air, device)[0]
    args = (_vec(st.cur_row, device), _vec(st.nxt_row, device),
            _vec(st.ood_evals, device),
            _vec([deep_trace[c][0] for c in range(n_cols)], device),
            _vec([deep_trace[c][1] for c in range(n_cols)], device),
            _vec(deep_constraints, device),
            scalar(st.z, device), scalar(zg, device), scalar(z_m, device),
            scalar(lam, device), scalar(mu, device))
    m_frag = min(m, FRAG)
    parts = []
    for a0 in range(0, m, m_frag):
        sl = slice(a0, a0 + m_frag)
        parts.append(_deep_core(
            st.main_lde[:, sl],
            st.aux_lde[:, sl] if air.aux_width else None,
            st.constraint_lde[:, sl], x_dom[sl], *args))
    st.deep = torch.cat(parts)


def stage_fri_pow(air: Air, st: ProverState) -> None:
    opts = air.options
    m = air.trace_length * opts.blowup_factor
    layers, _, remainder, rem_tree = commit_fri(
        st.deep, st.coin, opts.fri_folding_factor,
        opts.fri_max_remainder_size)
    st.fri_layers = layers
    st.fri_remainder = remainder
    st.rem_tree = rem_tree
    for layer in layers:
        st.commitments.append(layer.tree.root)
    st.commitments.append(rem_tree.root)

    st.pow_nonce = grind_pow(st.coin.seed, opts.grinding_factor,
                             st.deep.device)
    st.coin.reseed_with_int(st.pow_nonce)
    with span("coin_draws"):
        st.positions = st.coin.draw_integers(opts.num_queries, m)


def _open(tree: ResidentMerkleTree, cols: torch.Tensor,
          idxs: List[int]) -> Queries:
    rows = to_u64(cols[:, index_tensor(idxs, cols.device)].T)   # (q, w)
    return Queries(values=felts_to_bytes(rows.reshape(-1).tolist()),
                   paths=tree.prove_batch(idxs).serialize_nodes())


def stage_queries_serialize(air: Air, st: ProverState) -> None:
    opts = air.options
    ff = opts.fri_folding_factor
    trace_queries = [_open(st.main_tree, st.main_lde, st.positions)]
    if air.aux_width:
        trace_queries.append(_open(st.aux_tree, st.aux_lde, st.positions))
    constraint_queries = _open(st.constraint_tree, st.constraint_lde,
                               st.positions)

    fri_layers_ser: List[FriProofLayer] = []
    idxs = list(st.positions)
    size = air.trace_length * opts.blowup_factor
    for layer in st.fri_layers:
        target = size // ff
        folded: List[int] = []
        for p in idxs:
            fp = p % target
            if fp not in folded:
                folded.append(fp)
        rows = to_u64(layer.rows_at(folded))
        fri_layers_ser.append(FriProofLayer(
            values=felts_to_bytes(rows.reshape(-1).tolist()),
            paths=layer.tree.prove_batch(folded).serialize_nodes()))
        idxs = folded
        size = target

    st.proof = StarkProof(
        context=air.context(),
        commitments=st.commitments,
        trace_queries=trace_queries,
        constraint_queries=constraint_queries,
        ood_frame=OodFrame(
            trace_states=felts_to_bytes(st.cur_row + st.nxt_row),
            evaluations=felts_to_bytes(st.ood_evals)),
        fri_proof=FriProof(layers=fri_layers_ser,
                           remainder=felts_to_bytes(st.fri_remainder),
                           num_partitions=0),
        pow_nonce=st.pow_nonce,
    )


_STAGE_FNS = (stage_trace_commit, stage_aux_commit, stage_constraint_eval,
              stage_ood_frames, stage_deep_composition, stage_fri_pow,
              stage_queries_serialize)


# ----------------------------------------------------------------- frontend

def _run_stage(i: int, air: Air, st: ProverState) -> None:
    with span(STAGES[i]):
        _STAGE_FNS[i](air, st)
        if st.device.startswith("cuda"):
            synchronize(st.device)
    st.stage += 1


def prove(air: Air, main_trace: torch.Tensor, pub_inputs) -> StarkProof:
    """Run the seven stages on the device of `main_trace` (main_width, n)."""
    st = ProverState(pub_inputs=pub_inputs, device=str(main_trace.device),
                     main_trace=main_trace)
    with span("prove_program"):
        for i in range(len(STAGES)):
            _run_stage(i, air, st)
    return st.proof


def prove_resumable(air: Air, main_trace: torch.Tensor, pub_inputs,
                    checkpoint_dir: str) -> StarkProof:
    """prove() with a checkpoint after every stage: the state is pickled
    to <checkpoint_dir>/state.pkl, and a later call resumes from the first
    unfinished stage."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, "state.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            st = pickle.load(f).to_device()
    else:
        st = ProverState(pub_inputs=pub_inputs,
                         device=str(main_trace.device),
                         main_trace=main_trace)
    with span("prove_program", resume_from=st.stage):
        for i in range(st.stage, len(STAGES)):
            _run_stage(i, air, st)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(st.to_host(), f)
            os.replace(tmp, path)
            st.to_device()
    return st.proof
