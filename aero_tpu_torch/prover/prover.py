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
checkpoints after every stage. Stages run under the shared tracing spans
of `aero_tpu.utils` with the same names; on a CUDA device each stage ends
in a synchronize, so a span measures the stage's device work.

The transcript is the shared `spec.coin.RandomCoin`, seeded only from
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
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from aero_tpu.spec import field as F
from aero_tpu.spec.coin import RandomCoin
from aero_tpu.spec.hashing import hash_elements
from aero_tpu.spec.proof import (FriProof, FriProofLayer, OodFrame, Queries,
                                 StarkProof, felts_to_bytes)
from aero_tpu.utils import span

from ..air.air import Air
from ..field import (add, batch_inv, eval_polys_multi, from_u64, gf_sum, mul,
                     pow_loop, power_series, scalar, sub, to_u64)
from ..hash.blake2s_cuda import grind_pow
from ..merkle import ResidentMerkleTree, commit_columns
from ..ntt import intt, lde
from .fri import FriLayer, commit_fri

FRAG = 1 << 20      # domain points per constraint-eval / DEEP fragment


def _vec(ints, device) -> torch.Tensor:
    return from_u64(np.array([int(v) % F.P for v in ints], dtype=np.uint64),
                    device)


def _frag(x: torch.Tensor, a: int, m_frag: int) -> torch.Tensor:
    """x[..., a:a + m_frag], wrapping around the end of the domain."""
    m = x.shape[-1]
    a %= m
    if a + m_frag <= m:
        return x[..., a:a + m_frag]
    return torch.cat([x[..., a:], x[..., :m_frag - (m - a)]], dim=-1)


def _ceval_static(air: Air, device) -> tuple:
    """Transcript-independent constraint-eval inputs, cached per air and
    device: x over the LDE domain, the transition-divisor inverse and the
    boundary-divisor inverses (one row per distinct assertion point)."""
    cache = air.__dict__.setdefault("_prover_cache", {})
    key = ("ceval_static", str(device))
    if key not in cache:
        n = air.trace_length
        blowup = air.options.blowup_factor
        m = n * blowup
        offset = F.DOMAIN_OFFSET
        g_trace = air.trace_generator
        w_lde = air.lde_generator
        wn, on = F.exp(w_lde, n), F.exp(offset, n)
        # 1 / (x^n - 1) takes `blowup` values, periodic in the position
        zt_vals = F.batch_inv([F.sub(F.mul(on, F.exp(wn, t)), 1)
                               for t in range(blowup)])
        points = tuple(sorted({F.exp(g_trace, a.step)
                               for a in air.get_assertions()}))
        x_dom = power_series(w_lde, m, offset, device)
        shifted = sub(x_dom, scalar(F.exp(g_trace, n - 1), device))
        zt_inv = mul(shifted.reshape(m // blowup, blowup),
                     _vec(zt_vals, device)).reshape(m)
        denom = torch.stack([sub(x_dom, scalar(p, device)) for p in points])
        cache[key] = (x_dom, zt_inv, batch_inv(denom, axis=-1), points)
    return cache[key]


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
    g_trace = air.trace_generator
    device = st.main_lde.device

    # rand-dependent assertions (MidenAir's ROM product) need the aux
    # rands on the air, also when resuming past aux_commit
    air._aux_rand = [int(x) % F.P for x in st.aux_rand] or None

    cc_transition = [st.coin.draw_pair()
                     for _ in range(air.num_transition_constraints)]
    cc_boundary = [st.coin.draw_pair() for _ in range(air.num_assertions)]

    with span("constraint_prelude"):
        x_dom, zt_inv, denom_inv, points = _ceval_static(air, device)
        assertions = air.get_assertions()
        point_row = {p: i for i, p in enumerate(points)}
        t_adjust = air.transition_adjustments()
        b_adjust = air.boundary_adjustments()
        asrt_route = [(a.column < air.main_width,
                       a.column if a.column < air.main_width
                       else a.column - air.main_width,
                       point_row[F.exp(g_trace, a.step)])
                      for a in assertions]
        cc_t = from_u64(np.array(cc_transition, dtype=np.uint64), device)
        cc_b = from_u64(np.array(cc_boundary, dtype=np.uint64), device)
        bvals = _vec([a.value for a in assertions], device)
        rands = [int(r) % F.P for r in st.aux_rand]

    # evaluated in fragments of the domain: one fragment's temporaries
    # (hundreds of flag and product arrays) bound the peak memory;
    # constraints are local (nxt = +blowup positions), so the result is
    # that of one whole-domain evaluation
    m_frag = min(m, FRAG)
    parts = []
    with span("frag_eval", n_frags=m // m_frag):
        for a0 in range(0, m, m_frag):
            main_cur = _frag(st.main_lde, a0, m_frag)
            aux_cur = (_frag(st.aux_lde, a0, m_frag)
                       if st.aux_lde is not None else None)
            t_evals = air.evaluate_transitions(
                main_cur, _frag(st.main_lde, a0 + blowup, m_frag), aux_cur,
                _frag(st.aux_lde, a0 + blowup, m_frag)
                if st.aux_lde is not None else None, rands)
            x_frag = x_dom[a0:a0 + m_frag]
            xp: Dict[int, torch.Tensor] = {}
            for adj in set(t_adjust) | set(b_adjust):
                xp[adj] = pow_loop(x_frag, adj)
            merged = torch.zeros(m_frag, dtype=torch.int64, device=device)
            zt_f = zt_inv[a0:a0 + m_frag]
            for i, (ev, adj) in enumerate(zip(t_evals, t_adjust)):
                k = add(cc_t[i, 0], mul(xp[adj], cc_t[i, 1]))
                merged = add(merged, mul(mul(k, ev), zt_f))
            for j, ((is_main, c, prow), adj) in enumerate(zip(asrt_route,
                                                              b_adjust)):
                col = main_cur[c] if is_main else aux_cur[c]
                ev = sub(col, bvals[j])
                k = add(cc_b[j, 0], mul(xp[adj], cc_b[j, 1]))
                merged = add(merged,
                             mul(mul(k, ev), denom_inv[prow, a0:a0 + m_frag]))
            parts.append(merged)
        merged = torch.cat(parts)

    with span("composition_intt_lde"):
        # iNTT over the coset: divide out the offset powers
        cc = mul(intt(merged), power_series(F.inv(offset), m, 1, device))
        if bool((cc[ce * n:] != 0).any()):
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
    evals = eval_polys_multi(torch.cat(segs), [st.z, zg, z_m])   # (3, w+ce)
    w_trace = air.main_width + (air.aux_width or 0)
    st.cur_row = [int(v) for v in evals[0, :w_trace]]
    st.nxt_row = [int(v) for v in evals[1, :w_trace]]
    st.coin.reseed(hash_elements(st.cur_row))
    st.coin.reseed(hash_elements(st.nxt_row))
    st.ood_evals = [int(v) for v in evals[2, w_trace:]]
    st.coin.reseed(hash_elements(st.ood_evals))
    # the coefficients are never read past this stage
    st.main_polys = st.aux_polys = st.col_coeffs = None


def _deep_core(main_lde, aux_lde, constraint_lde, x_dom, cur, nxt, ood,
               a_vec, b_vec, c_vec, z, zg, zm, lam, mu) -> torch.Tensor:
    """DEEP composition of one domain fragment as weighted column sums."""
    dinv = batch_inv(torch.stack([sub(x_dom, z), sub(x_dom, zg),
                                  sub(x_dom, zm)]), axis=-1)

    def wsum(lde_, vals, weights):
        return gf_sum(mul(sub(lde_, vals[:, None]), weights[:, None]), axis=0)

    w_main = main_lde.shape[0]
    num_cur = wsum(main_lde, cur[:w_main], a_vec[:w_main])
    num_nxt = wsum(main_lde, nxt[:w_main], b_vec[:w_main])
    if aux_lde is not None:
        num_cur = add(num_cur, wsum(aux_lde, cur[w_main:], a_vec[w_main:]))
        num_nxt = add(num_nxt, wsum(aux_lde, nxt[w_main:], b_vec[w_main:]))
    deep = add(mul(num_cur, dinv[0]), mul(num_nxt, dinv[1]))
    deep = add(deep, mul(wsum(constraint_lde, ood, c_vec), dinv[2]))
    return mul(deep, add(lam, mul(x_dom, mu)))


def stage_deep_composition(air: Air, st: ProverState) -> None:
    n = air.trace_length
    m = n * air.options.blowup_factor
    ce = air.ce_blowup
    n_cols = air.main_width + air.aux_width
    device = st.main_lde.device
    zg = F.mul(st.z, air.trace_generator)
    z_m = F.exp(st.z, ce)

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
    st.positions = st.coin.draw_integers(opts.num_queries, m)


def _open(tree: ResidentMerkleTree, cols: torch.Tensor,
          idxs: List[int]) -> Queries:
    idx = torch.as_tensor(np.asarray(idxs, dtype=np.int64),
                          device=cols.device)
    rows = to_u64(cols[:, idx].T)                          # (q, w)
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
            torch.cuda.synchronize(st.device)
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
