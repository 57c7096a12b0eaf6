"""AIR (algebraic intermediate representation) base class.

The counterpart of `aero_tpu/air/air.py`, with the same winterfell-0.4
semantics: transitions hold on every step but the last (divisor
(x^n - 1) / (x - g^(n-1))); assertions pin single cells (divisor x - g^step);
every constraint is degree-adjusted with a random pair to the composition
degree; the composition polynomial splits into `ce_blowup` columns.

Transition evaluators are functions of (width, m) int64 field tensors.
`evaluate_transitions_scalar` runs the same evaluator on one-element CPU
tensors, so `..spec.verifier.verify(..., air=port_air)` checks a proof of this
package on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..spec import field as F
from ..spec.proof import Context, ProofOptions, TraceLayout

from ..field import from_u64, to_u64


@dataclass(frozen=True)
class Assertion:
    column: int      # absolute column index (aux columns follow the main)
    step: int        # trace step the assertion pins
    value: int       # asserted field value
    is_aux: bool = False


@dataclass(frozen=True)
class TransitionDegree:
    base: int = 1    # algebraic degree in the trace columns


class Air:
    """Base class. Subclasses define layout, constraints and assertions."""

    main_width: int
    aux_width: int = 0
    aux_rands: int = 0
    options: ProofOptions

    def __init__(self, trace_length: int, pub_inputs, options: ProofOptions):
        self.trace_length = trace_length
        self.pub_inputs = pub_inputs
        self.options = options

    # ---- layout / context ----

    @property
    def layout(self) -> TraceLayout:
        if self.aux_width:
            return TraceLayout(self.main_width, [self.aux_width],
                               [self.aux_rands])
        return TraceLayout(self.main_width, [], [])

    @property
    def lde_domain_size(self) -> int:
        return self.trace_length * self.options.blowup_factor

    @property
    def ce_blowup(self) -> int:
        """Number of composition-poly columns (= constraint domain blowup)."""
        max_deg = max([d.base for d in self.transition_degrees()] + [1])
        ce = 1
        while ce < max_deg:
            ce *= 2
        return max(2, ce)

    @property
    def trace_generator(self) -> int:
        return F.get_root_of_unity(self.trace_length.bit_length() - 1)

    @property
    def lde_generator(self) -> int:
        return F.get_root_of_unity(self.lde_domain_size.bit_length() - 1)

    def context(self) -> Context:
        return Context(
            layout=self.layout,
            log_trace_length=self.trace_length.bit_length() - 1,
            meta=b"",
            field_modulus_bytes=F.P.to_bytes(8, "little"),
            options=self.options,
        )

    # ---- to be provided by subclasses ----

    def transition_degrees(self) -> List[TransitionDegree]:
        raise NotImplementedError

    @property
    def num_transition_constraints(self) -> int:
        return len(self.transition_degrees())

    def get_assertions(self) -> List[Assertion]:
        raise NotImplementedError

    @property
    def num_assertions(self) -> int:
        return len(self.get_assertions())

    def evaluate_transitions(self, main_cur: torch.Tensor,
                             main_nxt: torch.Tensor,
                             aux_cur: Optional[torch.Tensor],
                             aux_nxt: Optional[torch.Tensor],
                             aux_rand: Sequence[int]) -> List[torch.Tensor]:
        """Inputs are (width, m) evaluations over m domain points (cur at x,
        nxt at x*g). Returns one (m,) tensor per transition constraint, in
        the order of transition_degrees()."""
        raise NotImplementedError

    def build_aux_trace(self, main_trace: torch.Tensor,
                        aux_rand: Sequence[int]) -> Optional[torch.Tensor]:
        """(main_width, n) -> (aux_width, n), or None without aux."""
        return None

    # ---- scalar evaluation used by the verifier's OOD check ----

    def evaluate_transitions_scalar(self, main_cur: Sequence[int],
                                    main_nxt: Sequence[int],
                                    aux_cur: Sequence[int],
                                    aux_nxt: Sequence[int],
                                    aux_rand: Sequence[int]) -> List[int]:
        """Single-point evaluation through one-element CPU tensors: one
        source of truth for the constraint semantics on both sides."""
        def col(vals):
            if not vals:
                return None
            return from_u64(np.array([[int(v) % F.P] for v in vals],
                                     dtype=np.uint64), "cpu")

        outs = self.evaluate_transitions(
            col(list(main_cur)), col(list(main_nxt)),
            col(list(aux_cur)), col(list(aux_nxt)),
            [int(r) % F.P for r in aux_rand])
        return [int(to_u64(o)[0]) for o in outs]

    # ---- degree adjustment (shared prover/verifier) ----

    def composition_degree(self) -> int:
        return self.ce_blowup * self.trace_length - 1

    def transition_adjustments(self) -> List[int]:
        n = self.trace_length
        cd = self.composition_degree()
        return [cd - (d.base * (n - 1) - (n - 1))
                for d in self.transition_degrees()]

    def boundary_adjustments(self) -> List[int]:
        n = self.trace_length
        cd = self.composition_degree()
        return [cd - (n - 2) for _ in self.get_assertions()]

    # ---- verifier-side OOD consistency ----

    def evaluate_constraints_at(self, z, mc, mn, ac, an, aux_rand_elements,
                                cc_transition, cc_boundary, pub_inputs):
        """Combined constraint evaluation at the OOD point z, compared by
        the verifier against sum(z^i * ood_eval_i)."""
        n = self.trace_length
        g = self.trace_generator
        aux_rand = aux_rand_elements[0] if aux_rand_elements else []
        # rand-dependent assertion values (MidenAir's ROM and overflow
        # boundaries) read the rands off the air instance
        self._aux_rand = list(aux_rand) or None

        t_evals = self.evaluate_transitions_scalar(mc, mn, ac, an, aux_rand)
        assert len(t_evals) == self.num_transition_constraints

        zn = F.exp(z, n)
        zt = F.div(F.sub(zn, 1), F.sub(z, F.exp(g, n - 1)))
        zt_inv = F.inv(zt)

        acc = 0
        for ev, (a, b), adj in zip(t_evals, cc_transition,
                                   self.transition_adjustments()):
            k = F.add(a, F.mul(b, F.exp(z, adj)))
            acc = F.add(acc, F.mul(F.mul(k, ev), zt_inv))

        full = list(mc) + list(ac)
        for asrt, (a, b), adj in zip(self.get_assertions(), cc_boundary,
                                     self.boundary_adjustments()):
            ev = F.sub(full[asrt.column], asrt.value)
            div = F.sub(z, F.exp(g, asrt.step))
            k = F.add(a, F.mul(b, F.exp(z, adj)))
            acc = F.add(acc, F.mul(F.mul(k, ev), F.inv(div)))
        return acc
