"""Fibonacci AIR: 2 main columns, 1 aux running-product column.

The counterpart of `aero_tpu/air/fib.py` (carried over whole: that module
imports jax). Transitions (degrees 1, 1, 2):
  C0: a' - (a + b)
  C1: b' - (a + 2b)
  C2: p' - p * (r0 + a + r1 * b)
Assertions: a[0] = 1, b[0] = 2, b[n-1] = result, p[0] = 1.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from ..spec import field as F

from ..field import add, from_u64, mul, mul_scalar, scalar, sub, to_u64
from .air import Air, Assertion, TransitionDegree


@dataclass
class FibPublicInputs:
    """Public inputs: the claimed value of column b at the last step."""
    result: int
    n_steps: int

    def elements(self) -> List[int]:
        return [self.result, self.n_steps]

    def to_bytes(self) -> bytes:
        return struct.pack("<QQ", self.result, self.n_steps)

    @classmethod
    def from_bytes(cls, data: bytes) -> "FibPublicInputs":
        return cls(*struct.unpack("<QQ", data))


def fib_result(n_steps: int) -> int:
    a, b = 1, 2
    for _ in range(n_steps - 1):
        a, b = (a + b) % F.P, (a + 2 * b) % F.P
    return b


def build_fib_trace(n_steps: int, device="cpu") -> torch.Tensor:
    """(2, n_steps) main trace."""
    tr = np.zeros((2, n_steps), dtype=np.uint64)
    a, b = 1, 2
    for i in range(n_steps):
        tr[0, i], tr[1, i] = a, b
        a, b = (a + b) % F.P, (a + 2 * b) % F.P
    return from_u64(tr, device)


class FibAir(Air):
    main_width = 2
    aux_width = 1
    aux_rands = 2

    def transition_degrees(self) -> List[TransitionDegree]:
        return [TransitionDegree(1), TransitionDegree(1), TransitionDegree(2)]

    def get_assertions(self) -> List[Assertion]:
        n = self.trace_length
        return [
            Assertion(0, 0, 1),
            Assertion(1, 0, 2),
            Assertion(1, n - 1, self.pub_inputs.result),
            Assertion(2, 0, 1, is_aux=True),
        ]

    def evaluate_transitions(self, main_cur, main_nxt, aux_cur, aux_nxt,
                             aux_rand: Sequence[int]):
        a, b = main_cur[0], main_cur[1]
        an, bn = main_nxt[0], main_nxt[1]
        c0 = sub(an, add(a, b))
        c1 = sub(bn, add(a, mul_scalar(b, 2)))
        p, pn = aux_cur[0], aux_nxt[0]
        r0 = scalar(aux_rand[0], a.device)
        r1 = scalar(aux_rand[1], a.device)
        mix = add(r0, add(a, mul(b, r1)))
        c2 = sub(pn, mul(p, mix))
        return [c0, c1, c2]

    def build_aux_trace(self, main_trace: torch.Tensor,
                        aux_rand: Sequence[int]) -> torch.Tensor:
        main = to_u64(main_trace)
        n = main.shape[1]
        p = np.zeros((1, n), dtype=np.uint64)
        acc = 1
        r0, r1 = aux_rand
        for i in range(n):
            p[0, i] = acc
            acc = acc * ((r0 + int(main[0, i]) + r1 * int(main[1, i]))
                         % F.P) % F.P
        return from_u64(p, main_trace.device)
