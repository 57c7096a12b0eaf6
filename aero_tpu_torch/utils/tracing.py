"""Structured tracing/profiling spans for the prover pipeline.

The reference wraps every prover stage in browser console timers
(aero-sdk/miden-wasm/src/proving_worker.rs:125-196: preparing_inputs,
generating_trace, prove_program_stage1, prove_trace_hashes,
constraint_evaluations, prove_final_stage, verify_program). This module is
the structured equivalent: nested spans with wall-clock durations,
collected into a per-process tracer and optionally echoed as they close
(AERO_TPU_TRACE=1, or Tracer(echo=True)).

Usage:
    from aero_tpu_torch.utils import span, get_tracer
    with span("prove_stage1"):
        ...
    get_tracer().records   # -> [TraceRecord(name, start, duration_s, depth)]
    get_tracer().report()  # -> formatted table
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class TraceRecord:
    name: str
    start: float
    duration_s: float
    depth: int
    meta: dict = field(default_factory=dict)


class Tracer:
    def __init__(self, echo: Optional[bool] = None):
        self.records: List[TraceRecord] = []
        self._depth = 0
        if echo is None:
            echo = os.environ.get("AERO_TPU_TRACE", "") not in ("", "0")
        self.echo = echo

    @contextmanager
    def span(self, name: str, **meta):
        t0 = time.perf_counter()
        depth = self._depth
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            dt = time.perf_counter() - t0
            self.records.append(TraceRecord(name, t0, dt, depth, meta))
            if self.echo:
                pad = "  " * depth
                extras = "".join(f" {k}={v}" for k, v in meta.items())
                print(f"[aero-tpu] {pad}{name}: {dt * 1e3:.1f} ms{extras}",
                      file=sys.stderr, flush=True)

    def report(self) -> str:
        lines = ["span" + " " * 36 + "ms"]
        for r in self.records:
            pad = "  " * r.depth
            lines.append(f"{pad}{r.name:<{40 - len(pad)}}{r.duration_s * 1e3:>10.1f}")
        return "\n".join(lines)

    def total(self, name: str) -> float:
        return sum(r.duration_s for r in self.records if r.name == name)

    def reset(self):
        self.records.clear()
        self._depth = 0


_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL


@contextmanager
def span(name: str, **meta):
    with _GLOBAL.span(name, **meta):
        yield
