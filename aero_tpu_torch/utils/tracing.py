"""Structured tracing/profiling spans for the prover pipeline.

The reference wraps every prover stage in browser console timers
(aero-sdk/miden-wasm/src/proving_worker.rs:125-196: preparing_inputs,
generating_trace, prove_program_stage1, prove_trace_hashes,
constraint_evaluations, prove_final_stage, verify_program). This module is
the structured equivalent: nested spans with wall-clock durations and
counters, collected into a per-process tracer and optionally echoed as they
close (AERO_TPU_TRACE=1, or Tracer(echo=True)).

Usage:
    from aero_tpu_torch.utils import count, span, get_tracer
    with span("prove_stage1"):
        count("syncs")          # adds 1 to the innermost open span
    get_tracer().records   # -> [TraceRecord(name, start, duration_s, depth,
                           #     meta, index, parent, counters)]
    get_tracer().report()  # -> formatted table

A record's `index` is its span's serial number in the tracer, in the order
the spans opened, and `parent` the index of the span it opened in (None at
the top): a span's own time is its duration less its children's, and
`subtree_count` sums a counter over a span and every span inside it. The
tracer keeps the last `MAX_RECORDS` records; `reset()` empties it.

While a `torch.profiler` is recording, every span also opens a
record-function range of its name, so the spans stand in the profiler's
own timeline, nested as they ran, on the clock of its kernels and runtime
calls. The range is a plain one, not a user annotation: the profiler draws
no device-side copy of it, so a reader that sums the device's intervals
sees only the device's work. With no profiler recording, the cost is one
read of torch's flag, and none while torch is not loaded.
"""

from __future__ import annotations

import collections
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

MAX_RECORDS = 4096


@dataclass
class TraceRecord:
    name: str
    start: float
    duration_s: float
    depth: int
    meta: dict = field(default_factory=dict)
    index: int = 0
    parent: Optional[int] = None
    counters: Dict[str, int] = field(default_factory=dict)


def _profiler_range(name: str):
    """An open record-function range of `name` while a torch.profiler
    records; None otherwise."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        return None
    import torch
    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


class Tracer:
    def __init__(self, echo: Optional[bool] = None):
        self.records: "collections.deque[TraceRecord]" = collections.deque(
            maxlen=MAX_RECORDS)
        self.counters: Dict[str, int] = {}    # counts made with no span open
        self._open: List[tuple] = []          # (index, counters) a span open
        self._next = 0
        if echo is None:
            echo = os.environ.get("AERO_TPU_TRACE", "") not in ("", "0")
        self.echo = echo

    @contextmanager
    def span(self, name: str, **meta):
        index = self._next
        self._next += 1
        parent = self._open[-1][0] if self._open else None
        counters: Dict[str, int] = {}
        depth = len(self._open)
        self._open.append((index, counters))
        rf = _profiler_range(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)
            self._open.pop()
            self.records.append(TraceRecord(name, t0, dt, depth, meta, index,
                                            parent, counters))
            if self.echo:
                pad = "  " * depth
                extras = "".join(f" {k}={v}" for k, v in
                                 (*meta.items(), *counters.items()))
                print(f"[aero-tpu] {pad}{name}: {dt * 1e3:.1f} ms{extras}",
                      file=sys.stderr, flush=True)

    def count(self, name: str, n: int = 1) -> None:
        """Add n to counter `name` of the innermost open span, or of the
        tracer itself where no span is open."""
        c = self._open[-1][1] if self._open else self.counters
        c[name] = c.get(name, 0) + n

    def report(self) -> str:
        lines = ["span" + " " * 36 + "ms"]
        for r in sorted(self.records, key=lambda r: r.index):
            pad = "  " * r.depth
            extras = "".join(f" {k}={v}" for k, v in r.counters.items())
            lines.append(f"{pad}{r.name:<{40 - len(pad)}}"
                         f"{r.duration_s * 1e3:>10.1f}{extras}")
        return "\n".join(lines)

    def reset(self):
        self.records.clear()
        self.counters.clear()


def subtree(records: Iterable[TraceRecord],
            root: TraceRecord) -> List[TraceRecord]:
    """`root` and every record held in it, at any depth."""
    recs = list(records)
    inside = {root.index}
    out = [root]
    # a parent opens before its children: walk in the order of opening
    for r in sorted(recs, key=lambda r: r.index):
        if r.parent in inside:
            inside.add(r.index)
            out.append(r)
    return out


def subtree_count(records: Iterable[TraceRecord], root: TraceRecord,
                  name: str) -> int:
    """Counter `name` summed over `root`'s subtree."""
    return sum(r.counters.get(name, 0) for r in subtree(records, root))


# the CUDA runtime calls by which the host waits for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


def profiled_syncs(prof, name: str) -> List[int]:
    """For each range of span `name` in a finished torch.profiler profile
    (CPU and CUDA activity), in order, the synchronizing runtime calls
    (`SYNC_CALLS`) the profiler recorded inside it: what the `syncs`
    counted in that span's subtree should equal."""
    events = prof.events()
    calls = [e.time_range for e in events if e.name in SYNC_CALLS]
    ranges = sorted((e.time_range for e in events if e.name == name),
                    key=lambda r: r.start)
    return [sum(r.start <= c.start and c.end <= r.end for c in calls)
            for r in ranges]


_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL


@contextmanager
def span(name: str, **meta):
    with _GLOBAL.span(name, **meta):
        yield


def count(name: str, n: int = 1) -> None:
    _GLOBAL.count(name, n)
