"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell is lives in files found by name: the cell
(`workloads/<cell>.json`: its configuration, its entry, its pool, its
client count), the configuration (`configs/<config>.json`), the
program's source (`programs/<name>.masm`), and the metrics, one module
each under `end_to_end/` and `metrics/` (the per-layer ones), which
declare their unit, direction, source, layer, the end-to-end metric they
move and the cells they read, and take their number from the run
(`read(run)`; None where the run holds nothing to read, and the metric
is then left out).

The window is a closed loop with one client: request k + 1 is sent
when request k's proof is back as bytes on the host. It measures for
`seconds` and then lets the request in flight finish. Every number is
taken over all the requests of the window: the rate over the window's
whole length, the tail over every latency. Nothing is timed on the
device or compiled inside the window; with `--trace 1` the profiler runs
after it, on requests of their own (`profiling.py`).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aero_tpu")


class NoCard(RuntimeError):
    pass


def load(kind: str, name: str) -> dict:
    """`configs/<name>.json` or `workloads/<name>.json`."""
    with open(ROOT / kind / f"{name}.json") as f:
        return json.load(f)


def metric_modules(kind: str) -> Dict[str, object]:
    """Every metric module under `end_to_end/` or `metrics/`, by the
    metric's name (the file's name without `.py`)."""
    out = {}
    for path in sorted((ROOT / kind).glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            f"port_bench.{kind}.{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def metrics_for(kind: str, cell: str) -> Dict[str, object]:
    """The metrics of `kind` a cell reports: those whose WORKLOADS name
    it, or that name none."""
    return {k: m for k, m in metric_modules(kind).items()
            if getattr(m, "WORKLOADS", None) in (None, [])
            or cell in m.WORKLOADS}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def nearest_rank(values, q: float) -> float:
    """The q-quantile (0 < q <= 1) of all the values, nearest rank: the
    smallest value with at least q of them at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def rows_per_s(run) -> Optional[float]:
    """Rows of every proof completed in the window over its length."""
    if not run.completed or run.window_s <= 0:
        return None
    return run.config["rows"] * len(run.completed) / run.window_s


def latency_p95_s(run) -> Optional[float]:
    """95th percentile, nearest rank, of every window request's latency."""
    lats = [r.latency for r in run.window]
    return nearest_rank(lats, 0.95) if lats else None


@dataclass
class Request:
    index: int
    start: float
    end: float
    answer: object = None                 # entries.Answer, None if it failed
    error: Optional[str] = None
    spans: Dict[str, float] = field(default_factory=dict)   # name -> seconds
    host_spans: list = field(default_factory=list)          # (name, start, end)
    # the program's counters summed over every `prove_program` subtree;
    # None where the request left no such span or filled the tracer's ring
    counters: Optional[Dict[str, int]] = None

    @property
    def latency(self) -> float:
        return self.end - self.start


@dataclass
class Run:
    """All a run measured; the metrics read their numbers from it."""
    cell: dict
    config: dict
    seed: int
    setup_s: float = 0.0
    cold_proof_s: Optional[float] = None
    window: List[Request] = field(default_factory=list)
    window_start: float = 0.0
    window_end: float = 0.0
    peak_window_bytes: int = 0            # the window's, from a reset at its start
    peak_bytes: int = 0                   # the process's
    segment: object = None                # profiling.Segment with --trace 1
    traced: List[Request] = field(default_factory=list)

    @property
    def completed(self) -> List[Request]:
        return [r for r in self.window if r.error is None]

    @property
    def window_s(self) -> float:
        return self.window_end - self.window_start

    def span_mean(self, name: str) -> Optional[float]:
        """Mean seconds of span `name` a completed window request, over
        the requests that ran it; None where none did."""
        vals = [r.spans[name] for r in self.completed if name in r.spans]
        return sum(vals) / len(vals) if vals else None


PROOF_SPAN = "prove_program"


def proof_counters(records) -> Optional[Dict[str, int]]:
    """Each counter of the program's span records summed over the
    subtree of every `prove_program` record: the record and every record
    opened inside it, at any depth (a record's `parent` is the `index` of
    the span it opened in). None where no record is `prove_program`."""
    inside: set = set()
    out: Dict[str, int] = {}
    # a span opens before the spans inside it: walk in the order of opening
    for rec in sorted(records, key=lambda r: r.index):
        if rec.name == PROOF_SPAN or rec.parent in inside:
            inside.add(rec.index)
            for name, n in rec.counters.items():
                out[name] = out.get(name, 0) + n
    return out if inside else None


def run_request(entry, k: int) -> Request:
    """One request of the closed loop, with the program's spans and
    counters of that request alone, read after its end is taken."""
    from aero_tpu_torch.utils import get_tracer
    tracer = get_tracer()
    tracer.reset()
    start = time.perf_counter()
    try:
        answer = entry.request(k)
        error = None
    except Exception as e:  # noqa: BLE001 - a failed request is counted
        traceback.print_exc()
        answer, error = None, f"{type(e).__name__}: {e}"
    end = time.perf_counter()
    req = Request(k, start, end, answer, error)
    records = list(tracer.records)
    for rec in records:
        req.spans[rec.name] = req.spans.get(rec.name, 0.0) + rec.duration_s
        req.host_spans.append((rec.name, rec.start, rec.start + rec.duration_s))
    # a full ring may have dropped records of this request: no short count
    if len(records) < tracer.records.maxlen:
        req.counters = proof_counters(records)
    if answer is not None:
        req.host_spans.extend(answer.spans)
    tracer.reset()
    return req


def measure(entry, seconds: float, sync) -> tuple:
    """The window: requests back to back for `seconds`, the last one let
    finish. Returns (requests, start, end)."""
    sync()
    reqs: List[Request] = []
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        reqs.append(run_request(entry, k))
        k += 1
    end = reqs[-1].end if reqs else time.perf_counter()
    return reqs, t0, end


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             t_process: float, rehearse: bool = False,
             control: bool = False) -> tuple:
    """Set up, measure and check one cell: (the Run, the compared
    numbers). With `rehearse`, on the CPU at 64 rows with a pool of at
    most 2."""
    import torch
    from . import entries, judge
    cell = load("workloads", cell_name)
    cfg = load("configs", cell["config"])
    chips = int(cell.get("chips", 1))
    if cell["clients"] != 1:
        raise ValueError("the harness drives one client in a closed loop; "
                         f"{cell['name']} asks for {cell['clients']}")
    if rehearse:
        cfg = rehearsal_config(cfg)
        cell = dict(cell, pool=min(cell.get("pool", 1), 2),
                    warmup=min(cell.get("warmup", 1), 1))
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise NoCard("no CUDA card: the benchmark runs on the card only")
        if torch.cuda.device_count() < chips:
            raise NoCard(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} found")
        device = torch.device("cuda", 0)
        from aero_tpu_torch import _build
        _build.load()                     # builds on a checkout's first run
    from aero_tpu_torch.utils import get_tracer

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run = Run(cell, cfg, seed)
    entry = entries.ENTRIES[cell["entry"]](cfg, cell, seed, device, control)
    get_tracer().reset()
    entry.setup()
    first = [r for r in get_tracer().records if r.name == "prove_program"]
    run.cold_proof_s = first[0].duration_s if first else None
    get_tracer().reset()
    gc.collect()
    sync()
    if device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_s = time.perf_counter() - t_process
    run.window, run.window_start, run.window_end = measure(entry, seconds,
                                                           sync)
    if device.type == "cuda":
        run.peak_window_bytes = torch.cuda.max_memory_allocated(device)
    if trace and device.type == "cuda":
        from .profiling import trace_segment
        run.traced, run.segment = trace_segment(
            entry, len(run.window), int(cell["trace_requests"]), run_request)
    if device.type == "cuda":
        run.peak_bytes = max(run.peak_bytes,
                             torch.cuda.max_memory_allocated(device))
    entry.close()
    del entry
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = judge.check(run)
    return run, checks


def rehearsal_config(cfg: dict) -> dict:
    """The configuration at `n_iters` 3, for a run on the CPU: the same
    program, options and AIR on a trace the CPU proves in seconds. Its
    rows are the length of the trace the VM gives that program, at least
    64 (the fib programs' 64; a program with chiplet rows or procedures
    its own)."""
    from aero_tpu_torch.vm import execute_full
    from .entries import POOL, inputs
    from .programs import program_source
    out = json.loads(json.dumps(cfg))
    out["program"] = dict(out["program"], n_iters=3)
    trace, _, _ = execute_full(program_source(out["program"]),
                               inputs(0, POOL, 0), min_rows=64)
    out["rows"] = trace.shape[1]
    out["lde_domain"] = out["rows"] * out["options"]["blowup_factor"]
    return out
