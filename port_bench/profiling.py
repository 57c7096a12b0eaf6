"""The traced segment of a `--trace 1` run: device time from `torch.profiler`.

After the measured window, a traced run proves a few more requests of the
same cell under `torch.profiler` (CPU and CUDA activity), with the calls
into the kernel layers recorded by shape (`Recorder`). From the
profiler's device events come:

- `busy_s`: the union of the intervals in which a kernel, a copy or a
  memset ran on the card, inside the segment;
- `window_s`: the segment's length on the host clock, from the first
  request's start to the last one's bytes;
- each device operation's count and seconds, by name;
- the idle gaps (the holes in that union), each named by the innermost
  span the host was in at the gap's middle: a tracing span of the program
  (its prover stages, "ntt_tables", "execute", ...) or one of the
  harness's own ("request", "serialize").

The host clock and the profiler's clock are tied by one annotation
recorded at a known `time.perf_counter()`.
"""

from __future__ import annotations

import importlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

ANCHOR = "port_bench.anchor"
# (module, attribute) of each call whose shape a roofline reads; a module
# binds the function by name, so every binding on the main path is wrapped
CALLS = {
    "ntt": [("aero_tpu_torch.ntt.ntt_cuda", "ntt_cuda"),
            ("aero_tpu_torch.ntt.ntt", "ntt_cuda")],
    "lde": [("aero_tpu_torch.ntt.ntt_cuda", "lde_cuda"),
            ("aero_tpu_torch.ntt.ntt", "lde_cuda")],
    "hash_columns": [("aero_tpu_torch.hash.blake2s_cuda", "hash_columns"),
                     ("aero_tpu_torch.merkle.tree", "hash_columns")],
    "frag_eval": [("aero_tpu_torch.field.gl_cuda", "frag_eval")],
}


def _shape(kind: str, args, kwargs) -> dict:
    """What a roofline needs of one call: its rows and sizes."""
    if kind == "ntt":
        x = args[0]
        n = x.shape[-1]
        return {"batch": x.numel() // max(n, 1), "log_n": n.bit_length() - 1}
    if kind == "lde":
        x, log_blowup = args[0], args[1]
        n = x.shape[-1] << log_blowup
        return {"batch": x.numel() // max(x.shape[-1], 1),
                "log_n": n.bit_length() - 1, "log_blowup": log_blowup}
    if kind == "hash_columns":
        w, m = args[0].shape
        return {"width": w, "leaves": m}
    name, zt = args[0], args[6]
    merge = not kwargs.get("transitions", args[11] if len(args) > 11
                           else False)
    return {"air": name, "points": zt.shape[-1], "merge": merge}


class Recorder:
    """Records the shape of every call into the wrapped entries while it
    is open, and puts every wrapped attribute back when it closes. An
    entry the program no longer has is left out: its roofline reads
    nothing."""

    def __init__(self):
        self.calls: List[Tuple[str, dict]] = []
        self._saved: list = []

    def __enter__(self):
        for kind, targets in CALLS.items():
            for mod_name, attr in targets:
                mod = importlib.import_module(mod_name)
                orig = getattr(mod, attr, None)
                if orig is None:
                    continue
                self._saved.append((mod, attr, orig))
                setattr(mod, attr, self._wrap(kind, orig))
        return self

    def _wrap(self, kind, orig):
        def call(*args, **kwargs):
            self.calls.append((kind, _shape(kind, args, kwargs)))
            return orig(*args, **kwargs)
        return call

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()
        return False


@dataclass
class Segment:
    """What the traced segment measured."""
    requests: int
    window_s: float
    busy_s: float
    kernel_launches: int
    ops: Dict[str, Tuple[int, float]]      # name -> (count, device seconds)
    gaps: List[Tuple[str, float]]          # (host span, seconds), longest first
    calls: List[Tuple[str, dict]] = field(default_factory=list)

    def device_seconds(self, needle: str) -> Tuple[int, float]:
        """(launches, device seconds) of the operations whose name holds
        `needle`."""
        hits = [v for k, v in self.ops.items() if needle in k]
        return sum(c for c, _ in hits), sum(s for _, s in hits)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(spans, t) -> str:
    """The shortest host span holding host time t, or "host"."""
    best: Optional[Tuple[float, str]] = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return best[1] if best else "host"


def reduce(prof, anchor_host_s: float, t0: float, t1: float, spans,
           requests: int, calls) -> Segment:
    """A finished profile's segment [t0, t1] (host seconds): busy time,
    operations by name, and idle gaps named by `spans`, (name, start,
    end) in host seconds."""
    import torch
    events = prof.events()
    anchor = [e for e in events if e.name == ANCHOR]
    if not anchor:
        raise RuntimeError("the profiler recorded no anchor annotation")
    # host seconds of a profiler timestamp (microseconds)
    shift = anchor_host_s - anchor[0].time_range.start * 1e-6
    ops: Dict[str, List[float]] = {}
    intervals = []
    launches = 0
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a = e.time_range.start * 1e-6 + shift
        b = e.time_range.end * 1e-6 + shift
        if b <= t0 or a >= t1:
            continue
        intervals.append((max(a, t0), min(b, t1)))
        row = ops.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += (e.time_range.end - e.time_range.start) * 1e-6
        if not e.name.startswith(("Memcpy", "Memset")):
            launches += 1
    busy = _union(intervals)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = [(_innermost(spans, (a + b) / 2), b - a)
            for a, b in zip(edges[::2], edges[1::2]) if b > a]
    gaps.sort(key=lambda g: -g[1])
    return Segment(requests=requests, window_s=t1 - t0,
                   busy_s=sum(b - a for a, b in busy),
                   kernel_launches=launches,
                   ops={k: (int(c), s) for k, (c, s) in ops.items()},
                   gaps=gaps, calls=list(calls))


def trace_segment(entry, first_index: int, count: int, run_request):
    """Prove `count` requests from `first_index` on under the profiler and
    the call recorder; returns (the requests, the Segment)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from aero_tpu_torch.utils import get_tracer
    spans: list = []
    done = []
    with Recorder() as rec, profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        anchor = time.perf_counter()
        with record_function(ANCHOR):
            pass
        t0 = time.perf_counter()
        for k in range(first_index, first_index + count):
            req = run_request(entry, k)
            done.append(req)
            spans.append(("request", req.start, req.end))
            spans.extend(req.host_spans)
        t1 = time.perf_counter()
    get_tracer().reset()
    return done, reduce(prof, anchor, t0, t1, spans, count, rec.calls)
