"""Mean milliseconds of the SDK's span `trace_upload` a request of the
window: the trace's copy from pageable host memory to the card, the last
part of `execute`. The copy ends in the stream's synchronize, so the span
holds all of it."""

LAYER, UNIT, BETTER, SOURCE = "sdk", "ms", "lower", "program_span"
MOVES = "latency_p95_s"
WORKLOADS = ["miden-fib-2e14.sdk"]


def read(run):
    v = run.span_mean("trace_upload")
    return None if v is None else v * 1e3
