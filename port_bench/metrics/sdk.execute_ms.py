"""Mean milliseconds of the SDK's span `execute` a request of the window:
the VM run, the public inputs, the AIR and the trace's upload (not
synchronized: part of the copy may fall into `trace_commit`)."""

LAYER, UNIT, BETTER, SOURCE = "sdk", "ms", "lower", "program_span"
MOVES = "latency_p95_s"
WORKLOADS = ["miden-fib-2e14.sdk"]


def read(run):
    v = run.span_mean("execute")
    return None if v is None else v * 1e3
