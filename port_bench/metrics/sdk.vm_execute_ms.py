"""Mean milliseconds of the SDK's span `vm_execute` a request of the
window: the VM run that makes the trace, the first part of `execute`."""

LAYER, UNIT, BETTER, SOURCE = "sdk", "ms", "lower", "program_span"
MOVES = "latency_p95_s"
WORKLOADS = ["miden-fib-2e14.sdk"]


def read(run):
    v = run.span_mean("vm_execute")
    return None if v is None else v * 1e3
