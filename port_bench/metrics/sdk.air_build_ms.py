"""Mean milliseconds of the SDK's span `air_build` a request of the
window: the program hash, the public inputs and the AIR, the second part
of `execute`."""

LAYER, UNIT, BETTER, SOURCE = "sdk", "ms", "lower", "program_span"
MOVES = "latency_p95_s"
WORKLOADS = ["miden-fib-2e14.sdk"]


def read(run):
    v = run.span_mean("air_build")
    return None if v is None else v * 1e3
