"""Seconds from the process's start to the first request of the window:
imports, the kernels loaded from the checkout's build (built there on
its first run), the pool's VM runs and uploads, and the warm-up proofs,
the first of which is the process's cold proof."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"
WORKLOADS = None


def read(run):
    return run.setup_s
