"""`latency_p95_s` of the 2^20-row resident prover, under a bound of its
own, for the reason `rows_per_s.2e20` gives."""

from port_bench.harness import latency_p95_s

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"
WORKLOADS = ["miden-fib-2e20.prove"]
read = latency_p95_s
