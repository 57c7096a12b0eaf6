"""`rows_per_s` of the 2^20-row resident prover, under a bound of its
own: there the kernels do most of the work and runs spread a few
percent, where the host-bound cells spread ten; one bound for both would
let the large proof slow by a quarter unseen."""

from port_bench.harness import rows_per_s

UNIT, BETTER, SOURCE = "rows/s", "higher", "host_clock"
WORKLOADS = ["miden-fib-2e20.prove"]
read = rows_per_s
