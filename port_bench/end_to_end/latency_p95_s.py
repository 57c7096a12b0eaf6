"""95th percentile (nearest rank) of the latency of every request of the
window, from its sending to its proof as bytes on the host; a request that
failed counts with the time it took. The tail a stall, a table rebuild
or a collector pause shows in. Every cell, later ones too; its bound is
set by the cells whose host does most of the work (`latency_p95_s.2e20`
holds the 2^20-row cell to its own, tighter one)."""

from port_bench.harness import latency_p95_s

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"
WORKLOADS = None
read = latency_p95_s
