"""Trace rows proved a second: the rows of every proof completed in the
window over the window's whole length. What a proving service pays a
proof. Every cell, later ones too; its bound is set by the cells whose
host does most of the work (`rows_per_s.2e20` holds the 2^20-row cell to
its own, tighter one)."""

from port_bench.harness import rows_per_s

UNIT, BETTER, SOURCE = "rows/s", "higher", "host_clock"
WORKLOADS = None
read = rows_per_s
