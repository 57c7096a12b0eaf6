"""Share of the traced segment in which nothing ran on the card: 1 - busy /
wall, busy the union of the kernel, copy and memset intervals that
`torch.profiler` recorded, wall the segment on the host clock."""

LAYER, UNIT, BETTER, SOURCE = "device", "%", "lower", "device_trace"
MOVES = "rows_per_s"
WORKLOADS = None            # every cell, later ones too


def read(run):
    seg = run.segment
    if seg is None or seg.window_s <= 0:
        return None
    return 100.0 * (1.0 - seg.busy_s / seg.window_s)
