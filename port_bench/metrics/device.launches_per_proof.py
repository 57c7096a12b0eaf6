"""Device kernel launches a request (copies and memsets apart), counted by
`torch.profiler` over the traced segment. A count: it repeats exactly."""

LAYER, UNIT, BETTER, SOURCE = "device", "launches", "lower", "device_trace"
MOVES = "rows_per_s"
WORKLOADS = None            # every cell, later ones too


def read(run):
    seg = run.segment
    if seg is None or not seg.requests:
        return None
    return seg.kernel_launches / seg.requests
