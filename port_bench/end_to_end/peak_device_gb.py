"""Peak device memory of the window, in 10^9 bytes:
`torch.cuda.max_memory_allocated` after the peak was reset at the
window's start, so it holds what set-up left resident (the pool, the
tables) and the largest working set of a request. The largest trace a
card can prove; it shows memory traded for speed."""

UNIT, BETTER, SOURCE = "GB", "lower", "device_trace"
WORKLOADS = None


def read(run):
    return run.peak_window_bytes / 1e9 if run.peak_window_bytes else None
