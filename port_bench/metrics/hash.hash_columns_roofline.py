"""The blake2s leaf kernel's share of its roofline over the traced
segment: the least time of the leaves of every `hash_columns` call (its
compressions a leaf, `roofline.hash_columns_bound`) over the device time
of the `hash_columns_kernel` launches."""

from port_bench import roofline

LAYER, UNIT, BETTER, SOURCE = "hash", "%", "higher", "device_trace"
MOVES = "rows_per_s"
WORKLOADS = ["miden-fib-2e20.prove", "miden-fib-2e18.prove"]


def read(run):
    seg = run.segment
    if seg is None:
        return None
    _, dev_s = seg.device_seconds("hash_columns_kernel")
    bound = sum(roofline.hash_columns_bound(c["width"], c["leaves"])
                for kind, c in seg.calls if kind == "hash_columns")
    return 100.0 * bound / dev_s if dev_s > 0 and bound > 0 else None
