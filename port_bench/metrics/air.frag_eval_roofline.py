"""K5's share of its roofline over the traced segment: the least time of
the merge over the points of every `frag_eval` call (the AIR's traced
field ops and the merge's a point, `roofline.frag_eval_bound`) over the
device time of the `frag_merge_kernel` launches."""

from port_bench import roofline

LAYER, UNIT, BETTER, SOURCE = "air", "%", "higher", "device_trace"
MOVES = "rows_per_s"
WORKLOADS = ["miden-fib-2e20.prove", "miden-fib-2e18.prove"]


def read(run):
    seg = run.segment
    if seg is None:
        return None
    _, dev_s = seg.device_seconds("frag_merge_kernel")
    bound = sum(roofline.frag_eval_bound(c["air"], c["points"])
                for kind, c in seg.calls
                if kind == "frag_eval" and c["merge"]
                and c["air"] in roofline.FRAG_EVAL_OPS)
    return 100.0 * bound / dev_s if dev_s > 0 and bound > 0 else None
