"""Kernel 1's share of its roofline over the traced segment: the least
time of the transforms the proof asked for (every `ntt`/`intt` and coset
LDE call, counted from its shape by `roofline.ntt_call_bound`) over the
device time of the `colntt_kernel` launches (`gl_colntt` and
`gl_colntt_lde`)."""

from port_bench import roofline

LAYER, UNIT, BETTER, SOURCE = "ntt", "%", "higher", "device_trace"
MOVES = "rows_per_s"
WORKLOADS = ["miden-fib-2e20.prove", "miden-fib-2e18.prove"]


def read(run):
    seg = run.segment
    if seg is None:
        return None
    _, dev_s = seg.device_seconds("colntt_kernel")
    bound = sum(roofline.ntt_call_bound(c["log_n"], c["batch"],
                                        c.get("log_blowup", 0), kind == "lde")
                for kind, c in seg.calls if kind in ("ntt", "lde"))
    return 100.0 * bound / dev_s if dev_s > 0 and bound > 0 else None
