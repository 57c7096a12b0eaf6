#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
                              --trace <0|1>

from the root of a checkout. The cell is `port_bench/workloads/<cell>.json`;
everything it names is found by name under `port_bench/`. It runs on one
CUDA card, and exits 2 with no result where there is none or fewer than
the cell asks for. With `--trace 0` the metrics are the cell's end-to-end
ones, with `--trace 1` its per-layer ones, read from a segment proved
under `torch.profiler` after the window.

The last lines of standard error are the compared numbers, each beside
its limit; the last line of standard output is the result:

    {"correct", "attempted", "failed", "metrics", "device",
     ["breakdown",] "checks"}

`--rehearse` runs the same cell files on the CPU at 64 rows and prints
no metric: a rehearsal of the control flow and of the check, never a
measurement. `--control` proves with one query fewer than the
configuration states, a proof below its security, which the check must
refuse.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


def result_line(run, checks, metrics, trace: bool, rehearse: bool) -> dict:
    import torch
    from port_bench import judge
    reqs = run.window + run.traced
    if rehearse:
        device = {"platform": "cpu", "kind": "rehearsal", "count": 0,
                  "memory_peak_bytes": 0}
    else:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": int(run.cell.get("chips", 1)),
                  "memory_peak_bytes": int(run.peak_bytes)}
    out = {"correct": judge.correct(checks), "attempted": len(reqs),
           "failed": sum(r.answer is None for r in reqs),
           "metrics": {} if rehearse else metrics, "device": device}
    seg = run.segment
    if trace and seg is not None:
        device["busy_s"] = seg.busy_s
        device["window_s"] = seg.window_s
        top = sorted(seg.ops.items(), key=lambda kv: -kv[1][1])[:10]
        out["breakdown"] = {
            "device_ops": [[k[:120], s] for k, (_, s) in top],
            "idle_gaps": [[name, s] for name, s in seg.gaps[:10]]}
    out["checks"] = {k: {"value": checks[k], "limit": lim}
                     for k, lim in judge.LIMITS.items()}
    out["checks"]["checked"] = {"value": checks["checked"], "limit": 1}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    from port_bench import harness
    try:
        run, checks = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            T_PROCESS, rehearse=args.rehearse, control=args.control)
    except harness.NoCard as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print("port_bench: the run loaded JAX or the JAX package: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    kind = "metrics" if args.trace else "end_to_end"
    metrics = {}
    for name, mod in harness.metrics_for(kind, args.workload).items():
        value = mod.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": mod.UNIT}
    line = result_line(run, checks, metrics, bool(args.trace), args.rehearse)
    if not args.rehearse:
        print(f"card: {_card_line()}", file=sys.stderr)
    lats = sorted(r.latency for r in run.window)
    if lats:
        print(f"window: {len(lats)} requests in {run.window_s:.6f} s; "
              f"latency min {lats[0]:.6f}, median {lats[len(lats) // 2]:.6f}, "
              f"max {lats[-1]:.6f} s; set-up {run.setup_s:.6f} s, cold "
              f"proof {run.cold_proof_s} s", file=sys.stderr)
    for name, c in line["checks"].items():
        rel = "at least" if name == "checked" else "limit"
        print(f"{name}: {c['value']} ({rel} {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
