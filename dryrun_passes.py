#!/usr/bin/env python3
"""Cold and warm stage seconds and peak device memory of the sharded dry
run (`aero_tpu_torch.parallel.dryrun`) on one CUDA card.

    python3 dryrun_passes.py LABEL [LOG_ROWS ...]       (default: 18 20)

At 2^LOG_ROWS rows of the long fib program that `chip_smoke.py` phase 7
proves: the single device in this process, world 1 on `nccl` and world 4
sharing the card (exchanges staged through pinned host memory and gloo).
Each process runs the pipeline twice after its set-up, through the
package's own `_pipeline_roots`, and prints one JSON line (a run, or a
rank of one): the seconds per stage of both passes, the peak device memory
of the set-up and of the two passes (each net of what the process held
before its set-up), the exchanges, and whether the roots equal the single
device's. Exits non-zero if a run raises or a root differs.

It measures the `aero_tpu_torch` beside it. To set an earlier commit
beside this one in one call on the card, unpack that commit with
`git archive`, copy this file into it and run both copies, alternating.
"""

import gc
import json
import sys

import torch

from aero_tpu_torch.parallel import dryrun as dr
from aero_tpu_torch.parallel.mesh import run_ranks, shard_domain
from bench_gpu import long_fib_source

RUNS = ((1, "device"), (4, "host"))


def passes(mesh, device, rows: int) -> dict:
    """Set-up, then the pipeline twice, on `device` (a rank's, with a
    mesh)."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    air, trace, aux, rands = dr._dryrun_air_and_traces(
        rows, device, long_fib_source((rows - 64) // 12), (0, 1))
    if mesh is not None:
        trace, aux = shard_domain(mesh, trace), shard_domain(mesh, aux)
    torch.cuda.synchronize(device)
    setup_peak = torch.cuda.max_memory_allocated(device) - base
    torch.cuda.reset_peak_memory_stats(device)
    out = []
    for _ in range(2):
        clock = dr._StageClock(device)
        roots = dr._pipeline_roots(air, trace, aux, rands, 3, mesh, clock)
        out.append((roots, clock.seconds))
    if out[0][0] != out[1][0]:
        raise RuntimeError("the second pass's roots differ from the first's")
    rec = dict(roots=out[0][0], seconds=out[0][1], seconds_warm=out[1][1],
               setup_peak_device_bytes=setup_peak,
               peak_device_bytes=torch.cuda.max_memory_allocated(device)
               - base)
    if mesh is not None:
        rec.update(rank=mesh.rank, traffic={k: list(v) for k, v in
                                            mesh.traffic.items()})
    return rec


def rank_passes(mesh, rows: int) -> dict:
    return passes(mesh, mesh.device, rows)


def main(argv) -> int:
    label = argv[0]
    log_rows = [int(a) for a in argv[1:]] or [18, 20]
    dev = torch.device("cuda", 0)
    dr._ready_builds(True)
    equal = True
    for lr in log_rows:
        rows = 1 << lr
        gc.collect()
        torch.cuda.empty_cache()
        single = passes(None, dev, rows)
        want = single.pop("roots")
        print(json.dumps(dict(tree=label, rows=rows, run="single device",
                              **single)), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        for world, exchange in RUNS:
            for r in run_ranks(rank_passes, world,
                               dr.rank_devices(world, dev, exchange), (rows,),
                               exchange, 900):
                r["roots_equal_single"] = r.pop("roots") == want
                equal &= r["roots_equal_single"]
                print(json.dumps(dict(tree=label, rows=rows,
                                      run=f"world {world}, {exchange}", **r)),
                      flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("dryrun_passes: no CUDA device; this script runs on the card")
    sys.exit(main(sys.argv[1:]))
