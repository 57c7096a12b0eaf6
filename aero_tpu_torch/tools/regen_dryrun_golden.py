"""regen_dryrun_golden — rewrite the committed dry-run roots.

The counterpart of `tools/regen_dryrun_golden.py`. `parallel.dryrun`
compares the sharded `MidenAir` pipeline's four Merkle roots at 64 rows
with `aero_tpu_torch/parallel/dryrun_golden.json`. This tool recomputes
them with the single-device pipeline and rewrites that file (or `--out`);
run it when the AIR, the trace or the NTT change their values on purpose.
The roots must stay equal to the JAX package's own golden file, which
`tests/test_torch_sharded.py` checks. It runs on the CUDA card unless
`--cpu` is given.

    python -m aero_tpu_torch.tools.regen_dryrun_golden [--cpu] [--out FILE]
"""

import argparse
import json
import sys


def regenerate(out=None, device=None) -> list:
    """Write {"trace_steps": 64, "roots": [...]} to `out` (None: the
    committed file) from a single-device run on `device` (None: the CUDA
    card); returns the roots."""
    from ..parallel.dryrun import (GOLDEN_PATH, ROOT_NAMES,
                                   single_device_dryrun_roots)
    out = out or GOLDEN_PATH
    roots = single_device_dryrun_roots(64, device)
    with open(out, "w") as f:
        json.dump({"trace_steps": 64, "roots": roots}, f, indent=1)
    print(f"wrote {out}")
    for name, r in zip(ROOT_NAMES, roots):
        print(f"  {name}: {[hex(w) for w in r]}")
    return roots


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="file to write (default: "
                    "the committed golden file)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)
    regenerate(args.out, "cpu" if args.cpu else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
