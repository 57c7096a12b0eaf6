"""check_constraints — evaluate every MidenAir constraint on honest rows.

The counterpart of `tools/check_constraints.py`: a sanity tool that runs a
program on the VM, evaluates every `MidenAir` transition constraint on
consecutive rows of the execution trace (no proving) with this package's
`air/miden.py` and `field/gl.py`, checks the boundary assertions, and
reports whatever fails to vanish. It evaluates on the CUDA card unless
`--cpu` is given.

    python -m aero_tpu_torch.tools.check_constraints [program_file] [--cpu]

Without a program file it runs a builtin program that exercises every
operation family.
"""

import argparse
import sys

import numpy as np

M32 = (1 << 32) - 1

DEFAULT_SRC = f"""
begin
    push.{M32} push.1 u32add
    push.3 u32sub
    push.123456789 push.987654321 u32mul
    push.17 push.5 u32div
    push.17 push.5 u32mod
    push.12 push.10 u32and
    push.12 push.10 u32or
    push.12 push.10 u32xor
    push.0 u32not
    push.3 push.4 u32shl
    push.48 push.4 u32shr
    push.3 push.4 u32lt
    push.{(7 << 32) | 12345} u32split
    push.99 mem.store.7 drop
    mem.load.7
    push.2 mem.store.7 drop
    mem.load.7
    mem.load.123
    push.1 push.1 eq
    if.true push.5 else push.6 end
    push.3
    dup.0 push.0 neq
    while.true
        push.1 u32sub
        dup.0 push.0 neq
    end
    drop drop drop drop drop drop drop drop drop drop
    drop drop drop drop drop drop drop drop drop
end
"""


def check(src: str = DEFAULT_SRC, inputs=(0, 0), device=None,
          corrupt=None) -> int:
    """Run `src`, evaluate the constraints on `device` (None: the CUDA
    card) and print every failure; returns their number. `corrupt`
    (column, row, value) overwrites one trace cell first, to show a
    violated constraint being reported."""
    from ..air.miden import MidenAir, make_public_inputs
    from ..field import P, from_u64, to_u64
    from .._device import resolve_device
    from ..spec.proof import ProofOptions
    from ..vm import execute, program_hash

    device = resolve_device(device)
    trace, out_stack = execute(src, list(inputs), min_rows=64)
    n = trace.shape[1]
    pub = make_public_inputs(program_hash(src), list(inputs), out_stack)
    opts = ProofOptions(num_queries=7, blowup_factor=8, grinding_factor=1)
    air = MidenAir(n, pub, opts, program=src)
    if corrupt is not None:
        col, row, value = corrupt
        trace[col, row] = value

    rng = np.random.default_rng(7)
    aux_rand = [int(x) for x in rng.integers(1, 1 << 63, size=16)]
    main = from_u64(trace, device)
    aux = air.build_aux_trace(main, aux_rand)

    evals = air.evaluate_transitions(
        main[:, :-1].contiguous(), main[:, 1:].contiguous(),
        aux[:, :-1].contiguous(), aux[:, 1:].contiguous(), aux_rand)
    bad = 0
    for i, ev in enumerate(evals):
        v = to_u64(ev)
        nz = np.nonzero(v)[0]
        if len(nz):
            bad += 1
            print(f"constraint {i} NONZERO at rows {nz[:8].tolist()} "
                  f"values {v[nz[:4]].tolist()}")
    # boundary assertions, the rand-dependent ones included
    air._aux_rand = aux_rand
    aux_np = to_u64(aux)
    for a in air.get_assertions():
        col = (aux_np[a.column - air.main_width] if a.is_aux
               else trace[a.column])
        got = int(col[a.step])
        if got != a.value % P:
            bad += 1
            print(f"assertion col={a.column} step={a.step}: got {got}, "
                  f"want {a.value}")
    print(f"{len(evals)} transition constraints and "
          f"{air.num_assertions} assertions on {n} rows ({device}): "
          + ("all constraints vanish" if not bad else f"{bad} FAILURES"))
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("program", nargs="?", help="a program file "
                    "(default: the builtin program)")
    ap.add_argument("--cpu", action="store_true",
                    help="evaluate on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)
    src = DEFAULT_SRC
    if args.program:
        with open(args.program) as f:
            src = f.read()
    return 1 if check(src, device="cpu" if args.cpu else None) else 0


if __name__ == "__main__":
    sys.exit(main())
