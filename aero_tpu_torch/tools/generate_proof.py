"""generate_proof — prove a VM program and write a .bin proof file.

The counterpart of `tools/generate_proof.py` (the reference's
`make generate_proof`, miden-proof-generator/src/main.rs:9-52): runs the
Fibonacci program on the VM, proves it through this package with the golden
parameters (27 queries, blowup 8, 16-bit grinding, blake2s, FRI folding 8),
self-verifies, and writes the bincode-style ProofData file. It proves on the
CUDA card unless `--cpu` is given.

    python -m aero_tpu_torch.tools.generate_proof [--n 10]
        [--out proofs/fib.bin] [--min-rows 1024] [--grind 16] [--cpu]
"""

import argparse
import os
import sys
import time


def generate(n: int = 10, out: str = "proofs/fib.bin", min_rows: int = 1024,
             grind: int = 16, queries: int = 27, device=None) -> bytes:
    """Prove fib(n) on `device` (None: the CUDA card), self-verify, write
    the proof file to `out` and return its bytes."""
    from ..air.miden import MidenAir, make_public_inputs
    from ..field import from_u64
    from ..prover import prove
    from .._device import resolve_device
    from ..spec.proof import ProofOptions, dump_proof_file
    from ..spec.verifier import verify
    from ..vm import execute, fibonacci_source, program_hash

    device = resolve_device(device)
    src = fibonacci_source(n)
    t0 = time.time()
    trace, out_stack = execute(src, [0, 1], min_rows=min_rows)
    print(f"executed: trace 2^{trace.shape[1].bit_length()-1} x 72, "
          f"outputs {out_stack[:2]} ({time.time()-t0:.2f}s)")

    pub = make_public_inputs(program_hash(src), [0, 1], out_stack)
    opts = ProofOptions(num_queries=queries, blowup_factor=8,
                        grinding_factor=grind)
    air = MidenAir(trace.shape[1], pub, opts, program=src)

    t0 = time.time()
    proof = prove(air, from_u64(trace, device), pub)
    wall = time.time() - t0
    data = dump_proof_file(pub, proof)
    print(f"proved in {wall:.2f}s; proof size: {len(data)/1024:.1f} KB")

    verify(proof, pub, air=air)
    print("self-verification OK (all 49 constraints checked at the OOD point)")

    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "wb") as f:
        f.write(data)
    print(f"wrote {out}")
    return data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10, help="fibonacci iterations")
    ap.add_argument("--out", default="proofs/fib.bin")
    ap.add_argument("--min-rows", type=int, default=1024)
    ap.add_argument("--grind", type=int, default=16)
    ap.add_argument("--queries", type=int, default=27)
    ap.add_argument("--cpu", action="store_true",
                    help="prove on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)
    generate(args.n, args.out, args.min_rows, args.grind, args.queries,
             device="cpu" if args.cpu else None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
