"""Demo: prove fib(N) through the SDK, parallel vs sequential, with spans.

The counterpart of `tools/demo.py` (the reference's browser demo app,
aero-sdk/src/demo/index.ts: fib(1000) with parallel and sequential buttons
and console timers). It proves on the CUDA card unless `--cpu` is given.

    python -m aero_tpu_torch.tools.demo [--n 1000] [--submit] [--cpu]
"""

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1000, help="fib iterations")
    ap.add_argument("--cpu", action="store_true",
                    help="prove on the CPU instead of the CUDA card")
    ap.add_argument("--submit", action="store_true",
                    help="round-trip through the HTTP submission service")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    os.environ.setdefault("AERO_TPU_TRACE", "1")

    from ..sdk import prove, prove_sequential
    from ..sdk.pb import aero_pb2 as pb
    from ..utils import get_tracer
    from ..vm import fibonacci_source

    program = pb.MidenProgram(program=fibonacci_source(args.n))
    inputs = pb.MidenProgramInputs(stack_init=[0, 1], advice_tape=[])

    t0 = time.perf_counter()
    result = prove(program, inputs, device=device)
    t_par = time.perf_counter() - t0
    top = int.from_bytes(result.outputs.stack[0].element, "little")
    print(f"fib({args.n}) mod p = {top}")
    print(f"parallel prove: {t_par:.2f}s, "
          f"proof {len(result.native_proof.to_bytes()) / 1024:.1f} KB")

    t0 = time.perf_counter()
    prove_sequential(program, inputs, device=device)
    print(f"sequential prove: {time.perf_counter() - t0:.2f}s")

    print(get_tracer().report())

    if args.submit:
        from ..sdk.server import SubmissionServer, submit_proof_remote
        server = SubmissionServer().start()
        try:
            req = pb.ProofSubmissionRequest(
                proof=result.proof, public_inputs=result.public_inputs,
                source_proof_system=pb.MIDEN, target_chain=pb.STARKNET)
            receipt = submit_proof_remote(
                f"http://127.0.0.1:{server.port}", req)
            print(f"submission receipt: {receipt}")
        finally:
            server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
