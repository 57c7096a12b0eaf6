"""SDK facade: execute and prove a program, protobuf in and out.

The counterpart of `aero_tpu.sdk.prove` (`aero_tpu/sdk/__init__.py:171-194`),
proving through this package on a chosen device. It reuses the JAX-free
wire layer of `aero_tpu.sdk`: `DEFAULT_OPTIONS`, `options_from_pb`,
`proof_to_pb`, `public_inputs_to_pb` and `ProveResult`, so the same request
gives the same `pb.StarkProof` bytes from either package.
"""

from __future__ import annotations

from typing import Optional

from aero_tpu.sdk import (DEFAULT_OPTIONS, ProveResult, options_from_pb,
                          proof_to_pb, public_inputs_to_pb)
from aero_tpu.sdk.pb import aero_pb2 as pb
from aero_tpu.utils import span
from aero_tpu.vm import execute_full, program_hash

from .air.miden import MidenAir, make_public_inputs
from .field import from_u64
from .prover import prove as run_prover


def prove(program: pb.MidenProgram, inputs: pb.MidenProgramInputs,
          options: Optional[pb.ProofOptions] = None, min_rows: int = 64,
          device="cpu") -> ProveResult:
    """Execute `program` on the VM and prove the trace on `device`."""
    opts = options_from_pb(options) if options is not None \
        else DEFAULT_OPTIONS
    stack_init = list(inputs.stack_init)
    with span("execute"):
        trace, out_stack, overflow = execute_full(
            program.program, list(reversed(stack_init)),
            advice_tape=list(inputs.advice_tape), min_rows=min_rows)
        pub = make_public_inputs(program_hash(program.program),
                                 list(reversed(stack_init)), out_stack,
                                 overflow=overflow)
        air = MidenAir(trace.shape[1], pub, opts, program=program.program)
        main_trace = from_u64(trace, device)
    proof = run_prover(air, main_trace, pub)
    with span("to_pb"):
        pub_pb = public_inputs_to_pb(pub)
        proof_pb = proof_to_pb(proof)
    return ProveResult(outputs=pub_pb.outputs, public_inputs=pub_pb,
                       proof=proof_pb, native_proof=proof, native_pub=pub)
