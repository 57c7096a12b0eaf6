"""proof_diff — the first part at which two serialized proofs differ.

    python -m aero_tpu_torch.tools.proof_diff A.bin B.bin

Each file holds `StarkProof.to_bytes()` or a proof file with its public
inputs (`spec.proof.dump_proof_file`). The proofs' parts are compared in
the order the prover makes them: the context, the trace and aux roots, the
constraint root, the OOD frame, each FRI layer root, the remainder, the
proof-of-work nonce, then the openings of each commitment. Two provers
that agree up to a part and differ there differ in the stage that makes
it. Prints `equal`, or the first part that differs and exits 1.
"""

import argparse
import itertools
import struct
import sys
from typing import Iterator, Optional, Tuple

from ..spec.proof import StarkProof, load_proof_file


def stages(proof: StarkProof) -> Iterator[Tuple[str, bytes]]:
    """(name, bytes) of each part of `proof`, in the prover's order."""
    segments = 1 + proof.context.layout.num_aux_segments
    yield "context", proof.context.to_bytes()
    yield "trace_root", proof.commitments[0]
    for i in range(1, segments):
        yield f"aux_root[{i - 1}]", proof.commitments[i]
    yield "constraint_root", proof.constraint_root()
    yield "ood_trace_states", proof.ood_frame.trace_states
    yield "ood_evaluations", proof.ood_frame.evaluations
    for i, root in enumerate(proof.fri_roots()):
        yield f"fri_root[{i}]", root
    yield "fri_remainder", proof.fri_proof.remainder
    yield "fri_num_partitions", bytes([proof.fri_proof.num_partitions])
    yield "pow_nonce", struct.pack("<Q", proof.pow_nonce)
    for i, q in enumerate(proof.trace_queries):
        yield f"trace_openings[{i}]", q.to_bytes()
    yield "constraint_openings", proof.constraint_queries.to_bytes()
    for i, layer in enumerate(proof.fri_proof.layers):
        yield f"fri_layer_openings[{i}]", layer.to_bytes()


def first_difference(a: bytes, b: bytes) -> Optional[str]:
    """The name of the first part at which the proofs `a` and `b` (each
    `StarkProof.to_bytes()`) differ, or None if they are equal."""
    pa, pb = StarkProof.from_bytes(a), StarkProof.from_bytes(b)
    for x, y in itertools.zip_longest(stages(pa), stages(pb)):
        if x != y:
            return (x or y)[0]
    return None


def read_proof(path: str) -> bytes:
    """The `StarkProof` bytes in `path`, with or without public inputs."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        StarkProof.from_bytes(data)
        return data
    except (ValueError, AssertionError):
        return load_proof_file(path)[1].to_bytes()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    args = ap.parse_args(argv)
    where = first_difference(read_proof(args.a), read_proof(args.b))
    print("equal" if where is None else f"first difference: {where}")
    return 0 if where is None else 1


if __name__ == "__main__":
    sys.exit(main())
