"""stark_parser — re-encode STARK proofs as Cairo-memory JSON.

The counterpart of `tools/stark_parser.py`, CLI-compatible with the
reference's Rust parser (miden-to-cairo-parser bin/stark_parser,
src/main.rs:14-113):

    python -m aero_tpu_torch.tools.stark_parser <file> proof
    python -m aero_tpu_torch.tools.stark_parser <file> public-inputs
    python -m aero_tpu_torch.tools.stark_parser <file> trace-queries '<json indexes>'
    python -m aero_tpu_torch.tools.stark_parser <file> constraint-queries '<json indexes>'
    python -m aero_tpu_torch.tools.stark_parser <file> fri-queries '<json indexes>'
    python -m aero_tpu_torch.tools.stark_parser <file> interpolate-poly '<json x hex>' '<json y hex>'

Works on both the reference's golden fib.bin and proofs written by
`aero_tpu_torch.tools.generate_proof`. Host code only: it needs no card.
"""

import json
import sys

from ..io.cairo_memory import (
    to_json, write_proof, write_public_inputs, write_trace_query_paths,
    write_constraint_query_paths, write_fri_query_paths)
from ..spec.polys import interpolate
from ..spec.proof import load_proof_file


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    path, cmd = argv[0], argv[1]
    pub, proof = load_proof_file(path)
    if cmd == "proof":
        print(to_json(write_proof, proof))
    elif cmd == "public-inputs":
        print(to_json(write_public_inputs, pub))
    elif cmd == "trace-queries":
        idxs = json.loads(argv[2])
        print(to_json(write_trace_query_paths, proof, idxs))
    elif cmd == "constraint-queries":
        idxs = json.loads(argv[2])
        print(to_json(write_constraint_query_paths, proof, idxs))
    elif cmd == "fri-queries":
        idxs = json.loads(argv[2])
        print(to_json(write_fri_query_paths, proof, idxs))
    elif cmd == "interpolate-poly":
        xs = [int.from_bytes(bytes.fromhex(v), "little")
              for v in json.loads(argv[2])]
        ys = [int.from_bytes(bytes.fromhex(v), "little")
              for v in json.loads(argv[3])]
        coeffs = interpolate(xs, ys)
        print("".join(", " + str(c) for c in coeffs))
    else:
        print(f"unknown subcommand {cmd}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
