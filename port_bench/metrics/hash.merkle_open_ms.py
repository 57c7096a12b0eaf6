"""Mean milliseconds a request of the window in the program's spans
`merkle_open`, summed over the request: every batch opening of a Merkle
tree (`ResidentMerkleTree.prove_batch`: the trace, aux and constraint
trees and each FRI layer), each level's upload of offsets and read of
digests waiting for the stream."""

LAYER, UNIT, BETTER, SOURCE = "hash", "ms", "lower", "program_span"
MOVES = "rows_per_s"
WORKLOADS = None            # every cell, later ones too


def read(run):
    v = run.span_mean("merkle_open")
    return None if v is None else v * 1e3
