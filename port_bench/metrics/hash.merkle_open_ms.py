"""Mean milliseconds a request of the window in the program's spans
`merkle_open`, summed over the request: every batch opening of a Merkle
tree (`ResidentMerkleTree.prove_batch`: the trace, aux and constraint
trees and each FRI layer), each one `merkle_gather` launch over all the
tree's levels and one wait for the stream, which leaves the digests in
host memory."""

LAYER, UNIT, BETTER, SOURCE = "hash", "ms", "lower", "program_span"
MOVES = "rows_per_s"
WORKLOADS = None            # every cell, later ones too


def read(run):
    v = run.span_mean("merkle_open")
    return None if v is None else v * 1e3
