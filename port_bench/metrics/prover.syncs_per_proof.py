"""Waits of the host for the card in a proof: the program's counter
`syncs` (one a blocking copy, a stream synchronize or a stream wait)
summed over the subtree of every `prove_program` span of a request, the
fewest over the window's completed requests. Only the proof's own waits
count: an SDK request's trace upload and protobuf lie outside that span.

The fewest and not the mean: the proof-of-work search waits once a batch
of nonces, and a batch holds about 4 x 2^bits of them, so about one proof
in 55 (e^-4) waits once more, as its seed falls. A mean over a pool of 2
to 8 traces would move from seed to seed by up to a pool slot's share (60
or 60.5 a proof at 2^20 rows); the fewest is the count of a proof whose
search ends in its first batch, and repeats exactly. None where a request
filled the tracer's ring of records, so that its sum could come out
short."""

LAYER, UNIT, BETTER, SOURCE = "prover", "syncs", "lower", "program_span"
MOVES = "rows_per_s"
WORKLOADS = None            # every cell, later ones too


def read(run):
    reqs = run.completed
    if not reqs or any(r.counters is None for r in reqs):
        return None
    return min(r.counters.get("syncs", 0) for r in reqs)
