"""Mean milliseconds a request of the window in the prover's spans
`coin_draws`, summed over the request: the bulk Fiat-Shamir draws on the
host (the aux randomness, the constraint and DEEP coefficients, the query
positions), one blake2s call an element."""

LAYER, UNIT, BETTER, SOURCE = "prover", "ms", "lower", "program_span"
MOVES = "rows_per_s"
WORKLOADS = None            # every cell, later ones too


def read(run):
    v = run.span_mean("coin_draws")
    return None if v is None else v * 1e3
