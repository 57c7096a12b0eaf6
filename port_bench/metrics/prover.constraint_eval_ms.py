"""Mean milliseconds of the prover's stage span `constraint_eval` a proof of
the window (K5 over the LDE domain, the composition's iNTT, LDE and
commitment), closed by a synchronize."""

LAYER, UNIT, BETTER, SOURCE = "prover", "ms", "lower", "program_span"
MOVES = "rows_per_s"
WORKLOADS = None            # every cell, later ones too


def read(run):
    v = run.span_mean("constraint_eval")
    return None if v is None else v * 1e3
