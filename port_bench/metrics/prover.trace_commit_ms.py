"""Mean milliseconds of the prover's stage span `trace_commit` a proof of
the window (the iNTT, LDE and Merkle commitment of the main trace),
closed by a synchronize."""

LAYER, UNIT, BETTER, SOURCE = "prover", "ms", "lower", "program_span"
MOVES = "rows_per_s"
WORKLOADS = None            # every cell, later ones too


def read(run):
    v = run.span_mean("trace_commit")
    return None if v is None else v * 1e3
