"""Seconds of the process's first proof, in set-up: the program's span
`prove_program` of the first warm-up request, which ends in its last
stage's synchronize. It pays the first launches of every kernel and the
NTT tables' first builds."""

LAYER, UNIT, BETTER, SOURCE = "prover", "s", "lower", "program_span"
MOVES = "setup_s"
WORKLOADS = None            # every cell, later ones too


def read(run):
    return run.cold_proof_s
