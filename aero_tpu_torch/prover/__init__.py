from .prover import STAGES, ProverState, prove, prove_resumable
