"""The port's prover end to end on FibAir: its proof bytes equal the live
aero_tpu.prover.prove proof on the same trace and options (the first
milestone of the port: field, NTT, hash, Merkle, FRI, PoW and openings),
and the proof verifies under the spec verifier with the port's air."""

import numpy as np
import pytest
import torch

from aero_tpu.air import fib as JF
from aero_tpu.prover import prove as jax_prove
from aero_tpu.spec import field as F
from aero_tpu.spec.proof import ProofOptions, StarkProof
from aero_tpu.spec.verifier import VerificationError, verify
from aero_tpu_torch.air import fib as TF
from aero_tpu_torch.field import from_u64, to_u64
from aero_tpu_torch.prover import STAGES, prove, prove_resumable
from aero_tpu_torch.prover import prover as prover_mod

torch.set_num_threads(1)   # one thread per xdist worker: no oversubscription

OPTS = ProofOptions(num_queries=27, blowup_factor=8, grinding_factor=8,
                    fri_folding_factor=8, fri_max_remainder_size=256)
N = 64


@pytest.fixture(scope="module")
def jax_fib_proof():
    pub = JF.FibPublicInputs(result=JF.fib_result(N), n_steps=N)
    return jax_prove(JF.FibAir(N, pub, OPTS), JF.build_fib_trace(N),
                     pub).to_bytes()


def _port_air():
    pub = TF.FibPublicInputs(result=TF.fib_result(N), n_steps=N)
    return TF.FibAir(N, pub, OPTS), pub


def test_fib_proof_bytes_equal_aero_tpu(jax_fib_proof):
    air, pub = _port_air()
    proof = prove(air, TF.build_fib_trace(N), pub)
    assert proof.to_bytes() == jax_fib_proof
    t = verify(StarkProof.from_bytes(proof.to_bytes()), pub, air=air)
    assert len(t.query_positions) == OPTS.num_queries


def test_rejects_wrong_result_claim(jax_fib_proof):
    air, pub = _port_air()
    bad_pub = TF.FibPublicInputs(result=(pub.result + 1) % F.P, n_steps=N)
    with pytest.raises(VerificationError):
        verify(StarkProof.from_bytes(jax_fib_proof), bad_pub,
               air=TF.FibAir(N, bad_pub, OPTS))


def test_cheating_trace_overflows_the_composition_degree():
    pub = TF.FibPublicInputs(result=12345, n_steps=N)
    arr = to_u64(TF.build_fib_trace(N))
    arr[1, N - 1] = 12345
    with pytest.raises(ValueError, match="composition degree"):
        prove(TF.FibAir(N, pub, OPTS), from_u64(arr, "cpu"), pub)


def test_resumable_prove_resumes_after_a_failed_stage(tmp_path,
                                                      jax_fib_proof,
                                                      monkeypatch):
    air, pub = _port_air()
    fns = list(prover_mod._STAGE_FNS)
    failing = STAGES.index("deep_composition")

    def boom(air_, st):
        raise RuntimeError("killed mid-proof")

    monkeypatch.setattr(prover_mod, "_STAGE_FNS",
                        tuple(boom if i == failing else f
                              for i, f in enumerate(fns)))
    with pytest.raises(RuntimeError):
        prove_resumable(air, TF.build_fib_trace(N), pub, str(tmp_path))
    monkeypatch.setattr(prover_mod, "_STAGE_FNS", tuple(fns))
    air2, _ = _port_air()
    proof = prove_resumable(air2, TF.build_fib_trace(N), pub, str(tmp_path))
    assert proof.to_bytes() == jax_fib_proof


def test_prover_state_moves_between_devices():
    air, pub = _port_air()
    st = prover_mod.ProverState(pub_inputs=pub, device="cpu",
                                main_trace=TF.build_fib_trace(N))
    for i in range(len(STAGES)):
        prover_mod._run_stage(i, air, st)
    before = st.proof.to_bytes()
    st.to_host().to_device()
    assert st.main_lde.device.type == "cpu"
    assert np.array_equal(to_u64(st.fri_layers[0].evals),
                          to_u64(st.deep))
    assert st.proof.to_bytes() == before
