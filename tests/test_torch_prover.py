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
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


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


# ----------------------------------------------------------------- FRI folds

@pytest.mark.parametrize("m,ff", [(64, 8), (256, 8), (128, 4), (32, 2)])
def test_fold_evals_gf_equals_fold_evals_and_aero_tpus(m, ff):
    import jax
    from aero_tpu import field as J
    from aero_tpu.prover import fri as JFRI
    from aero_tpu_torch.field import scalar
    from aero_tpu_torch.prover import fri as TFRI
    rng = np.random.default_rng(m + ff)
    evals = rng.integers(0, F.P, size=m, dtype=np.uint64)
    t = from_u64(evals, "cpu")
    for alpha in (0, 1, 31337, F.P - 1, int(rng.integers(0, F.P, dtype=np.uint64))):
        got = TFRI.fold_evals_gf(t, scalar(alpha, "cpu"), ff)
        assert got.shape == (m // ff,)
        assert torch.equal(got, TFRI.fold_evals(t, alpha, ff))
        with jax.disable_jit():
            a = J.to_gf(np.array(alpha, dtype=np.uint64))
            want = J.from_gf(JFRI.fold_evals_gf(J.to_gf(evals), a, ff))
        assert np.array_equal(to_u64(got), want)


def test_fold_evals_gf_takes_another_offset():
    from aero_tpu_torch.field import scalar
    from aero_tpu_torch.prover import fri as TFRI
    t = from_u64(np.arange(1, 65, dtype=np.uint64), "cpu")
    assert torch.equal(TFRI.fold_evals_gf(t, scalar(5, "cpu"), 8, offset=3),
                       TFRI.fold_evals(t, 5, 8, offset=3))
    assert not torch.equal(TFRI.fold_evals(t, 5, 8, offset=3),
                           TFRI.fold_evals(t, 5, 8))


@pytest.mark.parametrize("m,ff", [(64, 8), (32, 4)])
def test_transposed_rows_are_the_leaves_the_layer_commits(m, ff):
    from aero_tpu import field as J
    from aero_tpu.prover import fri as JFRI
    from aero_tpu_torch.merkle import commit_columns, commit_rows
    from aero_tpu_torch.prover import fri as TFRI
    evals = np.random.default_rng(m).integers(0, F.P, size=m, dtype=np.uint64)
    t = from_u64(evals, "cpu")
    rows = TFRI.transposed_rows(t, ff)
    assert rows.shape == (m // ff, ff)
    assert np.array_equal(to_u64(rows),
                          J.from_gf(JFRI.transposed_rows(J.to_gf(evals), ff)))
    assert commit_rows(rows).root == commit_columns(t.reshape(ff, -1)).root
    layer = TFRI.FriLayer(t, commit_rows(rows), ff)
    assert torch.equal(layer.rows_at([0, 3, m // ff - 1]),
                       rows[[0, 3, m // ff - 1]])
