"""The port's Miden proof path as a whole, held against aero_tpu.

- A live 64-row Miden proof of fib(10) through aero_tpu and through the
  port: the proof bytes, and the SDK's protobuf bytes, are equal; the port's
  proof verifies under the spec verifier with the port's air.
- The golden-parameter proof (1024 rows, default options) from the port on
  the CPU matches the digest of aero_tpu's proof committed under
  tests/golden/torch_port/ (a `slow` test re-derives that digest live from
  aero_tpu.prover.prove).

Kept in a file of its own: the live aero_tpu Miden proof is the longest
single computation of the CPU lane, and --dist loadfile gives it a worker.
"""

import hashlib
import json
import os
from dataclasses import asdict

import pytest
import torch

from aero_tpu import sdk as jax_sdk
from aero_tpu.sdk import DEFAULT_OPTIONS
from aero_tpu.sdk.pb import aero_pb2 as pb
from aero_tpu.spec.proof import StarkProof
from aero_tpu.spec.verifier import verify
from aero_tpu.vm import execute_full, fibonacci_source, program_hash
from aero_tpu_torch import sdk as port_sdk
from aero_tpu_torch.air.miden import MidenAir, make_public_inputs
from aero_tpu_torch.field import from_u64
from aero_tpu_torch.prover import prove
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


SRC = fibonacci_source(10)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch_port",
                      "miden_fib10_1024.json")


def _request():
    return (pb.MidenProgram(program=SRC),
            pb.MidenProgramInputs(stack_init=[1, 0]))    # top-first [0, 1]


@pytest.fixture(scope="module")
def jax_result():
    program, inputs = _request()
    return jax_sdk.prove(program, inputs, min_rows=64)


def _port_proof(min_rows):
    trace, out, ovf = execute_full(SRC, [0, 1], min_rows=min_rows)
    pub = make_public_inputs(program_hash(SRC), [0, 1], out, overflow=ovf)
    air = MidenAir(trace.shape[1], pub, DEFAULT_OPTIONS, program=SRC)
    return prove(air, from_u64(trace, "cpu"), pub), pub


def test_miden_proof_bytes_equal_aero_tpu(jax_result):
    proof, pub = _port_proof(64)
    # each package has its own PublicInputs class: equal field by field
    assert asdict(pub) == asdict(jax_result.native_pub)
    assert pub.to_bytes() == jax_result.native_pub.to_bytes()
    assert proof.to_bytes() == jax_result.native_proof.to_bytes()
    air = MidenAir(64, pub, DEFAULT_OPTIONS, program=SRC)
    verify(StarkProof.from_bytes(proof.to_bytes()), pub, air=air)


def test_sdk_prove_returns_the_same_protobuf(jax_result):
    program, inputs = _request()
    res = port_sdk.prove(program, inputs, min_rows=64, device="cpu")
    assert res.proof.SerializeToString() == \
        jax_result.proof.SerializeToString()
    assert res.public_inputs.SerializeToString() == \
        jax_result.public_inputs.SerializeToString()
    assert res.outputs.SerializeToString() == \
        jax_result.outputs.SerializeToString()


def _golden():
    with open(GOLDEN) as f:
        return json.load(f)


def test_golden_parameter_proof_matches_aero_tpu_digest():
    proof, pub = _port_proof(1024)
    data = proof.to_bytes()
    want = _golden()
    assert proof.context.trace_length == want["min_rows"] == 1024
    assert (hashlib.sha256(data).hexdigest(), len(data)) == \
        (want["sha256"], want["length"])
    verify(proof, pub, air=MidenAir(1024, pub, DEFAULT_OPTIONS, program=SRC))


@pytest.mark.slow
def test_golden_digest_regenerates_from_aero_tpu():
    """Re-derive the committed digest from aero_tpu (minutes on CPU)."""
    from aero_tpu.air.miden import MidenAir as JaxMidenAir
    from aero_tpu.air.miden import make_public_inputs as jax_pub
    from aero_tpu.field import to_gf
    from aero_tpu.prover import prove as jax_prove
    trace, out, ovf = execute_full(SRC, [0, 1], min_rows=1024)
    pub = jax_pub(program_hash(SRC), [0, 1], out, overflow=ovf)
    air = JaxMidenAir(trace.shape[1], pub, DEFAULT_OPTIONS, program=SRC)
    data = jax_prove(air, to_gf(trace), pub).to_bytes()
    want = _golden()
    assert (hashlib.sha256(data).hexdigest(), len(data)) == \
        (want["sha256"], want["length"])
