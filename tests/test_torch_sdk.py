"""The port's SDK wire layer and submission server against `aero_tpu.sdk`.

One 64-row proof is made by the port on the CPU. Its bytes, parsed by each
package's `spec.proof`, give the same `proof_to_pb` and
`public_inputs_to_pb` bytes from both packages (tolerance 0), the protobuf
round trip verifies, and the HTTP submission server of the port answers the
four cases of `tests/test_sdk_server.py`. `sdk.prove` with no `device` must
raise where there is no card.
"""

import urllib.error
import urllib.request

import pytest
import torch

from aero_tpu import sdk as jax_sdk
from aero_tpu.sdk.pb import aero_pb2 as jax_pb
from aero_tpu.spec import proof as JPR
from aero_tpu_torch import sdk as port_sdk
from aero_tpu_torch.sdk import server as port_server
from aero_tpu_torch.sdk.pb import aero_pb2 as pb
from aero_tpu_torch.spec import proof as TPR
from aero_tpu_torch.spec.verifier import VerificationError, verify
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


FAST = TPR.ProofOptions(num_queries=7, blowup_factor=8, grinding_factor=2)
ADVICE_PROGRAM = """
    begin
        repeat.8 swap dup.1 add end
        adv.push add
    end
    """


@pytest.fixture(scope="module")
def result():
    program = pb.MidenProgram(program=ADVICE_PROGRAM)
    inputs = pb.MidenProgramInputs(stack_init=[0, 1], advice_tape=[100])
    return port_sdk.prove(program, inputs, port_sdk.options_to_pb(FAST),
                          device="cpu")


def test_advice_tape_reaches_the_outputs(result):
    # fib(8) = 34 on top, +100 from the advice tape
    top = int.from_bytes(result.outputs.stack[0].element, "little")
    assert top == 34 + 100


def test_options_converters_equal():
    assert port_sdk.DEFAULT_OPTIONS.to_bytes() == \
        jax_sdk.DEFAULT_OPTIONS.to_bytes()
    t = port_sdk.options_to_pb(FAST)
    j = jax_sdk.options_to_pb(JPR.ProofOptions(
        num_queries=7, blowup_factor=8, grinding_factor=2))
    assert t.SerializeToString() == j.SerializeToString()
    assert port_sdk.options_from_pb(t) == FAST
    assert port_sdk.options_from_pb(t).to_bytes() == \
        jax_sdk.options_from_pb(j).to_bytes()


def test_proof_to_pb_bytes_equal(result):
    data = result.native_proof.to_bytes()
    t = port_sdk.proof_to_pb(TPR.StarkProof.from_bytes(data))
    j = jax_sdk.proof_to_pb(JPR.StarkProof.from_bytes(data))
    assert t.SerializeToString() == j.SerializeToString()
    assert t.SerializeToString() == result.proof.SerializeToString()


def test_public_inputs_to_pb_bytes_equal(result):
    data = result.native_pub.to_bytes()
    t = port_sdk.public_inputs_to_pb(TPR.PublicInputs.from_bytes(data))
    j = jax_sdk.public_inputs_to_pb(JPR.PublicInputs.from_bytes(data))
    assert t.SerializeToString() == j.SerializeToString()
    assert t.SerializeToString() == result.public_inputs.SerializeToString()


def test_pb_round_trip_verifies(result):
    back = port_sdk._proof_from_pb(port_sdk.proof_to_pb(result.native_proof))
    pub = port_sdk._public_inputs_from_pb(result.public_inputs)
    assert back.to_bytes() == result.native_proof.to_bytes()
    assert pub == result.native_pub
    verify(back, pub)
    # the reference's converters read the port's messages to the same proof
    assert jax_sdk._proof_from_pb(result.proof).to_bytes() == back.to_bytes()


def test_the_two_generated_modules_share_their_messages(result):
    req = jax_pb.ProofSubmissionRequest()
    req.ParseFromString(pb.ProofSubmissionRequest(
        proof=result.proof, public_inputs=result.public_inputs
    ).SerializeToString())
    assert req.proof.pow_nonce == result.native_proof.pow_nonce


def test_in_process_service(result):
    service = port_sdk.ProofSubmissionService()
    req = pb.ProofSubmissionRequest(proof=result.proof,
                                    public_inputs=result.public_inputs)
    assert len(service.submit_proof(req).receipt) == 64
    req.proof.pow_nonce += 1
    with pytest.raises(VerificationError):
        service.submit_proof(req)


def test_prove_sequential_is_prove(result):
    program = pb.MidenProgram(program=ADVICE_PROGRAM)
    inputs = pb.MidenProgramInputs(stack_init=[0, 1], advice_tape=[100])
    again = port_sdk.prove_sequential(
        program, inputs, port_sdk.options_to_pb(FAST), device="cpu")
    assert again.native_proof.to_bytes() == result.native_proof.to_bytes()


def test_prove_without_a_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    program = pb.MidenProgram(program=ADVICE_PROGRAM)
    inputs = pb.MidenProgramInputs(stack_init=[0, 1], advice_tape=[100])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_sdk.prove(program, inputs, port_sdk.options_to_pb(FAST))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_sdk.prove_sequential(program, inputs)


class TestSubmissionServer:
    @pytest.fixture(scope="class")
    def server(self):
        s = port_server.SubmissionServer().start()
        yield s
        s.stop()

    def test_submit_ok(self, server, result):
        req = pb.ProofSubmissionRequest(
            proof=result.proof, public_inputs=result.public_inputs,
            source_proof_system=pb.MIDEN, target_chain=pb.STARKNET)
        url = f"http://127.0.0.1:{server.port}"
        receipt = port_server.submit_proof_remote(url, req)
        assert len(receipt) == 64
        # deterministic receipt for the same submission
        assert port_server.submit_proof_remote(url, req) == receipt
        # the reference's in-process service gives the same receipt
        assert jax_sdk.ProofSubmissionService().submit_proof(
            req).receipt == receipt

    def test_submit_tampered_rejected(self, server, result):
        req = pb.ProofSubmissionRequest(
            proof=result.proof, public_inputs=result.public_inputs)
        req.proof.pow_nonce += 1
        with pytest.raises(port_server.SubmissionError):
            port_server.submit_proof_remote(
                f"http://127.0.0.1:{server.port}", req)

    def test_garbage_rejected(self, server):
        r = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/submit_proof",
            data=b"not a protobuf of the right shape" * 5)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(r, timeout=30)
        assert e.value.code == 400

    def test_unknown_path_is_404(self, server):
        r = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/elsewhere", data=b"x")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(r, timeout=30)
        assert e.value.code == 404
