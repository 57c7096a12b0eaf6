"""The port's Cairo-memory writers, Cairo-verifier simulation and parser
tool against `aero_tpu`'s.

On the golden proof `tests/golden/fib.bin` every writer of
`aero_tpu_torch.io.cairo_memory` emits the JSON that `aero_tpu.io.
cairo_memory` emits, `python -m aero_tpu_torch.tools.stark_parser` prints
what `tools/stark_parser.py` prints, and the port's `cairo_sim` walks the
same transcript. A proof made by the port passes the simulation. Tolerance
everywhere: 0 (integers and bytes).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from aero_tpu.io import cairo_memory as JIO
from aero_tpu.spec import cairo_sim as JSIM
from aero_tpu.spec.proof import load_proof_file as jax_load
from aero_tpu_torch.io import cairo_memory as TIO
from aero_tpu_torch.spec import cairo_sim as TSIM
from aero_tpu_torch.spec.proof import ProofOptions, load_proof_file
from aero_tpu_torch.spec.verifier import VerificationError, verify
from aero_tpu_torch.tools import generate_proof, stark_parser
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")
GOLDEN = os.path.join(GOLDEN_DIR, "fib.bin")
POSITIONS = [5207, 6722, 8132, 4654, 492]


@pytest.mark.parametrize("writer,golden_json", [
    ("write_proof", "fib_proof_memory.json"),
    ("write_public_inputs", "fib_public_inputs_memory.json")])
def test_proof_and_public_input_writers_equal(writer, golden_json):
    tpub, tproof = load_proof_file(GOLDEN)
    jpub, jproof = jax_load(GOLDEN)
    targ, jarg = ((tproof, jproof) if writer == "write_proof"
                  else (tpub, jpub))
    got = TIO.to_json(getattr(TIO, writer), targ)
    assert got == JIO.to_json(getattr(JIO, writer), jarg)
    with open(os.path.join(GOLDEN_DIR, golden_json)) as f:
        assert got.strip() == f.read().strip()


@pytest.mark.parametrize("writer", ["write_trace_query_paths",
                                    "write_constraint_query_paths",
                                    "write_fri_query_paths"])
def test_query_path_writers_equal(writer):
    tpub, tproof = load_proof_file(GOLDEN)
    _, jproof = jax_load(GOLDEN)
    positions = verify(tproof, tpub).query_positions   # all 27 openings
    assert positions[:5] == POSITIONS
    assert TIO.to_json(getattr(TIO, writer), tproof, positions) == \
        JIO.to_json(getattr(JIO, writer), jproof, positions)


def test_dynamic_memory_assembles_equal():
    def fill(mod):
        m = mod.DynamicMemory()
        m.write_value(3)
        sub = m.write_pointer_to_new_segment()
        sub.write_felt(2**64 - 2**32)
        sub.write_hex("ff")
        m.write_sized_array([1, 2, 3], lambda mm, v: mm.write_value(v))
        return m.assemble()
    assert fill(TIO) == fill(JIO)


def test_simulation_walks_the_golden_transcript_like_aero_tpu():
    got = TSIM.simulate_on_proof(*reversed(load_proof_file(GOLDEN)))
    want = JSIM.simulate_on_proof(*reversed(jax_load(GOLDEN)))
    assert got == want
    assert got[:5] == POSITIONS and len(got) == 27


def test_simulation_rejects_a_tampered_query_value():
    pub, proof = load_proof_file(GOLDEN)
    v = bytearray(proof.trace_queries[0].values)
    v[0] ^= 1
    proof.trace_queries[0].values = bytes(v)
    with pytest.raises(VerificationError):
        TSIM.simulate_on_proof(proof, pub)


@pytest.fixture(scope="module")
def port_proof_file(tmp_path_factory):
    out = tmp_path_factory.mktemp("proofs") / "fib64.bin"
    data = generate_proof.generate(n=10, out=str(out), min_rows=64, grind=1,
                                   queries=7, device="cpu")
    return str(out), data


def test_simulation_accepts_a_port_proof(port_proof_file):
    """The port's own Miden proof through the wire format and the live
    sequence, with the draw counts of its AIR (as the `slow`
    `tests/test_cairo_sim.py::TestOwnProofAcceptance` does for aero_tpu)."""
    from aero_tpu_torch.air.miden import MidenAir
    from aero_tpu_torch.vm import fibonacci_source
    path, data = port_proof_file
    with open(path, "rb") as f:
        assert f.read() == data
    pub, proof = load_proof_file(path)
    air = MidenAir(proof.context.trace_length, pub,
                   ProofOptions(num_queries=7, blowup_factor=8,
                                grinding_factor=1),
                   program=fibonacci_source(10))
    positions = TSIM.simulate_on_proof(
        proof, pub, num_transition=air.num_transition_constraints,
        num_assertions=air.num_assertions)
    assert len(positions) == 7
    assert positions == JSIM.simulate_on_proof(
        *reversed(jax_load(path)),
        num_transition=air.num_transition_constraints,
        num_assertions=air.num_assertions)


def test_generate_proof_cli_needs_a_card_without_cpu_flag(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_proof.main(["--min-rows", "64", "--grind", "1",
                             "--queries", "7",
                             "--out", str(tmp_path / "p.bin")])
    assert not (tmp_path / "p.bin").exists()


def _old_parser(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "stark_parser.py"),
         *args], capture_output=True, text=True, check=True, env=env,
        timeout=120).stdout


@pytest.mark.parametrize("cmd", ["proof", "public-inputs"])
def test_parser_prints_what_the_old_tool_prints(cmd, capsys,
                                                port_proof_file):
    for path in (GOLDEN, port_proof_file[0]):
        capsys.readouterr()
        assert stark_parser.main([path, cmd]) == 0
        assert capsys.readouterr().out == _old_parser(path, cmd)


def test_parser_query_and_interpolate_commands(capsys):
    pub, proof = load_proof_file(GOLDEN)
    idx = json.dumps(verify(proof, pub).query_positions)
    for cmd in ("trace-queries", "constraint-queries", "fri-queries"):
        capsys.readouterr()
        assert stark_parser.main([GOLDEN, cmd, idx]) == 0
        assert capsys.readouterr().out == _old_parser(GOLDEN, cmd, idx)
    xs = '["0100000000000000", "0200000000000000"]'
    ys = '["0300000000000000", "0500000000000000"]'
    assert stark_parser.main([GOLDEN, "interpolate-poly", xs, ys]) == 0
    assert capsys.readouterr().out == _old_parser(
        GOLDEN, "interpolate-poly", xs, ys)
    assert stark_parser.main([GOLDEN, "no-such-command"]) == 1


def test_parser_runs_as_a_module(port_proof_file):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "aero_tpu_torch.tools.stark_parser",
         port_proof_file[0], "public-inputs"], cwd=ROOT, env=env,
        capture_output=True, text=True, check=True, timeout=120).stdout
    pub, _ = load_proof_file(port_proof_file[0])
    assert out.strip() == TIO.to_json(TIO.write_public_inputs, pub).strip()
