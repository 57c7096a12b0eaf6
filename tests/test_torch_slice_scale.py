"""The port's Miden proof above 1024 rows, held byte for byte against aero_tpu.

The program is the scale cell's, `long_fib_source(((1 << k) - 64) // 12)`
(`bench.py`; the port's copy is `bench_gpu.long_fib_source`), stack
[0, 1] top first, `DEFAULT_OPTIONS` (27 queries, blowup 8, grinding 16,
folding 8, remainder 256): a trace of real execution, not padding.
`tests/golden/torch_port/miden_longfib_2e<k>.bin` is `aero_tpu.prover.prove`'s
proof of it, and the `.json` beside it its sha256, length, the seconds
`aero_tpu` took on the CPU, the box's `nproc` and the commit it ran on.

- 2^14 rows: an LDE domain of 2^17 points, Merkle trees four levels deeper
  than at 1024 rows, one more FRI layer, query positions drawn over a
  larger domain. The port's CPU proof equals aero_tpu's and verifies under
  both verifiers. (At 2^18 rows, where constraint evaluation and DEEP
  first run in two fragments of 2^20 points, no reference is committed:
  aero_tpu's CPU proof there handles 16 times the points of the 2^14 one,
  whose `aero_tpu_seconds` are hours already; ROADMAP.md queue 1 item 3.)
- The fragment path itself (the last fragment's next-row frame wrapping
  round the domain) at the 1024-row golden proof, with the port's fragment
  shrunk: aero_tpu's committed digest, made in one fragment.
- `tools.proof_diff` names the first part (trace root, aux root, constraint
  root, OOD frame, each FRI root, remainder, nonce, openings) at which two
  proofs differ: the tool that finds the stage at fault.
- `slow`: each committed proof re-derived live from `aero_tpu.prover.prove`
  (`-k regenerates`; the `.json`'s `aero_tpu_seconds` say how long).
  `PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_slice_scale.py 14`
  writes the committed files anew.

Kept in a file of its own: the port's 2^14-row proof is one of the longest
computations of the CPU lane, and --dist loadfile gives it a worker.
"""

import hashlib
import json
import os
from dataclasses import replace

import pytest

import bench
import bench_gpu
from aero_tpu import vm as jax_vm
from aero_tpu.air.miden import MidenAir as JaxMidenAir
from aero_tpu.sdk import DEFAULT_OPTIONS as JAX_OPTIONS
from aero_tpu.spec.proof import PublicInputs as JaxPublicInputs
from aero_tpu.spec.proof import StarkProof as JaxStarkProof
from aero_tpu.spec.verifier import verify as jax_verify
from aero_tpu_torch.air.miden import MidenAir, make_public_inputs
from aero_tpu_torch.field import from_u64
from aero_tpu_torch.prover import prove
from aero_tpu_torch.sdk import DEFAULT_OPTIONS
from aero_tpu_torch.spec.proof import StarkProof
from aero_tpu_torch.spec.verifier import verify
from aero_tpu_torch.tools import proof_diff
from aero_tpu_torch.vm import execute_full, program_hash
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch_port")
SIZES = (14,)             # log2 of the rows of each committed proof


def _path(log_rows, ext):
    return os.path.join(GOLDEN, f"miden_longfib_2e{log_rows}.{ext}")


def _digest(log_rows):
    with open(_path(log_rows, "json")) as f:
        return json.load(f)


def _reference(log_rows) -> bytes:
    with open(_path(log_rows, "bin"), "rb") as f:
        return f.read()


def _n_iters(log_rows):
    return ((1 << log_rows) - 64) // 12


def _port_proof(log_rows):
    src = bench_gpu.long_fib_source(_n_iters(log_rows))
    trace, out, ovf = execute_full(src, [0, 1], min_rows=1 << log_rows)
    pub = make_public_inputs(program_hash(src), [0, 1], out, overflow=ovf)
    air = MidenAir(trace.shape[1], pub, DEFAULT_OPTIONS, program=src)
    return prove(air, from_u64(trace, "cpu"), pub).to_bytes(), pub, src


def _assert_equals_aero_tpu(data, log_rows):
    want = _digest(log_rows)
    where = proof_diff.first_difference(data, _reference(log_rows))
    assert where is None, f"first part that differs from aero_tpu's: {where}"
    assert (hashlib.sha256(data).hexdigest(), len(data)) == \
        (want["sha256"], want["length"])


@pytest.fixture(scope="module")
def proof_2e14():
    return _port_proof(14)


@pytest.mark.parametrize("log_rows", SIZES)
def test_committed_reference_is_the_digest_it_names(log_rows):
    want = _digest(log_rows)
    data = _reference(log_rows)
    assert (hashlib.sha256(data).hexdigest(), len(data)) == \
        (want["sha256"], want["length"])
    proof = StarkProof.from_bytes(data)
    assert proof.context.trace_length == want["min_rows"] == 1 << log_rows
    assert proof.options == DEFAULT_OPTIONS
    assert want["program"] == f"bench.long_fib_source({_n_iters(log_rows)})"
    assert want["stack_inputs_topfirst"] == [0, 1]
    assert bench.long_fib_source(_n_iters(log_rows)) == \
        bench_gpu.long_fib_source(_n_iters(log_rows))


def test_port_proof_at_2e14_rows_equals_aero_tpus(proof_2e14):
    data, _, _ = proof_2e14
    _assert_equals_aero_tpu(data, 14)


def test_port_proof_at_2e14_rows_verifies_under_both_verifiers(proof_2e14):
    data, pub, src = proof_2e14
    verify(StarkProof.from_bytes(data), pub,
           air=MidenAir(1 << 14, pub, DEFAULT_OPTIONS, program=src))
    jpub = JaxPublicInputs.from_bytes(pub.to_bytes())
    jax_verify(JaxStarkProof.from_bytes(data), jpub,
               air=JaxMidenAir(1 << 14, jpub, JAX_OPTIONS, program=src))


@pytest.mark.parametrize("log_frag", [10, 12])
def test_fragments_wrapping_round_the_domain_keep_aero_tpus_bytes(
        monkeypatch, log_frag):
    """The path a proof takes from 2^18 rows on (constraint evaluation and
    DEEP in fragments of `prover.FRAG` points, the last fragment's next-row
    frame wrapping round the domain), brought down to the 1024-row golden
    proof (2^13 points) by shrinking the port's fragment: 8 and 2
    fragments give aero_tpu's committed digest, which it made in one
    fragment (its size is a literal 2^20 there)."""
    from aero_tpu_torch.prover import prover as prover_mod
    from aero_tpu_torch.vm import fibonacci_source
    monkeypatch.setattr(prover_mod, "FRAG", 1 << log_frag)
    src = fibonacci_source(10)
    trace, out, ovf = execute_full(src, [0, 1], min_rows=1024)
    pub = make_public_inputs(program_hash(src), [0, 1], out, overflow=ovf)
    air = MidenAir(trace.shape[1], pub, DEFAULT_OPTIONS, program=src)
    data = prove(air, from_u64(trace, "cpu"), pub).to_bytes()
    with open(os.path.join(GOLDEN, "miden_fib10_1024.json")) as f:
        want = json.load(f)
    assert (hashlib.sha256(data).hexdigest(), len(data)) == \
        (want["sha256"], want["length"])


# the parts of a proof, one changed at a time, and the name proof_diff must
# give: each comes from another stage of the prover
def _flip(b: bytes, i: int = 0) -> bytes:
    return b[:i] + bytes([b[i] ^ 1]) + b[i + 1:]


CHANGES = {
    "trace_root": lambda p: replace(
        p, commitments=[_flip(p.commitments[0])] + p.commitments[1:]),
    "aux_root[0]": lambda p: replace(
        p, commitments=[p.commitments[0], _flip(p.commitments[1])]
        + p.commitments[2:]),
    "constraint_root": lambda p: replace(
        p, commitments=p.commitments[:2] + [_flip(p.commitments[2])]
        + p.commitments[3:]),
    "ood_evaluations": lambda p: replace(p, ood_frame=replace(
        p.ood_frame, evaluations=_flip(p.ood_frame.evaluations, 9))),
    "fri_root[1]": lambda p: replace(
        p, commitments=p.commitments[:4] + [_flip(p.commitments[4])]
        + p.commitments[5:]),
    "fri_remainder": lambda p: replace(p, fri_proof=replace(
        p.fri_proof, remainder=_flip(p.fri_proof.remainder, 17))),
    "pow_nonce": lambda p: replace(p, pow_nonce=p.pow_nonce + 1),
    "trace_openings[1]": lambda p: replace(
        p, trace_queries=[p.trace_queries[0], replace(
            p.trace_queries[1], values=_flip(p.trace_queries[1].values))]),
    "fri_layer_openings[2]": lambda p: replace(p, fri_proof=replace(
        p.fri_proof, layers=p.fri_proof.layers[:2] + [replace(
            p.fri_proof.layers[2],
            paths=_flip(p.fri_proof.layers[2].paths, 5))]
        + p.fri_proof.layers[3:])),
}


@pytest.mark.parametrize("part", sorted(CHANGES))
def test_proof_diff_names_the_first_part_that_differs(part):
    ref = _reference(14)
    changed = CHANGES[part](StarkProof.from_bytes(ref)).to_bytes()
    assert changed != ref
    assert proof_diff.first_difference(ref, changed) == part
    assert proof_diff.first_difference(changed, ref) == part
    assert proof_diff.first_difference(ref, ref) is None


def test_proof_diff_cli(tmp_path, capsys):
    a = tmp_path / "a.bin"
    b = tmp_path / "b.bin"
    a.write_bytes(_reference(14))
    b.write_bytes(CHANGES["pow_nonce"](StarkProof.from_bytes(
        _reference(14))).to_bytes())
    assert proof_diff.main([str(a), str(a)]) == 0
    assert capsys.readouterr().out.strip() == "equal"
    assert proof_diff.main([str(a), str(b)]) == 1
    assert capsys.readouterr().out.strip() == "first difference: pow_nonce"
    # a proof file with its public inputs (spec.proof.dump_proof_file)
    with_pub = os.path.join(GOLDEN, "miden_2e20_rows.bin")
    assert proof_diff.main([with_pub, with_pub]) == 0
    assert proof_diff.main([with_pub, str(a)]) == 1
    assert capsys.readouterr().out.strip().splitlines() == [
        "equal", "first difference: context"]


def _aero_tpu_proof(log_rows) -> bytes:
    """`aero_tpu.prover.prove`'s proof of the scale program at 2^log_rows
    rows, on the CPU."""
    from aero_tpu.air.miden import make_public_inputs as jax_pub
    from aero_tpu.field import to_gf
    from aero_tpu.prover import prove as jax_prove
    src = bench.long_fib_source(_n_iters(log_rows))
    trace, out, ovf = jax_vm.execute_full(src, [0, 1],
                                          min_rows=1 << log_rows)
    pub = jax_pub(jax_vm.program_hash(src), [0, 1], out, overflow=ovf)
    air = JaxMidenAir(trace.shape[1], pub, JAX_OPTIONS, program=src)
    return jax_prove(air, to_gf(trace), pub).to_bytes()


@pytest.mark.slow
@pytest.mark.parametrize("log_rows", SIZES)
def test_reference_proof_regenerates_from_aero_tpu(log_rows):
    """Re-derive the committed proof from aero_tpu.prover.prove (the
    `.json`'s `aero_tpu_seconds` say how long it takes on the CPU)."""
    _assert_equals_aero_tpu(_aero_tpu_proof(log_rows), log_rows)


def main(argv) -> None:
    """Write `miden_longfib_2e<k>.bin` and `.json` for each k given, from
    aero_tpu on the CPU (AERO_TPU_TRACE=1 prints its stages as they end):

        PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_slice_scale.py 14
    """
    import jax
    import resource
    import subprocess
    import time
    jax.config.update("jax_platforms", "cpu")
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=GOLDEN,
                            capture_output=True, text=True).stdout.strip()
    for log_rows in map(int, argv):
        t0 = time.perf_counter()
        data = _aero_tpu_proof(log_rows)
        seconds = time.perf_counter() - t0
        with open(_path(log_rows, "bin"), "wb") as f:
            f.write(data)
        digest = {
            "what": "sha256 and length of StarkProof.to_bytes() from "
                    "aero_tpu.prover.prove on the CPU (JAX_PLATFORMS=cpu); "
                    f"the proof itself is miden_longfib_2e{log_rows}.bin",
            "program": f"bench.long_fib_source({_n_iters(log_rows)})",
            "stack_inputs_topfirst": [0, 1],
            "min_rows": 1 << log_rows,
            "options": "aero_tpu.sdk.DEFAULT_OPTIONS",
            "sha256": hashlib.sha256(data).hexdigest(),
            "length": len(data),
            "aero_tpu_seconds": round(seconds, 1),
            "nproc": os.cpu_count(),
            "commit": commit}
        with open(_path(log_rows, "json"), "w") as f:
            json.dump(digest, f, indent=2)
            f.write("\n")
        print(json.dumps(dict(digest, maxrss_gib=resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20)), flush=True)


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
