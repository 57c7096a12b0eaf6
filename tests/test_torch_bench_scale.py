"""bench_gpu.py's scale proof held against `bench.py`'s: the same program,
inputs and options through `aero_tpu` (a live proof, jitted on XLA:CPU) and
through `bench_gpu.bench_proof_scale` on `device="cpu"`, at 64 rows with 2
bits of grinding: the proof bytes are equal, and each package's verifier
accepts the port's proof.

Split from `test_torch_bench.py`: compiling `aero_tpu`'s prover takes this
file several minutes on a cold compilation cache, and the tier-1 lane runs
a file on one worker.
"""

import pytest

import bench
import bench_gpu
from aero_tpu import field as J
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


@pytest.fixture(scope="module")
def jax_scale_proof():
    """`bench.bench_proof_scale`'s program, inputs and options through
    `aero_tpu` at 64 rows with 2 bits of grinding: the proof it times."""
    from aero_tpu.air.miden import MidenAir, make_public_inputs
    from aero_tpu.prover.prover import prove
    from aero_tpu.spec.proof import ProofOptions
    from aero_tpu.vm import execute_full, program_hash
    src = bench.long_fib_source(((1 << 6) - 64) // 12)
    trace, out_stack, overflow = execute_full(
        src, [0, 1], min_rows=1 << 6, max_rows=1 << 23)
    assert trace.shape[1] == 1 << 6
    pub = make_public_inputs(program_hash(src), [0, 1], out_stack,
                             overflow=overflow)
    opts = ProofOptions(num_queries=27, blowup_factor=8, grinding_factor=2)
    air = MidenAir(trace.shape[1], pub, opts, program=src)
    return prove(air, J.to_gf(trace), pub), pub, air


def test_bench_proof_scale_bytes_equal_aero_tpu(jax_scale_proof):
    from aero_tpu.spec.verifier import verify
    want, pub, air = jax_scale_proof
    r = bench_gpu.bench_proof_scale(log_rows=6, grind=2, device="cpu")
    steady_dt, cold_dt, size = r[:3]           # bench.py's three values
    assert size == len(want.to_bytes()) and steady_dt > 0 and cold_dt > 0
    assert r.cold.proof.to_bytes() == want.to_bytes()
    assert r.steady.proof.to_bytes() == want.to_bytes()
    assert r.prep.pub.to_bytes() == pub.to_bytes()
    assert set(r.steady.spans) == set(bench_gpu_stages())
    bench_gpu.verify_proof(r.prep, r.steady.proof)
    # the reference's verifier accepts the port's proof
    verify(type(want).from_bytes(r.steady.proof.to_bytes()), pub, air=air)


def bench_gpu_stages():
    from aero_tpu_torch.prover import STAGES
    return STAGES
