"""bench_gpu.py (the port's benchmark) held against bench.py's pipelines.

At small sizes the inputs that `bench.py` draws (the same numpy seeds) go
through `bench.py`'s pipeline on `aero_tpu` (op by op: XLA:CPU takes about a
minute to compile each jitted transform size) and through `bench_gpu`'s on
`device="cpu"`: outputs, digests, roots and proof bytes are equal bit for
bit (tolerance: none), and the butterfly counts equal `bench.py`'s formulas.
`main()` prints one record for every planned metric, exits non-zero when a
step raises and 0 with skip records when the budget is spent; without
`device=` the functions raise where there is no card. The scale proof
against a live `aero_tpu` proof is `test_torch_bench_scale.py`: its XLA:CPU
compile alone outlasts the rest of this file.
"""

import hashlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import bench
import bench_gpu
from aero_tpu import field as J
from aero_tpu import ntt as JN
from aero_tpu.field import GF
from aero_tpu.hash.blake2s_pallas import hash_columns_t, merkle_levels_t
from aero_tpu.spec import field as F
from aero_tpu_torch import field as T
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = F.P
TINY = {"ntt": dict(log_n=6, cols=4), "merkle": dict(log_leaves=8,
                                                     row_width=8),
        "scale": dict(log_rows=6, grind=2), "proof": dict(min_rows=64,
                                                          grind=2),
        "lde24": dict(log_n=6), "hash": dict(log_leaves=8, row_width=8),
        "mul": dict(log_n=8)}


def _draw(seed, shape):
    """What `bench.py` draws for this seed and shape."""
    return np.random.default_rng(seed).integers(
        0, (1 << 64) - (1 << 32) + 1, size=shape, dtype=np.uint64)


def _records(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            assert set(rec) >= {"metric", "value", "unit", "vs_baseline"}
            assert rec["metric"] not in out, "one record a metric"
            out[rec["metric"]] = rec
    return out


# ------------------------------------------------------------ kernel-level

@pytest.mark.parametrize("log_n,cols", [(6, 4), (7, 8), (8, 4)])
def test_bench_ntt_equals_the_jax_pipeline(monkeypatch, log_n, cols):
    n = 1 << log_n
    x = _draw(0, (cols, n))
    with jax.disable_jit():
        y = JN.lde(JN.intt(J.to_gf(x)), 3)
        want = J.from_gf(GF(y.lo[..., :n], y.hi[..., :n]))
    got = bench_gpu.bench_ntt(log_n=log_n, cols=cols, log_blowup=3,
                              device="cpu")
    assert np.array_equal(T.to_u64(got.out.contiguous()), want)
    # the count is bench.py's formula: with a second a pipeline its rate
    monkeypatch.setattr(bench, "_bench_loop", lambda fn, x, K=8, iters=3: 1.0)
    assert bench.bench_ntt(log_n, cols, 3) == (got.butterflies, 1.0)
    assert got.rate == got.butterflies / got.dt and got.dt > 0


@pytest.mark.parametrize("log_leaves,row_width", [(8, 8), (8, 72), (5, 9)])
def test_bench_hash_and_merkle_equal_the_jax_commit(log_leaves, row_width):
    n = 1 << log_leaves
    cols = J.to_gf(_draw(1, (row_width, n)))
    leaves = hash_columns_t(cols)
    want_root = np.asarray(merkle_levels_t(leaves)[-1])
    h = bench_gpu.bench_hash(log_leaves, row_width, device="cpu")
    assert np.array_equal(h.digests.numpy().astype(np.uint32),
                          np.asarray(leaves))
    m = bench_gpu.bench_merkle(log_leaves, row_width, device="cpu")
    assert m.root == want_root.astype("<u4").tobytes()
    assert h.rate == n / h.dt and m.rate == n / m.dt


@pytest.mark.parametrize("log_n", [6, 8])
def test_bench_mul_equals_jax_mul(log_n):
    a = _draw(2, 1 << log_n)
    g = J.to_gf(a)
    got = bench_gpu.bench_mul(log_n, device="cpu")
    assert np.array_equal(T.to_u64(got.out), J.from_gf(J.mul(g, g)))
    assert [int(v) for v in T.to_u64(got.out)[:8]] == \
        [F.mul(int(v), int(v)) for v in a[:8]]
    assert got.rate == (1 << log_n) / got.dt


@pytest.mark.parametrize("log_n,log_blowup", [(6, 3), (7, 3), (6, 2)])
def test_bench_lde_2e24_equals_the_jax_formulation(monkeypatch, log_n,
                                                   log_blowup):
    """`bench.py:279-316` at a small size: the cosets as the leading axis of
    one size-n NTT of the scaled polynomial; scales from the host oracle
    there, made on the device here."""
    n, blowup = 1 << log_n, 1 << log_blowup
    m = n << log_blowup
    polys = J.to_gf(_draw(3, (1, n)))
    w_m = F.get_root_of_unity(m.bit_length() - 1)
    scales = J.to_gf(np.stack(
        [np.array(F.get_power_series(
            F.mul(F.DOMAIN_OFFSET, F.exp(w_m, t)), n), dtype=np.uint64)
         for t in range(blowup)]))
    with jax.disable_jit():
        pb = GF(np.broadcast_to(polys.lo, scales.shape),
                np.broadcast_to(polys.hi, scales.shape))
        want = J.from_gf(JN.ntt(J.mul(pb, scales)))
        whole = J.from_gf(JN.lde(polys, log_blowup))
    got = bench_gpu.bench_lde_2e24(log_n, log_blowup, device="cpu")
    assert np.array_equal(T.to_u64(got.out), want)
    # the two routes: out[t, i] is point blowup * i + t of the whole LDE
    assert np.array_equal(want.T.reshape(1, m), whole)
    monkeypatch.setattr(bench, "_bench", lambda fn, *a, **k: 1.0)
    assert bench.bench_lde_2e24(log_n, log_blowup) == (got.butterflies, 1.0)


def test_bench_lde_2e24_raises_when_the_two_routes_disagree(monkeypatch):
    import aero_tpu_torch.ntt as TN
    real = TN.lde
    monkeypatch.setattr(TN, "lde", lambda c, lb: real(c, lb).roll(1, -1))
    with pytest.raises(RuntimeError, match="disagree"):
        bench_gpu.bench_lde_2e24(5, 3, device="cpu")


# ------------------------------------------------------------------ proofs

def test_long_fib_source_is_bench_py_s():
    for n in (0, 1, 5, 87376):
        assert bench_gpu.long_fib_source(n) == bench.long_fib_source(n)


def test_bench_proof_scale_refuses_a_padded_trace(monkeypatch):
    monkeypatch.setattr(bench_gpu, "long_fib_source",
                        lambda n: bench.long_fib_source(n + 40))
    with pytest.raises(AssertionError, match="trace padded to"):
        bench_gpu.bench_proof_scale(log_rows=6, grind=2, device="cpu")


def test_bench_proof_at_the_golden_parameters_has_the_committed_digest():
    """`bench.bench_proof`'s workload on the CPU: the second proof, as timed,
    has the sha256 and length of `aero_tpu`'s proof (committed digest)."""
    r = bench_gpu.bench_proof(device="cpu")
    dt, size = r[:2]                            # bench.py's two values
    assert (dt, size) == (r.once.dt, 49627) and r.once.rows == 1 << 10
    with open(bench_gpu.GOLDEN) as f:
        want = json.load(f)
    assert bench_gpu.check_golden(r.once) == want["sha256"]
    assert hashlib.sha256(r.once.run.proof.to_bytes()).hexdigest() == \
        want["sha256"]


def test_check_golden_refuses_another_proof():
    r = bench_gpu.bench_proof(min_rows=64, grind=2, device="cpu")
    with pytest.raises(RuntimeError, match="committed"):
        bench_gpu.check_golden(r.once)


# ------------------------------------------------------ the budget runner

ALL = bench_gpu.PLANNED + bench_gpu.EXTRA


def test_planned_metrics_are_bench_py_s(monkeypatch):
    """The same names in the same order as `bench.main` plans and emits."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        text = f.read()
    plan = text[text.index("_PLAN.extend(["):text.index("_watchdog()\n\n")]
    names = [w for w in plan.replace('"', " ").replace(",", " ").split()
             if w.islower() and "_" in w and not w.startswith("_")]
    assert tuple(names) == bench_gpu.PLANNED
    for name in bench_gpu.EXTRA:
        assert f'_emit("{name}"' in text


def test_main_prints_one_record_for_every_planned_metric(capsys):
    assert bench_gpu.main(["--all"], device="cpu", sizes=TINY) == 0
    out = capsys.readouterr().out
    recs = _records(out)
    assert tuple(recs) [:2] == bench_gpu.PLANNED[:2]
    assert set(recs) == set(ALL)
    for rec in recs.values():
        assert rec["value"] is not None and rec["unit"] != "skipped"
    assert recs["fib_2e10_proof_size"]["unit"] == "bytes"
    assert recs["goldilocks_ntt_butterflies_per_s_per_chip"]["unit"] == \
        "butterflies/s"
    # the seconds behind each rate stand on a line of their own
    for word in ("goldilocks_ntt:", "lde_2e24:", "blake2s_leaf_hashes:",
                 "goldilocks_mul:", "merkle_commit:"):
        assert any(l.startswith(word) for l in out.splitlines()), word


def test_main_without_all_plans_the_seven(capsys, monkeypatch):
    for name in ("bench_ntt", "bench_merkle", "bench_proof_scale",
                 "bench_proof", "bench_lde_2e24"):
        monkeypatch.setattr(bench_gpu, name, _boom)
    assert bench_gpu.main([], device="cpu", sizes=TINY) == 1
    assert tuple(_records(capsys.readouterr().out)) == (
        bench_gpu.PLANNED[:2] + bench_gpu.PLANNED[5:7]
        + bench_gpu.PLANNED[3:5] + bench_gpu.PLANNED[2:3])


def _boom(*a, **k):
    raise ValueError("a step that raises")


def test_main_exits_non_zero_when_a_step_raises(capsys, monkeypatch):
    monkeypatch.setattr(bench_gpu, "bench_merkle", _boom)
    monkeypatch.setattr(bench_gpu, "bench_proof_scale", _boom)
    assert bench_gpu.main(["--all"], device="cpu", sizes=TINY) == 1
    cap = capsys.readouterr()
    recs = _records(cap.out)
    assert set(recs) == set(ALL)
    for name in ("merkle_commit_2e20_leaves_s",
                 "miden_2e20_row_proof_wall_clock",
                 "miden_2e20_row_proof_cold_wall_clock"):
        assert recs[name]["value"] is None
        assert recs[name]["skipped"] == "ValueError: a step that raises"
    for name in set(ALL) - {"merkle_commit_2e20_leaves_s",
                            "miden_2e20_row_proof_wall_clock",
                            "miden_2e20_row_proof_cold_wall_clock"}:
        assert recs[name]["value"] is not None
    assert "merkle_commit_2e20_leaves_s failed" in cap.err


def test_main_exits_zero_with_skip_records_when_the_budget_is_spent(
        capsys, monkeypatch):
    monkeypatch.setattr(bench_gpu, "BENCH_BUDGET_S", 0.0)
    assert bench_gpu.main(["--all"], device="cpu", sizes=TINY) == 0
    recs = _records(capsys.readouterr().out)
    assert set(recs) == set(ALL)
    for rec in recs.values():
        assert rec["value"] is None and rec["unit"] == "skipped"
        assert rec["skipped"] == "insufficient budget"


def test_watchdog_ends_the_run_with_zero_and_skip_records():
    code = ("import time, bench_gpu as b\n"
            "b._PLAN.extend(['done', 'late_a', 'late_b'])\n"
            "b._emit('done', 1.5, 's')\n"
            "b._watchdog(0.3)\n"
            "time.sleep(60)\n"
            "print('not reached')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=50)
    assert res.returncode == 0
    recs = _records(res.stdout)
    assert tuple(recs) == ("done", "late_a", "late_b")
    assert recs["done"]["value"] == 1.5
    for name in ("late_a", "late_b"):
        assert recs[name]["skipped"] == "bench budget exhausted (watchdog)"
    assert "not reached" not in res.stdout


def test_budget_is_read_as_bench_py_reads_it():
    code = "import bench_gpu; print(bench_gpu.BENCH_BUDGET_S)"
    env = dict(os.environ, BENCH_BUDGET_S="77")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.stdout.strip() == "77.0"
    assert bench_gpu.SIZES["scale"] == dict(log_rows=20, grind=16)
    assert bench_gpu.SIZES["ntt"] == dict(log_n=18, cols=8, log_blowup=3)
    assert bench_gpu.SIZES["merkle"] == dict(log_leaves=20, row_width=72)
    assert bench_gpu.SIZES["lde24"] == dict(log_n=24, log_blowup=3)
    assert bench_gpu.SIZES["mul"] == dict(log_n=21)


# ------------------------------------------------------------ card or raise

@pytest.mark.parametrize("fn", ["bench_ntt", "bench_hash", "bench_merkle",
                                "bench_mul", "bench_lde_2e24", "bench_proof",
                                "bench_proof_scale", "main"])
def test_without_a_device_argument_it_needs_a_card(fn):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        getattr(bench_gpu, fn)()


def test_script_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; bench_gpu.py would run for real")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "bench_gpu.py", "--all"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"metric"' not in res.stdout
    assert "CUDA card" in res.stderr


def test_timing_helpers_on_the_cpu():
    calls = []
    ms = bench_gpu.cuda_ms(lambda: calls.append(1), iters=4, device="cpu")
    assert len(calls) == 5 and ms >= 0                  # one warm-up
    assert bench_gpu.host_ms(lambda: calls.append(1), device="cpu") >= 0
    seen = []
    dt = bench_gpu._bench_loop(lambda v: seen.append(v) or v + 1, 0, K=3,
                               iters=2, device="cpu")
    assert seen == [0, 1, 2] * 4 and dt >= 0            # K chained, 2 + 2 runs
    n = []
    bench_gpu._bench(lambda a, b: n.append(a + b), 1, 2, warmup=1, iters=3,
                     device="cpu")
    assert n == [3] * 4


# --------------------------------- the card's 2^20-row proof, kept as a file

SCALE_BIN = os.path.join(ROOT, "tests", "golden", "torch_port",
                         "miden_2e20_rows.bin")


def _scale_digest():
    with open(SCALE_BIN[:-4] + ".json") as f:
        return json.load(f)


def test_the_card_s_2e20_row_proof_verifies_under_aero_tpu():
    """The proof `bench_proof_scale` made on the card (2^20 rows of real
    execution, out of reach of `aero_tpu` on a CPU): the reference's verifier
    with the reference's air accepts it, and its bytes have the sha256 that
    `chip_smoke.py` printed."""
    from aero_tpu.air.miden import MidenAir
    from aero_tpu.spec.proof import ProofOptions, load_proof_file
    from aero_tpu.spec.verifier import verify
    want = _scale_digest()
    pub, proof = load_proof_file(SCALE_BIN)
    data = proof.to_bytes()
    assert (hashlib.sha256(data).hexdigest(), len(data)) == \
        (want["sha256"], want["length"]) and len(data) == 113420
    assert proof.context.trace_length == want["rows"] == 1 << 20
    assert list(pub.stack_inputs)[::-1] == want["stack_inputs"]   # top first
    src = bench.long_fib_source(((1 << 20) - 64) // 12)
    assert want["program"] == "bench_gpu.long_fib_source(87376)"
    opts = ProofOptions(num_queries=27, blowup_factor=8, grinding_factor=16)
    verify(proof, pub, air=MidenAir(1 << 20, pub, opts, program=src))


def test_the_card_s_2e20_row_proof_verifies_under_the_port():
    from aero_tpu_torch.air.miden import MidenAir
    from aero_tpu_torch.spec.proof import (ProofOptions, dump_proof_file,
                                           load_proof_file)
    from aero_tpu_torch.spec.verifier import VerificationError, verify
    pub, proof = load_proof_file(SCALE_BIN)
    with open(SCALE_BIN, "rb") as f:
        assert dump_proof_file(pub, proof) == f.read()
    opts = ProofOptions(num_queries=27, blowup_factor=8, grinding_factor=16)
    air = MidenAir(1 << 20, pub, opts,
                   program=bench_gpu.long_fib_source(87376))
    verify(proof, pub, air=air)
    proof.pow_nonce += 1
    with pytest.raises(VerificationError):
        verify(proof, pub, air=air)
