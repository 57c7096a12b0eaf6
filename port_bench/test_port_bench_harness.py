"""Tests of the benchmark's harness, its yardstick and its reference.

    python -m pytest port_bench/ -q            # the CPU tests (~2 min)
    python -m pytest --noconftest -m gpu port_bench/   # on the card

The CPU tests rehearse whole cells at `n_iters` 3 (`run.py
--rehearse`; 64 rows for the fib programs, a chiplet program's own
trace length), break the timed path underneath a run and see `correct`
come out false, hold the frozen roofline counts to the port's own, the
reference to `aero_tpu`'s proof at 2^14 rows, the reference's reading of
a program (ROM, hash, outputs, overflow table) to the port's VM on fib,
chiplet and std::math::u64 programs and 240 seeded random ones, and the
u64 procedures' outputs to Python's 64-bit integer arithmetic. The `gpu`
tests run each cell's control on the card, at the cell's own size.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from port_bench import harness, judge, roofline  # noqa: E402
from port_bench.reference import miden, miden_air, verifier  # noqa: E402
from port_bench.reference.proof import StarkProof  # noqa: E402

CELLS = ["miden-fib-2e20.prove", "miden-fib-2e14.sdk", "miden-fib-2e14.prove",
         "miden-fib-2e18.prove"]


def _bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _run(*args, timeout=900):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, str(HERE / "run.py"), *args],
                          capture_output=True, text=True, cwd=ROOT, env=env,
                          timeout=timeout)


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


# --------------------------------------------------- found by name

def test_benchmark_json_matches_the_files():
    b = _bench()
    assert b["paths"] == ["port_bench"]
    for c in b["configs"]:
        cfg = harness.load("configs", c["name"])
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        assert (cfg["source"], cfg["reduced"]) == (c["source"], c["reduced"])
    for w in b["workloads"]:
        cell = harness.load("workloads", w["name"])
        assert (cell["config"], cell["traffic"], cell["why"]) == (
            w["config"], w["traffic"], w["why"])
    for kind, key in (("end_to_end", "end_to_end"), ("metrics", "per_layer")):
        mods = harness.metric_modules(kind)
        assert sorted(mods) == sorted(m["name"] for m in b[key])
        for m in b[key]:
            mod = mods[m["name"]]
            assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (
                m["unit"], m["better"], m["source"])
            assert (mod.WORKLOADS or None) == m.get("workloads")
            if key == "per_layer":
                assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_names_its_files(cell):
    wl = harness.load("workloads", cell)
    cfg = harness.load("configs", wl["config"])
    assert wl["entry"] in ("prove", "sdk") and wl["clients"] == 1
    reports = harness.metrics_for("metrics", cell)
    assert {"prover.trace_commit_ms", "device.idle_pct"} <= set(reports)
    assert ("sdk.execute_ms" in reports) == (wl["entry"] == "sdk")
    assert cfg["rows"] == 1 << int(cell.split(".")[0].split("2e")[1])


def test_a_new_cell_and_metric_are_files_only(tmp_path, monkeypatch):
    """A cell at 2^16 rows and a per-layer metric, added as new files in
    a copy of the folder, are found by name; no file already there
    changes."""
    for d in ("configs", "workloads", "metrics", "end_to_end"):
        shutil.copytree(HERE / d, tmp_path / d)
    before = _digest(tmp_path)
    cfg = harness.load("configs", "miden-fib-2e14")
    cfg.update(name="miden-fib-2e16", rows=1 << 16,
               program={"name": "long_fib", "n_iters": 5456})
    (tmp_path / "configs" / "miden-fib-2e16.json").write_text(json.dumps(cfg))
    cell = harness.load("workloads", "miden-fib-2e14.prove")
    cell.update(name="miden-fib-2e16.prove", config="miden-fib-2e16")
    (tmp_path / "workloads" / "miden-fib-2e16.prove.json").write_text(
        json.dumps(cell))
    (tmp_path / "metrics" / "prover.fri_pow_ms.py").write_text(
        'LAYER, UNIT, BETTER, SOURCE = "prover", "ms", "lower", '
        '"program_span"\nMOVES = "rows_per_s"\n'
        'WORKLOADS = ["miden-fib-2e16.prove"]\n\n\ndef read(run):\n'
        '    v = run.span_mean("fri_pow")\n'
        '    return None if v is None else v * 1e3\n')
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    assert harness.load("workloads", "miden-fib-2e16.prove")["config"] == \
        "miden-fib-2e16"
    assert harness.load("configs", "miden-fib-2e16")["rows"] == 1 << 16
    mods = harness.metrics_for("metrics", "miden-fib-2e16.prove")
    assert "prover.fri_pow_ms" in mods and "device.idle_pct" in mods
    assert "prover.fri_pow_ms" not in harness.metrics_for(
        "metrics", "miden-fib-2e14.prove")
    after = _digest(tmp_path)
    assert {k: after[k] for k in before} == before


@pytest.mark.parametrize("config", ["miden-fib-2e20", "miden-fib-2e14",
                                    "miden-fib-2e18"])
def test_todays_rehearsals_are_unchanged(config):
    """The fib configurations rehearse as before a program's own trace
    length set the rows: 64 rows, its LDE domain at 64 rows, `n_iters` 3,
    every other key as it stands."""
    cfg = harness.load("configs", config)
    want = json.loads(json.dumps(cfg))
    want["rows"] = 64
    want["lde_domain"] = 64 * want["options"]["blowup_factor"]
    want["program"] = dict(want["program"], n_iters=3)
    got = harness.rehearsal_config(cfg)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert (got["rows"], got["lde_domain"], got["program"]) == (
        64, 512, {"name": "long_fib", "n_iters": 3})
    assert cfg == harness.load("configs", config)


def _write_json(path: Path, obj: dict) -> None:
    path.write_text(json.dumps(obj, indent=1))


@pytest.fixture
def u64_cells(tmp_path, monkeypatch):
    """Copies of the folders with a std::math::u64 program, a configuration
    and an `sdk` and a `prove` cell on it, added as new files and found
    by name; no file already there changes."""
    from port_bench import programs
    for d in ("configs", "workloads", "metrics", "end_to_end", "programs"):
        shutil.copytree(HERE / d, tmp_path / d)
    before = _digest(tmp_path)
    (tmp_path / "programs" / "u64_loop.masm").write_text(U64_LOOP_CARRY)
    cfg = harness.load("configs", "miden-fib-2e14")
    cfg.update(name="miden-u64-2e16", rows=1 << 16, lde_domain=1 << 19,
               program={"name": "u64_loop", "n_iters": 400})
    _write_json(tmp_path / "configs" / "miden-u64-2e16.json", cfg)
    for entry in ("sdk", "prove"):
        cell = harness.load("workloads", f"miden-fib-2e14.{entry}")
        cell.update(name=f"miden-u64-2e16.{entry}", config="miden-u64-2e16")
        _write_json(tmp_path / "workloads" / f"miden-u64-2e16.{entry}.json",
                    cell)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(programs, "HERE", tmp_path / "programs")
    after = _digest(tmp_path)
    assert {k: after[k] for k in before} == before
    return tmp_path


def _plant_an_output_slot(monkeypatch):
    """The VM's third output slot changed in the public inputs that the
    program builds from it, where the SDK and the prove entry build them."""
    from aero_tpu_torch.air import miden as port_miden
    orig = port_miden.make_public_inputs

    def planted(phash, ins, out, overflow=None):
        out = list(out)
        out[2] = (out[2] + 1) % miden.P
        return orig(phash, ins, out, overflow=overflow)

    monkeypatch.setattr(port_miden, "make_public_inputs", planted)


@pytest.mark.parametrize("cell,case", [
    ("miden-u64-2e16.sdk", "sound"), ("miden-u64-2e16.sdk", "control"),
    ("miden-u64-2e16.sdk", "fault"), ("miden-u64-2e16.prove", "sound"),
    ("miden-u64-2e16.prove", "control")])
def test_a_chiplet_cell_is_files_only(u64_cells, monkeypatch, cell, case):
    """The u64 cell rehearses at its own trace length (1024 rows at 3
    iterations: its procedures and chiplet rows do not fit in 64) and is
    correct through either entry; its control (one query fewer) and a
    planted fault (one VM output slot changed in the SDK's public inputs)
    are not."""
    import torch
    cfg = harness.rehearsal_config(harness.load("configs", "miden-u64-2e16"))
    assert (cfg["rows"], cfg["lde_domain"], cfg["program"]) == (
        1024, 8192, {"name": "u64_loop", "n_iters": 3})
    if case == "fault":
        _plant_an_output_slot(monkeypatch)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        run, checks = harness.run_cell(cell, 2 ** 31 + 17, 1.0, False, 0.0,
                                       rehearse=True,
                                       control=case == "control")
    finally:
        torch.set_num_threads(threads)
    assert run.config["rows"] == 1024 and run.window
    assert judge.correct(checks) is (case == "sound"), checks
    if case != "sound":
        assert checks["rejected"] + checks["failed"] > 0


# --------------------------------------------------- the statistics

def _fake_run(latencies, rows=1 << 14):
    run = harness.Run(cell={}, config={"rows": rows}, seed=0)
    t = 100.0
    for i, lat in enumerate(latencies):
        run.window.append(harness.Request(i, t, t + lat, answer=object()))
        t += lat
    run.window_start, run.window_end = 100.0, t
    return run


def test_rate_and_tail_take_every_request_with_the_stall():
    mods = harness.metric_modules("end_to_end")
    # 90 quick requests and 10 stalls, the stalls together at the end: a
    # median of chunks would read 0.1 s and hide them
    run = _fake_run([0.1] * 90 + [2.0] * 10)
    assert mods["latency_p95_s"].read(run) == pytest.approx(2.0)
    assert mods["rows_per_s"].read(run) == pytest.approx(
        100 * (1 << 14) / (90 * 0.1 + 10 * 2.0))
    # below the 95th percentile's rank a stall does not set the tail
    run = _fake_run([0.1] * 96 + [2.0] * 4)
    assert mods["latency_p95_s"].read(run) == pytest.approx(0.1)


class _Planted:
    """An entry whose request counts `syncs` as the program's spans do:
    inside `prove_program`'s subtree (2 + 3 + 1, and 4 in a second
    proof), outside it (an upload before the proof, a protobuf after
    it), and with no span open. `retries` more waits in the subtree
    stand for a proof-of-work search past its first batch; `fill` more
    spans fill the ring."""

    def __init__(self, fill=0, proof=True, fail=False, retries=0):
        self.fill, self.proof, self.fail = fill, proof, fail
        self.retries = retries

    def request(self, k):
        from aero_tpu_torch.utils import count, span
        from port_bench import entries
        with span("request_outer"):
            count("syncs", 100)
            with span("prove_program" if self.proof else "other"):
                count("syncs", 2)
                with span("fri_pow"):
                    count("syncs", 3 + self.retries)
                    with span("merkle_open"):
                        count("syncs", 1)
            for _ in range(self.fill):
                with span("filler"):
                    pass
            with span("to_pb"):
                count("syncs", 7)
        count("syncs", 1000)
        if self.proof:
            with span("prove_program"):
                count("syncs", 4)
        if self.fail:
            raise RuntimeError("planted failure")
        return entries.Answer(k, [0, 1], b"")


def test_syncs_per_proof_reads_the_proofs_subtree():
    """`prover.syncs_per_proof` sums `syncs` over every `prove_program`
    subtree of a request, none outside it, takes the fewest over the
    completed requests, and reads None where a request filled the
    tracer's ring or ran no proof."""
    from aero_tpu_torch.utils.tracing import MAX_RECORDS
    read = harness.metric_modules("metrics")["prover.syncs_per_proof"].read
    run = harness.Run(cell={}, config={}, seed=0)
    run.window = [harness.run_request(_Planted(), k) for k in range(2)]
    assert [r.counters for r in run.window] == [{"syncs": 10}] * 2
    assert read(run) == 10
    retry = harness.run_request(_Planted(retries=1), 6)
    assert retry.counters == {"syncs": 11}
    assert read(dataclasses.replace(run, window=[retry])) == 11
    run.window.append(retry)
    assert read(run) == 10
    failed = harness.run_request(_Planted(fail=True), 2)
    assert failed.error is not None
    run.window.append(failed)
    assert read(run) == 10
    # six spans and the fillers: a ring one short of full keeps them all,
    # a full one may have dropped some
    near = harness.run_request(_Planted(fill=MAX_RECORDS - 7), 3)
    assert near.counters == {"syncs": 10}
    full = harness.run_request(_Planted(fill=MAX_RECORDS - 6), 4)
    assert full.counters is None
    assert read(dataclasses.replace(run, window=run.window + [full])) is None
    bare = harness.run_request(_Planted(proof=False), 5)
    assert bare.counters is None
    assert read(dataclasses.replace(run, window=run.window + [bare])) is None
    assert read(harness.Run(cell={}, config={}, seed=0)) is None


def test_nearest_rank():
    assert harness.nearest_rank([3, 1, 2], 0.95) == 3
    assert harness.nearest_rank(list(range(1, 101)), 0.95) == 95
    assert harness.nearest_rank([5], 0.95) == 5


# --------------------------------------------------- the frozen yardstick

@pytest.mark.parametrize("log_n,lde,log_blowup", [
    (n, lde, lb) for n in (6, 10, 14, 17, 20, 23, 24, 25, 27)
    for lde, lb in ((False, 0), (True, 3))])
def test_ntt_counts_equal_the_ports(log_n, lde, log_blowup):
    from aero_tpu_torch import _sass
    want = _sass.ntt_field_ops(log_n, 72, log_blowup, lde)
    got = roofline.ntt_field_ops(log_n, 72, log_blowup, lde)
    assert got == {k: want[k] for k in ("mul", "add", "sub")}


def test_frag_eval_counts_equal_the_traced_air():
    """K5's ops a point: MidenAir's traced transition program (the
    port's symbolic trace) and the merge's terms for its 112 constraints
    and 46 assertions."""
    from aero_tpu_torch.air import generated
    from aero_tpu_torch.air.miden import MidenAir
    from aero_tpu_torch.field.sym import ADD, MUL, NEG, SUB
    prog = generated.trace(MidenAir)
    kinds = [n.kind for n in prog.nodes]
    T, B = len(prog.outputs), 46
    assert T == 112
    got = {"mul": kinds.count(MUL) + 2 * T + 3 * B + 1,
           "add": kinds.count(ADD) + 2 * T + 2 * B,
           "sub": kinds.count(SUB) + kinds.count(NEG) + B}
    assert got == roofline.FRAG_EVAL_OPS["miden"] == {
        "mul": 948, "add": 777, "sub": 210}


def test_prices_and_bounds_at_todays_shapes():
    assert roofline.PRICES["mul"] == (21.2, 12.1)
    assert roofline.PRICES["compress"] == (710.0, 284.0)
    assert roofline.leaf_compressions(72) == 36
    # the bounds the kernel table states at the 2^20-row proof's shapes
    assert roofline.hash_columns_bound(72, 1 << 23) * 1e3 == pytest.approx(
        12.818, abs=1e-3)
    assert roofline.ntt_call_bound(23, 72) * 1e3 == pytest.approx(15.68,
                                                                  abs=0.01)
    assert roofline.frag_eval_bound("miden", 1 << 20) * 1e3 == pytest.approx(
        1.900, abs=1e-3)


# --------------------------------------------------- the reference

def _known():
    meta = json.loads((HERE / "reference/known/miden_longfib_2e14.json")
                      .read_text())
    data = (HERE / "reference/known/miden_longfib_2e14.bin").read_bytes()
    assert hashlib.sha256(data).hexdigest() == meta["sha256"]
    return meta, data


def test_reference_accepts_aero_tpus_proof_and_refuses_a_flip():
    from port_bench.programs import program_source
    meta, data = _known()
    cfg = harness.load("configs", "miden-fib-2e14")
    src = program_source(meta["program"])
    exp = miden.public_inputs(src, meta["stack_inputs_topfirst"])
    rom = miden.rom_listing(src)
    assert judge.judge_proof(StarkProof.from_bytes(data), exp, cfg, rom) == ""
    bad = bytearray(data)
    bad[len(bad) // 2] ^= 1
    assert judge.judge_proof(StarkProof.from_bytes(bytes(bad)), exp, cfg,
                             rom) != ""
    other = miden.public_inputs(src, [1, 1])
    assert judge.judge_proof(StarkProof.from_bytes(data), other, cfg,
                             rom) != ""


@pytest.mark.parametrize("n_iters", [3, 40, 1360])
def test_reference_reads_the_program_as_the_vm_runs_it(n_iters):
    import numpy as np
    from aero_tpu_torch.air.miden import make_public_inputs
    from aero_tpu_torch.vm import execute_full, program_hash, rom_listing
    from port_bench.entries import inputs
    from port_bench.programs import program_source
    src = program_source({"name": "long_fib", "n_iters": n_iters})
    assert miden.rom_listing(src) == rom_listing(src)
    for k in range(3):
        ins = inputs(2 ** 31 + 11, 0, k)
        trace, out, ovf = execute_full(src, ins, min_rows=64)
        pub = make_public_inputs(program_hash(src), ins, out, overflow=ovf)
        assert miden.public_inputs(src, ins).to_bytes() == pub.to_bytes()
    assert np.asarray(trace).shape[0] == miden_air.MidenAir.main_width


# a std::math::u64 program as a later configuration would name it: a loop
# over two field inputs split into u32 limbs, which calls four of the
# stdlib's procedures and stores to and loads from memory each iteration
U64_LOOP = """
use.std::math::u64
begin
    u32split swap               # [a_hi, a_lo, b]
    movup.2 u32split swap       # [b_hi, b_lo, a_hi, a_lo]
    push.{n_iters}
    dup.0 push.0 neq
    while.true                  # [n, B, A]
        movdn.4                 # [B, A, n]
        dup.3 dup.3 dup.3 dup.3
        exec.u64::wrapping_add  # [C = A + B, B, A, n]
        mem.store.1 drop mem.store.0 drop
        exec.u64::wrapping_mul  # [D = A * B, n]
        mem.load.0 mem.load.1   # [C, D, n]
        dup.3 dup.3 dup.3 dup.3
        exec.u64::lt            # [D < C, C, D, n]
        mem.load.2 add mem.store.2 drop
        dup.3 dup.3 dup.3 dup.3
        exec.u64::eq            # [D == C, C, D, n]
        mem.load.3 add mem.store.3 drop
        movup.4 push.1 sub      # [n - 1, C, D]
        dup.0 push.0 neq
    end
    drop mem.load.3 mem.load.2  # [#lt, #eq, C, D]
end
"""

# U64_LOOP with `lt` swapped for `overflowing_add`'s carry out of 64
# bits: the port's `u64::lt` leaves b_hi under its answer (reference/
# stdlib.py), so the comparisons with the port's VM and the chiplet cell
# run this one; U64_LOOP itself is held to Python's integers
U64_LOOP_CARRY = U64_LOOP.replace(
    "exec.u64::lt            # [D < C, C, D, n]",
    "exec.u64::overflowing_add movdn.2 drop drop  # [D + C > 2^64 - 1, C, D, n]")
assert U64_LOOP_CARRY != U64_LOOP

_A64, _B64 = 0xDEADBEEF_CAFEBABE, 0x01234567_89ABCDEF

# the two chiplet programs of the port's VM tests, as they stand there
CHIPLET_PROGRAMS = {
    "u32_and_memory": ("""
    begin
        push.4294967295 push.1 u32add
        push.12 push.10 u32xor add
        mem.store.5 drop
        push.99 mem.store.7 drop push.5 mem.load.7 add
        mem.load.5 add
        push.48 push.4 u32shr u32lt
    end
    """, [3, 4]),
    "stdlib_import": ("""
    use.std::math::u64
    begin
        exec.u64::wrapping_mul
        exec.u64::eqz
    end
    """, [_B64 >> 32, _B64 & 0xFFFFFFFF, _A64 >> 32, _A64 & 0xFFFFFFFF]),
}


def _vm_reading(src, ins):
    """ROM, program hash, output slots and overflow table by the port's
    VM."""
    from aero_tpu_torch.vm import execute_full, program_hash, rom_listing
    _, out, ovf = execute_full(src, ins, min_rows=64, max_rows=1 << 16)
    return rom_listing(src), program_hash(src), out, ovf


def _reference_reading(src, ins):
    out, table = miden.run(src, ins)
    return (miden.rom_listing(src), miden.public_inputs(src, ins).program_hash,
            out, table)


@pytest.mark.parametrize("name", sorted(CHIPLET_PROGRAMS) + ["u64_loop"])
def test_reference_reads_chiplet_programs_as_the_vm_runs_them(name):
    """The u32 family, memory and std::math::u64: the reference's ROM,
    program hash, output slots and overflow table equal the VM's."""
    from port_bench.entries import inputs
    if name == "u64_loop":
        cases = [(U64_LOOP_CARRY.format(n_iters=n),
                  inputs(2 ** 31 + 13, 0, k))
                 for n, k in ((1, 0), (2, 1), (7, 2), (25, 3))]
    else:
        cases = [CHIPLET_PROGRAMS[name]]
    for src, ins in cases:
        got = _reference_reading(src, ins)
        assert got == _vm_reading(src, ins)
        assert len(got[3]) > 0 or name == "stdlib_import"


# each std::math::u64 procedure's answer by Python's integers, top
# first, held against both the reference and the VM: the procedures are
# the repo's own text, the same on both sides, so only a known answer
# catches a wrong carry, borrow or limb in them
_M64 = (1 << 64) - 1


def _limbs(x):
    return [x >> 32, x & 0xFFFFFFFF]


U64_ANSWERS = {
    "wrapping_add": lambda a, b: _limbs((a + b) & _M64),
    "overflowing_add": lambda a, b: [int(a + b > _M64)]
    + _limbs((a + b) & _M64),
    "wrapping_sub": lambda a, b: _limbs((a - b) & _M64),
    "wrapping_mul": lambda a, b: _limbs((a * b) & _M64),
    "eq": lambda a, b: [int(a == b)],
    "lt": lambda a, b: [int(a < b)],
    "gt": lambda a, b: [int(a > b)],
    "lte": lambda a, b: [int(a <= b)],
    "gte": lambda a, b: [int(a >= b)],
    "eqz": lambda a, b: [int(a == 0)],
}

# edge limbs: 0, 2^32 - 1 in either limb, carries out of the low limb and
# out of 64 bits, borrows across both, and two seeded values
_EDGES = [0, 1, 0xFFFFFFFF, 1 << 32, (1 << 32) + 1, 0x1_FFFFFFFF, 1 << 63,
          0xFFFFFFFF_00000000, _M64, _A64, _B64]


def _answer_is(got, table, want, src, ins):
    """16 output slots against a known answer: `want` on top, zeros under
    it and in the overflow table (each value parked there was a zero
    under the operands, whatever the count)."""
    want = want + [0] * (16 - len(want))
    assert (list(got), {v for _, v in table} - {0}) == (want, set()), (
        src, ins)


@pytest.mark.parametrize("proc", sorted(U64_ANSWERS))
def test_u64_procedures_give_pythons_answers(proc):
    """Each procedure of the reference's `std::math::u64` on every pair
    of edge values gives what Python's 64-bit integer arithmetic gives:
    a = the second pair on the stack, b = the top pair, a OP b."""
    src = f"use.std::math::u64\nbegin\n    exec.u64::{proc}\nend\n"
    for a in _EDGES:
        for b in ([0] if proc == "eqz" else _EDGES):
            ins = _limbs(a) if proc == "eqz" else _limbs(b) + _limbs(a)
            _answer_is(*miden.run(src, ins), U64_ANSWERS[proc](a, b),
                       src, ins)


def _u64_loop_answer(a, b, n_iters, first):
    """A u64 loop by Python's integers: (#first, #eq, C, D) after n_iters
    rounds of C = A + B, D = A * B (mod 2^64), then A, B = D, C; `first`
    is the count U64_LOOP's `lt` (or U64_LOOP_CARRY's carry) keeps."""
    big, small = a, b
    n_first = n_eq = 0
    for _ in range(n_iters):
        c, d = (big + small) & _M64, (big * small) & _M64
        n_first, n_eq = n_first + first(d, c), n_eq + (d == c)
        big, small = d, c
    return n_first, n_eq, c, d


_LOOP_EDGES = [[0, 0], [2, 2], [miden.P - 1, miden.P - 1], [0xFFFFFFFF, 1],
               [1 << 32, 0xFFFFFFFF], [miden.P - 1, 1 << 63]]


def _loop_case(loop, case, first):
    """The loop at 7 iterations with C's limbs read back from memory at
    the end, its inputs, and its answer by Python's integers."""
    from port_bench.entries import inputs
    ins = (_LOOP_EDGES[case] if case < len(_LOOP_EDGES)
           else inputs(2 ** 31 + 29, 0, case))
    head, _, _ = loop.format(n_iters=7).rpartition("end")
    src = head + "    mem.load.0 mem.load.1\nend\n"
    n_first, n_eq, c, d = _u64_loop_answer(ins[0], ins[1], 7, first)
    if case == 0:
        assert (n_first, n_eq) == (0, 7)
    return src, ins, (_limbs(c) + [n_first, n_eq] + _limbs(c) + _limbs(d))


@pytest.mark.parametrize("case", range(9))
def test_u64_loop_gives_pythons_answer(case):
    """U64_LOOP read by the reference, with C's limbs read back from
    memory at the end, gives the counts of D < C and D == C and the last
    C and D that Python's integers give, in memory and on the stack."""
    src, ins, want = _loop_case(U64_LOOP, case, lambda d, c: int(d < c))
    _answer_is(*miden.run(src, ins), want, src, ins)


@pytest.mark.parametrize("case", range(9))
def test_the_cells_u64_loop_gives_pythons_answer_on_both_sides(case):
    """U64_LOOP_CARRY, the chiplet cell's program, gives Python's counts
    of carries out of D + C and of D == C and the last C and D, read by
    the reference and run by the port's VM."""
    from aero_tpu_torch.vm import execute_full
    src, ins, want = _loop_case(U64_LOOP_CARRY, case,
                                lambda d, c: int(d + c > _M64))
    _answer_is(*miden.run(src, ins), want, src, ins)
    _, out, table = execute_full(src, ins, min_rows=64, max_rows=1 << 16)
    _answer_is(out, table, want, src, ins)


def test_u32lo_and_u32hi_rows_list_no_immediate():
    """A u32lo or u32hi row carries a witness in the trace's immediate
    column, but the ROM lists 0 there, as the VM's listing does."""
    from aero_tpu_torch.vm import rom_listing
    src = "begin push.18446744069414584320 u32split u32lo u32hi end"
    rom = miden.rom_listing(src)
    assert rom == rom_listing(src)
    ops = [miden_air.OPS[op] for _, op, _ in rom]
    assert ops == ["push", "dup0", "u32hi", "swap", "u32lo", "u32lo",
                   "u32hi", "halt"]
    assert [imm for _, _, imm in rom][1:] == [0] * 7


def _random_program(rng):
    """A straight-line program over the reference's new tokens, and its
    stack inputs, every value on the stack and in memory a u32 so that
    every operand is in range."""
    u32 = lambda: rng.choice([0, 1, 2, 31, 0xFFFFFFFF, rng.getrandbits(32)])
    field = lambda: rng.choice([rng.randrange(miden.P), miden.P - 1,
                                0xFFFFFFFF << 32, rng.getrandbits(32)])
    addr = lambda: rng.choice([0, 1, 2, 3, 7, 0xFFFFFFFF, rng.getrandbits(32)])
    binary = ("u32add", "u32sub", "u32mul", "u32and", "u32or", "u32xor",
              "u32lt")
    menu = [
        lambda: [f"push.{u32()}"],
        lambda: [f"push.{field()}", rng.choice(["u32split", "u32lo",
                                                "u32hi"])],
        lambda: [rng.choice(["u32split", "u32lo", "u32hi", "u32not"])],
        lambda: [rng.choice(binary)],
        lambda: [f"{rng.choice(binary)}.{u32()}"],
        lambda: [f"{rng.choice(['u32div', 'u32mod'])}.{u32() or 3}"],
        lambda: [f"push.{rng.randrange(1, 1 << 32)}",
                 rng.choice(["u32div", "u32mod"])],
        lambda: [f"{rng.choice(['u32shl', 'u32shr'])}.{rng.randrange(32)}"],
        lambda: [f"push.{rng.randrange(32)}", rng.choice(["u32shl",
                                                          "u32shr"])],
        lambda: rng.choice([["eqz"], ["eqz", "not"],
                            ["eqz", "swap", "eqz", "and"],
                            ["eqz", "swap", "eqz", "or"]]),
        lambda: [f"dup.{rng.randrange(8)}"],
        lambda: [rng.choice(["swap", "drop", "movup.2", "movup.3", "movup.4",
                             "movdn.2", "movdn.3", "movdn.4"])],
        lambda: [f"mem.store.{addr()}"] + rng.choice([[], ["drop"]]),
        lambda: [f"mem.load.{addr()}"],
        lambda: [f"push.{addr()}", rng.choice(["mem.load", "mem.store"])],
        lambda: [rng.choice(["mem.load", "mem.store"])],
    ]
    toks = []
    for _ in range(rng.randrange(10, 60)):
        toks += rng.choice(menu)()
    ins = [u32() for _ in range(rng.randrange(17))]
    return "begin\n    " + " ".join(toks) + "\nend\n", ins


@pytest.mark.parametrize("batch", range(8))
def test_reference_reads_random_programs_as_the_vm_runs_them(batch):
    """30 seeded straight-line programs a batch, 240 in all."""
    import random
    rng = random.Random(2 ** 31 + 1000 + batch)
    for _ in range(30):
        src, ins = _random_program(rng)
        assert _reference_reading(src, ins) == _vm_reading(src, ins), src


@pytest.mark.parametrize("src", [
    "begin push.4294967296 push.1 u32add end",
    "begin push.1 push.4294967296 u32lt end",
    "begin push.4294967296 u32not end",
    "begin push.7 push.0 u32div end",
    "begin push.7 u32mod.0 end",
    "begin push.1 u32shl.32 end",
    "begin push.1 push.40 u32shr end",
    "begin push.2 not end",
    "begin push.2 push.1 and end",
    "begin push.4294967296 mem.load end",
    "begin push.5 mem.store.4294967296 end",
    "begin push.1 u32rotl end",
    "begin dup.8 end",
])
def test_reference_raises_where_the_vm_raises(src):
    from aero_tpu_torch.vm import VmError
    with pytest.raises(VmError):
        _vm_reading(src, [1, 2])
    with pytest.raises(ValueError):
        _reference_reading(src, [1, 2])


def test_the_reference_loads_nothing_of_the_program():
    """In a fresh process the reference verifies the known answer, reads
    a std::math::u64 program (its ROM, run and hash) and has loaded no
    module of the program, of JAX or of the JAX package."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from port_bench import judge, harness\n"
        "from port_bench.programs import program_source\n"
        "from port_bench.reference import miden\n"
        "from port_bench.reference.proof import StarkProof\n"
        "d = open(%r, 'rb').read()\n"
        "src = program_source({'name': 'long_fib', 'n_iters': 1360})\n"
        "cfg = harness.load('configs', 'miden-fib-2e14')\n"
        "why = judge.judge_proof(StarkProof.from_bytes(d),\n"
        "    miden.public_inputs(src, [0, 1]), cfg, miden.rom_listing(src))\n"
        "assert why == '', why\n"
        "u64 = %r.format(n_iters=3)\n"
        "out, table = miden.run(u64, [2 ** 40 + 5, 2 ** 63 + 7])\n"
        "assert len(miden.rom_listing(u64)) > 100 and table\n"
        "assert len(miden.public_inputs(u64, [2 ** 40 + 5, 2 ** 63 + 7])\n"
        "           .program_hash) == 4\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        % (str(ROOT), str(HERE / "reference/known/miden_longfib_2e14.bin"),
           U64_LOOP))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"aero_tpu_torch", "aero_tpu", "jax", "jaxlib", "flax",
                      "torch"}


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == [] or all(
        m.split(".")[0] in harness.FORBIDDEN
        for m in harness.forbidden_modules())
    fake = type(sys)("fake")
    monkeypatch.setitem(sys.modules, "aero_tpu_torch_extra", fake)
    monkeypatch.setitem(sys.modules, "aero_tpuish.x", fake)
    monkeypatch.setitem(sys.modules, "jaxfoo", fake)
    found = harness.forbidden_modules()
    assert not {"aero_tpu_torch_extra", "aero_tpuish.x", "jaxfoo"} & set(found)
    monkeypatch.setitem(sys.modules, "aero_tpu.spec", fake)
    monkeypatch.setitem(sys.modules, "jax.numpy", fake)
    found = harness.forbidden_modules()
    assert {"aero_tpu.spec", "jax.numpy"} <= set(found)


# --------------------------------------------------- rehearsed runs

@pytest.mark.parametrize("cell", ["miden-fib-2e14.prove", "miden-fib-2e14.sdk",
                                  "miden-fib-2e18.prove"])
def test_rehearsal_is_correct_and_the_control_is_not(cell):
    """The same cell files on the CPU at 64 rows; the process exits 0,
    which it does only with no JAX module loaded, and the control (one
    query fewer than the configuration states) comes out not correct."""
    for control, want in ((False, True), (True, False)):
        args = ["--workload", cell, "--seed", str(2 ** 31 + 7),
                "--seconds", "0.5", "--trace", "0", "--rehearse"]
        out = _run(*args, *(["--control"] if control else []))
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is want, out.stderr[-3000:]
        assert list(line)[-1] == "checks"
        assert line["metrics"] == {}
        last = out.stderr.strip().splitlines()[-len(line["checks"]):]
        assert [s.split(":")[0] for s in last] == list(line["checks"])


def test_a_measured_run_without_a_card_fails():
    if harness_card():
        pytest.skip("a card is present")
    out = _run("--workload", "miden-fib-2e14.prove", "--seed", "1",
               "--seconds", "1", "--trace", "0")
    assert out.returncode == 2 and out.stdout.strip() == ""


def harness_card() -> bool:
    import torch
    return torch.cuda.is_available()


def _broken_run(monkeypatch, cell, fault):
    """A rehearsed run of `cell` in this process, with each request's
    answer broken as `fault` says, where the entry produces it."""
    from port_bench import entries
    cls = entries.ENTRIES[harness.load("workloads", cell)["entry"]]
    orig = cls.request
    last: dict = {}

    def request(self, k):
        a = orig(self, k)
        if fault == "stale" and "prev" in last:
            # the step returns what it returned before, unchanged
            a = entries.Answer(a.key, a.inputs, last["prev"].proof,
                               last["prev"].public)
        elif fault == "altered":
            # a byte of the answer altered where it is produced
            data = bytearray(a.proof)
            data[len(data) // 3] ^= 0x10
            a = entries.Answer(a.key, a.inputs, bytes(data), a.public)
        last["prev"] = a
        return a

    monkeypatch.setattr(cls, "request", request)
    return harness.run_cell(cell, 2 ** 31 + 5, 2.5, False, 0.0,
                            rehearse=True)


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in ("miden-fib-2e14.prove", "miden-fib-2e14.sdk")
    for f in ("stale", "altered")])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        run, checks = _broken_run(monkeypatch, cell, fault)
    finally:
        torch.set_num_threads(threads)
    answers = [r for r in run.window if r.answer is not None]
    if fault == "stale":
        assert len(answers) >= 2
    assert not judge.correct(checks), checks


# --------------------------------------------------- on the card

@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell):
    """Each cell's control at the cell's own size on three seeds: proofs
    with one query fewer than the configuration states are refused."""
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        out = _run("--workload", cell, "--seed", str(seed), "--seconds", "3",
                   "--trace", "0", "--control", timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] is False
        assert line["checks"]["rejected"]["value"] >= 1


# the CUDA runtime calls by which the host waits for the card
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


def _profiled_waits(prof, name=harness.PROOF_SPAN):
    """For each range of span `name` in a finished profile, in order, the
    synchronizing runtime calls the profiler recorded inside it."""
    events = prof.events()
    calls = [e.time_range for e in events if e.name in SYNC_CALLS]
    ranges = sorted((e.time_range for e in events if e.name == name),
                    key=lambda r: r.start)
    return [sum(r.start <= c.start and c.end <= r.end for c in calls)
            for r in ranges]


def _card_entry(cell):
    """The cell's entry, set up on the card as a run sets it up."""
    import torch
    from aero_tpu_torch import _build
    from port_bench import entries
    wl = harness.load("workloads", cell)
    cfg = harness.load("configs", wl["config"])
    _build.load()
    entry = entries.ENTRIES[wl["entry"]](cfg, wl, 2 ** 31 + 301,
                                         torch.device("cuda", 0))
    entry.setup()
    return entry


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_syncs_per_proof_equals_the_profilers_waits(card, cell):
    """Request by request, the `syncs` that `prover.syncs_per_proof`
    reads equal the synchronizing runtime calls the profiler records in
    each `prove_program` range; the metric reads the fewest."""
    from torch.profiler import ProfilerActivity, profile
    entry = _card_entry(cell)
    try:
        plain = [harness.run_request(entry, k) for k in range(3)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced = [harness.run_request(entry, k) for k in range(3, 6)]
    finally:
        entry.close()
    counts = [r.counters["syncs"] for r in plain + traced]
    waits = _profiled_waits(prof)
    print(f"{cell}: syncs {counts}, profiler {waits}")
    assert min(counts) > 0 and waits == counts[3:]
    run = harness.Run(cell={}, config={}, seed=0, window=plain)
    read = harness.metric_modules("metrics")["prover.syncs_per_proof"].read
    assert read(run) == min(counts[:3])


@pytest.mark.gpu
def test_the_2e18_proof_runs_two_fragments_and_a_remainder_of_64(card):
    """At 2^18 rows the LDE domain of 2^21 points is two fragments of
    the prover's 2^20: constraint evaluation in two K5 launches under one
    `frag_eval` span with n_frags 2, DEEP in two K4 launches; FRI folds
    five layers down to a remainder of 64."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from aero_tpu_torch.utils import get_tracer
    entry = _card_entry("miden-fib-2e18.prove")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            get_tracer().reset()
            answer = entry.request(0)
            frags = [r.meta for r in get_tracer().records
                     if r.name == "frag_eval"]
    finally:
        entry.close()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    k5 = sum("frag_merge_kernel" in n for n in names)
    k4 = sum("deep_combine_kernel" in n for n in names)
    fri = StarkProof.from_bytes(answer.proof).fri_proof
    print(f"frag_eval {frags}, K5 {k5}, K4 {k4}, FRI layers "
          f"{len(fri.layers)}, remainder {len(fri.remainder_felts())}")
    assert frags == [{"n_frags": 2}] and (k5, k4) == (2, 2)
    assert (len(fri.layers), len(fri.remainder_felts())) == (5, 64)
