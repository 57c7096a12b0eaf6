"""Tests of the benchmark's harness, its yardstick and its reference.

    python -m pytest port_bench/ -q            # the CPU tests (~2 min)
    python -m pytest --noconftest -m gpu port_bench/   # on the card

The CPU tests rehearse whole cells at 64 rows (`run.py --rehearse`),
break the timed path underneath a run and see `correct` come out false,
hold the frozen roofline counts to the port's own and the reference to
`aero_tpu`'s proof at 2^14 rows. The `gpu` tests run each cell's control
on the card, at the cell's own size.
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


def test_the_reference_loads_nothing_of_the_program():
    """In a fresh process the reference verifies the known answer and
    has loaded no module of the program, of JAX or of the JAX package."""
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
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
        % (str(ROOT), str(HERE / "reference/known/miden_longfib_2e14.bin")))
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
