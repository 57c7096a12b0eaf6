"""The port's tracer (`aero_tpu_torch.utils.tracing`) and what reads it.

Counters on spans, the parent of each record, the bounded record buffer,
the spans' ranges in a `torch.profiler` trace, the host spans and the
`syncs` counter on the proof path (on the CPU nothing waits for a stream,
so every count is zero here; the card's count is held to the profiler's
synchronizing calls in `tests/test_torch_gpu.py`), and the benchmark's
metric modules that read the new spans.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aero_tpu_torch import _device
from aero_tpu_torch.utils import (Tracer, count, get_tracer, span, subtree,
                                  subtree_count, tracing)
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every span name the port had before the host spans, but "ntt_tables"
# (tables are built on the card only)
STAGE_SPANS = {"prove_program", "trace_commit", "aux_commit",
               "constraint_eval", "ood_frames", "deep_composition",
               "fri_pow", "queries_serialize", "constraint_prelude",
               "frag_eval", "composition_intt_lde", "constraint_commit"}
HOST_SPANS = {"merkle_open", "coin_draws"}
SDK_SPANS = {"execute", "to_pb", "vm_execute", "air_build", "trace_upload"}


def _by_name(tr):
    return {r.name: r for r in tr.records}


# ------------------------------------------------------------ counters

def test_a_count_lands_on_the_innermost_open_span():
    tr = Tracer(echo=False)
    with tr.span("outer"):
        tr.count("syncs")
        with tr.span("inner"):
            tr.count("syncs", 3)
            tr.count("other")
        tr.count("syncs")
    recs = _by_name(tr)
    assert recs["outer"].counters == {"syncs": 2}
    assert recs["inner"].counters == {"syncs": 3, "other": 1}
    assert tr.counters == {}


def test_a_count_with_no_span_open_is_kept_by_the_tracer():
    tr = Tracer(echo=False)
    tr.count("syncs")
    tr.count("syncs", 4)
    with tr.span("a"):
        pass
    assert tr.counters == {"syncs": 5}
    assert _by_name(tr)["a"].counters == {}
    tr.reset()
    assert tr.counters == {} and len(tr.records) == 0


def test_the_module_count_goes_to_the_global_tracer():
    tr = get_tracer()
    tr.reset()
    with span("probe_outer"):
        count("probe")
    assert _by_name(tr)["probe_outer"].counters == {"probe": 1}
    tr.reset()


def test_the_echo_prints_a_spans_counters(capsys):
    tr = Tracer(echo=True)
    with tr.span("stage", k=7):
        tr.count("syncs", 2)
    err = capsys.readouterr().err
    assert "stage:" in err and "k=7" in err and "syncs=2" in err


# ------------------------------------------------------------- nesting

def test_parent_indices_rebuild_the_nesting():
    tr = Tracer(echo=False)
    with tr.span("root"):
        with tr.span("a"):
            tr.count("syncs")
            with tr.span("a1"):
                tr.count("syncs", 2)
        with tr.span("b"):
            tr.count("syncs", 4)
    with tr.span("other"):
        tr.count("syncs", 8)
    recs = _by_name(tr)
    assert recs["root"].parent is None and recs["other"].parent is None
    assert recs["a"].parent == recs["b"].parent == recs["root"].index
    assert recs["a1"].parent == recs["a"].index
    assert [r.depth for r in (recs["root"], recs["a"], recs["a1"])] == \
        [0, 1, 2]
    assert {r.name for r in subtree(tr.records, recs["root"])} == \
        {"root", "a", "a1", "b"}
    assert {r.name for r in subtree(tr.records, recs["a"])} == {"a", "a1"}
    assert subtree_count(tr.records, recs["root"], "syncs") == 7
    assert subtree_count(tr.records, recs["other"], "syncs") == 8
    children = [r for r in tr.records if r.parent == recs["root"].index]
    assert {r.name for r in children} == {"a", "b"}
    own = recs["root"].duration_s - sum(r.duration_s for r in children)
    assert 0 <= own <= recs["root"].duration_s


def test_the_report_lists_spans_in_the_order_they_opened():
    tr = Tracer(echo=False)
    with tr.span("first"):
        with tr.span("second"):
            tr.count("syncs")
    lines = tr.report().splitlines()
    assert lines[1].startswith("first")
    assert lines[2].startswith("  second") and lines[2].endswith("syncs=1")


# -------------------------------------------------------------- bounds

def test_the_record_buffer_stays_bounded_and_reset_clears_it():
    tr = Tracer(echo=False)
    for _ in range(100_000):
        with tr.span("s"):
            tr.count("syncs")
    assert len(tr.records) == tracing.MAX_RECORDS
    assert tr.records[-1].index == 99_999          # the newest are kept
    tr.reset()
    assert len(tr.records) == 0
    with tr.span("after"):
        pass
    assert [r.name for r in tr.records] == ["after"]


# ------------------------------------------------------------ profiler

def _events(prof, names):
    return [e for e in prof.events() if e.name in names]


def test_spans_appear_in_the_profilers_trace_with_their_nesting():
    tr = Tracer(echo=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("prof_outer"):
            with tr.span("prof_inner"):
                torch.ones(4) + 1
    evs = {e.name: e for e in _events(prof, {"prof_outer", "prof_inner"})}
    assert set(evs) == {"prof_outer", "prof_inner"}
    assert evs["prof_inner"].cpu_parent is evs["prof_outer"]
    outer, inner = evs["prof_outer"].time_range, evs["prof_inner"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end
    # plain ranges, not user annotations: the profiler draws no device-side
    # copy of them that a sum of device intervals would count
    assert not any(getattr(e, "is_user_annotation", False)
                   for e in evs.values())


def test_no_range_opens_without_a_recording_profiler(monkeypatch):
    made = []
    real = torch._C._profiler._RecordFunctionFast

    def counted(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counted)
    tr = Tracer(echo=False)
    with tr.span("off"):
        pass
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tr.span("on"):
            with tr.span("on_inner"):
                pass
    assert made == ["on", "on_inner"]
    with tr.span("off_again"):
        pass
    assert made == ["on", "on_inner"]


def test_the_tracer_imports_no_torch():
    code = ("import sys\n"
            "import aero_tpu_torch.spec.verifier\n"
            "from aero_tpu_torch.utils import tracing\n"
            "with tracing.span('x'):\n"
            "    tracing.count('syncs')\n"
            "assert tracing.get_tracer().records[0].counters == {'syncs': 1}\n"
            "print('torch' in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False"


# ------------------------------------------------- the syncs helpers

class _CardTensor:
    """Stands for a CUDA tensor where there is no card."""
    is_cuda = True

    def cpu(self):
        return "host copy"


class _HostTensor:
    is_cuda = False

    def to(self, device):
        return _CardTensor()


def test_the_wait_helpers_count_a_card_copy_and_nothing_on_the_cpu():
    tr = get_tracer()
    tr.reset()
    with span("helpers"):
        assert _device.to_host(_CardTensor()) == "host copy"
        assert _device.upload(_HostTensor(), "cuda").is_cuda
        t = torch.arange(3)
        assert torch.equal(_device.to_host(t), t)
        assert torch.equal(_device.upload(t, "cpu"), t)
        assert torch.equal(_device.index_tensor([2, 0], "cpu"),
                           torch.tensor([2, 0]))
    assert _by_name(tr)["helpers"].counters == {"syncs": 2}
    tr.reset()


def test_synchronize_counts_one_wait(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)
    tr = Tracer(echo=False)
    monkeypatch.setattr(tracing, "_GLOBAL", tr)
    with tr.span("stage"):
        _device.synchronize("cuda:0")
    assert seen == ["cuda:0"]
    assert _by_name(tr)["stage"].counters == {"syncs": 1}


# ------------------------------------------------ the proof path's spans

def _span_names_and_syncs(tr):
    return ({r.name for r in tr.records},
            sum(r.counters.get("syncs", 0) for r in tr.records)
            + tr.counters.get("syncs", 0))


def test_a_cpu_proof_emits_the_host_spans_and_counts_no_syncs():
    from aero_tpu_torch.air import fib as TF
    from aero_tpu_torch.prover import prove
    from aero_tpu_torch.spec.proof import ProofOptions
    opts = ProofOptions(num_queries=7, blowup_factor=8, grinding_factor=2)
    n = 64
    pub = TF.FibPublicInputs(result=TF.fib_result(n), n_steps=n)
    tr = get_tracer()
    tr.reset()
    prove(TF.FibAir(n, pub, opts), TF.build_fib_trace(n), pub)
    names, syncs = _span_names_and_syncs(tr)
    recs = list(tr.records)
    tr.reset()
    assert STAGE_SPANS | HOST_SPANS <= names
    assert syncs == 0
    # trace, aux and constraint trees and one FRI layer (512 -> 64 points)
    assert sum(r.name == "merkle_open" for r in recs) == 4
    # aux randomness, constraint and DEEP coefficients, query positions
    assert sum(r.name == "coin_draws" for r in recs) == 4
    by_index = {r.index: r for r in recs}
    for r in recs:
        if r.name == "merkle_open":
            assert by_index[r.parent].name == "queries_serialize"
        if r.name == "coin_draws":
            assert by_index[r.parent].name in ("aux_commit",
                                               "constraint_eval",
                                               "deep_composition", "fri_pow")


def test_a_cpu_sdk_prove_splits_execute_in_three():
    from aero_tpu_torch import sdk
    from aero_tpu_torch.sdk.pb import aero_pb2 as pb
    from aero_tpu_torch.spec.proof import ProofOptions
    from aero_tpu_torch.vm import fibonacci_source
    fast = sdk.options_to_pb(ProofOptions(num_queries=7, blowup_factor=8,
                                          grinding_factor=2))
    tr = get_tracer()
    tr.reset()
    sdk.prove(pb.MidenProgram(program=fibonacci_source(10)),
              pb.MidenProgramInputs(stack_init=[1, 0]), fast, device="cpu")
    names, syncs = _span_names_and_syncs(tr)
    recs = list(tr.records)
    tr.reset()
    assert STAGE_SPANS | HOST_SPANS | SDK_SPANS <= names
    assert syncs == 0
    by_name = {r.name: r for r in recs}
    execute = by_name["execute"]
    parts = [by_name[p] for p in ("vm_execute", "air_build", "trace_upload")]
    assert [p.parent for p in parts] == [execute.index] * 3
    assert [p.index for p in parts] == sorted(p.index for p in parts)
    assert sum(p.duration_s for p in parts) <= execute.duration_s


# ------------------------------------------- the benchmark's new metrics

NEW_METRICS = {
    "hash.merkle_open_ms": "merkle_open",
    "prover.coin_draws_ms": "coin_draws",
    "sdk.vm_execute_ms": "vm_execute",
    "sdk.air_build_ms": "air_build",
    "sdk.trace_upload_ms": "trace_upload",
}


def _bench_metrics():
    from port_bench import harness
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entries = {m["name"]: m for m in json.load(f)["per_layer"]}
    return harness, harness.metric_modules("metrics"), entries


@pytest.mark.parametrize("name", sorted(NEW_METRICS))
def test_a_new_metric_declares_its_fields(name):
    _, mods, entries = _bench_metrics()
    mod, entry = mods[name], entries[name]
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["better"], entry["source"],
        entry["moves"])
    assert (mod.WORKLOADS or None) == entry.get("workloads")


@pytest.mark.parametrize("name", sorted(NEW_METRICS))
def test_a_new_metric_reads_a_synthetic_run(name):
    harness, mods, _ = _bench_metrics()
    span_name = NEW_METRICS[name]
    run = harness.Run(cell={}, config={"rows": 64}, seed=1)
    run.window = [
        harness.Request(0, 0.0, 1.0, answer=object(),
                        spans={span_name: 0.002, "prove_program": 0.5}),
        harness.Request(1, 1.0, 2.0, answer=object(),
                        spans={span_name: 0.004}),
        harness.Request(2, 2.0, 3.0, error="RuntimeError: x",
                        spans={span_name: 9.0}),     # failed: not read
    ]
    assert mods[name].read(run) == pytest.approx(3.0)
    parent = harness.Run(cell={}, config={"rows": 64}, seed=1)
    parent.window = [harness.Request(0, 0.0, 1.0, answer=object(),
                                     spans={"prove_program": 0.5})]
    assert mods[name].read(parent) is None           # a program without it
