#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port (`aero_tpu_torch`) on one CUDA card.

    python3 bench_gpu.py [--all]

The counterpart of `bench.py`: the same workloads at the same shapes under
the same metric names, one JSON line a metric,

    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

in the order `bench.py` plans them. `--all` adds the leaf-hash and field
multiply rates. Before the metrics come the card's name and power limit;
beside each rate, on a line of its own, the seconds it was made from.

It runs on the CUDA card and raises without one: every function takes
`device=None`, which `aero_tpu_torch._device.resolve_device` turns into the
card, and nothing falls back to the CPU (the tests pass `device="cpu"`).

Timing: device work is timed with CUDA events after a synchronize; where
`bench.py` loops K applications inside one dispatch, K applications are
queued back to back between the two events. Proofs are timed on the host
clock and closed by a synchronize. The best of the same number of
iterations counts. On the CPU the helpers use `time.perf_counter`.

Budget: a watchdog ends the run with exit code 0 just before
`BENCH_BUDGET_S` seconds and prints a skip record for every planned metric
that has no value yet, so every planned metric is always recorded. A step
that raises prints skip records with the error, the run goes on, and the
script exits non-zero at the end.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "torch_port",
                      "miden_fib10_1024.json")
BASELINE_BUTTERFLIES_PER_S = 1.0e8
_P = (1 << 64) - (1 << 32) + 1


# ------------------------------------------------------------------ timing

def _is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def _seconds(fn, device) -> float:
    """Seconds fn() takes on `device`: CUDA events around the work it
    queues, or the host clock on the CPU."""
    if not _is_cuda(device):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) * 1e-3


def cuda_ms(fn, iters: int = 5, device="cuda") -> float:
    """Mean milliseconds of fn() over `iters` runs queued back to back,
    after one warm-up."""
    fn()

    def runs():
        for _ in range(iters):
            fn()
    return _seconds(runs, device) * 1e3 / iters


def host_ms(fn, device="cuda") -> float:
    """Milliseconds of fn() on the host clock, closed by a synchronize."""
    return _host_seconds(fn, device)[1] * 1e3


def _host_seconds(fn, device):
    if _is_cuda(device):
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if _is_cuda(device):
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _bench(fn, *args, warmup=2, iters=5, device="cuda") -> float:
    """Best seconds of one fn(*args) over `iters` runs."""
    for _ in range(warmup):
        fn(*args)
    return min(_seconds(lambda: fn(*args), device) for _ in range(iters))


def _bench_loop(fn, x, K=8, iters=3, device="cuda") -> float:
    """Best seconds of one application when K are chained, v = fn(v)."""
    def rep():
        v = x
        for _ in range(K):
            v = fn(v)
        return v

    rep()
    rep()
    return min(_seconds(rep, device) for _ in range(iters)) / K


def draw_felts(rng, shape, device) -> torch.Tensor:
    """Canonical field elements drawn as `bench.py` draws them."""
    from aero_tpu_torch.field import from_u64
    return from_u64(rng.integers(0, _P, size=shape, dtype=np.uint64), device)


# ----------------------------------------------------------- kernel-level

class NttBench(NamedTuple):
    rate: float             # butterflies per second
    dt: float               # seconds per pipeline
    butterflies: int
    out: torch.Tensor       # one application of the pipeline


def bench_ntt(log_n=18, cols=8, log_blowup=3, device=None) -> NttBench:
    """Batched column iNTT + coset LDE, folded back to n points."""
    from aero_tpu_torch._device import resolve_device
    from aero_tpu_torch.ntt import intt, lde
    device = resolve_device(device)
    n = 1 << log_n
    m = n << log_blowup
    evals = draw_felts(np.random.default_rng(0), (cols, n), device)

    def pipeline(x):
        return lde(intt(x), log_blowup)[..., :n]

    dt = _bench_loop(pipeline, evals, K=4, device=device)
    butterflies = cols * (n // 2 * log_n + m // 2 * (log_n + log_blowup))
    return NttBench(butterflies / dt, dt, butterflies, pipeline(evals))


class HashBench(NamedTuple):
    rate: float             # leaves per second
    dt: float
    digests: torch.Tensor   # (8, leaves) u32 words


def bench_hash(log_leaves=20, row_width=72, device=None) -> HashBench:
    """Leaf hashing of 2^log_leaves rows of row_width felts."""
    from aero_tpu_torch._device import resolve_device
    from aero_tpu_torch.hash.blake2s_cuda import hash_columns
    device = resolve_device(device)
    n = 1 << log_leaves
    cols = draw_felts(np.random.default_rng(1), (row_width, n), device)
    dt = _bench(hash_columns, cols, warmup=1, iters=3, device=device)
    return HashBench(n / dt, dt, hash_columns(cols))


class MerkleBench(NamedTuple):
    rate: float             # leaves per second
    dt: float
    root: bytes


def bench_merkle(log_leaves=20, row_width=72, device=None) -> MerkleBench:
    """Full commit: leaf hashing and every tree level up to the root."""
    from aero_tpu_torch._device import resolve_device
    from aero_tpu_torch.merkle import commit_columns
    device = resolve_device(device)
    n = 1 << log_leaves
    cols = draw_felts(np.random.default_rng(1), (row_width, n), device)

    def commit(c):
        return commit_columns(c).root

    dt = _bench(commit, cols, warmup=1, iters=3, device=device)
    return MerkleBench(n / dt, dt, commit(cols))


class MulBench(NamedTuple):
    rate: float             # multiplies per second
    dt: float
    out: torch.Tensor       # v * v


def bench_mul(log_n=21, device=None) -> MulBench:
    from aero_tpu_torch._device import resolve_device
    from aero_tpu_torch.field import mul
    device = resolve_device(device)
    n = 1 << log_n
    a = draw_felts(np.random.default_rng(2), (n,), device)
    dt = _bench_loop(lambda v: mul(v, v), a, K=16, device=device)
    return MulBench(n / dt, dt, mul(a, a))


def mul_launches(log_n=21, device=None):
    """Device kernels one `field.mul` launches, counted by `torch.profiler`;
    None where the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile
    from aero_tpu_torch._device import resolve_device
    from aero_tpu_torch.field import mul
    device = resolve_device(device)
    a = draw_felts(np.random.default_rng(2), (1 << log_n,), device)
    mul(a, a)
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mul(a, a)
        torch.cuda.synchronize(device)
    return _device_kernels(prof)[0] or None


class LdeBench(NamedTuple):
    rate: float             # butterflies per second
    dt: float
    butterflies: int
    out: torch.Tensor       # (blowup, n): coset t in row t


def bench_lde_2e24(log_n=24, log_blowup=3, device=None) -> LdeBench:
    """Coset LDE of one 2^log_n-coefficient polynomial, the cosets batched
    as the leading axis of one size-n NTT of the polynomial scaled by
    (offset * w_m^t)^i in row t. The scales are made on the device.

    Once, outside the timed window, the same values are computed as
    `ntt.lde`'s single transform of n << log_blowup points, and the two
    results are held equal: out[t, i] == lde[blowup * i + t]."""
    from aero_tpu_torch._device import resolve_device
    from aero_tpu_torch.field import (from_u64, mul, power_series,
                                      power_series_rows)
    from aero_tpu_torch.ntt import lde, ntt
    from aero_tpu_torch.spec import field as F
    device = resolve_device(device)
    n = 1 << log_n
    m = n << log_blowup
    blowup = 1 << log_blowup
    polys = draw_felts(np.random.default_rng(3), (1, n), device)
    w_m = F.get_root_of_unity(m.bit_length() - 1)
    bases = power_series(w_m, blowup, scale=F.DOMAIN_OFFSET, device=device)
    scales = power_series_rows(bases, n)                    # (blowup, n)

    def full(p, sc):
        return ntt(mul(p.expand_as(sc), sc))

    dt = _bench(full, polys, scales, warmup=1, iters=2, device=device)
    out = full(polys, scales)
    del scales
    whole = lde(polys, log_blowup)                          # (1, m)
    if not torch.equal(whole.reshape(n, blowup), out.t()):
        raise RuntimeError(f"lde of 2^{log_n} coefficients at blowup "
                           f"{blowup}: the batched cosets and the single "
                           f"size-{m} transform disagree")
    butterflies = (m // 2) * (log_n + log_blowup)
    return LdeBench(butterflies / dt, dt, butterflies, out)


# ------------------------------------------------------------------ proofs

class ProofRun(NamedTuple):
    """One timed `prover.prove`."""
    seconds: float
    proof: object           # spec.proof.StarkProof
    launches: dict          # kernel launches of this proof
    spans: dict             # seconds per prover stage
    peak_bytes: int         # peak device memory (0 on the CPU)


class Prepared(NamedTuple):
    """A program executed and ready to prove."""
    src: str
    air: object
    trace: torch.Tensor     # (width, rows) on the device
    pub: object
    rows: int
    seconds: float          # VM run, public inputs, AIR, trace to the device


def _launch_modules():
    from aero_tpu_torch.field import gl_cuda
    from aero_tpu_torch.hash import blake2s_cuda
    from aero_tpu_torch.ntt import ntt_cuda
    return ntt_cuda, blake2s_cuda, gl_cuda


def _prepare(src, inputs, min_rows, grind, device) -> Prepared:
    from aero_tpu_torch.air.miden import MidenAir, make_public_inputs
    from aero_tpu_torch.field import from_u64
    from aero_tpu_torch.spec.proof import ProofOptions
    from aero_tpu_torch.vm import execute_full, program_hash

    def setup():
        trace, out_stack, overflow = execute_full(
            src, list(inputs), min_rows=min_rows, max_rows=1 << 23)
        pub = make_public_inputs(program_hash(src), list(inputs), out_stack,
                                 overflow=overflow)
        opts = ProofOptions(num_queries=27, blowup_factor=8,
                            grinding_factor=grind)
        air = MidenAir(trace.shape[1], pub, opts, program=src)
        return air, from_u64(trace, device), pub, trace.shape[1]

    if _is_cuda(device):
        from aero_tpu_torch import _build
        _build.load()                # the kernels' build is no part of a proof
    (air, gtrace, pub, rows), dt = _host_seconds(setup, device)
    return Prepared(src, air, gtrace, pub, rows, dt)


def _timed_prove(prep: Prepared) -> ProofRun:
    """One proof on the host clock, closed by a synchronize; the launch
    counts, the tracer and the peak-memory mark are reset just before."""
    from aero_tpu_torch.prover import STAGES, prove
    from aero_tpu_torch.utils import get_tracer
    device = prep.trace.device
    tracer = get_tracer()
    mods = _launch_modules()
    for m in mods:
        m.reset_launches()
    tracer.reset()
    if _is_cuda(device):
        torch.cuda.reset_peak_memory_stats(device)
    proof, dt = _host_seconds(
        lambda: prove(prep.air, prep.trace, prep.pub), device)
    launches = {k: v for m in mods for k, v in m.LAUNCHES.items()}
    spans = {s: sum(r.duration_s for r in tracer.records if r.name == s)
             for s in STAGES}
    peak = torch.cuda.max_memory_allocated(device) if _is_cuda(device) else 0
    return ProofRun(dt, proof, launches, spans, peak)


def verify_proof(prep: Prepared, proof) -> None:
    """The port's spec verifier on a proof of `prep`; raises on a defect."""
    from aero_tpu_torch.spec.verifier import verify
    verify(proof, prep.pub, air=prep.air)


class ProofOnce(NamedTuple):
    dt: float
    size: int
    rows: int
    run: ProofRun
    prep: Prepared


def _prove_once(src, inputs, min_rows, grind, warm=True,
                device=None) -> ProofOnce:
    from aero_tpu_torch._device import resolve_device
    prep = _prepare(src, inputs, min_rows, grind, resolve_device(device))
    if warm:
        _timed_prove(prep)           # the first proof of a process pays more
    run = _timed_prove(prep)
    return ProofOnce(run.seconds, len(run.proof.to_bytes()), prep.rows, run,
                     prep)


class ProofBench(NamedTuple):
    dt: float
    size: int
    once: ProofOnce


def bench_proof(min_rows=1 << 10, grind=16, device=None) -> ProofBench:
    """End-to-end Miden fib proof wall clock at the golden parameters
    (2^10-row 72+9-column trace, 27 queries, blowup 8, 16-bit grinding,
    blake2s): proved once to warm, the second proof is timed."""
    from aero_tpu_torch.vm import fibonacci_source
    once = _prove_once(fibonacci_source(10), [0, 1], min_rows, grind,
                       device=device)
    return ProofBench(once.dt, once.size, once)


def long_fib_source(n_iters: int) -> str:
    """Counter-driven fib loop: ~12 trace rows/iteration with a tiny ROM
    (a `repeat.N` unroll would blow the program ROM up to N entries).
    Stack: [counter, a, b, ...]."""
    return f"""
    begin
        push.{n_iters}
        dup.0 push.0 neq
        while.true
            movdn.2  swap dup.1 add  movup.2    # fib step under counter
            push.1 sub
            dup.0 push.0 neq
        end
    end
    """


class ScaleBench(NamedTuple):
    steady_dt: float
    cold_dt: float
    size: int
    cold: ProofRun
    steady: ProofRun
    prep: Prepared


def bench_proof_scale(log_rows=20, grind=16, device=None) -> ScaleBench:
    """Miden proofs over a 2^log_rows-row trace of real execution (not
    padding), 27 queries, blowup 8, blake2s. The first proof in the process
    is the cold one, the second the steady one of a resident prover."""
    from aero_tpu_torch._device import resolve_device
    n_iters = ((1 << log_rows) - 64) // 12
    prep = _prepare(long_fib_source(n_iters), [0, 1], 1 << log_rows, grind,
                    resolve_device(device))
    assert prep.rows == 1 << log_rows, f"trace padded to {prep.rows}"
    cold = _timed_prove(prep)
    steady = _timed_prove(prep)
    return ScaleBench(steady.seconds, cold.seconds,
                      len(steady.proof.to_bytes()), cold, steady, prep)


# ---------------------------------------------------------------- profiling

def _device_kernels(prof):
    """(launches, device seconds, rows by device time) of a finished
    `torch.profiler` profile: (name, launches, seconds) for each kernel."""
    rows = []
    for e in prof.key_averages():
        # the rows of the device's own events; the rows of the host
        # operators repeat their kernels' time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0:
            rows.append((e.key, e.count, us * 1e-6))
    rows.sort(key=lambda r: -r[2])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows


# ----------------------------------------------------------- budget runner

BENCH_BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", 1500))
# seconds a step wants left before it starts, as `bench.py` holds back its
# long steps; on the card: VM run + two 2^20-row proofs + verification,
# two 1024-row proofs, the 2^24 LDE with its 2^27 check
NEED_S = {"scale": 120.0, "proof": 30.0, "lde24": 60.0}
PLANNED = ("goldilocks_ntt_butterflies_per_s_per_chip",
           "merkle_commit_2e20_leaves_s",
           "lde_2e24_butterflies_per_s",
           "fib_2e10_proof_wall_clock",
           "fib_2e10_proof_size",
           "miden_2e20_row_proof_wall_clock",
           "miden_2e20_row_proof_cold_wall_clock")
EXTRA = ("blake2s_leaf_hashes_per_s_2e20x72", "goldilocks_mul_per_s")
SIZES = {"ntt": dict(log_n=18, cols=8, log_blowup=3),
         "merkle": dict(log_leaves=20, row_width=72),
         "scale": dict(log_rows=20, grind=16),
         "proof": dict(min_rows=1 << 10, grind=16),
         "lde24": dict(log_n=24, log_blowup=3),
         "hash": dict(log_leaves=20, row_width=72),
         "mul": dict(log_n=21)}

_T0 = time.monotonic()
_PRINTED: set = set()
_PLAN: list = []
_FAILED: list = []


def _emit(metric: str, value, unit: str, vs_baseline=None):
    _PRINTED.add(metric)
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      "vs_baseline": vs_baseline}), flush=True)


def _skip(metric: str, why: str):
    _PRINTED.add(metric)
    print(json.dumps({"metric": metric, "value": None, "unit": "skipped",
                      "vs_baseline": None, "skipped": why}), flush=True)


def _remaining() -> float:
    return BENCH_BUDGET_S - (time.monotonic() - _T0)


def _watchdog(after_s=None):
    def fire():
        for m in _PLAN:
            if m not in _PRINTED:
                _skip(m, "bench budget exhausted (watchdog)")
        sys.stdout.flush()
        os._exit(0)

    if after_s is None:
        after_s = max(5.0, _remaining() - 10.0)
    t = threading.Timer(after_s, fire)
    t.daemon = True
    t.start()
    return t


def _guard(metric_names, fn, need_s=0.0):
    """Run one bench step. Without `need_s` seconds of budget left it is
    skipped; if it raises, its metrics get skip records that carry the
    error, the failure is kept for the exit code and the run goes on."""
    if _remaining() <= need_s:
        for m in metric_names:
            _skip(m, "insufficient budget")
        return
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        _FAILED.append((tuple(metric_names), e))
        for m in metric_names:
            if m not in _PRINTED:
                _skip(m, f"{type(e).__name__}: {e}"[:200])


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]


def emit_ntt(r: NttBench):
    print(f"goldilocks_ntt: {r.dt:.9f} s a pipeline, {r.butterflies} "
          "butterflies", flush=True)
    _emit("goldilocks_ntt_butterflies_per_s_per_chip", round(r.rate, 1),
          "butterflies/s", round(r.rate / BASELINE_BUTTERFLIES_PER_S, 3))


def emit_merkle(r: MerkleBench):
    print(f"merkle_commit: {r.rate:.1f} leaves/s, root {r.root.hex()}",
          flush=True)
    _emit("merkle_commit_2e20_leaves_s", round(r.dt, 6), "s")


def emit_scale(r: ScaleBench):
    for what, run in (("cold", r.cold), ("steady", r.steady)):
        print(f"miden_2e20_row_proof {what}: {run.seconds:.3f} s, peak device "
              f"memory {run.peak_bytes} B, launches "
              f"{json.dumps(run.launches)}, stage seconds "
              f"{json.dumps(run.spans)}", flush=True)
    print(f"miden_2e20_row_proof: set-up {r.prep.seconds:.3f} s, "
          f"{r.size} B, sha256 "
          f"{hashlib.sha256(r.steady.proof.to_bytes()).hexdigest()}",
          flush=True)
    _emit("miden_2e20_row_proof_wall_clock", round(r.steady_dt, 3), "s")
    _emit("miden_2e20_row_proof_cold_wall_clock", round(r.cold_dt, 3), "s")


def emit_proof(r: ProofBench):
    _emit("fib_2e10_proof_wall_clock", round(r.dt, 3), "s")
    _emit("fib_2e10_proof_size", r.size, "bytes", round(r.size / 50303, 3))


def emit_lde24(r: LdeBench):
    print(f"lde_2e24: {r.dt:.6f} s an LDE, {r.butterflies} butterflies; "
          "equal to the single padded transform", flush=True)
    _emit("lde_2e24_butterflies_per_s", round(r.rate, 1), "butterflies/s",
          round(r.rate / BASELINE_BUTTERFLIES_PER_S, 3))


def emit_hash(r: HashBench):
    print(f"blake2s_leaf_hashes: {r.dt:.9f} s a call", flush=True)
    _emit("blake2s_leaf_hashes_per_s_2e20x72", round(r.rate, 1), "hashes/s")


def emit_mul(r: MulBench, launches=None):
    print(f"goldilocks_mul: {r.dt:.9f} s a multiply of {r.out.numel()} "
          "elements, "
          + (f"{launches} device kernels a multiply (torch.profiler)"
             if launches else "kernels a multiply not measured"), flush=True)
    _emit("goldilocks_mul_per_s", round(r.rate, 1), "muls/s")


def check_golden(once: ProofOnce) -> str:
    """Verify the golden-parameter proof and hold its bytes to the
    committed digest; returns the sha256."""
    with open(GOLDEN) as f:
        want = json.load(f)
    data = once.run.proof.to_bytes()
    digest = hashlib.sha256(data).hexdigest()
    if digest != want["sha256"] or len(data) != want["length"]:
        raise RuntimeError(f"golden proof is {len(data)} B with sha256 "
                           f"{digest}, committed {want['length']} B "
                           f"{want['sha256']}")
    verify_proof(once.prep, once.run.proof)
    return digest


def main(argv=None, device=None, sizes=None) -> int:
    global _T0
    from aero_tpu_torch._device import resolve_device
    _T0 = time.monotonic()
    argv = sys.argv[1:] if argv is None else argv
    device = resolve_device(device)
    sz = {k: dict(v) for k, v in SIZES.items()}
    for k, v in (sizes or {}).items():
        sz[k].update(v)
    if _is_cuda(device):
        print(card_line(), flush=True)
    del _PLAN[:], _FAILED[:]
    _PRINTED.clear()
    _PLAN.extend(PLANNED)
    if "--all" in argv:
        _PLAN.extend(EXTRA)
    dog = _watchdog()

    _guard(PLANNED[:1], lambda: emit_ntt(bench_ntt(device=device,
                                                   **sz["ntt"])))
    _guard(PLANNED[1:2], lambda: emit_merkle(bench_merkle(device=device,
                                                          **sz["merkle"])))

    # the end-to-end proofs before the entries that are cheaper to lose
    def step_scale():
        r = bench_proof_scale(device=device, **sz["scale"])
        if r.steady.proof.to_bytes() != r.cold.proof.to_bytes():
            raise RuntimeError("the steady proof differs from the cold one")
        verify_proof(r.prep, r.steady.proof)
        emit_scale(r)
    _guard(PLANNED[5:7], step_scale, NEED_S["scale"])

    def step_proof():
        r = bench_proof(device=device, **sz["proof"])
        if sz["proof"] == SIZES["proof"]:
            print(f"fib_2e10_proof: sha256 {check_golden(r.once)} equals the "
                  "committed digest; verified", flush=True)
        else:
            verify_proof(r.once.prep, r.once.run.proof)
        emit_proof(r)
    _guard(PLANNED[3:5], step_proof, NEED_S["proof"])

    _guard(PLANNED[2:3], lambda: emit_lde24(bench_lde_2e24(device=device,
                                                           **sz["lde24"])),
           NEED_S["lde24"])

    if "--all" in argv:
        _guard(EXTRA[:1], lambda: emit_hash(bench_hash(device=device,
                                                       **sz["hash"])))

        def step_mul():
            r = bench_mul(device=device, **sz["mul"])
            emit_mul(r, mul_launches(device=device, **sz["mul"])
                     if _is_cuda(device) else None)
        _guard(EXTRA[1:], step_mul)

    dog.cancel()
    for names, e in _FAILED:
        print(f"bench_gpu: {', '.join(names)} failed: {type(e).__name__}: {e}",
              file=sys.stderr)
    return 1 if _FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
