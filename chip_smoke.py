#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (`aero_tpu_torch`).

    python3 chip_smoke.py

Needs one CUDA card and `nvcc`; builds the kernels from `aero_tpu_torch/csrc`
at first use. Set-up, then four phases, each of which raises on a failed
check (so the script exits non-zero):

  0. card name and power limit, torch/CUDA versions, kernel and VM build
     times;
  1. blake2s kernel vs its plain PyTorch version vs hashlib at main-path
     shapes, and the PoW grind vs a host scan;
  2. NTT kernel vs its plain versions, round trips, and a coset LDE;
  3. the golden-parameter Miden proof (fib(10), 1024 rows, default
     options) through `aero_tpu_torch.sdk.prove` on the card: its sha256
     must equal the committed `aero_tpu` digest, and it must verify;
  4. a 2^20-row Miden proof of a real execution trace (2^23-point LDE
     domain): it must verify; prints stage times, wall clocks, peak memory.

Kernel comparisons are exact (tolerance 0): finite-field and hash
arithmetic. Launch counters are reset right before each proof and read
right after it. The second-to-last line is a JSON object with one entry per
kernel of the proof path; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "torch_port",
                      "miden_fib10_1024.json")
SEED = 20260
NTT_SRC = "aero_tpu_torch/csrc/ntt.cu"
B2S_SRC = "aero_tpu_torch/csrc/blake2s.cu"
NTT_TPU = "aero_tpu/ntt/ntt_pallas.py:131"
B2S_TPU = "aero_tpu/hash/blake2s_pallas.py:36"


def long_fib_source(n_iters: int) -> str:
    """Counter-driven fib loop, ~12 trace rows per iteration with a tiny
    program ROM (the scale workload of `bench.py`, carried as text)."""
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


def log(*args) -> None:
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, iters: int = 5) -> float:
    """Mean device time of fn() over `iters` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over elements, as unsigned 64-bit integers."""
    diff = (a != b).reshape(-1)
    if not bool(diff.any()):
        return 0
    x = a.reshape(-1)[diff].cpu().numpy().view(np.uint64)
    y = b.reshape(-1)[diff].cpu().numpy().view(np.uint64)
    return max(abs(int(u) - int(v)) for u, v in zip(x, y))


def words_tensor(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, np.uint64)
                            .view(np.int64)).to(device)


def phase_blake2s(dev, rng, kernels) -> None:
    from aero_tpu.spec.hashing import hash_elements, merge_with_int
    from aero_tpu_torch.field import from_u64, to_u64
    from aero_tpu_torch.hash import blake2s_cuda as bc

    for nbytes in (40, 64, 2304):
        W = -(-nbytes // 4)
        msgs = rng.integers(0, 2**32, size=(4096, W), dtype=np.uint64)
        t = words_tensor(msgs.T, dev)
        k = bc.blake2s_words(t, nbytes)
        p = bc.blake2s_words_plain(t, nbytes)
        check(torch.equal(k, p), f"blake2s_words {nbytes} B kernel == plain")
        kh = k.cpu().numpy()
        for i in range(0, 4096, 97):
            ref = hashlib.blake2s(msgs[i].astype("<u4").tobytes()[:nbytes])
            check(kh[:, i].astype("<u4").tobytes() == ref.digest(),
                  f"blake2s_words {nbytes} B == hashlib")
        log(f"[phase 1] blake2s_words {nbytes:>4} B x 4096: kernel == plain"
            " == hashlib")

    for w in (72, 9, 8):
        vals = rng.integers(0, 2**64 - 1, size=(w, 1 << 16), dtype=np.uint64)
        cols = from_u64(vals, dev)
        k = bc.hash_columns(cols)
        p = bc.hash_columns_plain(cols)
        err = max_abs_err(k, p)
        check(err == 0, f"hash_columns w={w} kernel == plain")
        host = to_u64(cols)
        kh = k.cpu().numpy()
        for i in range(0, 1 << 16, 4099):
            ref = hash_elements([int(v) for v in host[:, i]])
            check(kh[:, i].astype("<u4").tobytes() == ref,
                  f"hash_columns w={w} == spec hash_elements")
        ms = cuda_ms(lambda: bc.hash_columns(cols))
        pms = cuda_ms(lambda: bc.hash_columns_plain(cols), iters=1)
        log(f"[phase 1] hash_columns {w} x 2^16: kernel {ms:.3f} ms, "
            f"plain {pms:.3f} ms, max_abs_err {err}")
        if w == 72:
            kernels["blake2s_hash_columns"].update(
                max_abs_err=err, ms=ms, plain_ms=pms)

    d = words_tensor(rng.integers(0, 2**32, size=(8, 1 << 17),
                                  dtype=np.uint64), dev)
    k = bc.merge_level(d)
    p = bc.merge_level_plain(d)
    err = max_abs_err(k, p)
    check(err == 0, "merge_level kernel == plain")
    dh, kh = d.cpu().numpy(), k.cpu().numpy()
    for i in range(0, 1 << 16, 1021):
        ref = hashlib.blake2s(dh[:, 2 * i].astype("<u4").tobytes()
                              + dh[:, 2 * i + 1].astype("<u4").tobytes())
        check(kh[:, i].astype("<u4").tobytes() == ref.digest(),
              "merge_level == hashlib")
    ms = cuda_ms(lambda: bc.merge_level(d))
    pms = cuda_ms(lambda: bc.merge_level_plain(d), iters=1)
    log(f"[phase 1] merge_level 2^17 -> 2^16: kernel {ms:.3f} ms, "
        f"plain {pms:.3f} ms, max_abs_err {err}")
    kernels["blake2s_merge_level"].update(max_abs_err=err, ms=ms,
                                          plain_ms=pms)

    for s in range(2):
        seed = hashlib.blake2s(f"chip-smoke-seed-{s}".encode()).digest()
        nonce = bc.grind_pow(seed, 16, dev)
        plain = bc.grind_pow_plain(seed, 16, dev)
        host = 0
        while 128 - int.from_bytes(merge_with_int(seed, host)[:16],
                                   "big").bit_length() < 16:
            host += 1
        check(nonce == plain == host, f"grind_pow seed {s}: kernel {nonce},"
              f" plain {plain}, host scan {host}")
        ms = host_ms(lambda: bc.grind_pow(seed, 16, dev))
        pms = host_ms(lambda: bc.grind_pow_plain(seed, 16, dev))
        log(f"[phase 1] grind_pow 16 bits seed {s}: nonce {nonce} (kernel =="
            f" plain == host scan); kernel {ms:.3f} ms, plain {pms:.3f} ms")
        if s == 0:
            kernels["blake2s_grind_pow"].update(
                max_abs_err=abs(nonce - host), ms=ms, plain_ms=pms)


def phase_ntt(dev, rng, kernels) -> None:
    from aero_tpu_torch.field import P, from_u64
    from aero_tpu_torch.ntt import coset_pad, lde, ntt_plain
    from aero_tpu_torch.ntt.ntt_cuda import ntt_cuda, ntt_four_step_plain

    for logn in range(1, 17):
        x = from_u64(rng.integers(0, P, size=(8, 1 << logn),
                                  dtype=np.uint64), dev)
        for inv in (False, True):
            k = ntt_cuda(x, inv)
            check(torch.equal(k, ntt_four_step_plain(x, inv)),
                  f"ntt 2^{logn} inv={inv} kernel == four-step plain")
            check(torch.equal(k, ntt_plain(x, inv)),
                  f"ntt 2^{logn} inv={inv} kernel == radix-2 plain")
    log("[phase 2] ntt/intt 2^1..2^16 x 8: kernel == both plain versions")

    for cols, logn in ((8, 20), (1, 23)):
        x = from_u64(rng.integers(0, P, size=(cols, 1 << logn),
                                  dtype=np.uint64), dev)
        check(torch.equal(ntt_cuda(ntt_cuda(x), True), x),
              f"intt(ntt(x)) == x at 2^{logn} x {cols}")
        log(f"[phase 2] round trip 2^{logn} x {cols}: exact")

    x = from_u64(rng.integers(0, P, size=(8, 1 << 23), dtype=np.uint64), dev)
    k = ntt_cuda(x)
    p = ntt_four_step_plain(x, False)
    err = max_abs_err(k, p)
    check(err == 0, "ntt 2^23 x 8 kernel == four-step plain")
    ms = cuda_ms(lambda: ntt_cuda(x))
    pms = cuda_ms(lambda: ntt_four_step_plain(x, False), iters=1)
    r2ms = cuda_ms(lambda: ntt_plain(x), iters=1)
    log(f"[phase 2] ntt 2^23 x 8 (the LDE transform of 8 columns): kernel "
        f"{ms:.3f} ms, four-step plain {pms:.3f} ms, radix-2 plain "
        f"{r2ms:.3f} ms, max_abs_err {err}")
    kernels["gl_colntt"].update(max_abs_err=err, ms=ms, plain_ms=pms)
    del x, k, p

    c = from_u64(rng.integers(0, P, size=(8, 1 << 20), dtype=np.uint64), dev)
    k = lde(c, 3)
    p = ntt_plain(coset_pad(c, 3))
    check(torch.equal(k, p), "lde (8, 2^20) x8 kernel path == plain")
    ms = cuda_ms(lambda: lde(c, 3))
    pms = cuda_ms(lambda: ntt_plain(coset_pad(c, 3)), iters=1)
    log(f"[phase 2] lde (8, 2^20) blowup 8: kernel path {ms:.3f} ms, plain "
        f"{pms:.3f} ms, exact")


def _launches():
    from aero_tpu_torch.hash import blake2s_cuda as bc
    from aero_tpu_torch.ntt import ntt_cuda as nc
    return {**nc.LAUNCHES, **bc.LAUNCHES}


def _reset_launches():
    from aero_tpu_torch.hash import blake2s_cuda as bc
    from aero_tpu_torch.ntt import ntt_cuda as nc
    nc.reset_launches()
    bc.reset_launches()


def _prove(src: str, min_rows: int, dev):
    from aero_tpu.sdk.pb import aero_pb2 as pb
    from aero_tpu_torch import sdk
    program = pb.MidenProgram(program=src)
    inputs = pb.MidenProgramInputs(stack_init=[1, 0])   # top-first [0, 1]
    return sdk.prove(program, inputs, min_rows=min_rows, device=dev)


def _verify(res, src: str) -> None:
    from aero_tpu.sdk import DEFAULT_OPTIONS
    from aero_tpu.spec.verifier import verify
    from aero_tpu_torch.air.miden import MidenAir
    proof, pub = res.native_proof, res.native_pub
    air = MidenAir(proof.context.trace_length, pub, DEFAULT_OPTIONS,
                   program=src)
    verify(proof, pub, air=air)


PATH_KERNELS = ("gl_colntt", "blake2s_hash_columns", "blake2s_merge_level",
                "blake2s_grind_pow")


def phase_golden(dev) -> None:
    from aero_tpu.vm import fibonacci_source
    with open(GOLDEN) as f:
        want = json.load(f)
    src = fibonacci_source(10)
    _reset_launches()
    t0 = time.perf_counter()
    res = _prove(src, 1024, dev)
    dt = time.perf_counter() - t0
    counts = _launches()
    data = res.native_proof.to_bytes()
    digest = hashlib.sha256(data).hexdigest()
    log(f"[phase 3] golden proof: {len(data)} B in {dt:.3f} s, sha256 "
        f"{digest}; launches {counts}")
    check(digest == want["sha256"] and len(data) == want["length"],
          "golden proof bytes == aero_tpu digest")
    _verify(res, src)
    log("[phase 3] golden proof verifies under spec.verifier (air=port air)")
    for name in PATH_KERNELS:
        check(counts[name] > 0, f"{name} launched in the golden proof")


def phase_scale(dev, kernels) -> None:
    from aero_tpu.utils import get_tracer
    from aero_tpu_torch.prover import STAGES
    SPANS = ("execute",) + STAGES + ("to_pb",)
    n_iters = ((1 << 20) - 64) // 12
    src = long_fib_source(n_iters)
    tracer = get_tracer()

    def timed_proof():
        tracer.reset()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = _prove(src, 1 << 20, dev)
        return res, time.perf_counter() - t0

    _reset_launches()
    res, cold = timed_proof()
    counts = _launches()
    stages = {s: tracer.total(s) for s in SPANS}
    check(res.native_proof.context.trace_length == 1 << 20,
          "scale trace is 2^20 rows")
    peak = torch.cuda.max_memory_allocated()
    size = len(res.native_proof.to_bytes())
    log(f"[phase 4] 2^20-row proof (cold): {cold:.3f} s, {size} B, peak "
        f"device memory {peak} B; launches {counts}")
    log("[phase 4] cold span seconds: " + json.dumps(stages))
    for name in PATH_KERNELS:
        check(counts[name] > 0, f"{name} launched in the 2^20-row proof")
        kernels[name]["launches"] = counts[name]
    t0 = time.perf_counter()
    _verify(res, src)
    log(f"[phase 4] 2^20-row proof verifies under spec.verifier (air=port"
        f" air) in {time.perf_counter() - t0:.3f} s")
    res2, warm = timed_proof()
    stages = {s: tracer.total(s) for s in SPANS}
    check(res2.native_proof.to_bytes() == res.native_proof.to_bytes(),
          "warm proof == cold proof")
    log(f"[phase 4] 2^20-row proof (warm): {warm:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated()} B")
    log("[phase 4] warm span seconds: " + json.dumps(stages))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from aero_tpu_torch import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[set-up] {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"[set-up] kernels built in {time.perf_counter() - t0:.3f} s: {lib}")
    # the C++ VM builds itself at its first run; keep that out of phase 3
    from aero_tpu.vm import execute_full, fibonacci_source
    t0 = time.perf_counter()
    execute_full(fibonacci_source(1), [0, 1], min_rows=64)
    log(f"[set-up] VM ready (built at first run) in "
        f"{time.perf_counter() - t0:.3f} s")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    kernels = {
        "gl_colntt": dict(route="cuda", source=NTT_SRC, replaces=NTT_TPU),
        "blake2s_hash_columns": dict(route="cuda", source=B2S_SRC,
                                     replaces=B2S_TPU),
        "blake2s_merge_level": dict(route="cuda", source=B2S_SRC,
                                    replaces=B2S_TPU),
        "blake2s_grind_pow": dict(route="cuda", source=B2S_SRC,
                                  replaces=B2S_TPU),
    }
    phase_blake2s(dev, rng, kernels)
    phase_ntt(dev, rng, kernels)
    phase_golden(dev)
    phase_scale(dev, kernels)

    print(json.dumps({"kernels": [
        {"name": name, "route": k["route"], "source": k["source"],
         "replaces": k["replaces"], "launches": k["launches"],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"]} for name, k in kernels.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
