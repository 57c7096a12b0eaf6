#!/usr/bin/env python3
"""On-card smoke run of the PyTorch + CUDA port (`aero_tpu_torch`).

    python3 chip_smoke.py [--proof-out FILE]

Needs one CUDA card, `nvcc` and `cuobjdump`; builds the kernels from
`aero_tpu_torch/csrc` and the C++ VM from `aero_tpu_torch/vm/core` at first
use. It imports the port and `bench_gpu.py` only. Set-up, then nine phases,
each of which raises on a failed check (so the script exits non-zero):

  0. card name, power limit and clocks, torch/CUDA versions, kernel and VM
     build times, instruction counts read from the kernels' SASS and those
     of one field op (`csrc/probe/field_ops.cu`, a cubin of its own);
  1. blake2s kernel vs its plain PyTorch version vs hashlib, and the PoW
     grind vs a host scan, at 2^16 leaves and at the shapes the 2^20-row
     proof launches (72 x 2^23 and 9 x 2^23 leaves, a 2^23 -> 2^22 level);
  2. NTT kernel vs its plain versions, round trips, the coset LDE route
     (`gl_colntt_lde`, then `gl_colntt`) at 2^10..2^20 coefficients x
     blowup 2..16, the 72 x 2^23 transform, the proof's main LDE (72 x
     2^20 at blowup 8) and its first pass alone (the LDE entry) against
     the plain rendering, and 1 x 2^24 -> 2^27 against the padded
     transform; 2b: the field
     kernels K1-K7
     (`csrc/field.cu`; K5 generated from MidenAir's constraints,
     `csrc/air_miden.cu`; K6 from its bus factors, `csrc/aux_miden.cu`;
     K7 `csrc/eval_multi.cu`) vs their plain versions at the 2^20-row
     proof's shapes, each timed beside its bound; K5 on that proof's
     fragment 0 and on its last (the next-row frame read in place, body
     and tail), also against the eager path (K1 a field op, then the
     plain merge), with its registers, warps an SM and the words it reads
     (the set-up fails if K5's merge kernel spills); K6 on that proof's trace, also
     against `_bus_row_factors` op by op on the card; K7 on its 72 + 9 + 8
     coefficient rows at three points, the rows read where they lie;
  3. the golden-parameter Miden proof (fib(10), 1024 rows, default
     options) through `aero_tpu_torch.sdk.prove` on the card: its sha256
     must equal the committed `aero_tpu` digest, and it must verify; then
     `bench_gpu.bench_proof` (one proof to warm, one timed), same digest;
  4. `bench_gpu.bench_proof_scale`: two 2^20-row Miden proofs of a real
     execution trace (2^23-point LDE domain), cold and steady, then the same
     program through `aero_tpu_torch.sdk.prove(min_rows=2^20)`: equal bytes
     all three, the SDK's must verify, and its launches are the ones the
     `kernels` line reports: one K6 launch, one K7 call (two launches), at
     most 178 K1 launches, and no `torch.roll` of the trace, no `torch.cat`
     of the coefficient rows or of a next-row frame (the last fragment's,
     read in place: `frames_in_place` 1 on the `frag_eval` span) and no
     zero-padded LDE input (`coset_pad`, `torch.zeros` of rows of 2^23) on
     the card; prints stage times, wall
     clocks, peak memory and sha256, which must equal the committed
     `tests/golden/torch_port/miden_2e20_rows.json` (`--proof-out FILE`
     writes the proof with its public inputs first);
  4b. the same program at each size of which `aero_tpu`'s proof is
     committed beside it (`miden_longfib_2e14.bin`, 2^14 rows, made on the
     CPU) through `sdk.prove`: byte for byte that proof (on a difference
     the first part that differs is named), and verified; each size's
     seconds, launches and peak device memory are printed beside the
     card's name and power limit; then the golden proof with constraint
     evaluation and DEEP in 8 fragments, the last one's next-row frame
     wrapping round the domain (the path of proofs from 2^18 rows on):
     `aero_tpu`'s digest, one K5 launch a fragment;
  5. the served path: a `SubmissionServer` on an ephemeral port accepts the
     2^20-row proof (same receipt twice) and the golden proof, refuses a
     tampered nonce and answers garbage with HTTP 400;
  6. the parser path: `generate_proof` on the card writes a .bin, the
     parser re-encodes it as Cairo memory and `cairo_sim` accepts it;
  7. the multi-device path: the dry-run pipeline of `parallel/` (`MidenAir`,
     72 + 9 columns, 112 constraints, blowup 8, folding 8) at 64 rows
     against the committed golden roots, at 2^14 rows the single device and
     world 1 on `nccl` (world 4 on `nccl` too where there are four cards)
     against `aero_tpu`'s roots there (`parallel/dryrun_golden_2e14.json`,
     made on the CPU), the single device at 2^18 rows
     (phase 8 repeats it), and at the main path's 2^20 rows (a real trace,
     a 2^23-point domain) against the single-device pipeline run on the
     card here. With one card the mesh is driven two ways and the lines say
     which: world 1 on `nccl` (every exchange a copy, every launch and
     reshape real), and world 4 as four processes sharing the card with the
     exchanges staged through pinned host memory and gloo, asked for by
     name (`exchange="host"`); with four cards world 4 on `nccl` as well,
     one card a rank, else a line says it did not run and how many cards
     there are. First each kernel is held against its plain version at
     every shape those runs hand it, the LDEs' column chunks at the widths
     `dist_ntt.chunk_cols` gives (K5 on the last fragment of 2^21- and
     2^23-point blocks, K6 on the traces of the aux builds in the runs'
     set-up). Each process runs the pipeline twice; prints the roots, each
     rank's seconds per stage of both passes, the bytes each kind of
     exchange moved, the launches per kernel and the set-up and pipeline
     peak device memory; a mismatch, a dead rank, a rank taking other
     chunk widths than those checked, world 1's pipeline peak above 1.25
     times the single device's or a host-shared world-4 rank's above 0.4
     times world 1's raises.
  8. the int8 tensor-core 4-step NTT (`ntt/ntt_mxu.py`; `torch._int_mm`, no
     hand-written kernel, so it has no row in the `kernels` line): `ntt_mxu`
     and `intt_mxu` equal to the NTT kernel at 2^6 x 3, 2^8 x 2, 2^10 x 2 x 4,
     2^13 x 8, 2^18 x 8 (tiles of 512, the schoolbook route) and 2^20 x 72
     (tiles of 1024, the Karatsuba route), and to `ntt_plain` up to 2^18; at
     the last two shapes the CUDA-event times of the int8 products alone,
     of the whole transform and of the NTT kernel, beside the products'
     bound (their multiply-adds over the card's dense int8 rate) and the
     peak device memory, and one product in both layouts of its second
     operand; the golden proof and the 2^18-row single-device dry
     run once more with every transform of 2^10..2^20 points patched
     through `ntt_mxu` here in the script, sha256 and roots unchanged; and
     `tools.card_check` in-process.
  9. transforms past 2^24 points (three passes of the NTT kernel): round
     trips at 2^25 and 2^27 points, 2^25 against the plain rendering, three
     levels with the pass limit lowered to 8 on a batch of rows; then
     `bench_gpu`'s kernel-level steps at their full shapes, each held
     against plain versions (`bench_ntt`, `bench_merkle`, `bench_hash`,
     `bench_mul`, `bench_lde_2e24`, which also holds the batched 2^24 LDE
     equal to `ntt.lde`'s single 2^27-point transform), each printing its
     metric record, and the proof records from the times of phases 3 and 4.

Kernel comparisons are exact (tolerance 0): finite-field and hash
arithmetic. Launch counters are reset right before each proof and read
right after it. Each kernel's bound is the larger of its bytes (inputs read
once, outputs written once) over 3.35 TB/s and its instructions (SASS
counts per compress or unit of a field kernel, by pipe, times the work of
the call) over what 132 SMs take at the card's maximum SM clock: 64
integer-ALU lanes, 64 multiply-add lanes and 128 scheduler slots each.
Where a bound counts the field ops a function needs (kernel 1 from its
shape alone, `_sass.ntt_field_ops`; K5, the scan, the batch inversion),
each op is priced at its own straight-line count, read from the field-op
probe (a multiply of kernel 1's by a twiddle +-2^e at the cheaper for the
call of the general multiply's count and that of the multiply by shifts,
`gl_mul_pow2`). The third-to-last line is
a JSON object with one entry per kernel of the proof path; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import torch

import bench_gpu
from bench_gpu import cuda_ms, host_ms, long_fib_source

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(HERE, "tests", "golden", "torch_port")
GOLDEN = os.path.join(GOLDEN_DIR, "miden_fib10_1024.json")
# the card's own 2^20-row proof (phase 4 keeps its sha256)
SCALE_DIGEST = os.path.join(GOLDEN_DIR, "miden_2e20_rows.json")
# aero_tpu's proofs of the scale program, `miden_longfib_2e<k>.bin` at 2^k
# rows for each k here, made on the CPU (`tests/test_torch_slice_scale.py`):
# phase 4b proves each size on the card
REFERENCE_PROOF = os.path.join(GOLDEN_DIR, "miden_longfib_2e{}")
REFERENCE_LOG_ROWS = (14,)
GOLDEN_LOG_FRAG = 10        # phase 4b: the golden proof's 2^13 points in 8
                            # fragments
SEED = 20260
NTT_SRC = "aero_tpu_torch/csrc/ntt.cu"
B2S_SRC = "aero_tpu_torch/csrc/blake2s.cu"
NTT_TPU = "aero_tpu/ntt/ntt_pallas.py:131"
B2S_TPU = "aero_tpu/hash/blake2s_pallas.py:36"
FIELD_SRC = "aero_tpu_torch/csrc/field.cu"
# the field kernels have no Pallas counterpart: where each stands in aero_tpu
FIELD_REPLACES = {
    "gl_elementwise": ("aero_tpu/field/jax_gl.py:210",
                       "no Pallas kernel: XLA's fusion of jax_gl.add / sub "
                       "/ mul / pow_loop (jax_gl.py:187-304) under jax.jit"),
    "gl_scan": ("aero_tpu/field/jax_gl.py:490",
                "no Pallas kernel: lax.associative_scan(mul / add) under "
                "jax.jit in gf_cumprod, gf_cumsum (jax_gl.py:490, :496); "
                "one launch, a single pass with decoupled look-back"),
    "gl_batch_inv": ("aero_tpu/field/jax_gl.py:309",
                     "no Pallas kernel: jax_gl.batch_inv under jax.jit, two "
                     "associative scans (:312, :343), flips, one inverse "
                     "and products; one call of three launches (tile "
                     "products, row factors, apply); bound by the "
                     "function's 16 B and 3 multiplies an element and one "
                     "inverse a row; the kernels move 24 B and do about "
                     "twice those multiplies"),
    "gl_deep_combine": ("aero_tpu/prover/prover.py:556",
                        "no Pallas kernel: _deep_core_jit "
                        "(prover.py:556-589)"),
}
# kernel K5: generated for each AIR class (aero_tpu_torch/air/codegen.py)
K5_SRC = "aero_tpu_torch/csrc/air_miden.cu"
K5_THREADS = 128               # csrc/frag_eval.cuh kFragThreads
K5_REPLACES = ("aero_tpu/prover/prover.py:407",
               "no Pallas kernel: XLA's fusion of jax.jit(frag_fn) "
               "(prover.py:407-446), MidenAir's 112 transition constraints "
               "and 46 assertions merged in one pass; generated from "
               "MidenAir.evaluate_transitions (csrc/air_miden_transitions."
               "cuh, csrc/frag_eval.cuh)")
# kernel K6: generated from MidenAir's row function (air/codegen.py)
K6_SRC = "aero_tpu_torch/csrc/aux_miden.cu"
K6_REPLACES = ("aero_tpu/air/miden.py:1073",
               "no Pallas kernel: XLA's fusion of _aux_factors_jit "
               "(miden.py:1073, _bus_row_factors :937 under jax.jit), "
               "MidenAir's eight bus factors a row in one pass, the next "
               "row read in place; generated from the port's "
               "_bus_row_factors (csrc/aux_miden_factors.cuh, "
               "csrc/frag_eval.cuh); the dry run builds its aux segment "
               "through it in its set-up, before its counts are reset")
K7_SRC = "aero_tpu_torch/csrc/eval_multi.cu"
K7_THREADS = 256               # csrc/eval_multi.cu kEvalThreads
K7_REPLACES = ("aero_tpu/field/jax_gl.py:456",
               "no Pallas kernel: XLA's fusion of _eval_multi_core and "
               "power_series_dyn (jax_gl.py:456, :437, under "
               "eval_polys_multi :464); one call of two launches (the "
               "blocks' partial sums, their fold); the dry run evaluates "
               "no OOD point")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
SMS = 132                      # streaming multiprocessors of an H100 SXM
LOG_LDE = 23                   # LDE domain of the 2^20-row proof
INT8_OPS_PER_S = 1979e12       # H100 SXM data sheet: dense int8 rate
MXU_LOGS = (10, 20)            # sizes phase 8 patches through ntt_mxu: both
                               # tiles at least 32 (no padding), up to the
                               # largest size the JAX package sends that way


def log(*args) -> None:
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms_queued(fn, iters: int, busy) -> float:
    """Mean device time of fn() over `iters` runs enqueued behind `busy()`,
    device work that outlasts the enqueuing: the runs then follow one
    another on the card and the host's enqueue rate does not count."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    busy()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def device_felts(shape, gen, dev) -> torch.Tensor:
    """Seeded canonical felts made on the card: hi < 2^32 - 1 keeps every
    value below p = 2^64 - 2^32 + 1."""
    hi = torch.randint(0, (1 << 32) - 1, shape, generator=gen, device=dev,
                       dtype=torch.int64)
    lo = torch.randint(0, 1 << 32, shape, generator=gen, device=dev,
                       dtype=torch.int64)
    return hi.bitwise_left_shift_(32).bitwise_or_(lo)


def sm_clocks(terms) -> float:
    """SM clocks the instructions of `terms` ((units, counts a unit)
    pairs) take at the least: the fuller of the two 64-lane pipes or the
    128 scheduler slots."""
    alu = sum(u * c.alu for u, c in terms)
    fma = sum(u * c.fma for u, c in terms)
    total = sum(u * c.total for u, c in terms)
    return max(alu / 64, fma / 64, total / 128)


def bound(nbytes: int, terms, clock_hz: float):
    """(least milliseconds the card could take, what sets it): the bytes
    over the memory rate, or the instructions of `terms`, (units of work,
    instruction counts a unit) pairs, over what 132 SMs take in a clock:
    the fuller of the two 64-lane pipes or the 128 scheduler slots
    (`_sass.Counts.sm_clocks`)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = sm_clocks(terms) / (SMS * clock_hz) * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def ntt_terms(sass, log_n: int, batch: int, **kw) -> list:
    """Kernel 1's bound terms for a call, from its shape alone: the field
    multiplies, adds and subtracts the transform (or, with lde=True, the
    coset LDE; with passes=k, its first k passes) needs
    (`_sass.ntt_field_ops`), each at its straight-line count from the
    field-op probe. The multiplies by a twiddle +-2^e are split between
    the general multiply and the one by shifts (`gl_mul_pow2`) where the
    call takes the fewest clocks: each pipe's load is linear in the share
    f done by shifts, so the least of their maximum lies at f = 0, f = 1
    or where two pipes' loads cross."""
    from aero_tpu_torch import _sass
    ops = _sass.ntt_field_ops(log_n, batch, **kw)
    rest = [(ops["mul"] - ops["mul_pow2"], sass["op_mul_vv"]),
            (ops["add"], sass["op_add_vv"]), (ops["sub"], sass["op_sub_vv"])]

    def terms(f):
        return rest + [(ops["mul_pow2"] * (1 - f), sass["op_mul_vv"]),
                       (ops["mul_pow2"] * f, sass["op_mul_pow2"])]

    def loads(f):
        t = terms(f)
        return [sum(u * c.alu for u, c in t) / 64,
                sum(u * c.fma for u, c in t) / 64,
                sum(u * c.total for u, c in t) / 128]

    a, b = loads(0), loads(1)
    cands = [0, 1]
    for i in range(3):
        for j in range(i):
            slope = (b[i] - a[i]) - (b[j] - a[j])
            if slope and 0 < (a[j] - a[i]) / slope < 1:
                cands.append((a[j] - a[i]) / slope)
    return terms(min(cands, key=lambda f: max(loads(f))))


def record(kernels, name, shape, err, ms, plain_ms, nbytes, units, per_unit,
           clock_hz) -> None:
    """Log the bound of the call just timed; with a `name`, keep the row
    for the `kernels` line. `units` of `per_unit` instructions each, or,
    with `per_unit` None, a list of (units, per_unit) terms."""
    terms = units if per_unit is None else [(units, per_unit)]
    b_ms, b_by = bound(nbytes, terms, clock_hz)
    instructions = sum(u * c.total for u, c in terms)
    log(f"          bound {b_ms:.4f} ms by {b_by} ({nbytes} B, "
        f"{instructions} instructions): {100 * b_ms / ms:.1f} % of the "
        f"bound reached")
    if name is not None:
        kernels[name].update(shape=shape, max_abs_err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=None)


PROBE_SRC = "aero_tpu_torch/csrc/probe/field_ops.cu"
PROBE_OPS = 64                 # csrc/probe/field_ops.cu kOps


def start_probe_build():
    """(nvcc on the field-op probe, its cubin): started before the kernel
    library's build, so both compile at once."""
    from aero_tpu_torch import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "field_ops_probe.cubin"
    job = subprocess.Popen(
        [_build._nvcc(), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-o", str(out), os.path.join(HERE, PROBE_SRC)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return job, out


def field_op_counts(job, cubin) -> dict:
    """Instructions of one field op by pipe, add / sub / mul with two
    varying operands ("vv") or a constant second one ("vc"), the multiply
    by a root of unity of order at most 64 by shifts ("mul_pow2") and the
    lazy forms kernel 1 computes with ("*_lazy_vv", logged, priced by no
    bound): each probe kernel's count less probe_none's, over its
    PROBE_OPS ops."""
    from aero_tpu_torch import _sass
    _, err = job.communicate()
    check(job.returncode == 0, f"nvcc builds {PROBE_SRC}: {err}")
    fns = _sass.parse_functions(_sass.dump_sass(cubin))
    base = _sass.count_instructions(fns["probe_none"])
    out = {}
    for op in ("add_vv", "add_vc", "sub_vv", "sub_vc", "mul_vv", "mul_vc",
               "mul_pow2", "add_lazy_vv", "sub_lazy_vv", "mul_lazy_vv"):
        c = _sass.count_instructions(fns[f"probe_{op}"])
        log(f"[set-up] probe_{op}: {c}; probe_none: {base}")
        d = _sass.Counts(*((getattr(c, f) - getattr(base, f)) / PROBE_OPS
                           for f in ("alu", "fma", "uniform", "memory",
                                     "control")), 0)
        check(d.memory == 0 and d.alu > 0,
              f"the {op} probe adds arithmetic only")
        out[f"op_{op}"] = d
    return out


def read_sass_counts(lib, probe) -> dict:
    """Instructions per blake2s compress and per unit of the field kernels,
    by pipe, read from the SASS of the built library, and those of one field
    op from the probe (which price kernel 1's bound, `ntt_terms`)."""
    from aero_tpu_torch import _sass
    fns = _sass.parse_functions(_sass.dump_sass(lib))
    merge = _sass.count_instructions(
        _sass.find_function(fns, "merge_level_kernel"))
    grind_loops = _sass.loops(_sass.find_function(fns, "grind_kernel"))
    check(bool(grind_loops), "grind_kernel has its loop over passes")
    grind = _sass.count_instructions(max(grind_loops, key=len))
    check(grind.total <= 1.25 * merge.total,
          "the grind loop holds one compress per trip")
    leaf_loops = _sass.loops(_sass.find_function(fns, "hash_columns_kernel"))
    check(bool(leaf_loops), "hash_columns_kernel has its compress loop")
    leaf = _sass.count_instructions(max(leaf_loops, key=len))
    check(leaf.total <= 1.25 * merge.total,
          "the leaf loop holds one compress per trip")
    counts = {"compress_merge": merge, "compress_leaf": leaf,
              "compress_grind": grind, **field_sass_counts(fns),
              **field_op_counts(*probe)}
    for k, c in counts.items():
        log(f"[set-up] SASS per {k}: {c.alu:g} ALU, {c.fma:g} multiply-add,"
            f" {c.uniform:g} uniform, {c.memory:g} memory, {c.control:g} "
            f"control instructions; at least {c.sm_clocks():.2f} SM clocks a"
            " thread")
        # an add, a subtract or a shift alone needs no multiply-add lane
        check(c.alu > 0 and (c.fma > 0 or k.startswith(("op_add", "op_sub",
                                                        "op_mul_pow2"))),
              f"SASS counts of {k} > 0")
    return counts


def inner_loops(body) -> list:
    """The loops of a kernel that hold no other loop, in address order;
    the branch to itself that ends every kernel's code is no loop."""
    from aero_tpu_torch import _sass
    lps = [lp for lp in _sass.loops(body) if len(lp) > 1]
    inner = [lp for lp in lps
             if not any(o is not lp and o[0].addr >= lp[0].addr
                        and o[-1].addr <= lp[-1].addr and len(o) < len(lp)
                        for o in lps)]
    return sorted(inner, key=lambda lp: lp[0].addr)


def field_sass_counts(fns) -> dict:
    """Instructions a unit of work of the field kernels (csrc/field.cu):
    an element of K1's multiply, add and subtract of two full operands (its
    storing loop, which the compiler may unroll, over the stores in it: one
    an element)
    and a bit of its exponent loop (the loop with no store); a thread of
    each K2 kernel, its whole code once (the loops over a thread's elements
    are unrolled; the row factors' loops over tile products and the
    inverse's squarings count once), the scan's look-back loop apart: one
    trip a tile for warp 0's 32 lanes (the least a tile needs; its trips
    depend on the order the tiles ran in); and a row of K4's three loops
    (main, aux, composition), one row a trip. Where a kernel's loops are not as
    described, its whole code stands for each unit, an overcount, and the
    line says so."""
    from aero_tpu_torch import _sass

    def stores(lp):
        return sum(i.op == "STG" for i in lp)

    def scaled(c, k):
        return _sass.Counts(c.alu / k, c.fma / k, c.uniform / k,
                            c.memory / k, c.control / k, c.shared_stores)

    def pick(name, want, how):
        body = _sass.find_function(fns, name)
        got = how(inner_loops(body))
        if got is None or len(got) != want:
            log(f"[set-up] SASS of {name}: its loops are not as expected; "
                "the whole kernel's code stands for each unit (an overcount)")
            return [_sass.count_instructions(body)] * want
        return got

    def storing(lps):
        lps = [lp for lp in lps if stores(lp)]
        if not lps:
            return None
        lp = max(lps, key=stores)
        return [scaled(_sass.count_instructions(lp), stores(lp))]

    def bit_loop(lps):
        lps = [lp for lp in lps if not stores(lp)]
        return [_sass.count_instructions(min(lps, key=len))] if lps else None

    def each(lps):
        return [_sass.count_instructions(lp) for lp in lps]

    def whole(name):
        return _sass.count_instructions(_sass.find_function(fns, name))

    def minus(a, b):
        return _sass.Counts(a.alu - b.alu, a.fma - b.fma,
                            a.uniform - b.uniform, a.memory - b.memory,
                            a.control - b.control,
                            a.shared_stores - b.shared_stores)

    def look_back_apart(name):
        """(the kernel but its look-back loop, one trip of that loop): the
        widest loop that holds the spin's NANOSLEEP."""
        body = _sass.find_function(fns, name)
        spins = [lp for lp in _sass.loops(body)
                 if any(i.op == "NANOSLEEP" for i in lp)]
        check(bool(spins), f"{name} has its look-back loop")
        lb = _sass.count_instructions(max(spins, key=len))
        return minus(_sass.count_instructions(body), lb), lb

    k4 = pick("deep_combine_kernel", 3, each)
    scan, look_back = look_back_apart("chained_scan_kernelILi2E")
    return {
        "k1_mul": pick("elementwise_kernelILi2ELi0ELi0E", 1, storing)[0],
        "k1_add": pick("elementwise_kernelILi0ELi0ELi0E", 1, storing)[0],
        "k1_sub": pick("elementwise_kernelILi1ELi0ELi0E", 1, storing)[0],
        "k1_pow_bit": pick("elementwise_kernelILi3ELi0ELi1E", 1, bit_loop)[0],
        "k2_scan": scan, "k2_look_back": look_back,
        "k2_tile_products": whole("tile_products_kernel"),
        "k2_row_factors": whole("row_factors_kernel"),
        "k2_apply": whole("batch_inv_apply_kernel"),
        "k4_main": k4[0], "k4_aux": k4[1], "k4_comp": k4[2]}


def phase_blake2s(dev, rng, kernels, sass, clock_hz) -> None:
    from aero_tpu_torch.spec.hashing import hash_elements, merge_with_int
    from aero_tpu_torch.field import from_u64, to_u64
    from aero_tpu_torch.hash import blake2s_cuda as bc

    for nbytes in (40, 64, 2304):
        W = -(-nbytes // 4)
        msgs = rng.integers(0, 2**32, size=(4096, W), dtype=np.uint64)
        t = words_tensor(msgs.T, dev)
        k = bc.blake2s_words(t, nbytes)
        p = bc.blake2s_words_plain(t, nbytes)
        kh, ph = k.cpu().numpy(), p.cpu().numpy()
        refs = {i: hashlib.blake2s(msgs[i].astype("<u4").tobytes()[:nbytes])
                .digest() for i in range(0, 4096, 97)}
        if not torch.equal(k, p):
            # say which side is wrong, and where, before failing
            apart = np.flatnonzero((kh != ph).any(axis=0))
            wrong = {side: sum(h[:, i].astype("<u4").tobytes() != d
                               for i, d in refs.items())
                     for side, h in (("kernel", kh), ("plain", ph))}
            check(False, f"blake2s_words {nbytes} B kernel == plain: "
                  f"{apart.size} of 4096 messages differ (first "
                  f"{apart[:8].tolist()}); against hashlib at {len(refs)} "
                  f"messages, the kernel is wrong at {wrong['kernel']}, the "
                  f"plain version at {wrong['plain']}")
        for i, d in refs.items():
            check(kh[:, i].astype("<u4").tobytes() == d,
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

    def qualifies(seed, nonce, bits):
        d = merge_with_int(seed, nonce)
        return 128 - int.from_bytes(d[:16], "big").bit_length() >= bits

    # 16 bits is the proof's setting (one batch of one wave); 20 bits takes
    # batches of 2^22 nonces that the kernel stops handing out after the hit
    ballast = torch.zeros(1 << 27, dtype=torch.int64, device=dev)

    def busy():                     # about 6 ms of device work
        for _ in range(8):
            ballast.add_(1)

    for bits, n_seeds in ((16, 4), (20, 3)):
        for s in range(n_seeds):
            seed = hashlib.blake2s(f"chip-smoke-seed-{s}".encode()).digest()
            nonce = bc.grind_pow(seed, bits, dev)
            plain = bc.grind_pow_plain(seed, bits, dev)
            check(nonce == plain and qualifies(seed, nonce, bits),
                  f"grind_pow {bits} bits seed {s}: kernel {nonce}, plain "
                  f"{plain}")
            if bits == 16:
                host = next(i for i in range(nonce + 1)
                            if qualifies(seed, i, bits))
                check(nonce == host, f"grind_pow seed {s}: kernel {nonce}, "
                      f"host scan {host}")
            # the batches this seed needs; the hashes the data cannot avoid
            # are the nonces up to the hit
            batches = []
            for base, count in bc.grind_batches(bits):
                batches.append((base, count))
                if nonce < base + count:
                    break
            count = batches[-1][1]
            hashes = nonce + 1

            def launches():
                for b, c in batches:
                    bc.grind_launch(seed, bits, dev, b, c)
            ms = cuda_ms_queued(launches, 20, busy)
            calls = 20
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                bc.grind_pow(seed, bits, dev)
            call_ms = (time.perf_counter() - t0) * 1e3 / calls
            pms = host_ms(lambda: bc.grind_pow_plain(seed, bits, dev))
            log(f"[phase 1] grind_pow {bits} bits seed {s}: nonce {nonce} "
                f"(kernel == plain" + (" == host scan" if bits == 16 else "")
                + f"), {len(batches)} batch(es) of {count}; device "
                f"{ms * 1e3:.1f} us (CUDA events around the kernel), whole "
                f"call {call_ms * 1e3:.1f} us on the host clock, plain "
                f"{pms:.3f} ms")
            keep = bits == 16 and s == 0
            record(kernels, "blake2s_grind_pow" if keep else None,
                   f"{bits} bits, {len(batches)} batch(es) of {count} nonces "
                   f"(device time; the whole call takes {call_ms:.4f} ms on "
                   f"the host clock)", abs(nonce - plain), ms, pms, 24, hashes,
                   sass["compress_grind"], clock_hz)
            if keep:
                kernels["blake2s_grind_pow"]["host_ms"] = call_ms


def plain_chunks(fn, src, ratio, out, chunk: int = 1 << 20):
    """max_abs_err of `out` against fn over column chunks of `src`
    (`ratio` input columns per output column), and the plain time."""
    err = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in range(0, out.shape[1], chunk):
        p = fn(src[:, ratio * a:ratio * (a + chunk)].contiguous())
        err = max(err, max_abs_err(out[:, a:a + chunk], p))
    torch.cuda.synchronize()
    return err, (time.perf_counter() - t0) * 1e3


def phase_blake2s_path_shapes(dev, gen, kernels, sass, clock_hz) -> None:
    """The leaf and merge shapes of the 2^20-row proof, each held against
    the plain version chunk by chunk over the whole output."""
    from aero_tpu_torch.field import to_u64
    from aero_tpu_torch.hash import blake2s_cuda as bc
    from aero_tpu_torch.spec.hashing import hash_elements
    n = 1 << LOG_LDE

    for w in (72, 9):
        cols = device_felts((w, n), gen, dev)
        k = bc.hash_columns(cols)
        err, pms = plain_chunks(bc.hash_columns_plain, cols, 1, k)
        check(err == 0, f"hash_columns {w} x 2^{LOG_LDE} kernel == plain")
        kh = k[:, ::n // 8 + 1].cpu().numpy()
        host = to_u64(cols[:, ::n // 8 + 1].contiguous())
        for i in range(kh.shape[1]):
            check(kh[:, i].astype("<u4").tobytes()
                  == hash_elements([int(v) for v in host[:, i]]),
                  f"hash_columns {w} x 2^{LOG_LDE} == spec hash_elements")
        ms = cuda_ms(lambda: bc.hash_columns(cols))
        log(f"[phase 1] hash_columns {w} x 2^{LOG_LDE}: kernel {ms:.3f} ms, "
            f"plain {pms:.3f} ms (2^20-leaf chunks), max_abs_err {err}")
        record(kernels, "blake2s_hash_columns" if w == 72 else None,
               f"{w} x 2^{LOG_LDE}", err, ms, pms, (w + 8) * n * 8,
               (w + 1) // 2 * n, sass["compress_leaf"], clock_hz)
        del cols, k

    d = torch.randint(0, 1 << 32, (8, n), generator=gen, device=dev,
                      dtype=torch.int64)
    k = bc.merge_level(d)
    err, pms = plain_chunks(bc.merge_level_plain, d, 2, k)
    check(err == 0, f"merge_level 2^{LOG_LDE} kernel == plain")
    ms = cuda_ms(lambda: bc.merge_level(d))
    log(f"[phase 1] merge_level 2^{LOG_LDE} -> 2^{LOG_LDE - 1}: kernel "
        f"{ms:.3f} ms, plain {pms:.3f} ms (chunked), max_abs_err {err}")
    record(kernels, "blake2s_merge_level", f"2^{LOG_LDE} -> 2^{LOG_LDE - 1}",
           err, ms, pms, (8 * n + 8 * n // 2) * 8, n // 2,
           sass["compress_merge"], clock_hz)

    # a batch opening of the 2^23-leaf tree over d at the proof's 27 queries
    from aero_tpu_torch.merkle import commit_digests
    from aero_tpu_torch.spec.merkle import batch_proof_coords
    tree = commit_digests(d.t())
    idxs = [int(i) for i in torch.randperm(n, generator=gen, device=dev)[:27]]
    leaf_coords, node_coords = batch_proof_coords(n, LOG_LDE, idxs)
    coords = leaf_coords + [c for lst in node_coords for c in lst]
    K = len(coords)
    pinned = torch.tensor(coords, dtype=torch.int64, pin_memory=True)

    def gather():
        return bc.merkle_gather(tree.levels, pinned)
    k = gather()
    torch.cuda.synchronize()
    m32 = (1 << 32) - 1
    err = max_abs_err(k.long() & m32, bc.merkle_gather_plain(
        tree.levels, pinned.to(dev)).cpu().long() & m32)
    check(err == 0, f"merkle_gather of {K} digests kernel == plain")
    ballast = torch.zeros(1 << 27, dtype=torch.int64, device=dev)

    def busy():                     # about 6 ms of device work
        for _ in range(8):
            ballast.add_(1)
    ms = cuda_ms_queued(gather, 50, busy)
    pms = cuda_ms_queued(lambda: bc.merkle_gather_plain(
        tree.levels, pinned.to(dev, non_blocking=True)), 5, busy)
    open_ms = host_ms(lambda: tree.prove_batch(idxs))
    log(f"[phase 1] merkle_gather {K} digests of a 2^{LOG_LDE}-leaf tree (27"
        f" queries), indexes and digests in pinned host memory: kernel "
        f"{ms * 1e3:.2f} us (queued), plain {pms:.3f} ms (on the card), "
        f"max_abs_err {err}; the whole batch opening {open_ms:.3f} ms on "
        f"the host clock")
    record(kernels, "merkle_gather", f"{K} digests of a 2^{LOG_LDE}-leaf "
           f"tree, 27 queries", err, ms, pms, K * (8 + 64 + 32), [], None,
           clock_hz)
    kernels["merkle_gather"]["host_ms"] = open_ms
    del tree, ballast


def lde_entry(c, log_blowup: int, offset: int):
    """(launch, plain) of the LDE entry alone, the first pass of `lde(c,
    log_blowup, offset)` on a two-pass domain, with the arguments
    `ntt_cuda.lde_cuda` gives it: `launch()` writes that pass's output
    (B, m) and returns it; `plain(a, b)` is its plain rendering for rows
    a..b, `colntt_plain` of the zero-padded, offset-scaled rows
    (`coset_pad`)."""
    from aero_tpu_torch.ntt import coset_pad
    from aero_tpu_torch.ntt import ntt_cuda as nc
    B, n = c.shape
    m = n << log_blowup
    check(nc._two_pass(m, nc.tables.MAX_L), "the LDE entry's domain is "
          "two-pass")
    n1, n2, tw2, _, ctw = nc._tables(m, False, c.device)
    rowpow, colpow = nc._lde_tables(offset, n2, n1, c.device)
    out = torch.empty((B, m), dtype=torch.int64, device=c.device)

    def launch():
        nc._pass_lde(c, out, tw2, ctw, rowpow, colpow, n2.bit_length() - 1,
                     n1.bit_length() - 1, B, n, nc.zero_stages(n, n2, n1),
                     (m, n1, 1), n1)
        return out

    def plain(a, b):
        x = coset_pad(c[a:b], log_blowup, offset).reshape(b - a, n2, n1)
        return nc.colntt_plain(x, tw2, ctw).reshape(b - a, m)

    return launch, plain


def phase_ntt(dev, rng, gen, kernels, sass, clock_hz) -> None:
    from aero_tpu_torch.field import P, from_u64
    from aero_tpu_torch.ntt import coset_pad, lde, ntt_plain
    from aero_tpu_torch.ntt import ntt_cuda as nc
    from aero_tpu_torch.ntt.ntt_cuda import ntt_cuda, ntt_four_step_plain
    from aero_tpu_torch.spec import field as F

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
    record(kernels, None, "", err, ms, pms,
           2 * x.numel() * 8 + ((1 << 23) + (1 << 12) + (1 << 11)) * 8,
           ntt_terms(sass, 23, 8), None, clock_hz)
    del x, k, p

    # the LDE route at small and middle sizes, every blowup the port uses
    for logn, cols in ((10, 3), (14, 3), (20, 2)):
        c = from_u64(rng.integers(0, P, size=(cols, 1 << logn),
                                  dtype=np.uint64), dev)
        for lb in (1, 2, 3, 4):
            for off in (F.DOMAIN_OFFSET, 5):
                got = lde(c, lb, off)
                want = (ntt_plain(coset_pad(c, lb, off)) if logn < 20 else
                        ntt_four_step_plain(coset_pad(c, lb, off), False))
                check(torch.equal(got, want),
                      f"lde 2^{logn} x {cols} blowup 2^{lb} offset {off}: "
                      "kernel route == plain")
    log("[phase 2] lde 2^10, 2^14, 2^20 at blowup 2..16, two offsets: "
        "kernel route == ntt_plain(coset_pad(...))")
    c = from_u64(rng.integers(0, P, size=(8, 1 << 20), dtype=np.uint64), dev)
    k = lde(c, 3)
    p = ntt_plain(coset_pad(c, 3))
    check(torch.equal(k, p), "lde (8, 2^20) x8 kernel path == plain")
    ms = cuda_ms(lambda: lde(c, 3))
    pms = cuda_ms(lambda: ntt_plain(coset_pad(c, 3)), iters=1)
    log(f"[phase 2] lde (8, 2^20) blowup 8: kernel path {ms:.3f} ms, plain "
        f"{pms:.3f} ms, exact")
    del c, k, p

    # the main-trace LDE transform of the 2^20-row proof: 72 columns at once
    n = 1 << LOG_LDE
    x = device_felts((72, n), gen, dev)
    k = ntt_cuda(x)
    err = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in range(0, 72, 8):
        err = max(err, max_abs_err(k[a:a + 8],
                                   ntt_four_step_plain(x[a:a + 8], False)))
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t0) * 1e3
    check(err == 0, f"ntt 2^{LOG_LDE} x 72 kernel == four-step plain")
    del k
    ms = cuda_ms(lambda: ntt_cuda(x))
    log(f"[phase 2] ntt 2^{LOG_LDE} x 72 (2 launches): kernel {ms:.3f} ms, "
        f"four-step plain {pms:.3f} ms (8-column chunks), max_abs_err {err}")
    # bytes: the columns in and out, the cross table and the pass tables
    tables_b = (n + (1 << 12) + (1 << 11)) * 8
    record(kernels, "gl_colntt", f"NTT 2^{LOG_LDE} x 72 (2 launches)", err,
           ms, pms, 2 * x.numel() * 8 + tables_b,
           ntt_terms(sass, LOG_LDE, 72), None, clock_hz)

    # the main LDE of the 2^20-row proof: 72 x 2^20 coefficients, blowup 8
    c = x[:, :1 << 20].contiguous()
    del x
    torch.cuda.empty_cache()
    nc.reset_launches()
    k = lde(c, 3)
    torch.cuda.synchronize()
    check(nc.LAUNCHES["gl_colntt_lde"] == 1 and nc.LAUNCHES["gl_colntt"] == 1,
          "the LDE is two launches, the first the LDE entry")
    err = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in range(0, 72, 8):
        err = max(err, max_abs_err(k[a:a + 8], ntt_four_step_plain(
            coset_pad(c[a:a + 8], 3), False)))
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t0) * 1e3
    check(err == 0, "lde 72 x 2^20 x8: kernel route == four-step plain of "
          "coset_pad")
    del k
    ms = cuda_ms(lambda: lde(c, 3))
    log(f"[phase 2] lde 72 x 2^20 -> 2^{LOG_LDE} (gl_colntt_lde + "
        f"gl_colntt): {ms:.3f} ms, plain {pms:.3f} ms (8-column chunks), "
        f"max_abs_err {err}")
    # bytes: the coefficients in, the evaluations out, the tables (the
    # pass tables, the cross, the offset powers)
    lde_b = (1 << 11) + (1 << 12)
    record({}, None, "", err, ms, pms,
           c.numel() * 8 + 72 * n * 8 + tables_b + lde_b * 8,
           ntt_terms(sass, LOG_LDE, 72, log_blowup=3, lde=True), None,
           clock_hz)
    # its first pass alone: the LDE entry, one launch
    entry, entry_plain = lde_entry(c, 3, F.DOMAIN_OFFSET)
    nc.reset_launches()
    k = entry()
    torch.cuda.synchronize()
    check(nc.LAUNCHES == {"gl_colntt": 0, "gl_colntt_lde": 1},
          "the LDE entry alone is one launch")
    err = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in range(0, 72, 8):
        err = max(err, max_abs_err(k[a:a + 8], entry_plain(a, a + 8)))
    torch.cuda.synchronize()
    pms = (time.perf_counter() - t0) * 1e3
    check(err == 0, "the LDE entry 72 x 2^20 -> 2^23 == colntt_plain of "
          "coset_pad")
    del k
    ms = cuda_ms(entry)
    log(f"[phase 2] the LDE entry alone (gl_colntt_lde, the first pass of "
        f"the main LDE): {ms:.3f} ms, plain {pms:.3f} ms (8-column chunks), "
        f"max_abs_err {err}")
    # bytes: the coefficients in, the pass output, its tables: the pass
    # table (2^11), the cross (2^23), the offset powers (2^11 + 2^12)
    record(kernels, "gl_colntt_lde", f"LDE entry 72 x 2^20 -> 2^{LOG_LDE}, "
           "the first of the LDE's two launches", err, ms, pms,
           c.numel() * 8 + 72 * n * 8 + (n + (1 << 11) + lde_b) * 8,
           ntt_terms(sass, LOG_LDE, 72, log_blowup=3, lde=True, passes=1),
           None, clock_hz)
    del c, entry, entry_plain
    nc.clear_table_cache()
    torch.cuda.empty_cache()
    # bench_lde_2e24's shape: 1 x 2^24 coefficients -> 2^27, three passes
    c = device_felts((1, 1 << 24), gen, dev)
    nc.reset_launches()
    k = lde(c, 3)
    torch.cuda.synchronize()
    check(nc.LAUNCHES == {"gl_colntt": 2, "gl_colntt_lde": 1},
          "lde 2^24 -> 2^27: the LDE entry, then two passes")
    check(torch.equal(k, ntt_cuda(coset_pad(c, 3))),
          "lde 2^24 -> 2^27 == the transform of the padded input")
    del k
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: lde(c, 3), iters=3)
    log(f"[phase 2] lde 1 x 2^24 -> 2^27 (three launches): {ms:.3f} ms")
    record({}, None, "", 0, ms, float("nan"),
           c.numel() * 8 + 8 * c.numel() * 8 * 2,
           ntt_terms(sass, 27, 1, log_blowup=3, lde=True), None, clock_hz)
    del c
    nc.clear_table_cache()
    torch.cuda.empty_cache()


def queued_ms(dev):
    """A timer for short kernels: CUDA-event milliseconds a call, with the
    calls enqueued behind about 6 ms of device work, so the host's launch
    rate does not count (`cuda_ms_queued`)."""
    ballast = torch.zeros(1 << 27, dtype=torch.int64, device=dev)

    def busy():
        for _ in range(8):
            ballast.add_(1)

    return lambda fn, iters=20: cuda_ms_queued(fn, iters, busy)


# the multiplies of p - 2's addition chain, 63 squarings and 9 products
# (csrc/field.cu gl_inv)
INV_CHAIN_MULS = 72


def k2_terms(rows: int, n: int, sass) -> tuple:
    """((units, instructions a unit) terms of what each function needs,
    (the same of what K2's kernels execute)) for gl_scan and gl_batch_inv
    on a (rows, n) call. What a function needs: a scan one field
    operation an element; a batch inversion three multiplies an element
    (Montgomery's trick: the prefix products, then two an element on the
    way back) and one addition-chain inverse a row; a multiply at its own
    straight-line count (the field-op probe). What the kernels
    execute: gl_scan's one launch, gl_batch_inv's three."""
    from aero_tpu_torch.field.gl_cuda import INV_TILE, SCAN_TILE, tiles
    mul = sass["op_mul_vv"]
    need_scan = [(rows * n, mul)]
    need_inv = [(3 * rows * n + INV_CHAIN_MULS * rows, mul)]
    scan_tiles = tiles(rows, n, SCAN_TILE)
    run_scan = [(scan_tiles * 256, sass["k2_scan"]),
                (scan_tiles * 32, sass["k2_look_back"])]
    inv_tiles = tiles(rows, n, INV_TILE)
    run_inv = [(inv_tiles * 256, sass["k2_tile_products"]),
               (rows * 256, sass["k2_row_factors"]),
               (inv_tiles * 256, sass["k2_apply"])]
    return (need_scan, need_inv), (run_scan, run_inv)


def field_k1(dev, gen, log_n: int, timer, sass, clock_hz, kernels=None):
    """K1 against its plain versions at 2^log_n elements: add, sub, mul of
    two full operands and with a 0-d operand on either side, and the Fermat
    inverse (pow). With `kernels`, the multiply's row and the host time a
    launch."""
    from aero_tpu_torch.field import gl
    n = 1 << log_n
    a, b = device_felts((n,), gen, dev), device_felts((n,), gen, dev)
    s0 = device_felts((), gen, dev)
    err = 0
    for op in ("add", "sub", "mul"):
        k, p = getattr(gl, op), getattr(gl, op + "_plain")
        for x, y in ((a, b), (a, s0), (s0, a)):
            err = max(err, max_abs_err(k(x, y), p(x, y)))
    err = max(err, max_abs_err(gl.inv(a), gl.inv_plain(a)))
    check(err == 0, f"K1 at 2^{log_n}: kernel == plain")
    if kernels is None:
        return err
    ms = timer(lambda: gl.mul(a, b))
    pms = cuda_ms(lambda: gl.mul_plain(a, b), iters=3)
    log(f"[phase 2b] K1 gl_elementwise mul 2^{log_n}: kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms, max_abs_err {err} (add, sub, mul, 0-d "
        "operands, inv)")
    record(kernels, "gl_elementwise", f"mul 2^{log_n}", err, ms, pms,
           3 * n * 8, n, sass["k1_mul"], clock_hz)
    ms = timer(lambda: gl.mul(a, s0))
    pms = cuda_ms(lambda: gl.mul_plain(a, s0), iters=3)
    log(f"[phase 2b] K1 mul 2^{log_n} by a 0-d operand: kernel {ms:.4f} ms,"
        f" plain {pms:.4f} ms")
    record({}, None, "", err, ms, pms, 2 * n * 8 + 8, n, sass["k1_mul"],
           clock_hz)
    bits = (gl.P - 2).bit_length()
    ms = timer(lambda: gl.inv(a), iters=5)
    pms = cuda_ms(lambda: gl.inv_plain(a), iters=1)
    log(f"[phase 2b] K1 pow (inv, e = p - 2, {bits} bits) 2^{log_n}: kernel "
        f"{ms:.4f} ms, plain {pms:.4f} ms")
    record({}, None, "", err, ms, pms, 2 * n * 8, n * bits,
           sass["k1_pow_bit"], clock_hz)
    small = device_felts((1024,), gen, dev)
    gl.mul(small, small)
    torch.cuda.synchronize()
    calls = 2000
    t0 = time.perf_counter()
    for _ in range(calls):
        gl.mul(small, small)
    host_ms_call = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    kernels["gl_elementwise"]["host_ms"] = host_ms_call
    log(f"[phase 2b] K1 host time a launch (wrapper, checks, ctypes, no "
        f"synchronize; 2^10 elements, {calls} calls): {host_ms_call * 1e3:.2f}"
        " us")
    branch_ns = symbolic_branch_ns(small)
    kernels["gl_elementwise"]["symbolic_branch_ns"] = branch_ns
    log(f"[phase 2b] the symbolic branch at the top of field.add / sub / mul"
        f" (two type tests): {branch_ns:.1f} ns a call, "
        f"{100 * branch_ns * 1e-6 / host_ms_call:.3f} % of the host time a "
        "launch")
    return err


def symbolic_branch_ns(x, calls: int = 1_000_000) -> float:
    """Host nanoseconds of the test `field/gl.py` makes before every op on
    two tensors (`type(a) is Sym or type(b) is Sym`), less the loop's."""
    from aero_tpu_torch.field.sym import Sym
    t0 = time.perf_counter()
    for _ in range(calls):
        if type(x) is Sym or type(x) is Sym:
            break
    t1 = time.perf_counter()
    for _ in range(calls):
        pass
    t2 = time.perf_counter()
    return max(0.0, (t1 - t0) - (t2 - t1)) / calls * 1e9


def field_k2(dev, gen, shape, zero_at, timer, sass, clock_hz, kernels=None,
             what="", rows_for=()):
    """K2's scans and batch inversion against their plain versions on
    `shape` (rows, n), with a zero at `zero_at` and none elsewhere: that
    row of batch_inv must be all zero, the others the inverses. With
    `kernels`, each is timed beside its bound (what the function needs;
    what the kernels execute is logged beside it), and the kernels named
    in `rows_for` take this shape's row of the `kernels` line."""
    from aero_tpu_torch.field import gl, gl_cuda
    x = device_felts(shape, gen, dev)
    x[x == 0] = 1
    x[zero_at] = 0
    err = 0
    for fn in ("gf_cumprod", "gf_cumsum", "batch_inv"):
        gl_cuda.reset_launches()
        err = max(err, max_abs_err(getattr(gl, fn)(x),
                                   getattr(gl, fn + "_plain")(x)))
        want = {"batch_inv": ("gl_batch_inv", 3)}.get(fn, ("gl_scan", 1))
        check(gl_cuda.LAUNCHES[want[0]] == want[1],
              f"{fn} {shape}: {want[1]} launch(es) of {want[0]}")
    inv = gl.batch_inv(x)
    check(not bool(inv[zero_at[0]].any()), f"batch_inv {shape}: the row "
          "with a zero is all zero")
    others = [r for r in range(shape[0]) if r != zero_at[0]]
    if others:
        check(torch.equal(gl.mul(inv[others], x[others]),
                          torch.ones_like(x[others])),
              f"batch_inv {shape}: the other rows are the inverses")
    check(err == 0, f"K2 {shape}: kernel == plain")
    if kernels is None:
        return err
    rows, n = shape
    ms = timer(lambda: gl.gf_cumprod(x))
    sms = timer(lambda: gl.gf_cumsum(x))
    pms = cuda_ms(lambda: gl.gf_cumprod_plain(x), iters=1)
    bms = timer(lambda: gl.batch_inv(x), iters=10)
    bpms = cuda_ms(lambda: gl.batch_inv_plain(x), iters=1)
    log(f"[phase 2b] K2 {rows} x {n}{what} (a zero in row {zero_at[0]}): "
        f"gl_scan gf_cumprod {ms:.4f} ms, gf_cumsum {sms:.4f} ms, plain "
        f"gf_cumprod {pms:.4f} ms; gl_batch_inv {bms:.4f} ms, plain "
        f"{bpms:.4f} ms; max_abs_err {err}")
    need, run = k2_terms(rows, n, sass)
    # each input element read once and each output written once: 16 B an
    # element for either function (the batch inversion's kernels read x
    # twice, 24 B)
    for name, t, p, terms, ran in (("gl_scan", ms, pms, need[0], run[0]),
                                   ("gl_batch_inv", bms, bpms, need[1],
                                    run[1])):
        keep = name in rows_for
        record(kernels if keep else {}, name if keep else None,
               f"{'gf_cumprod' if name == 'gl_scan' else 'batch_inv'} "
               f"{rows} x {n}", err, t, p, 16 * rows * n, terms, None,
               clock_hz)
        r_ms, _ = bound(0, ran, clock_hz)
        log(f"          the kernels' own {sum(u * c.total for u, c in ran)}"
            f" instructions would take {r_ms:.4f} ms")
    return err


def field_k4(dev, gen, widths, log_m: int, log_ld: int, timer, sass,
             clock_hz, kernels=None):
    """K4 (and `_deep_core` around it) against the plain versions: a
    fragment of 2^log_m points of main / aux / composition LDEs whose rows
    are 2^log_ld long, read in place."""
    from aero_tpu_torch.field import gl
    from aero_tpu_torch.prover import prover as PR
    wm, wa, wc = widths
    m, ld = 1 << log_m, 1 << log_ld
    a0 = ld - m if ld > m else 0
    sl = slice(a0, a0 + m)
    lde_m = device_felts((wm, ld), gen, dev)
    lde_a = device_felts((wa, ld), gen, dev)
    lde_c = device_felts((wc, ld), gen, dev)
    x = device_felts((m,), gen, dev)
    vecs = [device_felts((k,), gen, dev)
            for k in (wm + wa, wm + wa, wc, wm + wa, wm + wa, wc)]
    zs = [device_felts((), gen, dev) for _ in range(5)]
    mats = (lde_m[:, sl], lde_a[:, sl], lde_c[:, sl], x)
    err = max_abs_err(PR._deep_core(*mats, *vecs, *zs),
                      PR._deep_core_plain(*mats, *vecs, *zs))
    dinv = gl.batch_inv(torch.stack([gl.sub(x, z) for z in zs[:3]]))
    args = (*mats, *vecs, dinv, *zs[3:])
    err = max(err, max_abs_err(PR.gl_cuda.deep_combine(*args),
                               PR.deep_combine_plain(*args)))
    what = f"{wm} + {wa} + {wc} rows x 2^{log_m} at row stride 2^{log_ld}"
    check(err == 0, f"K4 {what}: kernel == plain")
    if kernels is None:
        return err
    ms = timer(lambda: PR.gl_cuda.deep_combine(*args), iters=10)
    pms = cuda_ms(lambda: PR.deep_combine_plain(*args), iters=1)
    whole = timer(lambda: PR._deep_core(*mats, *vecs, *zs), iters=10)
    log(f"[phase 2b] K4 gl_deep_combine {what}: kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms, max_abs_err {err}; `_deep_core` with its batch_inv "
        f"{whole:.4f} ms")
    rows = wm + wa + wc + 3 + 1 + 1          # LDE rows, dinv, x, out
    record(kernels, "gl_deep_combine", what, err, ms, pms,
           rows * m * 8 + (4 * (wm + wa) + 2 * wc + 2) * 8,
           [(m * wm, sass["k4_main"]), (m * wa, sass["k4_aux"]),
            (m * wc, sass["k4_comp"])], None, clock_hz)
    return err


def scale_merger(dev):
    """The merger of the 2^20-row proof (the program of phase 4), the
    frames of its fragment 0 and, with its offset, of its last fragment
    (the next-row frame wrapping round the domain, a `Wrapped` pair of
    views): the trace and aux commits, the constraint coefficients as the
    transcript draws them; and the trace, the aux rands and the main and
    aux coefficient rows."""
    from aero_tpu_torch.prover import prover as PR
    from aero_tpu_torch.spec import field as F
    prep = bench_gpu._prepare(long_fib_source(((1 << 20) - 64) // 12),
                              [0, 1], 1 << 20, 16, dev)
    air = prep.air
    st = PR.ProverState(pub_inputs=prep.pub, device=str(dev),
                        main_trace=prep.trace)
    for i in (0, 1):
        PR._run_stage(i, air, st)
    air._aux_rand = [int(v) % F.P for v in st.aux_rand]
    cc_t = [st.coin.draw_pair()
            for _ in range(air.num_transition_constraints)]
    cc_b = [st.coin.draw_pair() for _ in range(air.num_assertions)]
    merger = PR.ConstraintMerger(air, st.aux_rand, cc_t, cc_b,
                                 PR._ceval_static(air, dev), dev)
    b = air.options.blowup_factor
    frames = tuple(PR._frame(lde_, a, PR.FRAG)
                   for lde_ in (st.main_lde, st.aux_lde) for a in (0, b))
    a_last = st.main_lde.shape[-1] - PR.FRAG
    last = tuple(PR._frame(lde_, a_last + a, PR.FRAG)
                 for lde_ in (st.main_lde, st.aux_lde) for a in (0, b))
    return merger, frames, (last, a_last), (prep.trace, st.aux_rand,
                                             st.main_polys, st.aux_polys)


def kernel_resources(lib, pattern: str, threads: int, what: str) -> tuple:
    """(resources, SASS body) of the one kernel of library `lib` whose
    mangled name holds `pattern`, logged: registers a thread, stack bytes,
    spill instructions (local stores and loads in the SASS), global loads
    and instructions, and the blocks and warps an SM those registers leave
    room for at `threads` threads a block."""
    import re
    from aero_tpu_torch import _sass
    out = subprocess.run(["cuobjdump", "--dump-resource-usage", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    found = re.search(r"Function (\S*" + pattern + r"\S*):\s*REG:(\d+)\s+"
                      r"STACK:(\d+)", out)
    check(found is not None, f"cuobjdump lists {what}")
    body = _sass.find_function(_sass.parse_functions(_sass.dump_sass(lib)),
                               pattern)
    regs = int(found.group(2))
    # an SM holds 65 536 registers, given out a warp at a time in units of
    # 256, 2 048 threads and 32 blocks
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(2048 // threads, 32, 65536 // (per_warp * threads // 32))
    res = dict(registers=regs, stack_bytes=int(found.group(3)),
               spill_instructions=sum(i.op in ("STL", "LDL") for i in body),
               global_loads=sum(i.op == "LDG" for i in body),
               instructions=len(body), blocks_per_sm=blocks,
               warps_per_sm=blocks * threads // 32)
    log(f"[set-up] {what}: {res['registers']} registers a thread, "
        f"{res['stack_bytes']} B of stack, {res['spill_instructions']} "
        f"spill instructions (STL/LDL) and {res['global_loads']} global "
        f"loads of {res['instructions']}; room for {res['blocks_per_sm']} "
        f"blocks of {threads}, {res['warps_per_sm']} warps, an SM")
    return res, body


NTT_THREADS = 256             # csrc/ntt.cu kThreads
NTT_NOTE = ("radix-16 steps in registers over tiles of 2^13 elements (64 KB "
            "of dynamic shared memory a block, XOR-swizzled), a step's "
            "pre-twiddles from one table of w_L^e, no multiply by 1, lazy "
            "words inside a pass and canonical ones at every store; bound "
            "by the field ops the transform needs (_sass.ntt_field_ops), "
            "each at the probe's count of its canonical form")
NTT_LDE_NOTE = ("the coset LDE's first pass alone: reads the n coefficients, "
                "scales them by offset^i as it loads them and skips the "
                "stages that only copy; the LDE is this launch and one "
                "gl_colntt pass (phase 2 logs the whole LDE's time and "
                "bound); no zero-padded input exists")


def radix16_trip(body, what: str):
    """One trip of kernel 1's radix-16 step in SASS `body`, a group of 16
    elements: the innermost loop that holds 16 shared-memory loads (the
    pre-twiddles, 32 butterflies and both of the step's ends, the shared
    stores of a middle step and the cross multiplies and global stores of
    the last), counted by pipe and logged."""
    from aero_tpu_torch import _sass
    lds = [lp for lp in _sass.loops(body)
           if sum(i.op == "LDS" for i in lp) == 16]
    inner = [lp for lp in lds if not any(
        o is not lp and lp[0].addr <= o[0].addr and o[-1].addr <= lp[-1].addr
        for o in lds)]
    check(len(inner) == 1, f"{what}: one innermost loop of 16 shared loads "
          f"(the radix-16 step), found {len(inner)}")
    c = _sass.count_instructions(inner[0])
    log(f"[set-up] {what}, one radix-16 step (16 elements): {c.alu} ALU, "
        f"{c.fma} multiply-add, {c.memory} memory, {c.total} instructions")
    return c


def ntt_resources(lib) -> dict:
    """Kernel 1's two instances of library `lib` (`kernel_resources`), with
    a cross table (the first pass of every transform): the transform's and
    the LDE entry's, keyed by whether it is the LDE's, each with the
    instructions of one radix-16 step by pipe (`radix16_trip`)."""
    out = {}
    for lde, pattern in ((False, "colntt_kernelILb0ELb1E"),
                         (True, "colntt_kernelILb1ELb1E")):
        what = f"kernel 1 {'LDE entry' if lde else 'pass'}"
        out[lde], body = kernel_resources(lib, pattern, NTT_THREADS, what)
        c = radix16_trip(body, what)
        out[lde].update(radix16_alu=c.alu, radix16_fma=c.fma,
                        radix16_memory=c.memory)
    return out


def k5_resources(lib, sass) -> dict:
    """K5's merge kernel for MidenAir in library `lib` (`kernel_resources`);
    the run fails on a spill. Into `sass`: "k5_point", the kernel's code (a
    thread runs one point with no loop around it, so its whole code counts
    once a point, its assertion loop once in it), and "k5_assertion", one
    trip of its assertion loop."""
    from aero_tpu_torch import _sass
    res, body = kernel_resources(lib, "frag_merge_kernelI16MidenTransitions",
                                 K5_THREADS, "K5 miden_frag_eval merge kernel")
    check(res["spill_instructions"] == 0 and res["stack_bytes"] == 0,
          "K5's merge kernel for MidenAir keeps a point in registers: no "
          "spill instruction, no stack")
    sass["k5_point"] = _sass.count_instructions(body)
    inner = [lp for lp in inner_loops(body) if len(lp) < len(body)]
    if len(inner) == 1:
        sass["k5_assertion"] = _sass.count_instructions(inner[0])
    else:
        log("[set-up] K5's merge kernel does not hold exactly one inner "
            "loop, the assertion loop: its code is counted once a point "
            "(an undercount)")
        sass["k5_assertion"] = _sass.Counts(0, 0, 0, 0, 0, 0)
    return res


def k6_k7_resources(lib, sass) -> tuple:
    """(K6's resources, K7's) in library `lib` (`kernel_resources`), K7's
    at the proof's three points. Into `sass`: "k6_row", K6's code (one row
    a thread, no loop around it: its whole code once a row)."""
    from aero_tpu_torch import _sass
    k6, body = kernel_resources(lib, "row_eval_kernelI15MidenAuxFactors",
                                K5_THREADS, "K6 miden_aux_factors")
    sass["k6_row"] = _sass.count_instructions(body)
    k7, _ = kernel_resources(lib, "eval_partial_kernelILi3E", K7_THREADS,
                             "K7 gl_eval_multi, partial sums of 3 points")
    return k6, k7


# the field ops the merge needs a point, as (op, operands) -> ops per
# constraint, per assertion, once: constraint k weighed by c0_k + c1_k
# x^adj_k and added in, the sum times zt, and an assertion's
# (cb0_j + x^adj_j cb1_j)(col_j - b_j) dinv_j added in
K5_MERGE_OPS = {"op_mul_vv": (2, 3, 1), "op_add_vv": (2, 2, 0),
                "op_sub_vv": (0, 1, 0)}


def probe_op(kind: str, const: bool) -> str:
    """The field-op probe that prices a traced op of `kind` (an operand a
    constant or not); NEG is gl_sub(0, x)."""
    from aero_tpu_torch.field.sym import NEG
    return "op_sub_vc" if kind == NEG else \
        f"op_{kind}_{'vc' if const else 'vv'}"


def program_ops(prog):
    """A traced program's field ops, counted by the probe that prices
    each."""
    from collections import Counter
    from aero_tpu_torch.field.sym import CONST, OPS
    return Counter(
        probe_op(n.kind, any(prog.nodes[a].kind == CONST for a in n.args))
        for n in prog.nodes if n.kind in OPS)


def k5_terms(merger, sass) -> tuple:
    """(rows read and written, (units, instructions) terms a point of what
    the function needs, the same of the field ops the generated code
    states, the same of what the kernel executes, the field ops, the
    words the kernel reads a point) for one K5 call. What it needs: each
    field op of the traced program and of the merge at that op's own
    straight-line count (the field-op probe; an op with a constant operand
    at the constant probe's); the rows: the frame rows it reads (the
    traced loads and the asserted columns), zt, the divisor and x^adj
    rows, once, and the merged row written once. What the code states:
    the emission's statements (the traced ops and the values computed
    again, `symbolic.emission`) and the merge's, priced alike. What it
    executes: its code once a point (a thread runs one point, with no loop
    around it) and its assertion loop B - 1 more times. What it reads: the
    emission's frame and rand reads (cells read again past the reuse
    window) and the merge's own words."""
    from collections import Counter
    from aero_tpu_torch.air import generated, symbolic
    from aero_tpu_torch.field.sym import LOAD, OPS
    _, prog = generated.kernel_for(merger.air)
    em = symbolic.emission(prog)
    T, B = len(prog.outputs), len(merger.asrt_route)
    X = len(merger._k5[1])          # x^adj slots: two multiplies each
    merge = Counter({op: per_t * T + per_b * B + once for op, (
        per_t, per_b, once) in K5_MERGE_OPS.items()})
    merge["op_mul_vv"] += 2 * X
    ops = merge + program_ops(prog)
    stated = merge + Counter(
        probe_op(kind, any(isinstance(a, int) for a in args))
        for kind, _, args in em.steps if kind in OPS)
    need = [(n, sass[op]) for op, n in sorted(ops.items())]
    emitted = [(n, sass[op]) for op, n in sorted(stated.items())]
    run = [(1, sass["k5_point"]), (B - 1, sass["k5_assertion"])]
    cells = {n.args for n in prog.nodes if n.kind == LOAD}
    cells |= {("main_cur" if is_main else "aux_cur", c)
              for is_main, c, _ in merger.asrt_route}
    rows = len(cells) + 1 + merger.denom_inv.shape[0] + 1
    # the merge's words: a constraint's c0 and c1 (MergeOut::put reads them
    # where the value arrives; its x^adj comes from the point's slot in
    # shared memory), zt, an assertion's two coefficients, value, divisor
    # and column, and a slot's exponent, offset^adj and two table words
    reads = dict(frame=em.frame_reads, rand=em.rand_reads,
                 merge=2 * T + 1 + 5 * B + 4 * X, cells=len(cells))
    return rows, need, emitted, run, dict(ops), reads


def field_k5(merger, frames, a0, timer, sass, clock_hz, kernels=None,
             what="", wrapped=None):
    """K5 on one fragment against the eager path (the AIR's own
    evaluate_transitions, one K1 launch a field op, and
    constraint_merge_plain on the card) and against its plain version
    (the traced program in the plain ops and constraint_merge_plain),
    merged rows and transition values; then, with `kernels`, timed beside
    its bound, and on `wrapped` (frames, a0), the last fragment, its
    next-row frame read in place, against its plain version and timed."""
    from aero_tpu_torch.air import symbolic
    from aero_tpu_torch.field import gl_cuda
    from aero_tpu_torch.prover import prover as PR
    gl_cuda.reset_launches()
    got = merger.fragment(*frames, a0)
    launched = dict(gl_cuda.LAUNCHES)
    k5_args = merger.k5_inputs(*frames, a0)
    slots = k5_args[8].pw.shape[0]
    check(launched["miden_frag_eval"] == 1
          and sum(launched.values()) == 1,
          f"K5 {what}: one launch, its {slots} x^adj values made inside it "
          "(no K1 launch)")
    inputs = merger.merge_inputs(*frames, a0)
    err = max_abs_err(got, PR.constraint_merge_plain(*inputs))
    t_k5 = gl_cuda.frag_eval(*k5_args, transitions=True)
    err = max(err, max_abs_err(t_k5, torch.stack(list(inputs.t_evals))))
    del inputs
    err = max(err, max_abs_err(got, merger.fragment_plain(*frames, a0)))
    err = max(err, max_abs_err(t_k5, torch.stack(symbolic.interpret(
        symbolic.trace(type(merger.air)), *(PR.joined(f) for f in frames),
        merger.rands))))
    del t_k5
    m = frames[0].shape[-1]
    check(err == 0, f"K5 {what}: kernel == eager == plain, merged "
          "and transition values")
    if kernels is None:
        return err
    ms = timer(lambda: gl_cuda.frag_eval(*k5_args), iters=10)
    whole = timer(lambda: merger.fragment(*frames, a0), iters=10)
    route_host = host_ms(lambda: merger.fragment(*frames, a0))
    pms = cuda_ms(lambda: merger.fragment_plain(*frames, a0), iters=1)
    log(f"[phase 2b] K5 miden_frag_eval {what}: kernel {ms:.4f} ms, its "
        f"{slots} x^adj values made inside; through "
        f"ConstraintMerger.fragment {whole:.4f} ms (host clock: "
        f"{route_host:.3f} ms); plain {pms:.3f} ms; max_abs_err {err}")
    last_ms = None
    if wrapped is not None:
        w_frames, w_a0 = wrapped
        check(isinstance(w_frames[1], PR.Wrapped),
              "the last fragment's next-row frame wraps: body and tail")
        w_err = max_abs_err(merger.fragment(*w_frames, w_a0),
                            merger.fragment_plain(*w_frames, w_a0))
        check(w_err == 0, f"K5 on the last fragment, its next-row frame "
              "read in place == plain")
        w_args = merger.k5_inputs(*w_frames, w_a0)
        last_ms = timer(lambda: gl_cuda.frag_eval(*w_args), iters=10)
        log(f"[phase 2b] K5 miden_frag_eval on the last fragment (from "
            f"{w_a0}, its next-row frame read in place, body "
            f"{w_frames[1].body.shape[-1]} + tail "
            f"{w_frames[1].tail.shape[-1]} points): kernel {last_ms:.4f} "
            f"ms; max_abs_err {w_err}")
    rows, need, emitted, run, ops, reads = k5_terms(merger, sass)
    per_pipe = {pipe: tuple(sum(u * getattr(c, pipe) for u, c in terms)
                            for terms in (need, emitted, run))
                for pipe in ("alu", "fma")}
    log(f"[phase 2b] K5 a point: the function's field ops {ops}; at each "
        f"op's own count {per_pipe['alu'][0]:g} ALU and "
        f"{per_pipe['fma'][0]:g} multiply-add instructions; the field ops "
        f"the generated code states (the values computed again too) "
        f"{per_pipe['alu'][1]:g} ALU and {per_pipe['fma'][1]:g} "
        f"multiply-add; the kernel's own code executes "
        f"{per_pipe['alu'][2]:g} ALU and {per_pipe['fma'][2]:g} "
        "multiply-add (its code once, its assertion loop B - 1 more times)")
    words = reads["frame"] + reads["rand"] + reads["merge"]
    log(f"[phase 2b] K5 reads a point {reads['frame']} frame words (cells "
        f"read again past the reuse window; {reads['cells']} cells), "
        f"{reads['rand']} rands and {reads['merge']} words of the "
        f"merge: {words * m * 8} B from L1/L2 a call, "
        f"{words * m * 8 / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s "
        f"(the bound counts each row once: {rows * m * 8} B)")
    check(all(need_n <= run_n for need_n, _, run_n in per_pipe.values()),
          "K5's bound counts no more ALU or multiply-add work than the "
          "kernel executes")
    record(kernels, "miden_frag_eval", f"{what}: {m} points, {rows} rows",
           err, ms, pms, rows * m * 8, [(m * u, c) for u, c in need],
           None, clock_hz)
    kernels["miden_frag_eval"].update(route_ms=whole,
                                      last_fragment_ms=last_ms,
                                      words_read_per_point=words)
    return err


def field_k6(air, trace, rands, timer, sass, clock_hz, kernels=None,
             what=""):
    """K6 over a (72, n) trace against its plain version (the traced
    program in the plain ops) and the op-by-op path on the card
    (`_bus_row_factors`, one K1 launch a field op, over the trace's roll);
    then, with `kernels`, timed beside its bound: the function's field ops
    at each op's own count, and the distinct columns it reads and its
    eight rows written, once."""
    from aero_tpu_torch.air import generated, symbolic
    from aero_tpu_torch.air import miden as TM
    from aero_tpu_torch.field import gl_cuda, scalar
    from aero_tpu_torch.field.sym import LOAD
    name, prog = generated.row_kernel_for(air, TM._bus_row_factors)
    n = trace.shape[-1]
    gl_cuda.reset_launches()
    got = air.bus_factors(trace, rands)
    launched = dict(gl_cuda.LAUNCHES)
    check(launched["miden_aux_factors"] == 1 and sum(launched.values()) == 1,
          f"K6 {what}: one launch and no other")
    nxt = torch.roll(trace, -1, dims=-1)
    g = [scalar(r, trace.device) for r in rands]
    err = 0
    for k, v in enumerate(symbolic.interpret(prog, trace, nxt, None, None,
                                             rands)):
        err = max(err, max_abs_err(got[k], v))
    eager = TM._bus_row_factors(trace, nxt, g)
    err = max(err, max(max_abs_err(a, b) for a, b in zip(got, eager)))
    del eager
    check(err == 0, f"K6 {what}: kernel == plain == op by op on the card")
    if kernels is None:
        return err
    rt = gl_cuda.device_vector(rands, trace.device)
    ms = timer(lambda: gl_cuda.aux_factors(name, trace, rt, 8), iters=10)
    pms = cuda_ms(lambda: symbolic.interpret(prog, trace, torch.roll(
        trace, -1, dims=-1), None, None, rands), iters=1)
    gl_cuda.reset_launches()
    eager_ms = host_ms(lambda: TM._bus_row_factors(
        trace, torch.roll(trace, -1, dims=-1), g))
    k1 = gl_cuda.LAUNCHES["gl_elementwise"]
    cols = len({n_.args[1] for n_ in prog.nodes if n_.kind == LOAD})
    ops = program_ops(prog)
    need = [(n * c, sass[op]) for op, c in sorted(ops.items())]
    run = sass["k6_row"]
    log(f"[phase 2b] K6 miden_aux_factors {what}: kernel {ms:.4f} ms, plain "
        f"{pms:.3f} ms, op by op on the card {eager_ms:.3f} ms (host clock, "
        f"{k1} K1 launches and the roll), max_abs_err {err}")
    log(f"[phase 2b] K6 a row: the function's field ops {dict(ops)}; at "
        f"each op's own count {sum(c * sass[o].alu for o, c in ops.items()):g}"
        " ALU and "
        f"{sum(c * sass[o].fma for o, c in ops.items()):g} multiply-add "
        f"instructions; the kernel's own code executes {run.alu:g} ALU and "
        f"{run.fma:g} multiply-add; {cols} distinct columns read")
    record(kernels, "miden_aux_factors", f"{what}: {n} rows, {cols} columns "
           "read, 8 rows written", err, ms, pms, (cols + 8) * n * 8, need,
           None, clock_hz)
    kernels["miden_aux_factors"].update(op_by_op_k1_ms=eager_ms)
    return err


def field_k7(blocks, zs, timer, sass, clock_hz, kernels=None, what=""):
    """K7 on row blocks read where they lie against its plain version
    (`eval_polys_multi_plain`); then, with `kernels`, timed beside its
    bound: one multiply and one add a coefficient a point, each at its own
    count, and the rows read once."""
    from aero_tpu_torch.field import eval_polys_multi_plain, gl_cuda, to_u64
    gl_cuda.reset_launches()
    got = to_u64(gl_cuda.eval_multi(blocks, zs))
    check(gl_cuda.LAUNCHES["gl_eval_multi"] == 2
          and sum(gl_cuda.LAUNCHES.values()) == 2,
          f"K7 {what}: one call of two launches")
    want = eval_polys_multi_plain(blocks, zs)
    diff = got != want
    err = (max(abs(int(a) - int(b)) for a, b in zip(got[diff], want[diff]))
           if diff.any() else 0)
    w = sum(b.shape[0] for b in blocks)
    n = blocks[0].shape[-1]
    k = len(zs)
    check(err == 0 and got.shape == (k, w),
          f"K7 {what}: kernel == plain, ({k}, {w}) values")
    if kernels is None:
        return err
    ms = timer(lambda: gl_cuda.eval_multi(blocks, zs), iters=10)
    pms = cuda_ms(lambda: eval_polys_multi_plain(blocks, zs), iters=1)
    terms = k * w * n
    log(f"[phase 2b] K7 gl_eval_multi {what}: kernel {ms:.4f} ms (two "
        f"launches), plain {pms:.3f} ms, max_abs_err {err}")
    record(kernels, "gl_eval_multi", f"{what}: {w} rows x {n} at {k} points",
           err, ms, pms, (w * n + k * w) * 8,
           [(terms, sass["op_mul_vv"]), (terms, sass["op_add_vv"])], None,
           clock_hz)
    return err


def phase_field(dev, gen, kernels, sass, clock_hz) -> None:
    """The field kernels (csrc/field.cu) against their plain versions at
    the shapes of the 2^20-row proof, each timed beside its bound."""
    timer = queued_ms(dev)
    field_k1(dev, gen, 21, timer, sass, clock_hz, kernels)
    # the shape the two-pass scan was timed at first (to compare with its
    # times), then the 2^20-row proof's own: _deep_core's divisors (8 a
    # proof, gl_batch_inv's row of the kernels line), the aux build's
    # inversions, a bus scan (gl_scan's row), and ceval_domain's divisors
    # over the whole domain (once an air, cached)
    for shape, zero, what, rows_for in (
            ((4, (1 << 20) - 1), (2, 12345), "", ()),
            ((3, 1 << 20), (0, 0), ", _deep_core", ("gl_batch_inv",)),
            ((4, 1 << 20), (3, (1 << 20) - 1), ", the aux build", ()),
            ((1, (1 << 20) - 1), (0, 2048), ", a bus scan", ("gl_scan",)),
            ((2, 1 << 23), (1, 4095), ", ceval_domain", ())):
        field_k2(dev, gen, shape, zero, timer, sass, clock_hz, kernels, what,
                 rows_for)
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    merger, frames, last, (trace, rands, main_polys, aux_polys) = \
        scale_merger(dev)
    log(f"[phase 2b] the 2^20-row proof's fragment 0, through aux_commit: "
        f"{time.perf_counter() - t0:.3f} s")
    field_k5(merger, frames, 0, timer, sass, clock_hz, kernels,
             "fragment 0 of the 2^20-row proof", wrapped=last)
    air = merger.air
    del merger, frames, last
    torch.cuda.empty_cache()
    field_k6(air, trace, rands, timer, sass, clock_hz, kernels,
             "the 2^20-row proof's trace")
    del trace
    torch.cuda.empty_cache()
    zs = [int(v) for v in np.random.default_rng(SEED).integers(
        0, 1 << 63, 3)]
    field_k7([main_polys, aux_polys, device_felts((8, 1 << 20), gen, dev)],
             zs, timer, sass, clock_hz, kernels,
             "the OOD shape, 72 + 9 + 8 row blocks")
    del main_polys, aux_polys
    torch.cuda.empty_cache()
    field_k4(dev, gen, (72, 9, 8), 20, LOG_LDE, timer, sass, clock_hz,
             kernels)
    torch.cuda.empty_cache()


def _launches():
    from aero_tpu_torch.field import gl_cuda as fc
    from aero_tpu_torch.hash import blake2s_cuda as bc
    from aero_tpu_torch.ntt import ntt_cuda as nc
    return {**nc.LAUNCHES, **bc.LAUNCHES, **fc.LAUNCHES}


def _reset_launches():
    from aero_tpu_torch.field import gl_cuda as fc
    from aero_tpu_torch.hash import blake2s_cuda as bc
    from aero_tpu_torch.ntt import ntt_cuda as nc
    nc.reset_launches()
    bc.reset_launches()
    fc.reset_launches()


@contextlib.contextmanager
def watch_copies(trace_shape, coeff_shape):
    """Count, while the block runs, the calls of torch.roll on a card tensor
    of `trace_shape` and of torch.cat into one of `coeff_shape`: the copies
    K6 (the trace rolled by a row) and K7 (the trace's, aux and composition
    coefficient rows concatenated) do without; the next-row frames that K5
    reads in place where they wrap (torch.cat of views of an LDE's rows
    into (72 or 9, 2^20) on the card); and the zero-padded LDE inputs that
    kernel 1's LDE entry does
    without: calls of `coset_pad` and of torch.zeros for rows of the LDE
    domain, (rows, 2^23) on the card."""
    import importlib
    ntt_mod = importlib.import_module("aero_tpu_torch.ntt.ntt")
    seen = {"roll": 0, "cat": 0, "frame_cat": 0, "coset_pad": 0,
            "zeros_domain_rows": 0}
    roll, cat, zeros, pad = torch.roll, torch.cat, torch.zeros, \
        ntt_mod.coset_pad

    def counted_zeros(*size, **kwargs):
        shape = tuple(size[0]) if len(size) == 1 and isinstance(
            size[0], (tuple, list, torch.Size)) else size
        dev = kwargs.get("device")
        if (len(shape) >= 2 and shape[-1] == 1 << LOG_LDE and dev is not None
                and torch.device(dev).type == "cuda"):
            seen["zeros_domain_rows"] += 1
        return zeros(*size, **kwargs)

    def counted_pad(*args, **kwargs):
        seen["coset_pad"] += 1
        return pad(*args, **kwargs)

    def counted_roll(x, *args, **kwargs):
        if x.is_cuda and tuple(x.shape) == tuple(trace_shape):
            seen["roll"] += 1
        return roll(x, *args, **kwargs)

    def counted_cat(tensors, *args, **kwargs):
        out = cat(tensors, *args, **kwargs)
        if out.is_cuda and tuple(out.shape) == tuple(coeff_shape):
            seen["cat"] += 1
        if (out.is_cuda and tuple(out.shape) in ((72, 1 << 20), (9, 1 << 20))
                and all(t._base is not None
                        and t._base.shape[-1] == 1 << LOG_LDE
                        for t in tensors)):
            seen["frame_cat"] += 1      # pieces of an LDE's rows joined
        return out

    torch.roll, torch.cat, torch.zeros = counted_roll, counted_cat, \
        counted_zeros
    ntt_mod.coset_pad = counted_pad
    try:
        yield seen
    finally:
        torch.roll, torch.cat, torch.zeros = roll, cat, zeros
        ntt_mod.coset_pad = pad


def _prove(src: str, min_rows: int, dev):
    from aero_tpu_torch import sdk
    from aero_tpu_torch.sdk.pb import aero_pb2 as pb
    program = pb.MidenProgram(program=src)
    inputs = pb.MidenProgramInputs(stack_init=[1, 0])   # top-first [0, 1]
    return sdk.prove(program, inputs, min_rows=min_rows, device=dev)


def _verify(res, src: str) -> None:
    from aero_tpu_torch.air.miden import MidenAir
    from aero_tpu_torch.sdk import DEFAULT_OPTIONS
    from aero_tpu_torch.spec.verifier import verify
    proof, pub = res.native_proof, res.native_pub
    air = MidenAir(proof.context.trace_length, pub, DEFAULT_OPTIONS,
                   program=src)
    verify(proof, pub, air=air)


# the kernels of the main path
FIELD_KERNELS = ("gl_elementwise", "gl_scan", "gl_batch_inv",
                 "gl_deep_combine", "miden_frag_eval", "miden_aux_factors",
                 "gl_eval_multi")
# a proof's launches of K6 (one call) and K7 (one call of two launches),
# and the most K1 launches a 2^20-row proof may make (853 while the bus
# factors and the OOD evaluation ran op by op, 250 while K1 raised K5's
# x^adj rows, 72 launches)
PROOF_K6, PROOF_K7, PROOF_K1_MAX = 1, 2, 178
PATH_KERNELS = ("gl_colntt", "gl_colntt_lde", "blake2s_hash_columns",
                "blake2s_merge_level", "blake2s_grind_pow",
                "merkle_gather") + FIELD_KERNELS


def phase_golden(dev):
    from aero_tpu_torch.vm import fibonacci_source
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
    check(counts["miden_aux_factors"] == PROOF_K6
          and counts["gl_eval_multi"] == PROOF_K7,
          "the golden proof builds its bus factors in one K6 launch and "
          "evaluates its OOD rows in one K7 call")
    bench = bench_gpu.bench_proof(device=dev)
    check(bench_gpu.check_golden(bench.once) == digest,
          "bench_proof's proof == the golden digest")
    log(f"[phase 3] bench_gpu.bench_proof: second proof {bench.dt:.3f} s, "
        f"{bench.size} B, same sha256, verifies; launches "
        f"{bench.once.run.launches}")
    return res, digest, bench


def phase_scale(dev, kernels, proof_out):
    """The 2^20-row proofs: cold and steady through
    `bench_gpu.bench_proof_scale`, then the same program through `sdk.prove`,
    whose launches the `kernels` line reports. Returns the SDK's result and
    the bench."""
    from aero_tpu_torch.spec.proof import dump_proof_file
    r = bench_gpu.bench_proof_scale(device=dev)
    check(r.prep.rows == 1 << 20, "scale trace is 2^20 rows")
    data = r.cold.proof.to_bytes()
    log(f"[phase 4] 2^20-row proof (cold): {r.cold_dt:.3f} s, {len(data)} B, "
        f"peak device memory {r.cold.peak_bytes} B; launches "
        f"{r.cold.launches}")
    log("[phase 4] cold span seconds: "
        + json.dumps({"execute": r.prep.seconds, **r.cold.spans}))
    check(r.steady.proof.to_bytes() == data, "steady proof == cold proof")
    log(f"[phase 4] 2^20-row proof (steady): {r.steady_dt:.3f} s, peak "
        f"device memory {r.steady.peak_bytes} B")
    log("[phase 4] steady span seconds: " + json.dumps(r.steady.spans))
    _reset_launches()
    t0 = time.perf_counter()
    with watch_copies((72, 1 << 20), (72 + 9 + 8, 1 << 20)) as copies:
        res = _prove(r.prep.src, 1 << 20, dev)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _launches()
    log(f"[phase 4] sdk.prove, 2^20 rows (VM run, proof, protobuf): {dt:.3f} "
        f"s; launches {counts}")
    log(f"[phase 4] a 2^20-row proof launches K1 {counts['gl_elementwise']} "
        f"times (at most {PROOF_K1_MAX}), K6 {counts['miden_aux_factors']} "
        f"(one call), K7 {counts['gl_eval_multi']} (one call of two "
        f"launches); calls on the card of torch.roll of the (72, 2^20) "
        f"trace, of torch.cat into (89, 2^20) coefficient rows or into "
        f"(72 or 9, 2^20) next-row frames, of coset_pad and of torch.zeros "
        f"for (rows, 2^23): {copies}")
    check(counts["miden_aux_factors"] == PROOF_K6
          and counts["gl_eval_multi"] == PROOF_K7
          and counts["gl_elementwise"] <= PROOF_K1_MAX,
          f"the 2^20-row proof makes one K6 launch, one K7 call and at most "
          f"{PROOF_K1_MAX} K1 launches")
    check(copies == {"roll": 0, "cat": 0, "frame_cat": 0, "coset_pad": 0,
                     "zeros_domain_rows": 0},
          "no roll of the trace, no concatenation of the coefficient rows "
          "or of a next-row frame and no zero-padded LDE input on the card "
          "path")
    from aero_tpu_torch.utils import get_tracer
    frag = [r for r in get_tracer().records if r.name == "frag_eval"][-1]
    log(f"[phase 4] the 2^20-row proof's frag_eval span: {frag.meta}, "
        f"counters {frag.counters}")
    check(frag.counters.get("frames_in_place") == 1,
          "K5 reads the one wrapping next-row frame of the proof in place "
          "(frames_in_place 1)")
    check(res.native_proof.to_bytes() == data
          and res.native_pub.to_bytes() == r.prep.pub.to_bytes(),
          "sdk.prove's proof and public inputs == the bench's")
    for name in PATH_KERNELS:
        check(counts[name] > 0, f"{name} launched in the 2^20-row proof")
    for name in PATH_KERNELS:
        kernels[name]["launches"] = counts[name]
    t0 = time.perf_counter()
    _verify(res, r.prep.src)
    log(f"[phase 4] 2^20-row proof verifies under spec.verifier (air=port"
        f" air) in {time.perf_counter() - t0:.3f} s")
    with open(SCALE_DIGEST) as f:
        want = json.load(f)
    digest = hashlib.sha256(data).hexdigest()
    log(f"[phase 4] 2^20-row proof sha256 {digest}, {len(data)} B; committed "
        f"{want['sha256']}, {want['length']} B")
    if proof_out:     # written before the check, to remake the file
        os.makedirs(os.path.dirname(os.path.abspath(proof_out)),
                    exist_ok=True)
        with open(proof_out, "wb") as f:
            f.write(dump_proof_file(res.native_pub, res.native_proof))
        log(f"[phase 4] wrote the proof with its public inputs to "
            f"{proof_out}")
    check((digest, len(data)) == (want["sha256"], want["length"]),
          "the 2^20-row proof == the committed miden_2e20_rows.json")
    return res, r


def phase_reference_sizes(dev, smi: str) -> None:
    """The scale program at each size of `REFERENCE_LOG_ROWS` through
    `sdk.prove` on the card: its bytes must equal `aero_tpu`'s committed
    proof (on a difference, the first part that differs is named), and it
    must verify. Then the golden proof in fragments."""
    from aero_tpu_torch.tools.proof_diff import first_difference
    for log_rows in REFERENCE_LOG_ROWS:
        path = REFERENCE_PROOF.format(log_rows)
        with open(path + ".json") as f:
            want = json.load(f)
        with open(path + ".bin", "rb") as f:
            reference = f.read()
        src = long_fib_source(((1 << log_rows) - 64) // 12)
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated(dev)    # earlier phases' tables
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches()
        t0 = time.perf_counter()
        res = _prove(src, 1 << log_rows, dev)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        counts = _launches()
        peak = torch.cuda.max_memory_allocated(dev) - held
        data = res.native_proof.to_bytes()
        digest = hashlib.sha256(data).hexdigest()
        log(f"[phase 4b] 2^{log_rows} rows, sdk.prove (VM run, proof, "
            f"protobuf): {dt:.3f} s, peak device memory {peak} B above the "
            f"{held} B held before it, {len(data)} B, sha256 {digest}; "
            f"aero_tpu's {want['sha256']}, {want['length']} B; {smi}; "
            f"launches {json.dumps(counts)}")
        where = first_difference(data, reference)
        check(where is None and (digest, len(data)) == (want["sha256"],
                                                        want["length"]),
              f"the card's 2^{log_rows}-row proof == aero_tpu's (first part "
              f"that differs: {where})")
        for name in PATH_KERNELS:
            check(counts[name] > 0,
                  f"{name} launched in the 2^{log_rows}-row proof")
        _verify(res, src)
        log(f"[phase 4b] 2^{log_rows} rows: equal to aero_tpu's proof byte for"
            f" byte; verifies under spec.verifier (air=port air)")
    # the fragment path of proofs from 2^18 rows on (constraint evaluation
    # and DEEP in fragments, the last one's next-row frame wrapping round
    # the domain) at the golden proof's size, against aero_tpu's digest
    from aero_tpu_torch.prover import prover as prover_mod
    from aero_tpu_torch.vm import fibonacci_source
    with open(GOLDEN) as f:
        want = json.load(f)
    frag = prover_mod.FRAG
    prover_mod.FRAG = 1 << GOLDEN_LOG_FRAG
    try:
        _reset_launches()
        res = _prove(fibonacci_source(10), 1024, dev)
    finally:
        prover_mod.FRAG = frag
    counts = _launches()
    data = res.native_proof.to_bytes()
    digest = hashlib.sha256(data).hexdigest()
    log(f"[phase 4b] golden proof in fragments of 2^{GOLDEN_LOG_FRAG} points "
        f"(8, the last wrapping): sha256 {digest}; K5 launches "
        f"{counts['miden_frag_eval']}, K4 {counts['gl_deep_combine']}")
    check(digest == want["sha256"] and len(data) == want["length"]
          and counts["miden_frag_eval"] == 8,
          "the golden proof in 8 fragments == aero_tpu's digest, one K5 "
          "launch a fragment")


def phase_served(scale_res, golden_res) -> None:
    """A submission server answers five requests about proofs made on the
    card; verification is host code, so no kernel is launched here."""
    from aero_tpu_torch.sdk.pb import aero_pb2 as pb
    from aero_tpu_torch.sdk.server import (SubmissionError, SubmissionServer,
                                           submit_proof_remote)

    def request(res):
        return pb.ProofSubmissionRequest(
            proof=res.proof, public_inputs=res.public_inputs,
            source_proof_system=pb.MIDEN, target_chain=pb.STARKNET)

    def timed(what, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"[phase 5] {what}: {time.perf_counter() - t0:.3f} s")
        return out

    _reset_launches()
    server = SubmissionServer().start()
    try:
        url = f"http://127.0.0.1:{server.port}"
        req = request(scale_res)
        receipt = timed("2^20-row proof accepted",
                        lambda: submit_proof_remote(url, req))
        check(len(receipt) == 64 and int(receipt, 16) >= 0,
              "receipt is 64 hex characters")
        again = timed("2^20-row proof accepted again",
                      lambda: submit_proof_remote(url, req))
        check(again == receipt, "same receipt on a second submission")
        g_receipt = timed("golden proof accepted", lambda:
                          submit_proof_remote(url, request(golden_res)))
        check(len(g_receipt) == 64 and g_receipt != receipt,
              "golden proof has a receipt of its own")

        bad = request(scale_res)
        bad.proof.pow_nonce += 1

        def refused():
            try:
                submit_proof_remote(url, bad)
            except SubmissionError as e:
                return str(e)
            raise RuntimeError("check failed: tampered nonce was accepted")
        why = timed("tampered nonce refused", refused)
        log(f"[phase 5] the server said: {why!r}")

        def garbage():
            r = urllib.request.Request(
                url + "/submit_proof",
                data=b"not a protobuf of the right shape" * 5)
            try:
                urllib.request.urlopen(r, timeout=30)
            except urllib.error.HTTPError as e:
                return e.code
            raise RuntimeError("check failed: garbage bytes were accepted")
        check(timed("garbage bytes refused", garbage) == 400,
              "garbage bytes get HTTP 400")
    finally:
        server.stop()
    log(f"[phase 5] receipt {receipt}; server stopped; launches "
        f"{_launches()}")


def phase_parser(dev) -> None:
    """generate_proof on the card -> .bin -> Cairo-memory JSON -> the Cairo
    verifier's live sequence."""
    from aero_tpu_torch.air.miden import MidenAir
    from aero_tpu_torch.io.cairo_memory import (to_json, write_proof,
                                                write_public_inputs)
    from aero_tpu_torch.sdk import DEFAULT_OPTIONS
    from aero_tpu_torch.spec.cairo_sim import simulate_on_proof
    from aero_tpu_torch.spec.proof import load_proof_file
    from aero_tpu_torch.tools import generate_proof, stark_parser
    from aero_tpu_torch.vm import fibonacci_source

    with open(GOLDEN) as f:
        want = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fib.bin")
        _reset_launches()
        t0 = time.perf_counter()
        data = generate_proof.generate(n=10, out=path, min_rows=1024,
                                       device=dev)
        dt = time.perf_counter() - t0
        counts = _launches()
        for name in PATH_KERNELS:
            check(counts[name] > 0, f"{name} launched by generate_proof")
        with open(path, "rb") as f:
            check(f.read() == data, "the .bin holds the returned bytes")
        pub, proof = load_proof_file(path)
        digest = hashlib.sha256(proof.to_bytes()).hexdigest()
        log(f"[phase 6] generate_proof wrote {len(data)} B in {dt:.3f} s; "
            f"proof sha256 {digest}; launches {counts}")
        check(digest == want["sha256"],
              "the proof in the .bin == the golden aero_tpu digest")
        for cmd, writer, arg in (("proof", write_proof, proof),
                                 ("public-inputs", write_public_inputs, pub)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = stark_parser.main([path, cmd])
            memory = json.loads(buf.getvalue())
            check(rc == 0 and isinstance(memory, list) and len(memory) > 0
                  and buf.getvalue().strip() == to_json(writer, arg).strip(),
                  f"stark_parser {cmd} prints the Cairo memory")
            log(f"[phase 6] stark_parser {cmd}: {len(memory)} memory cells")
    air = MidenAir(proof.context.trace_length, pub, DEFAULT_OPTIONS,
                   program=fibonacci_source(10))
    t0 = time.perf_counter()
    positions = simulate_on_proof(
        proof, pub, num_transition=air.num_transition_constraints,
        num_assertions=air.num_assertions)
    check(len(positions) == DEFAULT_OPTIONS.num_queries,
          "cairo_sim opened every query")
    log(f"[phase 6] cairo_sim accepts the proof ({len(positions)} queries) "
        f"in {time.perf_counter() - t0:.3f} s")


# the dry run builds its aux segment (K6, K2) in its set-up, before its
# counts are reset, and evaluates no OOD point (K7)
DRYRUN_KERNELS = ("gl_colntt", "blake2s_hash_columns",
                  "blake2s_merge_level") + tuple(
                      k for k in FIELD_KERNELS
                      if k not in ("gl_scan", "miden_aux_factors",
                                   "gl_eval_multi"))
LOG_MXU_DRYRUN_ROWS = 18   # the single-device run phase 8 repeats through
                           # ntt_mxu
LOG_MESH_ROWS = 20         # the mesh's depth: the main path's trace
LOG_REFERENCE_MESH_ROWS = 14   # the depth of aero_tpu's committed roots
# the meshes phase 7 drives on one card at 2^LOG_MESH_ROWS rows, and the
# one it drives where there are four cards
MESHES = ((1, "device", "world 1, nccl"),
          (4, "host", "world 4, four processes sharing the card, exchange "
           "through pinned host memory and gloo"))
NCCL_WORLD4 = (4, "device", "world 4, nccl, one card a rank")
# a pipeline's peak device memory against the single device's at the
# mesh's depth: world 1 at most 1.25 times it, a rank of the host-shared
# world 4 at most 0.4 times world 1's
PEAK_WORLD1_OVER_SINGLE = 1.25
PEAK_WORLD4_OVER_WORLD1 = 0.4


def dryrun_kernel_shapes(world, log_rows: int, free_bytes: int):
    """What one rank of a `world`-rank dry run at 2^log_rows rows hands
    the kernels: the local transforms (rows, size, inverse) of every
    distributed NTT, with the LDEs in the chunks `dist_ntt.chunk_cols`
    gives for `free_bytes` of free device memory, the (columns, leaves) of
    every leaf hashing, and the chunk widths of the main, aux and
    composition LDEs (which the ranks must report). `world` None is the
    single-device pipeline: whole transforms, no chunks."""
    from aero_tpu_torch.parallel.dist_ntt import chunk_cols, split_sizes
    rows, m = 1 << log_rows, 8 << log_rows
    D = world or 1
    chunks = {w: w if world is None
              else chunk_cols(w, rows // D, m // D, free_bytes)
              for w in (72, 9, 8)}
    transforms = []
    # main and aux LDE; the composition's iNTT and the LDE of its 8
    # columns; the fold's iNTT and the NTT of the folded layer
    for w, n, inv in ((72, rows, True), (72, m, False), (9, rows, True),
                      (9, m, False), (1, m, True), (8, m, False),
                      (1, m // 8, False)):
        if world is None:
            transforms.append((w, n, inv))
            continue
        k1, k2, l1, l2 = split_sizes(n, world)
        c = chunks.get(w, w)
        for b in sorted({c, w % c} - {0}):      # a chunk, the last one
            for shape in ((b * l1, k2, inv), (b * l2, k1, inv)):
                if shape not in transforms:
                    transforms.append(shape)
    leaves = [(72, m // D), (9, m // D), (8, m // D),
              (8, m // 64 // D)]            # main, aux, constraint, fold
    return transforms, leaves, [chunks[72], chunks[9], chunks[8]]


def phase_dryrun_shapes(dev, gen, free_bytes: int) -> dict:
    """Each kernel against its plain version at the shapes the dry runs
    launch: the single device at 2^LOG_MXU_DRYRUN_ROWS rows, and the single
    device and every world at 2^LOG_MESH_ROWS rows, with the chunk widths
    the ranks will choose; before the dry runs are driven. Returns those
    widths a world."""
    from aero_tpu_torch.hash import blake2s_cuda as bc
    from aero_tpu_torch.ntt.ntt_cuda import ntt_cuda, ntt_four_step_plain
    seen = set()
    chunks = {}
    runs = [(None, LOG_MXU_DRYRUN_ROWS), (None, LOG_MESH_ROWS)] + [
        (w, LOG_MESH_ROWS) for w in sorted({m[0] for m in MESHES}
                                           | {NCCL_WORLD4[0]})]
    for world, log_rows in runs:
        transforms, leaves, chunks[world] = dryrun_kernel_shapes(
            world, log_rows, free_bytes)
        who = (f"world {world}" if world else "the single device") + (
            f" at 2^{log_rows} rows")
        for shape in transforms:
            if shape in seen:
                continue
            seen.add(shape)
            B, n, inv = shape
            x = device_felts((B, n), gen, dev)
            k = ntt_cuda(x, inv)
            step = max(1, (1 << 26) // n)       # rows a plain call takes
            err = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for a in range(0, B, step):
                err = max(err, max_abs_err(
                    k[a:a + step], ntt_four_step_plain(x[a:a + step], inv)))
            torch.cuda.synchronize()
            pms = (time.perf_counter() - t0) * 1e3
            check(err == 0, f"gl_colntt {B} x {n} inverse={inv} kernel == "
                  "four-step plain")
            del k
            ms = cuda_ms(lambda: ntt_cuda(x, inv), iters=2)
            log(f"[phase 7] shapes of {who}: "
                f"{'intt' if inv else 'ntt'} {B} x {n}: kernel {ms:.3f} ms, "
                f"four-step plain {pms:.3f} ms, max_abs_err {err}")
            del x
        for shape in leaves:
            if shape in seen:
                continue
            seen.add(shape)
            w, n = shape
            cols = device_felts(shape, gen, dev)
            k = bc.hash_columns(cols)
            err, pms = plain_chunks(bc.hash_columns_plain, cols, 1, k)
            check(err == 0, f"hash_columns {w} x {n} kernel == plain")
            ms = cuda_ms(lambda: bc.hash_columns(cols), iters=2)
            log(f"[phase 7] shapes of {who}: hash_columns {w} x {n}: "
                f"kernel {ms:.3f} ms, plain {pms:.3f} ms, max_abs_err {err}")
            del cols, k
        torch.cuda.empty_cache()
    log(f"[phase 7] chunk widths (main, aux, composition LDE) each world "
        f"will take with {free_bytes} B free: " + json.dumps(
            {str(w): c for w, c in chunks.items() if w}))
    # every merge of every commit, whatever the world: a block's levels, the
    # fold's and the top of the tree over the gathered digests are all
    # (8, 2n) -> (8, n) with 2n a power of two up to the whole domain
    d = torch.randint(0, 1 << 32, (8, 8 << LOG_MESH_ROWS), generator=gen,
                      device=dev, dtype=torch.int64)
    worst, levels = 0, 0
    while d.shape[1] > 1:
        k = bc.merge_level(d)
        err, _ = plain_chunks(bc.merge_level_plain, d, 2, k)
        check(err == 0, f"merge_level {d.shape[1]} -> {k.shape[1]} kernel == "
              "plain")
        worst, levels, d = max(worst, err), levels + 1, k
    log(f"[phase 7] shapes of every world: merge_level at each of the "
        f"{levels} levels from 2^{LOG_MESH_ROWS + 3} digests down to the "
        f"root: kernel == plain, max_abs_err {worst}")
    del d, k
    # the field kernels: the aux bus scans (4, rows), the divisors of a
    # block (2, m / D) and the DEEP divisors of a fragment (3, m_frag) of
    # both depths; K4 and K5 on the last fragment (2^20 points) of the
    # whole 2^21-point domain at 2^18 rows, of a world-1 block (2^23) and
    # of a world-4 block (2^21) at 2^20 rows
    worst = 0
    for log_n in (LOG_MXU_DRYRUN_ROWS, LOG_MESH_ROWS):
        worst = max(worst, field_k1(dev, gen, log_n, None, None, None))
    for shape in ((4, 1 << 18), (2, 1 << 21), (3, 1 << 19), (4, 1 << 20),
                  (2, 1 << 23), (3, 1 << 20)):
        worst = max(worst, field_k2(dev, gen, shape, (1, 77), None, None,
                                    None))
    for log_rows, log_m, log_ld in ((LOG_MXU_DRYRUN_ROWS, 20, 21),
                                    (LOG_MESH_ROWS, 20, 23),
                                    (LOG_MESH_ROWS, 20, 21)):
        worst = max(worst, field_k4(dev, gen, (72, 9, 8), log_m, log_ld,
                                    None, None, None))
        merger, frames, a0 = dryrun_merger(dev, gen, log_m, log_ld, log_rows)
        worst = max(worst, field_k5(merger, frames, a0, None, None, None,
                                    what=f"2^{log_m} of a block of "
                                    f"2^{log_ld} at 2^{log_rows} rows"))
        del merger, frames
        torch.cuda.empty_cache()
    # the aux build of each dry run (in its set-up): K6 over the trace
    from aero_tpu_torch.air.miden import MidenAir
    rng = np.random.default_rng(SEED + LOG_MESH_ROWS)
    for rows in (64, 1 << LOG_MXU_DRYRUN_ROWS, 1 << LOG_MESH_ROWS):
        rands = [int(v) for v in rng.integers(0, 1 << 63, 16)]
        worst = max(worst, field_k6(object.__new__(MidenAir),
                                    device_felts((72, rows), gen, dev),
                                    rands, None, None, None,
                                    what=f"{rows} rows"))
    log(f"[phase 7] shapes of every world: K1 at 2^{LOG_MXU_DRYRUN_ROWS} and "
        f"2^{LOG_MESH_ROWS}, K2 on the aux scans and divisors, K4 and K5 "
        f"on the last fragments of 2^21- and 2^23-point blocks, K6 on traces "
        f"of 64, 2^{LOG_MXU_DRYRUN_ROWS} and 2^{LOG_MESH_ROWS} rows: kernel "
        f"== plain, max_abs_err {worst}")
    return chunks


def dryrun_merger(dev, gen, log_m: int, log_ld: int, log_rows: int):
    """A MidenAir merger over one rank's block of 2^log_ld points of the
    2^log_rows-row dry run's domain (the last block), seeded coefficients
    and rands, and the frames of the block's last fragment of 2^log_m
    points as `parallel.sharded.stage_composition` hands them: cur a view
    of the block, nxt the block's tail followed by the next block's first
    points (the halo), read in place as a `Wrapped` pair."""
    from aero_tpu_torch.air.miden import MidenAir, make_public_inputs
    from aero_tpu_torch.prover import prover as PR
    from aero_tpu_torch.sdk import DEFAULT_OPTIONS
    from aero_tpu_torch.vm import execute_full, fibonacci_source, program_hash
    src = fibonacci_source(10)
    _, out, ovf = execute_full(src, [0, 1], min_rows=64)
    pub = make_public_inputs(program_hash(src), [0, 1], out, overflow=ovf)
    air = MidenAir(1 << log_rows, pub, DEFAULT_OPTIONS, program=src)
    rng = np.random.default_rng(SEED + log_m)
    air._aux_rand = [int(v) for v in rng.integers(0, 1 << 63, 16)]
    cc_t = [tuple(int(v) for v in rng.integers(0, 1 << 63, 2))
            for _ in range(air.num_transition_constraints)]
    cc_b = [tuple(int(v) for v in rng.integers(0, 1 << 63, 2))
            for _ in range(air.num_assertions)]
    m_blk, m_frag, b = 1 << log_ld, 1 << log_m, DEFAULT_OPTIONS.blowup_factor
    first = (8 << log_rows) - m_blk
    merger = PR.ConstraintMerger(air, air._aux_rand, cc_t, cc_b,
                                 PR.ceval_domain(air, dev, first, m_blk), dev,
                                 first=first)
    a0 = m_blk - m_frag
    frames = []
    for w in (72, 9):
        block = device_felts((w, m_blk), gen, dev)
        halo = device_felts((w, b), gen, dev)
        frames += [block[:, a0:], PR.Wrapped(block[:, a0 + b:], halo)]
    return merger, tuple(frames), a0


def phase_dryrun(dev, gen, kernels):
    """The sharded stages end to end: world 1 on nccl and world 4 sharing
    the card at 64 rows against the golden roots, and at 2^LOG_MESH_ROWS
    rows against the single-device pipeline (world 4 on nccl too where
    there are four cards); first the kernels against their plain versions
    at the shapes of those runs. Returns the single-device roots at
    2^LOG_MXU_DRYRUN_ROWS rows, which phase 8 repeats."""
    from aero_tpu_torch.parallel import dryrun as dr

    torch.cuda.empty_cache()
    chunks = phase_dryrun_shapes(dev, gen, torch.cuda.mem_get_info(dev)[0])
    torch.cuda.empty_cache()

    def peaks(r):
        return (f"peak device memory: set-up {r['setup_peak_device_bytes']}"
                f" B, pipeline {r['peak_device_bytes']} B")

    def report(what, out, want, rows, world):
        check(out.matches_single_device
              and [list(r) for r in out[:4]] == want,
              f"{what}: roots equal the reference")
        for name, root in zip(dr.ROOT_NAMES, out[:4]):
            log(f"[phase 7] {what}: {name}_root {dr.root_hex(root)}")
        total = {}
        for r in out.ranks:
            check(r["rows"] == rows, f"{what}: the trace has {rows} rows")
            for name in DRYRUN_KERNELS:
                check(r["launches"][name] > 0,
                      f"{what}: rank {r['rank']} launched {name}")
            if rows == 1 << LOG_MESH_ROWS:
                check(r["chunk_cols"] == chunks[world],
                      f"{what}: rank {r['rank']} took the LDE chunks "
                      f"{chunks[world]} whose shapes were checked, not "
                      f"{r['chunk_cols']}")
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
            log(f"[phase 7] {what} rank {r['rank']}: set-up "
                f"{r['setup_seconds']:.3f} s; stage seconds "
                + json.dumps(r["seconds"]) + "; again (warm) "
                + json.dumps(r["seconds_warm"]) + "; LDE chunks "
                + json.dumps(r["chunk_cols"]) + "; exchanges [calls, bytes "
                "sent] " + json.dumps(r["traffic"]) + "; launches "
                + json.dumps(r["launches"]) + "; " + peaks(r))
        return total

    golden = dr.golden_roots(64)
    for world, exchange, how in MESHES:
        t0 = time.perf_counter()
        out = dr.dryrun_prove_core(world, 64, device=dev, exchange=exchange,
                                   reference=golden, timeout_s=300)
        report(f"64 rows, {how}", out, golden, 64, world)
        log(f"[phase 7] 64 rows, {how}: equal to the committed golden roots;"
            f" {time.perf_counter() - t0:.3f} s with the start of the ranks")
    # aero_tpu's roots at 2^14 rows: the single device and world 1 on nccl
    # (world 4 on nccl too where there are four cards)
    rows = 1 << LOG_REFERENCE_MESH_ROWS
    golden = dr.golden_roots(rows)
    single = dr.single_device_dryrun(rows, dev)
    check(single["roots"] == golden, f"2^{LOG_REFERENCE_MESH_ROWS} rows, "
          "single device: roots equal aero_tpu's committed ones")
    reference_runs = [MESHES[0]]
    if torch.cuda.device_count() >= NCCL_WORLD4[0]:
        reference_runs.append(NCCL_WORLD4)
    for world, exchange, how in reference_runs:
        t0 = time.perf_counter()
        out = dr.dryrun_prove_core(world, rows, device=dev, exchange=exchange,
                                   reference=golden, timeout_s=300)
        what = f"2^{LOG_REFERENCE_MESH_ROWS} rows, {how}"
        report(what, out, golden, rows, world)
        log(f"[phase 7] {what}: equal to aero_tpu's committed roots (and the "
            f"single device's on the card); {time.perf_counter() - t0:.3f} s"
            " with the start of the ranks")

    def single_device(log_rows):
        rows = 1 << log_rows
        torch.cuda.empty_cache()
        single = dr.single_device_dryrun(rows, dev,
                                         long_fib_source((rows - 64) // 12),
                                         [0, 1])
        check(single["rows"] == rows, f"the dry-run trace has 2^{log_rows}"
              " rows")
        for name, root in zip(dr.ROOT_NAMES, single["roots"]):
            log(f"[phase 7] 2^{log_rows} rows, single device: {name}_root "
                f"{dr.root_hex(root)}")
        log(f"[phase 7] 2^{log_rows} rows, single device: set-up "
            f"{single['setup_seconds']:.3f} s; stage seconds "
            + json.dumps(single["seconds"]) + "; again (warm) "
            + json.dumps(single["seconds_warm"]) + "; launches "
            + json.dumps(single["launches"]) + "; " + peaks(single))
        return single

    mxu_roots = single_device(LOG_MXU_DRYRUN_ROWS)["roots"]
    single = single_device(LOG_MESH_ROWS)
    rows = 1 << LOG_MESH_ROWS
    src = long_fib_source((rows - 64) // 12)
    runs = list(MESHES)
    if torch.cuda.device_count() >= NCCL_WORLD4[0]:
        runs.append(NCCL_WORLD4)
    else:
        log(f"[phase 7] {NCCL_WORLD4[2]}: not run, this machine has "
            f"{torch.cuda.device_count()} CUDA card(s) "
            f"(torch.cuda.device_count())")
    for name in PATH_KERNELS:
        kernels[name]["launches_dryrun_world4_nccl"] = None
    rank_peaks = {}
    for world, exchange, how in runs:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = dr.dryrun_prove_core(world, rows, device=dev,
                                   exchange=exchange,
                                   reference=single["roots"], source=src,
                                   inputs=[0, 1], timeout_s=600)
        what = f"2^{LOG_MESH_ROWS} rows, {how}"
        total = report(what, out, single["roots"], rows, world)
        log(f"[phase 7] {what}: equal to the single-device roots; "
            f"{time.perf_counter() - t0:.3f} s with the start of the ranks")
        check(total["blake2s_grind_pow"] == 0,
              "the dry run has no proof of work and launches no grind")
        key = (f"launches_dryrun_world{world}"
               + ("_nccl" if (world, exchange) == NCCL_WORLD4[:2] else ""))
        for name in PATH_KERNELS:
            kernels[name][key] = total[name]
        rank_peaks[exchange, world] = max(r["peak_device_bytes"]
                                          for r in out.ranks)
    w1 = rank_peaks["device", 1]
    w4 = rank_peaks["host", 4]
    log(f"[phase 7] 2^{LOG_MESH_ROWS} rows, pipeline peak device memory: "
        f"single device {single['peak_device_bytes']} B, world 1 {w1} B "
        f"({w1 / single['peak_device_bytes']:.4f} of the single device's), "
        f"the largest rank of world 4 sharing the card {w4} B "
        f"({w4 / w1:.4f} of world 1's)")
    check(w1 <= PEAK_WORLD1_OVER_SINGLE * single["peak_device_bytes"],
          f"world 1's pipeline peak is at most {PEAK_WORLD1_OVER_SINGLE} "
          "times the single device's")
    check(w4 <= PEAK_WORLD4_OVER_WORLD1 * w1,
          f"a rank of world 4 peaks at most {PEAK_WORLD4_OVER_WORLD1} times "
          "world 1's")
    return mxu_roots


def mxu_products_ms(k: int, m: int, dev) -> tuple:
    """(milliseconds, products, multiply-adds) of the int8 products one DFT
    pass of `ntt_mxu` makes for a (k, m) operand, and nothing else: the same
    `_int8_matmul` on the same column chunks, 108 products a chunk on the
    Karatsuba route (k >= 1024) and 256 on the schoolbook route."""
    from aero_tpu_torch.ntt import ntt_mxu as mx
    count = 108 if k >= 1024 else 256
    step = max(8, mx.CHUNK_POINTS // k)
    widths = [min(step, m - a) for a in range(0, m, step)]
    f = torch.randint(0, 16, (k, k), dtype=torch.int8, device=dev)
    xts = {w: torch.randint(0, 16, (w, k), dtype=torch.int8, device=dev)
           for w in set(widths)}

    def run():
        for w in widths:
            for _ in range(count):
                mx._int8_matmul(f, xts[w])
    return cuda_ms(run, iters=3), count * len(widths), count * k * k * m


@contextlib.contextmanager
def transforms_through_mxu(routed: list):
    """Inside the block, every transform of the port on a CUDA tensor whose
    size lies in MXU_LOGS goes through `ntt_mxu` / `intt_mxu`; the others
    take the NTT kernel as always. The package has no such switch: this
    replaces its dispatch function here, for the block."""
    import importlib
    from aero_tpu_torch.ntt.ntt_mxu import intt_mxu, ntt_mxu
    # the package's attribute `ntt.ntt` is the function; this is the module
    nn = importlib.import_module("aero_tpu_torch.ntt.ntt")
    kernel_path = nn._transform

    def dispatch(x, invert):
        log_n = x.shape[-1].bit_length() - 1
        if x.is_cuda and MXU_LOGS[0] <= log_n <= MXU_LOGS[1]:
            routed.append((x.numel() >> log_n, log_n, invert))
            return intt_mxu(x) if invert else ntt_mxu(x)
        return kernel_path(x, invert)

    nn._transform = dispatch
    try:
        yield
    finally:
        nn._transform = kernel_path


def phase_mxu(dev, rng, gen, golden_digest, dryrun_roots) -> None:
    from aero_tpu_torch.field import P, from_u64
    from aero_tpu_torch.ntt import ntt_plain
    from aero_tpu_torch.ntt import ntt_mxu as mx
    from aero_tpu_torch.ntt.ntt_cuda import ntt_cuda
    from aero_tpu_torch.parallel import dryrun as dr
    from aero_tpu_torch.tools import card_check
    from aero_tpu_torch.vm import fibonacci_source

    log(f"[phase 8] int8 bound: multiply-adds x 2 operations over "
        f"{INT8_OPS_PER_S / 1e12:.0f} TOPS, the H100 SXM data sheet's dense "
        "int8 tensor-core rate")
    # why `_int8_matmul` hands `_int_mm` its second operand column-major:
    # one product of the Karatsuba route's chunk shape in both layouts
    k, m = 1024, mx.CHUNK_POINTS // 1024
    a = torch.randint(0, 16, (k, k), dtype=torch.int8, device=dev)
    bt = torch.randint(0, 16, (m, k), dtype=torch.int8, device=dev)
    b_row = bt.t().contiguous()
    check(torch.equal(torch._int_mm(a, bt.t()), torch._int_mm(a, b_row)),
          "_int_mm gives the same product in both layouts")
    col_ms = cuda_ms(lambda: torch._int_mm(a, bt.t()), iters=20)
    row_ms = cuda_ms(lambda: torch._int_mm(a, b_row), iters=20)
    log(f"[phase 8] torch._int_mm ({k} x {k}) @ ({k} x {m}): second operand "
        f"column-major {col_ms:.4f} ms ({2 * k * k * m / col_ms / 1e9:.1f} "
        f"TOPS), row-major {row_ms:.4f} ms "
        f"({2 * k * k * m / row_ms / 1e9:.1f} TOPS)")
    del a, bt, b_row
    shapes = (((3,), 6), ((2,), 8), ((2, 4), 10), ((8,), 13), ((8,), 18),
              ((72,), 20))
    for batch, log_n in shapes:
        n = 1 << log_n
        shape = batch + (n,)
        what = " x ".join(map(str, batch)) + f" x 2^{log_n}"
        k1, k2 = mx._factor(n)
        x = (device_felts(shape, gen, dev) if log_n >= 18 else
             from_u64(rng.integers(0, P, size=shape, dtype=np.uint64), dev))
        for inv, fn in ((False, mx.ntt_mxu), (True, mx.intt_mxu)):
            name = "intt_mxu" if inv else "ntt_mxu"
            mx.reset_products()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            got = fn(x)
            peak = torch.cuda.max_memory_allocated() - held
            launched = mx.PRODUCTS["int8_matmul"]
            want = ntt_cuda(x, inv)
            err = max_abs_err(got, want)
            check(err == 0, f"{name} {what} == the NTT kernel")
            check(launched > 0, f"{name} {what} launched its int8 products")
            plain = ""
            if log_n <= 18:
                check(torch.equal(got, ntt_plain(x, inv)),
                      f"{name} {what} == ntt_plain")
                plain = " == ntt_plain"
            del got, want
            log(f"[phase 8] {name} {what} (tiles {k1} x {k2}): == the NTT "
                f"kernel{plain}, max_abs_err {err}; {launched} int8 products"
                f"; peak device memory above the input {peak} B")
            if log_n < 18:
                continue
            ms = cuda_ms(lambda: fn(x), iters=2)
            kms = cuda_ms(lambda: ntt_cuda(x, inv))
            log(f"[phase 8] {name} {what}: whole transform {ms:.3f} ms, the "
                f"NTT kernel (gl_colntt, 2 launches) {kms:.3f} ms: "
                f"{ms / kms:.1f} x")
        if log_n < 18:
            continue
        B = x.numel() // n
        del x
        p_ms, products, macs = 0.0, 0, 0
        for k, m in ((k1, B * k2), (k2, B * k1)):
            t, c, w = mxu_products_ms(k, m, dev)
            p_ms, products, macs = p_ms + t, products + c, macs + w
        b_ms = 2 * macs / INT8_OPS_PER_S * 1e3
        log(f"[phase 8] {what}: the int8 products alone ({products} calls of "
            f"torch._int_mm, {macs} multiply-adds, "
            f"{macs // (B * n)} a point): {p_ms:.3f} ms; bound {b_ms:.3f} ms "
            f"by operations: {100 * b_ms / p_ms:.1f} % of the bound reached, "
            f"{2 * macs / p_ms / 1e9:.1f} TOPS")
    torch.cuda.empty_cache()

    routed = []
    with transforms_through_mxu(routed):
        mx.reset_products()
        res = _prove(fibonacci_source(10), 1024, dev)
    digest = hashlib.sha256(res.native_proof.to_bytes()).hexdigest()
    log(f"[phase 8] golden proof with {len(routed)} transforms through "
        f"ntt_mxu (rows, log size, inverse) {sorted(set(routed))}, "
        f"{mx.PRODUCTS['int8_matmul']} int8 products: sha256 {digest}")
    check(len(routed) > 0 and digest == golden_digest,
          "golden proof through ntt_mxu == phase 3's sha256")

    rows = 1 << LOG_MXU_DRYRUN_ROWS
    routed = []
    with transforms_through_mxu(routed):
        mx.reset_products()
        single = dr.single_device_dryrun(rows, dev,
                                         long_fib_source((rows - 64) // 12),
                                         [0, 1])
    log(f"[phase 8] 2^{LOG_MXU_DRYRUN_ROWS}-row single-device dry run with "
        f"{len(routed)} transforms through ntt_mxu {sorted(set(routed))}, "
        f"{mx.PRODUCTS['int8_matmul']} int8 products: stage seconds "
        + json.dumps(single["seconds"]) + "; launches "
        + json.dumps(single["launches"]))
    for name, root in zip(dr.ROOT_NAMES, single["roots"]):
        log(f"[phase 8] 2^{LOG_MXU_DRYRUN_ROWS} rows through ntt_mxu: "
            f"{name}_root {dr.root_hex(root)}")
    check((72, LOG_MXU_DRYRUN_ROWS, True) in routed
          and single["roots"] == dryrun_roots,
          "dry-run roots through ntt_mxu == phase 7's single-device roots")
    torch.cuda.empty_cache()

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = card_check.main()
    for line in buf.getvalue().splitlines():
        log(f"[phase 8] card_check: {line}")
    check(rc == 0, "card_check passes")


def plain_merkle_root(leaves: torch.Tensor) -> bytes:
    """The root over word-major leaf digests (8, n) by the plain merge,
    2^20 digests a call."""
    from aero_tpu_torch.hash import blake2s_cuda as bc
    d = leaves
    while d.shape[1] > 1:
        d = torch.cat([bc.merge_level_plain(d[:, a:a + (1 << 20)].contiguous())
                       for a in range(0, d.shape[1], 1 << 20)], dim=1)
    return d[:, 0].cpu().numpy().astype("<u4").tobytes()


def phase_bench(dev, rng, gen, sass, clock_hz, proof_bench, scale_bench):
    from aero_tpu_torch.field import P, from_u64, to_u64
    from aero_tpu_torch.hash import blake2s_cuda as bc
    from aero_tpu_torch.ntt import coset_pad, intt, ntt, ntt_plain
    from aero_tpu_torch.ntt import ntt_cuda as nc
    from aero_tpu_torch.spec import field as F

    # three levels with a pass limit of 8: every stride of the last pass,
    # which runs once for each row of the batch
    for logn in (7, 8, 9):
        x = from_u64(rng.integers(0, P, size=(3, 2, 1 << logn),
                                  dtype=np.uint64), dev)
        for inv in (False, True):
            nc.reset_launches()
            k = nc.ntt_cuda(x, inv, max_l=8)
            check(nc.LAUNCHES["gl_colntt"] == 2 + 6,
                  "three levels: two launches and one a row")
            check(torch.equal(k, ntt_plain(x, inv))
                  and torch.equal(k, nc.ntt_four_step_plain(x, inv, 8)),
                  f"ntt 2^{logn} x 6, pass limit 8, inv={inv}: kernel == "
                  "both plain versions")
    log("[phase 9] three-level ntt/intt 2^7..2^9 x 3 x 2 with the pass limit "
        "at 8: kernel == both plain versions")

    for logn in (25, 27):
        n = 1 << logn
        x = device_felts((1, n), gen, dev)
        t0 = time.perf_counter()
        nc.reset_launches()
        k = ntt(x)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        check(nc.LAUNCHES["gl_colntt"] == 3, "three launches for one row")
        if logn == 25:
            p = nc.ntt_four_step_plain(x, False)
            err = max_abs_err(k, p)
            check(err == 0, "ntt 2^25 kernel == three-pass plain rendering")
            pms = cuda_ms(lambda: nc.ntt_four_step_plain(x, False), iters=1)
            del p
        else:
            err, pms = 0, float("nan")
        back = intt(k)
        check(torch.equal(back, x), f"intt(ntt(x)) == x at 2^{logn}")
        del back
        ms = cuda_ms(lambda: ntt(x), iters=3)
        # both directions in turn: the cache holds both sets of tables
        pair_ms = cuda_ms(lambda: intt(ntt(x)), iters=2)
        check(nc.table_cache_bytes() >= 2 * n * 8,
              f"the forward and the inverse tables of 2^{logn} stay cached")
        log(f"[phase 9] ntt 2^{logn} x 1 (3 launches; split "
            f"{nc.tables.three_level_split(n)}): round trip exact; kernel "
            f"{ms:.3f} ms, ntt then intt in turn {pair_ms:.3f} ms a pair, "
            f"first call with its tables {first_s:.3f} s, plain "
            f"rendering {pms:.3f} ms, max_abs_err {err}; table cache "
            f"{nc.table_cache_bytes()} B of {nc.TABLE_CACHE_BYTES}")
        # bytes: the row in and out and the outer cross table, each once
        record({}, None, "", err, ms, pms, 3 * n * 8,
               ntt_terms(sass, logn, 1), None, clock_hz)
        del x, k
    nc.clear_table_cache()
    torch.cuda.empty_cache()

    r = bench_gpu.bench_ntt(device=dev)
    x = bench_gpu.draw_felts(np.random.default_rng(0), (8, 1 << 18), dev)
    want = ntt_plain(coset_pad(ntt_plain(x, True), 3))[..., :1 << 18]
    check(torch.equal(r.out, want), "bench_ntt's pipeline == radix-2 plain")
    log("[phase 9] bench_ntt 8 x 2^18, blowup 8: == the plain versions")
    bench_gpu.emit_ntt(r)
    del x, want, r

    r = bench_gpu.bench_merkle(device=dev)
    h = bench_gpu.bench_hash(device=dev)
    cols = bench_gpu.draw_felts(np.random.default_rng(1), (72, 1 << 20), dev)
    err, pms = plain_chunks(bc.hash_columns_plain, cols, 1, h.digests,
                            chunk=1 << 18)
    check(err == 0, "bench_hash's digests == plain at 72 x 2^20")
    root = plain_merkle_root(h.digests)
    check(r.root == root, "bench_merkle's root == the plain versions' root")
    log(f"[phase 9] bench_merkle / bench_hash 72 x 2^20: digests and root "
        f"{root.hex()} == the plain versions (plain leaves {pms:.3f} ms)")
    bench_gpu.emit_merkle(r)
    bench_gpu.emit_hash(h)
    del cols, h, r

    r = bench_gpu.bench_mul(device=dev)
    a = bench_gpu.draw_felts(np.random.default_rng(2), (1 << 21,), dev)
    idx = torch.arange(0, 1 << 21, (1 << 21) // 64 + 1, device=dev)
    got, src = to_u64(r.out[idx]), to_u64(a[idx])
    check(all(int(g) == F.mul(int(v), int(v)) for g, v in zip(got, src)),
          "bench_mul == spec.field.mul on a sample")
    log(f"[phase 9] bench_mul 2^21: == spec.field.mul on {len(got)} samples")
    bench_gpu.emit_mul(r, bench_gpu.mul_launches(device=dev))
    del a, r

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = bench_gpu.bench_lde_2e24(device=dev)
    log(f"[phase 9] bench_lde_2e24: the batched 8 x 2^24 transform == "
        f"ntt.lde's single 2^27-point transform; {time.perf_counter() - t0:.3f}"
        f" s with inputs and tables, peak device memory "
        f"{torch.cuda.max_memory_allocated()} B")
    bench_gpu.emit_lde24(r)
    del r
    nc.clear_table_cache()
    torch.cuda.empty_cache()

    bench_gpu.emit_scale(scale_bench)
    bench_gpu.emit_proof(proof_bench)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    proof_out = argv[argv.index("--proof-out") + 1] \
        if "--proof-out" in argv else None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from aero_tpu_torch import _build

    def smi_query(fields: str) -> str:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True
        ).stdout.strip().splitlines()[0]

    smi = smi_query("name,power.limit")
    clock_mhz = float(smi_query("clocks.max.sm").split()[0])
    clock_hz = clock_mhz * 1e6
    log(f"[set-up] {smi}; max SM clock {clock_mhz:.0f} MHz; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    t0 = time.perf_counter()
    probe = start_probe_build()
    lib = _build.build()
    _build.load()
    log(f"[set-up] kernels built in {time.perf_counter() - t0:.3f} s: {lib}")
    sass = read_sass_counts(lib, probe)
    ntt_res = ntt_resources(lib)
    k5_res = k5_resources(lib, sass)
    k6_res, k7_res = k6_k7_resources(lib, sass)
    # the C++ VM builds itself at its first run; keep that out of phase 3
    from aero_tpu_torch.vm import execute_full, fibonacci_source
    t0 = time.perf_counter()
    execute_full(fibonacci_source(1), [0, 1], min_rows=64)
    log(f"[set-up] VM ready (built at first run) in "
        f"{time.perf_counter() - t0:.3f} s")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    kernels = {
        **{name: dict(route="cuda", source=FIELD_SRC, replaces=where,
                      note=note)
           for name, (where, note) in FIELD_REPLACES.items()},
        "gl_colntt": dict(route="cuda", source=NTT_SRC, replaces=NTT_TPU,
                          note=NTT_NOTE, **ntt_res[False]),
        "gl_colntt_lde": dict(route="cuda", source=NTT_SRC, replaces=NTT_TPU,
                              note=NTT_LDE_NOTE, **ntt_res[True]),
        "blake2s_hash_columns": dict(route="cuda", source=B2S_SRC,
                                     replaces=B2S_TPU),
        "blake2s_merge_level": dict(route="cuda", source=B2S_SRC,
                                    replaces=B2S_TPU),
        "blake2s_grind_pow": dict(route="cuda", source=B2S_SRC,
                                  replaces=B2S_TPU),
        "merkle_gather": dict(route="cuda", source=B2S_SRC,
                              replaces="none: aero_tpu's ResidentMerkleTree "
                              "gathers a level at a time (merkle/tree.py)"),
        "miden_frag_eval": dict(route="cuda", source=K5_SRC,
                                replaces=K5_REPLACES[0],
                                note=K5_REPLACES[1], **k5_res),
        "miden_aux_factors": dict(route="cuda", source=K6_SRC,
                                  replaces=K6_REPLACES[0],
                                  note=K6_REPLACES[1], **k6_res),
        "gl_eval_multi": dict(route="cuda", source=K7_SRC,
                              replaces=K7_REPLACES[0], note=K7_REPLACES[1],
                              **k7_res),
    }
    phase_blake2s(dev, rng, kernels, sass, clock_hz)
    phase_blake2s_path_shapes(dev, gen, kernels, sass, clock_hz)
    phase_ntt(dev, rng, gen, kernels, sass, clock_hz)
    torch.cuda.empty_cache()
    phase_field(dev, gen, kernels, sass, clock_hz)
    golden_res, golden_digest, proof_bench = phase_golden(dev)
    scale_res, scale_bench = phase_scale(dev, kernels, proof_out)
    phase_reference_sizes(dev, smi)
    scale_bench = scale_bench._replace(       # phase 9 needs the times only
        prep=scale_bench.prep._replace(trace=None, air=None))
    phase_served(scale_res, golden_res)
    phase_parser(dev)
    dryrun_roots = phase_dryrun(dev, gen, kernels)
    del scale_res
    torch.cuda.empty_cache()
    phase_mxu(dev, rng, gen, golden_digest, dryrun_roots)
    torch.cuda.empty_cache()
    phase_bench(dev, rng, gen, sass, clock_hz, proof_bench, scale_bench)

    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "launches_dryrun_world1", "launches_dryrun_world4",
            "launches_dryrun_world4_nccl")
    print(json.dumps({"kernels": [
        {"name": name, **{key: k[key] for key in keys},
         **{key: k[key] for key in ("host_ms", "symbolic_branch_ns", "note",
                                    "registers",
                                    "stack_bytes", "spill_instructions",
                                    "global_loads", "blocks_per_sm",
                                    "warps_per_sm", "words_read_per_point",
                                    "radix16_alu", "radix16_fma",
                                    "radix16_memory",
                                    "route_ms", "last_fragment_ms",
                                    "op_by_op_k1_ms")
            if key in k}}
        for name, k in kernels.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
