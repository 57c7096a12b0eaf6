"""Whether a run's answers are correct, by the plain reference.

Every answer is a proof of the configuration's program on the stack
inputs the harness drew from the seed. After the window the reference
(`reference/`, which imports nothing of the program) works out on its
own what such a proof must state, the program hash, the ROM, the output
stack and the overflow table, and verifies each proof checked against
that: its context (the rows, the trace layout, the options the
configuration states), the trace, aux and constraint commitments and
every opening of them, the OOD frame against MidenAir's 112 constraints
and 46 assertions, the DEEP composition, every FRI layer and the
remainder, and the proof of work. Where the SDK also returns the public
inputs, they must equal the reference's.

Which answers are checked: in a `prove` cell every request proves a
trace of the pool, and the protocol fixes a proof's bytes, so every
answer is compared byte for byte with the others of its slot and each
distinct proof is verified; in an `sdk` cell a sample of the window's
answers drawn from the seed (`check_sample`, 0 for all), with the first
and the last.

The numbers compared, each an exact count with the limit 0:

- `failed`: requests that raised or never answered;
- `rejected`: answers the reference does not accept;
- `under_target`: answers whose options give less than the stated
  security (queries x log2(blowup) + grinding bits);
- `unequal_repeats`: slots of the pool with more than one distinct proof.
"""

from __future__ import annotations

import random
import sys
from typing import Dict, List

from .reference import miden, miden_air, verifier, wire
from .reference.proof import StarkProof

LIMITS = {"failed": 0, "rejected": 0, "under_target": 0, "unequal_repeats": 0}


def say(msg: str) -> None:
    print(f"check: {msg}", file=sys.stderr)


def security_bits(opts) -> int:
    return (opts.num_queries * (opts.blowup_factor.bit_length() - 1)
            + opts.grinding_factor)


def judge_proof(proof: StarkProof, expected, cfg: dict, rom) -> str:
    """'' if the reference accepts `proof` as the configuration's proof
    of `expected` (its public inputs), else why not."""
    ctx = proof.context
    lay = ctx.layout
    t = cfg["trace"]
    want = cfg["options"]
    got = {"num_queries": ctx.options.num_queries,
           "blowup_factor": ctx.options.blowup_factor,
           "grinding_factor": ctx.options.grinding_factor,
           "fri_folding_factor": ctx.options.fri_folding_factor,
           "fri_max_remainder_size": ctx.options.fri_max_remainder_size}
    if got != want:
        return f"options {got}, the configuration states {want}"
    if ctx.trace_length != cfg["rows"]:
        return f"{ctx.trace_length} rows, the configuration has {cfg['rows']}"
    if (lay.main_width, list(lay.aux_widths), list(lay.aux_rands)) != (
            t["main_width"], t["aux_widths"], t["aux_rands"]):
        return "trace layout differs from the configuration's"
    air = miden_air.MidenAir(cfg["rows"], expected, rom)
    try:
        verifier.verify(proof, expected, air=air)
    except verifier.VerificationError as e:
        return f"verification: {e}"
    return ""


def _sample(n: int, k: int, seed: int) -> List[int]:
    """k of the indices 0..n-1 drawn from the seed, with the first and
    the last; all of them where k is 0 or not below n."""
    if k <= 0 or k >= n:
        return list(range(n))
    rest = random.Random(seed).sample(range(1, n - 1), max(0, k - 2))
    return sorted({0, n - 1, *rest})


def check(run) -> Dict[str, int]:
    """The compared numbers of a finished run (see the module's text)."""
    from .programs import program_source
    cfg, cell = run.config, run.cell
    src = program_source(cfg["program"])
    rom = miden.rom_listing(src)
    reqs = run.window + run.traced
    out = dict.fromkeys(LIMITS, 0)
    out["failed"] = sum(r.answer is None for r in reqs)
    answers = [r.answer for r in reqs if r.answer is not None]
    expected_by_inputs: dict = {}

    def expected(ins):
        key = tuple(ins)
        if key not in expected_by_inputs:
            expected_by_inputs[key] = miden.public_inputs(src, ins)
        return expected_by_inputs[key]

    def judge_one(a, data: bytes) -> bool:
        try:
            proof = (wire.stark_proof(data) if a.public is not None
                     else StarkProof.from_bytes(data))
        except (ValueError, IndexError, AssertionError) as e:
            say(f"request for {a.inputs}: unreadable proof: {e}")
            return False
        if security_bits(proof.context.options) < cfg["security_bits"]:
            out["under_target"] += 1
        exp = expected(a.inputs)
        if a.public is not None:
            try:
                pub = wire.public_inputs(a.public)
            except ValueError as e:
                say(f"unreadable public inputs: {e}")
                return False
            if pub.to_bytes() != exp.to_bytes():
                say(f"request for {a.inputs}: public inputs differ from "
                    "the reference's")
                return False
        why = judge_proof(proof, exp, cfg, rom)
        if why:
            say(f"request for {a.inputs}: {why}")
        return not why

    if cell["entry"] == "prove":
        verdict: dict = {}
        by_slot: dict = {}
        for a in answers:
            by_slot.setdefault(a.key, set()).add(a.proof)
            if (a.key, a.proof) not in verdict:
                verdict[(a.key, a.proof)] = judge_one(a, a.proof)
            out["rejected"] += not verdict[(a.key, a.proof)]
        out["unequal_repeats"] = sum(len(v) > 1 for v in by_slot.values())
        out["checked"] = len(answers)
    else:
        picked = _sample(len(answers), int(cell["check_sample"]), run.seed)
        for i in picked:
            out["rejected"] += not judge_one(answers[i], answers[i].proof)
        out["checked"] = len(picked)
    return out


def correct(checks: Dict[str, int]) -> bool:
    return checks["checked"] > 0 and all(
        checks[k] <= lim for k, lim in LIMITS.items())
