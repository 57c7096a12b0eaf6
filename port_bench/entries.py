"""The entries a cell drives: the resident prover and the SDK.

An entry is built from a configuration, a cell and a seed. `setup()`
makes everything the window's requests need and proves once for each
distinct input it holds (the first of those is the process's cold
proof); `request(k)` is one request of the closed loop, from its start to
its proof as bytes on the host; `close()` frees what the entry holds on
the card. Nothing an entry keeps is derived from one request's trace for
the next; the prover's tables keyed by size are the program's own.

- `prove`: a pool of `pool` executed traces held on the device, each
  from its own seeded stack inputs; request k proves trace k mod pool
  with `prover.prove` and serializes it with `StarkProof.to_bytes()`.
- `sdk`: request k calls `sdk.prove` on the program with fresh seeded
  stack inputs and the SDK's default options, at the configuration's
  rows, and serializes the `pb.StarkProof` and the
  `pb.MidenPublicInputs` it returns.

The inputs are drawn from the seed alone (`inputs(seed, stream, k)`), so
the same seed gives the same requests in the same order.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .programs import program_source

P = (1 << 64) - (1 << 32) + 1
POOL, SDK, SDK_WARMUP = 0, 1, 2       # input streams of a seed


def inputs(seed: int, stream: int, k: int, count: int = 2) -> List[int]:
    """`count` stack inputs, top first, drawn as field elements."""
    rng = np.random.default_rng([seed % (1 << 64), stream, k])
    return [int(v) for v in rng.integers(0, P, size=count, dtype=np.uint64)]


@dataclass
class Answer:
    key: int                      # which input it answers (a pool slot, a request)
    inputs: List[int]             # stack inputs, top first
    proof: bytes                  # the serialized proof
    public: Optional[bytes] = None    # the serialized public inputs, where returned
    spans: list = field(default_factory=list)


def _options(cfg: dict, control: bool):
    """The configuration's proof options, with one query fewer for the
    control (a proof below the stated security)."""
    o = dict(cfg["options"])
    if control:
        o["num_queries"] -= 1
    return o


class ProveEntry:
    def __init__(self, cfg, cell, seed, device, control=False):
        self.cfg, self.cell, self.seed, self.device = cfg, cell, seed, device
        self.src = program_source(cfg["program"])
        self.opts = _options(cfg, control)
        self.pool: list = []

    def setup(self) -> None:
        from aero_tpu_torch.air.miden import MidenAir, make_public_inputs
        from aero_tpu_torch.field import from_u64
        from aero_tpu_torch.spec.proof import ProofOptions
        from aero_tpu_torch.vm import execute_full, program_hash
        rows = self.cfg["rows"]
        opts = ProofOptions(**self.opts)
        phash = program_hash(self.src)
        for i in range(self.cell["pool"]):
            ins = inputs(self.seed, POOL, i)
            trace, out, ovf = execute_full(self.src, ins, min_rows=rows,
                                           max_rows=rows)
            if trace.shape[1] != rows:
                raise RuntimeError(f"the program's trace has {trace.shape[1]} "
                                   f"rows, the configuration {rows}")
            pub = make_public_inputs(phash, ins, out, overflow=ovf)
            air = MidenAir(rows, pub, opts, program=self.src)
            self.pool.append((ins, air, from_u64(trace, self.device), pub))
        for i in range(len(self.pool)):
            self.request(i)

    def request(self, k: int) -> Answer:
        from aero_tpu_torch.prover import prove
        slot = k % len(self.pool)
        ins, air, trace, pub = self.pool[slot]
        proof = prove(air, trace, pub)
        t = time.perf_counter()
        data = proof.to_bytes()
        return Answer(slot, ins, data,
                      spans=[("serialize", t, time.perf_counter())])

    def close(self) -> None:
        self.pool.clear()


class SdkEntry:
    def __init__(self, cfg, cell, seed, device, control=False):
        self.cfg, self.cell, self.seed, self.device = cfg, cell, seed, device
        self.src = program_source(cfg["program"])
        self.opts = _options(cfg, control) if control else None

    def setup(self) -> None:
        for j in range(self.cell["warmup"]):
            self._prove(inputs(self.seed, SDK_WARMUP, j), -1 - j)

    def request(self, k: int) -> Answer:
        return self._prove(inputs(self.seed, SDK, k), k)

    def _prove(self, ins, key) -> Answer:
        from aero_tpu_torch import sdk
        from aero_tpu_torch.sdk import pb
        options = None
        if self.opts is not None:
            options = pb.ProofOptions(
                num_queries=self.opts["num_queries"],
                blowup_factor=self.opts["blowup_factor"],
                grinding_factor=self.opts["grinding_factor"],
                fri_folding_factor=self.opts["fri_folding_factor"],
                fri_max_remainder_size=self.opts["fri_max_remainder_size"])
        # stack_init is bottom first: the VM sees ins top first
        res = sdk.prove(pb.MidenProgram(program=self.src),
                        pb.MidenProgramInputs(stack_init=ins[::-1]),
                        options=options, min_rows=self.cfg["rows"],
                        device=self.device)
        t = time.perf_counter()
        proof = res.proof.SerializeToString()
        public = res.public_inputs.SerializeToString()
        return Answer(key, ins, proof, public,
                      spans=[("serialize", t, time.perf_counter())])

    def close(self) -> None:
        pass


ENTRIES = {"prove": ProveEntry, "sdk": SdkEntry}
