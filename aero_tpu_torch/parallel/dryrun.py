"""The dry-run pipeline: the sharded stages end to end on a small mesh.

The counterpart of `aero_tpu/parallel/sharded.py:283-430` and of the entry
point `__graft_entry__.dryrun_multichip`. `MidenAir` at full width (72 + 9
columns, 112 constraints, blowup 8, FRI folding 8) goes through
LDE -> commit -> composition -> commit -> DEEP -> FRI fold -> commit, with
fixed numbers standing in for the Fiat-Shamir challenges, and the four
Merkle roots (main, aux, constraint, first FRI fold) are compared with the
single-device pipeline's. The fixed numbers are part of the reference and
are the JAX package's, so at 64 rows the roots equal its committed
`dryrun_golden.json`, of which `dryrun_golden.json` beside this module is
the port's own copy.

Two modes, equal roots:
- `mesh=None`: one device, through the prover's own stage code
  (`prover.stage_constraint_eval`, `_deep_core`, `fold_evals`,
  `commit_columns`);
- a mesh: the stages of `sharded.py` on local blocks.

    python -m aero_tpu_torch.parallel.dryrun --world 4 [--rows 64]
        [--exchange device|host] [--cpu]

starts the ranks as processes, runs the pipeline, prints the four roots
and whether they match, and exits non-zero if they do not or a rank died.
It runs on the CUDA card unless `--cpu` is given and raises without one.
With fewer cards than ranks, `--exchange host` puts every rank on card 0
and stages the exchanges through pinned host memory; that is never chosen
for the caller.

Each process (a rank, or the caller for one device) runs the pipeline
twice after its set-up and reports both passes' seconds per stage
(`seconds`, then `seconds_warm`: the first pass carries the cost of first
use, module loading and table builds); the second pass's roots must equal
the first's. On a CUDA device it also reports the peak device memory of
the set-up (`setup_peak_device_bytes`) and of the two passes
(`peak_device_bytes`, the high-water mark reset after the set-up), each
net of what the process held before the dry run began.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..field import from_u64, gl_cuda, scalar
from ..hash import blake2s_cuda
from ..merkle import commit_columns
from ..ntt import intt, lde, ntt_cuda
from ..prover import ProverState
from ..prover.fri import fold_evals
from ..prover.prover import (FRAG, _ceval_static, _deep_core,
                             stage_constraint_eval)
from ..spec import field as F
from .dist_ntt import lde_chunk_cols
from .mesh import Mesh, run_ranks, shard_domain
from .sharded import (fold_leaf_columns, stage_commit, stage_composition,
                      stage_deep, stage_fri_fold, stage_lde)

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "dryrun_golden.json")
ROOT_NAMES = ("main", "aux", "constraint", "fold")

# exercises u32 and memory operations, so the chiplet rows are not empty
DRYRUN_SRC = """
    begin
        push.4294967295 push.1 u32add
        push.3 u32sub
        push.12 push.10 u32xor
        mem.store.5 drop mem.load.5
        drop drop
    end
    """


class DryrunOut(NamedTuple):
    main_root: tuple
    aux_root: tuple
    constraint_root: tuple
    fold_root: tuple
    matches_single_device: bool
    ranks: tuple = ()       # each rank's report (seconds, traffic, launches,
                            # peaks)


def _dryrun_air_and_traces(trace_steps: int = 64, device="cpu",
                           source: str = DRYRUN_SRC,
                           inputs: Sequence[int] = (0, 0)):
    """The dry-run workload: MidenAir over a real VM trace of at least
    `trace_steps` rows, with its aux segment built from fixed rands."""
    from ..air.miden import MidenAir, make_public_inputs
    from ..spec.proof import ProofOptions
    from ..vm import execute, program_hash

    trace_np, out_stack = execute(source, list(inputs), min_rows=trace_steps)
    n = trace_np.shape[1]
    pub = make_public_inputs(program_hash(source), list(inputs), out_stack)
    opts = ProofOptions(num_queries=7, blowup_factor=8, grinding_factor=1)
    air = MidenAir(n, pub, opts, program=source)

    aux_rand_ints = [7919 * (i + 1) ** 2 for i in range(air.aux_rands)]
    trace = from_u64(trace_np, device)
    aux = air.build_aux_trace(trace, aux_rand_ints)
    # rand-dependent boundary values (the ROM product) read the rands
    air._aux_rand = [r % F.P for r in aux_rand_ints]
    return air, trace, aux, aux_rand_ints


class _FixedCoin:
    """Hands the prover's constraint stage the fixed coefficient pairs."""

    def __init__(self, pairs):
        self._pairs = iter(pairs)

    def draw_pair(self):
        return next(self._pairs)

    def reseed(self, _):
        pass


class _StageClock:
    """Seconds per stage on the host clock, each closed by a synchronize
    on a CUDA device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds = {}
        self._t0 = self._now()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, stage: str) -> None:
        t = self._now()
        self.seconds[stage] = self.seconds.get(stage, 0.0) + t - self._t0
        self._t0 = t


def _words(root) -> List[int]:
    """A root as the golden file stores it: eight u32 words."""
    if isinstance(root, bytes):
        return [int.from_bytes(root[i:i + 4], "little")
                for i in range(0, 32, 4)]
    return [int(w) for w in root.cpu().tolist()]


def _pipeline_roots(air, trace: torch.Tensor, aux: torch.Tensor,
                    aux_rand_ints, log_blowup: int,
                    mesh: Optional[Mesh] = None, clock=None,
                    cols_per_chunk: Optional[int] = None):
    """Run LDE -> commit -> composition -> commit -> DEEP -> FRI fold ->
    commit and return the four roots, each as eight u32 words. With a mesh,
    `trace` and `aux` are this rank's blocks, and its LDEs take
    `cols_per_chunk` columns at a time (None: `dist_ntt.lde_chunk_cols`)."""
    opts = air.options
    ff = opts.fri_folding_factor
    clock = clock or _StageClock(trace.device)
    nt, nb = air.num_transition_constraints, air.num_assertions
    cc_t = [(11 + i, 13 + i) for i in range(nt)]
    cc_b = [(17 + i, 19 + i) for i in range(nb)]
    w = air.main_width + air.aux_width
    ce = air.ce_blowup
    deep_args = dict(z=98765, zg=43210, zm=55555, cur_vals=[0] * w,
                     nxt_vals=[0] * w, ood_vals=[0] * ce, deep_a=[1] * w,
                     deep_b=[1] * w, deep_c=[1] * ce, lam=7, mu=9)
    alpha = 31337

    if mesh is not None:
        _, main_lde = stage_lde(mesh, trace, log_blowup, cols_per_chunk)
        _, aux_lde = stage_lde(mesh, aux, log_blowup, cols_per_chunk)
        clock.lap("lde")
        main_root = stage_commit(mesh, main_lde)
        aux_root = stage_commit(mesh, aux_lde)
        clock.lap("commit")
        constraint_lde = stage_composition(
            mesh, air, main_lde, aux_lde, aux_rand_ints, cc_t, cc_b,
            log_blowup, cols_per_chunk=cols_per_chunk)
        clock.lap("composition")
        constraint_root = stage_commit(mesh, constraint_lde)
        clock.lap("commit")
        deep = stage_deep(mesh, main_lde, aux_lde, constraint_lde,
                          w_lde=air.lde_generator, **deep_args)
        clock.lap("deep")
        folded = stage_fri_fold(mesh, deep, alpha, ff)
        clock.lap("fri_fold")
        fold_root = stage_commit(mesh, fold_leaf_columns(mesh, folded, ff))
        clock.lap("commit")
        return [_words(r) for r in (main_root, aux_root, constraint_root,
                                    fold_root)]

    device = trace.device
    st = ProverState(pub_inputs=air.pub_inputs, device=str(device))
    st.main_lde = lde(intt(trace), log_blowup, F.DOMAIN_OFFSET)
    st.aux_lde = lde(intt(aux), log_blowup, F.DOMAIN_OFFSET)
    clock.lap("lde")
    main_root = commit_columns(st.main_lde).root
    aux_root = commit_columns(st.aux_lde).root
    clock.lap("commit")
    st.aux_rand = list(aux_rand_ints)
    st.coin = _FixedCoin(cc_t + cc_b)
    stage_constraint_eval(air, st)
    clock.lap("composition")        # the prover's stage commits as well
    constraint_root = st.constraint_tree.root

    def vec(ints):
        return from_u64(np.array(ints, dtype=np.uint64), device)

    d = deep_args
    args = (vec(d["cur_vals"]), vec(d["nxt_vals"]), vec(d["ood_vals"]),
            vec(d["deep_a"]), vec(d["deep_b"]), vec(d["deep_c"]),
            *(scalar(d[k], device) for k in ("z", "zg", "zm", "lam", "mu")))
    x_dom = _ceval_static(air, device)[0]
    m = x_dom.shape[0]
    m_frag = min(m, FRAG)
    deep = torch.cat([
        _deep_core(st.main_lde[:, a:a + m_frag], st.aux_lde[:, a:a + m_frag],
                   st.constraint_lde[:, a:a + m_frag], x_dom[a:a + m_frag],
                   *args)
        for a in range(0, m, m_frag)])
    clock.lap("deep")
    folded = fold_evals(deep, alpha, ff)
    clock.lap("fri_fold")
    fold_root = commit_columns(folded.reshape(ff, -1)).root
    clock.lap("commit")
    return [_words(r) for r in (main_root, aux_root, constraint_root,
                                fold_root)]


def _launches() -> dict:
    return {**ntt_cuda.LAUNCHES, **blake2s_cuda.LAUNCHES,
            **gl_cuda.LAUNCHES}


def _reset_launches() -> None:
    ntt_cuda.reset_launches()
    blake2s_cuda.reset_launches()
    gl_cuda.reset_launches()


class _Peaks:
    """Device memory high-water marks of a CUDA device, net of what was
    allocated when this object was made; on the CPU every figure is
    None."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.base = self._reset() if self.device.type == "cuda" else None

    def _reset(self) -> int:
        torch.cuda.synchronize(self.device)     # CUDA up: the reset needs it
        torch.cuda.reset_peak_memory_stats(self.device)
        return torch.cuda.memory_allocated(self.device)

    def read_and_reset(self) -> Optional[int]:
        """The peak since the last reset, net of the base; a new mark
        starts."""
        if self.base is None:
            return None
        peak = torch.cuda.max_memory_allocated(self.device) - self.base
        self._reset()
        return peak


def _twice(mesh: Optional[Mesh], air, trace, aux, rands, peaks: _Peaks,
           setup_s: float, cols_per_chunk: Optional[int] = None) -> dict:
    """The pipeline twice after a set-up of `setup_s` seconds: the first
    pass's roots, seconds, launches (and a mesh's traffic and the chunk
    widths of its main, aux and composition LDEs), the second pass's
    seconds, and the set-up's and the two passes' peak device memory. The
    second pass must give the first's roots. A mesh's chunk width
    (`cols_per_chunk` None: `dist_ntt.lde_chunk_cols` of the main LDE,
    resolved once, before the first pass) holds for every LDE of both."""
    setup_peak = peaks.read_and_reset()
    device = trace.device
    if mesh is not None and cols_per_chunk is None:
        blk = trace.shape[-1]
        cols_per_chunk = lde_chunk_cols(mesh, trace.shape[0], blk, blk << 3)
    _reset_launches()
    clock = _StageClock(device)
    roots = _pipeline_roots(air, trace, aux, rands, 3, mesh, clock,
                            cols_per_chunk)
    out = dict(roots=roots, seconds=clock.seconds, launches=_launches(),
               setup_seconds=setup_s, rows=air.trace_length)
    if mesh is not None:
        out.update(traffic={k: list(v) for k, v in mesh.traffic.items()},
                   chunk_cols=[min(w, cols_per_chunk) for w in (
                       trace.shape[0], aux.shape[0], air.ce_blowup)])
    warm = _StageClock(device)
    again = _pipeline_roots(air, trace, aux, rands, 3, mesh, warm,
                            cols_per_chunk)
    if again != roots:
        raise RuntimeError(f"the second pass's roots {again} differ from "
                           f"the first's {roots}")
    out.update(seconds_warm=warm.seconds, setup_peak_device_bytes=setup_peak,
               peak_device_bytes=peaks.read_and_reset())
    return out


def single_device_dryrun(trace_steps: int = 64, device=None,
                         source: str = DRYRUN_SRC,
                         inputs: Sequence[int] = (0, 0)) -> dict:
    """The pipeline on one device (None: the CUDA card), twice: its four
    roots, the seconds per stage of both passes, the kernel launches of
    the first and the peak device memory (see the module's docstring)."""
    device = resolve_device(device)
    peaks = _Peaks(device)
    t0 = time.perf_counter()
    air, trace, aux, rands = _dryrun_air_and_traces(trace_steps, device,
                                                    source, inputs)
    return _twice(None, air, trace, aux, rands, peaks,
                  time.perf_counter() - t0)


def single_device_dryrun_roots(trace_steps: int = 64, device=None
                               ) -> List[List[int]]:
    """The four pipeline roots on ONE device: the reference the sharded
    pipeline is held to, and what `tools.regen_dryrun_golden` writes."""
    return single_device_dryrun(trace_steps, device)["roots"]


def _rank_pipeline(mesh: Mesh, trace_steps: int, source: str,
                   inputs: Sequence[int],
                   cols_per_chunk: Optional[int] = None) -> dict:
    """One rank of the sharded pipeline: build the workload (every rank
    runs the VM itself; the trace is then cut into blocks), run the
    stages twice, report."""
    peaks = _Peaks(mesh.device)
    t0 = time.perf_counter()
    air, trace, aux, rands = _dryrun_air_and_traces(trace_steps, mesh.device,
                                                    source, inputs)
    trace, aux = shard_domain(mesh, trace), shard_domain(mesh, aux)
    return dict(rank=mesh.rank, **_twice(mesh, air, trace, aux, rands, peaks,
                                         time.perf_counter() - t0,
                                         cols_per_chunk))


def rank_devices(world: int, device, exchange: str) -> List[str]:
    """The device of each rank. On the CPU every rank is a CPU process;
    on the card rank r takes card r, and only exchange="host" lets the
    ranks share card 0."""
    device = resolve_device(device)
    if device.type == "cpu":
        if exchange != "device":
            raise ValueError("the CPU mesh exchanges through gloo directly: "
                             "exchange must be 'device'")
        return ["cpu"] * world
    if exchange == "host":
        return ["cuda:0"] * world
    if torch.cuda.device_count() < world:
        raise RuntimeError(
            f"{world} ranks need {world} CUDA cards for a device exchange "
            f"and this machine has {torch.cuda.device_count()}; "
            "exchange='host' shares one card and is never chosen for you")
    return [f"cuda:{r}" for r in range(world)]


def _ready_builds(on_cuda: bool) -> None:
    """Build what the ranks load, once, before they start: D ranks must not
    race to compile."""
    from .. import _build
    from ..vm import _ensure_built
    _ensure_built()
    if on_cuda:
        _build.build()


def dryrun_prove_core(world: int, trace_steps: int = 64, device=None,
                      exchange: str = "device", reference=None,
                      source: str = DRYRUN_SRC,
                      inputs: Sequence[int] = (0, 0),
                      timeout_s: float = 600.0,
                      cols_per_chunk: Optional[int] = None) -> DryrunOut:
    """Run the sharded pipeline on a mesh of `world` ranks (processes) and
    compare every root with the single-device pipeline's. The ranks' LDEs
    take `cols_per_chunk` columns at a time (None: `dist_ntt.lde_chunk_cols`).

    The reference roots are `reference` if given; at 64 rows of the
    default program the committed golden file; else a single-device run on
    `device` here in the caller's process."""
    devices = rank_devices(world, device, exchange)
    if reference is None:
        if trace_steps == 64 and source == DRYRUN_SRC:
            with open(GOLDEN_PATH) as f:
                reference = json.load(f)["roots"]
        else:
            reference = single_device_dryrun(trace_steps, device, source,
                                             inputs)["roots"]
    _ready_builds(devices[0] != "cpu")
    ranks = run_ranks(_rank_pipeline, world, devices,
                      (trace_steps, source, tuple(inputs), cols_per_chunk),
                      exchange, timeout_s)
    roots = ranks[0]["roots"]
    for r in ranks[1:]:
        if r["roots"] != roots:
            raise RuntimeError(f"rank {r['rank']} disagrees with rank 0 on "
                               f"the roots: {r['roots']} != {roots}")
    ok = [list(map(int, r)) for r in reference] == roots
    return DryrunOut(*(tuple(r) for r in roots), matches_single_device=ok,
                     ranks=tuple(ranks))


def root_hex(words) -> str:
    return b"".join(int(w).to_bytes(4, "little") for w in words).hex()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4, help="number of ranks")
    ap.add_argument("--rows", type=int, default=64, help="trace rows")
    ap.add_argument("--exchange", choices=("device", "host"),
                    default="device",
                    help="host: every rank on card 0, exchanges staged "
                    "through pinned host memory and gloo")
    ap.add_argument("--cpu", action="store_true",
                    help="run the ranks on the CPU instead of CUDA cards")
    args = ap.parse_args(argv)
    out = dryrun_prove_core(args.world, args.rows,
                            device="cpu" if args.cpu else None,
                            exchange=args.exchange)
    for name, root in zip(ROOT_NAMES, out[:4]):
        print(f"{name}_root {root_hex(root)}")
    for r in out.ranks:
        print(f"rank {r['rank']}: seconds " + json.dumps(r["seconds"])
              + " seconds_warm " + json.dumps(r["seconds_warm"])
              + " traffic " + json.dumps(r["traffic"])
              + f" chunk_cols {r['chunk_cols']}"
              + f" setup_peak_device_bytes {r['setup_peak_device_bytes']}"
              + f" peak_device_bytes {r['peak_device_bytes']}")
    print("roots match the single-device pipeline: "
          f"{out.matches_single_device}")
    return 0 if out.matches_single_device else 1


if __name__ == "__main__":
    sys.exit(main())
