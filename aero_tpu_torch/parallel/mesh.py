"""The process group of the multi-device path, and its one exchange.

The counterpart of `aero_tpu/parallel/sharded.py` `make_mesh` (:44) and
`shard_domain` (:49). JAX's mesh is one process that owns D devices; here
a mesh is D ranks of a `torch.distributed` process group with one device
each. Every function of `parallel/` takes a `Mesh` and the LOCAL shard
`(..., n / D)` of the trailing domain axis: rank r holds the contiguous
block r.

`all_to_all` is the only place that knows how tensors travel between
ranks. Which way they travel is the caller's choice, made when the mesh is
built, and never changes behind its back:

  exchange="device"  the group's backend moves the tensors where they lie:
                     `nccl` for CUDA tensors (one card per rank), `gloo`
                     for CPU tensors;
  exchange="host"    CUDA tensors are staged through pinned host memory and
                     travel over `gloo`. This lets several ranks share one
                     card (NCCL refuses two ranks on one device), which is
                     how the index arithmetic is checked for D > 1 on a
                     machine with a single card.

`mesh.traffic` counts, per label, the calls and the bytes this rank sent.

`run_ranks` starts the ranks of a mesh as processes and returns what each
one returned; a rank that raises, dies or outlives the time limit fails
the whole run.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..field import from_u64, to_u64

EXCHANGES = ("device", "host")


@dataclass
class Mesh:
    group: Any                      # torch.distributed.ProcessGroup
    rank: int
    world: int
    device: torch.device
    exchange: str                   # "device" or "host"
    traffic: Dict[str, List[int]] = field(default_factory=dict)

    def count(self, label: str, nbytes: int) -> None:
        calls_bytes = self.traffic.setdefault(label, [0, 0])
        calls_bytes[0] += 1
        calls_bytes[1] += nbytes

    def close(self) -> None:
        dist.destroy_process_group(self.group)


def make_mesh(world: int, rank: int, device, init_method: str,
              exchange: str = "device", timeout_s: float = 120.0) -> Mesh:
    """Join the group of `world` ranks as `rank`, holding `device`. The
    backend follows from the device and the exchange: `nccl` for a CUDA
    device with exchange="device", `gloo` otherwise. A collective that
    waits longer than `timeout_s` raises instead of hanging."""
    device = torch.device(device)
    if exchange not in EXCHANGES:
        raise ValueError(f"make_mesh: exchange must be one of {EXCHANGES}")
    if world < 1 or world & (world - 1):
        raise ValueError("make_mesh: the world size must be a power of two")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; pass "
                               "a CPU device to run on the CPU")
        torch.cuda.set_device(device)
        backend = "nccl" if exchange == "device" else "gloo"
    elif device.type == "cpu":
        if exchange == "host":
            raise ValueError("make_mesh: exchange='host' stages CUDA tensors;"
                             " a CPU mesh uses exchange='device'")
        backend = "gloo"
    else:
        raise ValueError(f"make_mesh: unsupported device {device}")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh(dist.group.WORLD, rank, world, device, exchange)


# ---------------------------------------------------------------- exchange

def _travel(mesh: Mesh, t: torch.Tensor, collective) -> torch.Tensor:
    """Run `collective(input) -> output` where the mesh's exchange mode
    puts the tensors: in place, or staged through pinned host memory."""
    if mesh.exchange == "device" or t.device.type == "cpu":
        return collective(t)
    staged = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    staged.copy_(t)
    return collective(staged).to(t.device)


def all_to_all(mesh: Mesh, t: torch.Tensor, label: str,
               in_splits: Optional[Sequence[int]] = None,
               out_splits: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Split `t` along axis 0 into one piece per rank (equal pieces, or
    `in_splits` rows each), send piece j to rank j, and return the pieces
    received, in rank order, along axis 0 (`out_splits` rows each)."""
    t = t.contiguous()
    rows = t.shape[0] if out_splits is None else sum(out_splits)
    mesh.count(label, t.numel() * t.element_size())

    def collective(src: torch.Tensor) -> torch.Tensor:
        dst = torch.empty((rows,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device, pin_memory=src.is_pinned())
        dist.all_to_all_single(
            dst, src,
            None if out_splits is None else list(out_splits),
            None if in_splits is None else list(in_splits),
            group=mesh.group)
        return dst

    return _travel(mesh, t, collective)


def all_gather(mesh: Mesh, t: torch.Tensor, label: str) -> torch.Tensor:
    """Every rank's `t`, stacked along a new axis 0 in rank order."""
    t = t.contiguous()
    mesh.count(label, t.numel() * t.element_size())

    def collective(src: torch.Tensor) -> torch.Tensor:
        dst = torch.empty((mesh.world,) + tuple(src.shape), dtype=src.dtype,
                          device=src.device)
        dist.all_gather(list(dst.unbind(0)), src, group=mesh.group)
        return dst

    return _travel(mesh, t, collective)


def swap_blocks(mesh: Mesh, v: torch.Tensor, label: str) -> torch.Tensor:
    """The transposing exchange of the distributed NTT: local `v` of shape
    (b, A, D, C) -> (b, D, A, C) with out[:, j] = rank j's v[:, :, me]
    (`jax.lax.all_to_all(v, axis, 2, 1)` of `aero_tpu/parallel/dist_ntt.py`)."""
    sent = v.permute(2, 0, 1, 3)                       # (D, b, A, C)
    return all_to_all(mesh, sent, label).permute(1, 0, 2, 3)


def send_to_rank(mesh: Mesh, t: torch.Tensor, dest: int,
                 sources: Sequence[int], label: str) -> torch.Tensor:
    """Send the whole of `t` to rank `dest` (None: to nobody) and receive
    one tensor of t's shape from each rank of `sources`, the ranks whose
    `dest` is this one. Returns them stacked along a new axis 0 in rank
    order: (len(sources),) + t.shape."""
    flat = t.reshape(1, -1)
    ins = [1 if j == dest else 0 for j in range(mesh.world)]
    outs = [1 if j in sources else 0 for j in range(mesh.world)]
    if dest is None:
        flat = flat[:0]
    got = all_to_all(mesh, flat, label, ins, outs)
    return got.reshape((len(sources),) + tuple(t.shape))


# ------------------------------------------------------ whole <-> sharded

def shard_domain(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of a whole tensor (..., n), on the
    mesh's device."""
    n = x.shape[-1]
    if n % mesh.world:
        raise ValueError(f"shard_domain: {n} points over {mesh.world} ranks")
    blk = n // mesh.world
    return x[..., mesh.rank * blk:(mesh.rank + 1) * blk].to(
        mesh.device).contiguous()


def gather_domain(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The whole tensor (..., n) from the local blocks (for the tests)."""
    parts = all_gather(mesh, x, "gather_domain")       # (D, ..., n / D)
    return torch.cat(list(parts), dim=-1)


def split_blocks(arr: np.ndarray, world: int, device="cpu"
                 ) -> List[torch.Tensor]:
    """A whole numpy uint64 array (..., n) -> the `world` local blocks, as
    the ranks hold them (so a test feeds both packages the same array)."""
    arr = np.asarray(arr, dtype=np.uint64)
    if arr.shape[-1] % world:
        raise ValueError(f"split_blocks: {arr.shape[-1]} points over {world}")
    return [from_u64(b, device) for b in np.split(arr, world, axis=-1)]


def join_blocks(blocks: Sequence[torch.Tensor]) -> np.ndarray:
    """The local blocks in rank order -> the whole numpy uint64 array."""
    return np.concatenate([to_u64(b) for b in blocks], axis=-1)


# ------------------------------------------------------------------- ranks

def _rank_entry(rank: int, fn: Callable, world: int, device_of, exchange: str,
                init_method: str, out_dir: str, timeout_s: float,
                args: tuple) -> None:
    torch.set_num_threads(1)        # D ranks share the host's cores
    mesh = make_mesh(world, rank, device_of[rank], init_method, exchange,
                     timeout_s)
    try:
        result = fn(mesh, *args)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        tmp = os.path.join(out_dir, f"rank{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, os.path.join(out_dir, f"rank{rank}.pkl"))
    except BaseException as e:
        # on record before the group closes and the peers lose this rank
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"{type(e).__name__}: {e}")
        raise
    finally:
        mesh.close()


def run_ranks(fn: Callable, world: int, devices: Sequence, args: tuple = (),
              exchange: str = "device", timeout_s: float = 120.0) -> list:
    """Start `world` processes, rank r on `devices[r]`, each running
    `fn(mesh, *args)` (a module-level function), and return their results
    in rank order. The ranks meet through a file in a temporary directory.
    A rank that raises or dies ends the others, and the run raises with the
    error of every rank that raised, each under its rank; ranks still
    running after `timeout_s` are killed and the run raises."""
    import torch.multiprocessing as mp
    if len(devices) != world:
        raise ValueError("run_ranks: one device per rank")
    devices = [str(d) for d in devices]
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.spawn(_rank_entry,
                       args=(fn, world, devices, exchange, init_method, tmp,
                             timeout_s, tuple(args)),
                       nprocs=world, join=False)
        deadline = time.monotonic() + timeout_s
        try:
            # join() returns True once every rank has exited cleanly and
            # raises, after ending the others, when one failed
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"run_ranks: ranks still running after {timeout_s} s")
        except Exception as e:
            own = []
            for r in range(world):
                path = os.path.join(tmp, f"rank{r}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        own.append(f"rank {r}: {f.read()}")
            if own:
                raise RuntimeError("run_ranks: " + "; ".join(own)) from e
            raise
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
