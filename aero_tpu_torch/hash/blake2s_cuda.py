"""Kernel 2: blake2s-256 on the card (`csrc/blake2s.cu`).

Replaces the TPU kernel `aero_tpu/hash/blake2s_pallas.py:36`
(`_make_kernel`, launched by `_blake2s_t_tpu`). Each wrapper takes the
plain PyTorch version (`blake2s.py`, re-exported here with a `_plain`
suffix) for a CPU tensor and launches the kernel for a CUDA tensor; any
other device raises, and so does a failed build or launch. `LAUNCHES`
counts the kernel launches of each entry point. `merkle_gather`, in the
same source, hashes nothing: it reads a batch opening's digests from every
level of a tree in one launch.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import torch

from .. import _build
from .._device import upload, wait_stream
from .blake2s import (blake2s_words as blake2s_words_plain,
                      hash_columns_t as hash_columns_plain,
                      merge_level_t as merge_level_plain,
                      merkle_gather_t as merkle_gather_plain,
                      grind_pow as grind_pow_plain)

LAUNCHES = {"blake2s_words": 0, "blake2s_hash_columns": 0,
            "blake2s_merge_level": 0, "blake2s_grind_pow": 0,
            "merkle_gather": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(t: torch.Tensor, ndim: int, what: str) -> bool:
    """True for a CUDA tensor the kernel takes, False for a CPU tensor;
    raises for anything else."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    if t.dtype != torch.int64 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{what}: needs a contiguous {ndim}-d int64 tensor,"
                         f" got {t.dtype} {tuple(t.shape)}")
    return True


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def blake2s_words(msg: torch.Tensor, nbytes: int) -> torch.Tensor:
    """(W, B) word-major u32 messages of nbytes -> (8, B) digests."""
    if not _on_cuda(msg, 2, "blake2s_words"):
        return blake2s_words_plain(msg, nbytes)
    W, B = msg.shape
    out = torch.empty((8, B), dtype=torch.int64, device=msg.device)
    _build.launch("blake2s_words", msg.data_ptr(), W, B, nbytes,
                  out.data_ptr(), _stream(msg))
    LAUNCHES["blake2s_words"] += 1
    return out


def hash_columns(cols: torch.Tensor) -> torch.Tensor:
    """hash_elements of each row of column-major felts (w, m) -> (8, m)."""
    if not _on_cuda(cols, 2, "hash_columns"):
        return hash_columns_plain(cols)
    w, m = cols.shape
    out = torch.empty((8, m), dtype=torch.int64, device=cols.device)
    _build.launch("blake2s_hash_columns", cols.data_ptr(), w, m,
                  out.data_ptr(), _stream(cols))
    LAUNCHES["blake2s_hash_columns"] += 1
    return out


def merge_level(d: torch.Tensor) -> torch.Tensor:
    """One Merkle level word-major: (8, 2n) -> (8, n)."""
    if not _on_cuda(d, 2, "merge_level"):
        return merge_level_plain(d)
    if d.shape[0] != 8 or d.shape[1] % 2:
        raise ValueError(f"merge_level: bad digest shape {tuple(d.shape)}")
    n = d.shape[1] // 2
    out = torch.empty((8, n), dtype=torch.int64, device=d.device)
    _build.launch("blake2s_merge_level", d.data_ptr(), n, out.data_ptr(),
                  _stream(d))
    LAUNCHES["blake2s_merge_level"] += 1
    return out


def merkle_gather(levels, coords: torch.Tensor) -> torch.Tensor:
    """The digests at flat-tree indexes `coords` (K,) int64 (root 1, leaves
    [n, 2n)) of a tree's word-major levels (level l is (8, n >> l)) ->
    (K, 8) int32, each row a digest's 32 bytes little-endian. For levels on
    a card, one launch and no copy: `coords` lies in pinned host memory and
    the kernel writes the result into pinned host memory, valid once the
    stream has drained. Every index must lie in [1, 2n): the kernel does
    not check them. Up to 64 levels."""
    if levels[0].device.type == "cpu":
        return merkle_gather_plain(levels, coords)
    _on_cuda(levels[0], 2, "merkle_gather")
    if not coords.is_pinned() or coords.dtype != torch.int64 \
            or coords.dim() != 1:
        raise ValueError("merkle_gather: needs the indexes as a 1-d int64 "
                         "tensor in pinned host memory")
    out = torch.empty((coords.shape[0], 8), dtype=torch.int32,
                      pin_memory=True)
    table = (ctypes.c_int64 * len(levels))(*(l.data_ptr() for l in levels))
    _build.launch("merkle_gather", table, len(levels), coords.data_ptr(),
                  coords.shape[0], out.data_ptr(), _stream(levels[0]))
    LAUNCHES["merkle_gather"] += 1
    return out


# One wave of the card: 132 SMs x 2048 threads; no batch is smaller. The
# kernel's own grid is RESIDENT threads, two blocks of 256 an SM, which take
# a batch chunk by chunk: that fills the integer pipes, and a hit is seen
# sooner than with more warps sharing an SM (measured on an H100).
WAVE = 132 * 2048
RESIDENT = 132 * 512
MAX_BATCH = 1 << 28             # a batch without a hit ends in about 12 ms
NOT_FOUND = (1 << 64) - 1       # the result word when no nonce qualified


def grind_batches(grinding_bits: int, wave: int = WAVE):
    """The (base, count) batches of the search, in increasing nonce order.
    A batch holds about 4 x 2^bits nonces (the first one then has a hit
    with probability 1 - e^-4 = 98 %), at least one wave, in whole blocks of
    256; the kernel stops handing out nonces past a hit, so an oversized
    batch costs nothing. Every batch has the same size."""
    count = min(max(4 << grinding_bits, wave), MAX_BATCH)
    count = -(-count // 256) * 256
    base = 0
    while True:
        yield base, count
        base += count


def grind_search(batches, run_batch) -> int:
    """Walk `batches` in order; `run_batch(base, count)` returns the smallest
    qualifying nonce of its batch or NOT_FOUND. Batches are disjoint and
    increasing, so the first batch with a hit holds the global minimum."""
    for base, count in batches:
        found = run_batch(base, count)
        if found != NOT_FOUND:
            return found
    raise RuntimeError("grind_search: the batches ran out without a hit")


_GRIND_WORDS: dict = {}
# One search at a time in a process: the state words are shared by every
# call on a device, so the launch, the wait and the read of the pinned word
# are one critical section (`grind_batch`).
_GRIND_LOCK = threading.Lock()


def _grind_words(device: torch.device):
    """The kernel's three state words on the card (the result, resting at
    ~0, and the ticket and chunk counters, resting at 0) and the pinned
    host word the result lands in: allocated once per device and reused by
    every call. The kernel puts the state back itself."""
    device = torch.device("cuda", torch.cuda.current_device()
                          if device.index is None else device.index)
    if device not in _GRIND_WORDS:
        _GRIND_WORDS[device] = (
            upload(torch.tensor([-1, 0, 0], dtype=torch.int64), device),
            torch.empty(1, dtype=torch.int64).pin_memory())
    return _GRIND_WORDS[device]


def grind_launch(seed: bytes, grinding_bits: int, device: torch.device,
                 base: int, count: int) -> torch.Tensor:
    """Enqueue one batch of the search on the card, one kernel and nothing
    else on the stream: the seed goes by value and the kernel's last block
    writes the batch's smallest qualifying nonce (NOT_FOUND if none) into
    pinned host memory. Returns that pinned tensor, valid once the stream
    has drained. Launches on one device share their state, so they must
    follow one another: `grind_batch` is the call that sees to it."""
    if count <= 0 or len(seed) != 32:
        raise ValueError("grind_launch: an empty batch, or a seed that is "
                         "not a 32-byte digest")
    state, host = _grind_words(device)
    _build.launch("blake2s_grind_pow", *struct.unpack("<8I", seed), base,
                  count, RESIDENT, grinding_bits, state.data_ptr(),
                  host.data_ptr(),
                  torch.cuda.current_stream(device).cuda_stream)
    LAUNCHES["blake2s_grind_pow"] += 1
    return host


def grind_batch(seed: bytes, grinding_bits: int, device: torch.device,
                base: int, count: int) -> int:
    """The smallest qualifying nonce of base .. base + count - 1, or
    NOT_FOUND: one launch, one wait on the stream and one read, under the
    lock, so threads and streams of one process cannot mix their results."""
    with _GRIND_LOCK:
        host = grind_launch(seed, grinding_bits, device, base, count)
        wait_stream(device)
        return int(host[0]) & NOT_FOUND


def grind_pow(seed: bytes, grinding_bits: int, device) -> int:
    """Minimal nonce with >= grinding_bits leading zero bits in
    blake2s(seed || u64le(nonce)). One call is, in the usual case, one
    launch and one wait (`grind_batches`, `grind_batch`)."""
    device = torch.device(device)
    if device.type == "cpu":
        return grind_pow_plain(seed, grinding_bits, device)
    if device.type != "cuda":
        raise ValueError(f"grind_pow: unsupported device {device}")

    return grind_search(
        grind_batches(grinding_bits),
        lambda base, count: grind_batch(seed, grinding_bits, device, base,
                                        count))
