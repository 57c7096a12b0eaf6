"""Kernel 2: blake2s-256 on the card (`csrc/blake2s.cu`).

Replaces the TPU kernel `aero_tpu/hash/blake2s_pallas.py:36`
(`_make_kernel`, launched by `_blake2s_t_tpu`). Each wrapper takes the
plain PyTorch version (`blake2s.py`, re-exported here with a `_plain`
suffix) for a CPU tensor and launches the kernel for a CUDA tensor; any
other device raises, and so does a failed build or launch. `LAUNCHES`
counts the kernel launches of each entry point.
"""

from __future__ import annotations

import torch

from .. import _build
from .blake2s import (blake2s_words as blake2s_words_plain,
                      hash_columns_t as hash_columns_plain,
                      merge_level_t as merge_level_plain,
                      grind_pow as grind_pow_plain, seed_words)

LAUNCHES = {"blake2s_words": 0, "blake2s_hash_columns": 0,
            "blake2s_merge_level": 0, "blake2s_grind_pow": 0}


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


def grind_pow(seed: bytes, grinding_bits: int, device,
              batch: int = 1 << 20) -> int:
    """Minimal nonce with >= grinding_bits leading zero bits in
    blake2s(seed || u64le(nonce)). Batches run in increasing nonce order
    and atomicMin keeps each batch's smallest hit, so the first batch with
    a hit holds the global minimum."""
    device = torch.device(device)
    if device.type == "cpu":
        return grind_pow_plain(seed, grinding_bits, device)
    if device.type != "cuda":
        raise ValueError(f"grind_pow: unsupported device {device}")
    sw = torch.tensor(seed_words(seed), dtype=torch.int64, device=device)
    result = torch.full((1,), -1, dtype=torch.int64, device=device)
    base = 0
    while True:
        _build.launch("blake2s_grind_pow", sw.data_ptr(), base, batch,
                      grinding_bits, result.data_ptr(), _stream(sw))
        LAUNCHES["blake2s_grind_pow"] += 1
        found = int(result.item())
        if found != -1:
            return found
        base += batch
