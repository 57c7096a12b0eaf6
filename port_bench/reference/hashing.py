"""blake2s-256 hashing conventions of the protocol (host-side specification).

Conventions (derived from reference src/stark_verifier/crypto/random.cairo and
validated against the golden proof fib.bin):

- `hash_elements(felts)` = blake2s over each element encoded as **32 bytes
  little-endian** (random.cairo:93-104 via cairo blake2s_add_felts; the Rust
  fork pads each Goldilocks element to 32 bytes to match the Cairo felt
  encoding). Used for Merkle leaves and Fiat-Shamir element hashing.
- `merge(a, b)` = blake2s(a || b) over two 32-byte digests (random.cairo:41-63;
  Merkle 2-to-1 node hash, channel.cairo:206-231).
- `merge_with_int(seed, v)` = blake2s(seed || u64le(v)) (random.cairo:67-91).

Frozen copy of the port's `spec/hashing.py` for the benchmark's plain
reference: it imports nothing of the program, and a change to the
program does not change it.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Sequence

DIGEST_SIZE = 32


def blake2s(data: bytes) -> bytes:
    return hashlib.blake2s(data).digest()


def felts_to_bytes32(felts: Iterable[int]) -> bytes:
    """Cairo felt encoding: each element as 32 bytes little-endian."""
    return b"".join(int(x).to_bytes(32, "little") for x in felts)


def felts_to_bytes8(felts: Iterable[int]) -> bytes:
    """Winterfell native encoding: each element as 8 bytes little-endian."""
    return b"".join(int(x).to_bytes(8, "little") for x in felts)


def hash_elements(felts: Sequence[int]) -> bytes:
    """Protocol element hash (32-byte LE per element)."""
    return blake2s(felts_to_bytes32(felts))


def merge(a: bytes, b: bytes) -> bytes:
    assert len(a) == DIGEST_SIZE and len(b) == DIGEST_SIZE
    return blake2s(a + b)


def merge_with_int(seed: bytes, value: int) -> bytes:
    assert len(seed) == DIGEST_SIZE
    return blake2s(seed + int(value).to_bytes(8, "little"))
