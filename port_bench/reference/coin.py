"""Fiat-Shamir public coin (blake2s), protocol specification.

Semantics derived from reference src/stark_verifier/crypto/random.cairo and
validated against its KATs (tests/integration/test_verifier.cairo:104,108):

- construction re-hashes the provided seed bytes (random.cairo:31-37);
- `reseed(digest)`: seed = blake2s(seed || digest), counter = 0
  (random.cairo:108-128,318-326);
- `draw()`: counter += 1; digest = blake2s(seed || u64le(counter)); the value
  is the first 8 digest bytes as a little-endian u64. Field-element draws
  reject values >= p and redraw (winterfell semantics; the Cairo verifier
  skips the rejection, which coincides except with probability ~2^-32/draw).
- `draw_integers(n, domain_size)`: raw u64 & (domain_size-1), skipping
  duplicates (random.cairo:210-252) — no field rejection.
- `leading_zeros()`: leading zero bits of the first 16 seed bytes interpreted
  big-endian, capped at 64 (random.cairo:282-316).

Frozen copy of the port's `spec/coin.py` for the benchmark's plain
reference: it imports nothing of the program, and a change to the
program does not change it.
"""

from __future__ import annotations

from .field import P
from .hashing import blake2s, merge, merge_with_int, hash_elements


class RandomCoin:
    def __init__(self, seed_bytes: bytes):
        # random_coin_new hashes the seed material (random.cairo:34)
        self.seed = blake2s(seed_bytes)
        self.counter = 0

    @classmethod
    def from_digest(cls, digest: bytes) -> "RandomCoin":
        # Used when the caller already hashed the seed material once; the
        # constructor still re-hashes (matches seed_with_pub_inputs followed
        # by random_coin_new in stark_verifier.cairo:83-91).
        return cls(digest)

    def reseed(self, digest: bytes) -> None:
        self.seed = merge(self.seed, digest)
        self.counter = 0

    def reseed_with_int(self, value: int) -> None:
        self.seed = merge_with_int(self.seed, value)
        self.counter = 0

    def next_digest(self) -> bytes:
        self.counter += 1
        return merge_with_int(self.seed, self.counter)

    def next_u64(self) -> int:
        return int.from_bytes(self.next_digest()[:8], "little")

    def draw(self) -> int:
        """Draw a Goldilocks field element (with winterfell rejection)."""
        for _ in range(1000):
            value = self.next_u64()
            if value < P:
                return value
        raise RuntimeError("failed to draw a field element after 1000 tries")

    def draw_elements(self, n: int) -> list[int]:
        return [self.draw() for _ in range(n)]

    def draw_pair(self) -> tuple[int, int]:
        return self.draw(), self.draw()

    def draw_integers(self, n: int, domain_size: int) -> list[int]:
        assert domain_size & (domain_size - 1) == 0, "domain must be a power of 2"
        assert n < domain_size
        mask = domain_size - 1
        out: list[int] = []
        for _ in range(1000):
            if len(out) == n:
                break
            value = self.next_u64() & mask
            if value not in out:
                out.append(value)
        else:
            raise RuntimeError("failed to draw unique integers after 1000 tries")
        return out

    def leading_zeros(self) -> int:
        high = int.from_bytes(self.seed[:16], "big")
        lz = 128 - high.bit_length()
        return min(lz, 64)

    def check_pow(self, nonce: int, grinding_bits: int) -> bool:
        """Reseed with the nonce, then check the grinding condition
        (stark_verifier.cairo:205-213)."""
        self.reseed_with_int(nonce)
        return self.leading_zeros() >= grinding_bits
