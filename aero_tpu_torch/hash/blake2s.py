"""blake2s-256 in plain PyTorch: the reference for kernel 2.

The counterpart of `aero_tpu/hash/blake2s_jax.py` and the front ends of
`aero_tpu/hash/blake2s_pallas.py`: every function hashes a batch of
independent messages, one per tensor lane. u32 words live in int64 tensors
and every add is masked back to 32 bits (torch's uint32 op coverage is
thin). Layouts are word-major, as in the TPU kernel: messages (W, B),
digests (8, B), so column-major trace data hashes without a transpose.

These functions run on any device. The kernel wrappers in
`blake2s_cuda.py` take them for CPU tensors; `chip_smoke.py` runs them on
the card as the comparison for the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import canonicalize

M32 = 0xFFFFFFFF

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
# parameter block word 0: digest_length=32, key_len=0, fanout=1, depth=1
H0 = (IV[0] ^ 0x01010020,) + IV[1:]

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)


def _ror(x, r: int):
    return ((x >> r) | (x << (32 - r))) & M32


def _g(v, a, b, c, d, x, y):
    v[a] = (v[a] + v[b] + x) & M32
    v[d] = _ror(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & M32
    v[b] = _ror(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + y) & M32
    v[d] = _ror(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & M32
    v[b] = _ror(v[b] ^ v[c], 7)


def _compress(h, m, t: int, final: bool):
    """One compression. h: 8 state words, m: 16 message words (each a
    (B,) int64 tensor or a Python int); t: byte counter."""
    v = list(h) + list(IV)
    v[12] ^= t
    if final:
        v[14] ^= M32
    for s in SIGMA:
        _g(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def _hash_blocks(blocks, nbytes: int, batch: int, device) -> torch.Tensor:
    """Run the compress chain over `blocks` (lists of 16 words) -> (8, B)."""
    h = list(H0)
    nblocks = len(blocks)
    for b, m in enumerate(blocks):
        final = b == nblocks - 1
        h = _compress(h, m, nbytes if final else 64 * (b + 1), final)
    return torch.stack([torch.as_tensor(x, dtype=torch.int64, device=device)
                        .expand(batch) for x in h])


def blake2s_words(msg: torch.Tensor, nbytes: int) -> torch.Tensor:
    """blake2s-256 of B messages given word-major: msg (W, B) u32 words
    (zero past nbytes) -> (8, B) digest words."""
    W, B = msg.shape
    nblocks = max(1, -(-nbytes // 64))
    blocks = [[msg[b * 16 + j] if b * 16 + j < W else 0 for j in range(16)]
              for b in range(nblocks)]
    return _hash_blocks(blocks, nbytes, B, msg.device)


def hash_columns_t(cols: torch.Tensor) -> torch.Tensor:
    """Protocol hash_elements of each row of column-major felts (w, m):
    felt c is the words [lo, hi, 0 x 6]; returns (8, m)."""
    cols = canonicalize(cols)
    w, m = cols.shape
    lo, hi = cols & M32, (cols >> 32) & M32
    blocks = []
    for b in range((w + 1) // 2):
        words = [0] * 16
        words[0], words[1] = lo[2 * b], hi[2 * b]
        if 2 * b + 1 < w:
            words[8], words[9] = lo[2 * b + 1], hi[2 * b + 1]
        blocks.append(words)
    return _hash_blocks(blocks, 32 * w, m, cols.device)


def merge_level_t(d: torch.Tensor) -> torch.Tensor:
    """One Merkle level word-major: (8, 2n) -> (8, n),
    parent = blake2s(left digest || right digest)."""
    words = [d[j, 0::2] for j in range(8)] + [d[j, 1::2] for j in range(8)]
    return _hash_blocks([words], 64, d.shape[1] // 2, d.device)


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of u32 lanes (branchless binary search)."""
    n = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        small = x < (1 << (32 - shift))
        n = n + torch.where(small, shift, 0)
        x = torch.where(small, x << shift, x)
    return torch.where(x == 0, 32, torch.clamp(n, max=32))


def leading_zeros_t(d: torch.Tensor) -> torch.Tensor:
    """Leading zero bits of the 128-bit big-endian prefix of each digest:
    (8, B) word-major -> (B,) int64."""
    total = torch.zeros(d.shape[1], dtype=torch.int64, device=d.device)
    alive = torch.ones(d.shape[1], dtype=torch.bool, device=d.device)
    for w in range(4):
        x = d[w]
        be = (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
              | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF))
        total = total + torch.where(alive, _clz32(be), 0)
        alive = alive & (be == 0)
    return total


def seed_words(seed: bytes):
    words = np.frombuffer(seed, dtype="<u4")
    if words.shape[0] != 8:
        raise ValueError("PoW seed must be a 32-byte digest")
    return [int(x) for x in words]


def grind_pow(seed: bytes, grinding_bits: int, device="cpu",
              batch: int = 1 << 16) -> int:
    """Minimal nonce whose blake2s(seed || u64le(nonce)) has at least
    `grinding_bits` leading zero bits; `batch` nonces per round."""
    sw = seed_words(seed)
    base = 0
    while True:
        nonce = base + torch.arange(batch, dtype=torch.int64, device=device)
        m = sw + [nonce & M32, (nonce >> 32) & M32] + [0] * 6
        ok = leading_zeros_t(_hash_blocks([m], 40, batch, device)) \
            >= grinding_bits
        if bool(ok.any()):
            return base + int(torch.argmax(ok.to(torch.int8)))
        base += batch
