"""Host reference for the VM's Rescue-Prime instance ("ARP64-12").

Mirrors the constants and round structure compiled into the C++ core
(aero_tpu/vm/core/vm.cpp RpConsts): state width 12, rate 8, capacity 4,
alpha = 7, 7 rounds; MDS = the Cauchy matrix M[i][j] = (i + 12 + j)^-1
(provably MDS); round constants = splitmix64(0xAE20C0DE5EED0001) mod p.

Used by tests to cross-check the VM's rpperm/rphash execution and
available to SDK consumers as the host-side hash.

Reference analog: the miden v0.3 fork's Rescue-Prime ops
(the reference's README.md:49-53 — fork of miden-vm 0.3, whose
crypto-ops family is rpperm/rphash); the exact forked constants are
unrecoverable (empty submodule), so this is a documented from-scratch
instance of the same shape.
"""

from __future__ import annotations

from typing import List, Sequence

P = (1 << 64) - (1 << 32) + 1
INV7 = pow(7, -1, P - 1)
RP_W = 12
RP_ROUNDS = 7

_MASK = (1 << 64) - 1


def _splitmix_stream(seed: int):
    s = seed
    while True:
        s = (s + 0x9E3779B97F4A7C15) & _MASK
        z = s
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        z ^= z >> 31
        yield z % P


def _constants():
    mds = [[pow(i + 12 + j, P - 2, P) for j in range(RP_W)]
           for i in range(RP_W)]
    gen = _splitmix_stream(0xAE20C0DE5EED0001)
    ark1 = [[next(gen) for _ in range(RP_W)] for _ in range(RP_ROUNDS)]
    ark2 = [[next(gen) for _ in range(RP_W)] for _ in range(RP_ROUNDS)]
    return mds, ark1, ark2


MDS, ARK1, ARK2 = _constants()


def _mds_mul(state: List[int]) -> List[int]:
    return [sum(MDS[i][j] * state[j] for j in range(RP_W)) % P
            for i in range(RP_W)]


def rp_permute(state: Sequence[int]) -> List[int]:
    """The ARP64-12 permutation; state[0] is the stack top."""
    s = [int(x) % P for x in state]
    assert len(s) == RP_W
    for r in range(RP_ROUNDS):
        s = [pow(x, 7, P) for x in s]
        s = _mds_mul(s)
        s = [(x + c) % P for x, c in zip(s, ARK1[r])]
        s = [pow(x, INV7, P) for x in s]
        s = _mds_mul(s)
        s = [(x + c) % P for x, c in zip(s, ARK2[r])]
    return s


def rp_hash8(elements: Sequence[int]) -> List[int]:
    """Fixed-length sponge: 8 elements -> 4-element digest.
    capacity = state[0..3] = (8, 0, 0, 0); rate = state[4..11] = inputs
    (top-first); digest = state[4..7] after one permutation."""
    el = [int(x) % P for x in elements]
    assert len(el) == 8
    state = [8, 0, 0, 0] + el
    return rp_permute(state)[4:8]
