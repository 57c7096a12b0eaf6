"""The yardstick of the kernel rooflines: frozen work counts and prices.

A kernel's roofline share is the least time the card could take for the
work of its launches, over the device time they took. The least time is
the larger of two bounds:

- bytes: each input read once and each output written once, over HBM's
  3.35 TB/s (NVIDIA's H100 SXM data sheet);
- instructions: the work's field operations (or blake2s compressions),
  each at a frozen count of integer instructions by pipe, over what the
  card starts: 132 SMs at 1.98 GHz (the H100 SXM's boost clock), each a
  clock at most 64 ALU instructions, 64 multiply-add instructions and
  128 in all.

The work is counted from the launch's shape and what the function needs,
never from the code that implements it, so a rewrite of a kernel does not
move its own yardstick. The prices are the straight-line SASS counts that
the port's field-op probe (`csrc/probe/field_ops.cu`) and blake2s kernel
gave on the H100 (sm_90) when this benchmark was made, frozen here; an
operation with a constant operand is priced as a general one.
"""

from __future__ import annotations

from typing import Dict, List

HBM_BYTES_PER_S = 3.35e12
SMS = 132
CLOCK_HZ = 1.98e9
ALU_PER_CLOCK = 64            # per SM
FMA_PER_CLOCK = 64
SLOTS_PER_CLOCK = 128

# (ALU, multiply-add) instructions of one operation, a thread
PRICES = {
    "mul": (21.2, 12.1),          # Goldilocks multiply
    "add": (11.2, 3.1),           # Goldilocks add
    "sub": (7.2, 1.1),            # Goldilocks subtract
    "compress": (710.0, 284.0),   # one blake2s compression of a leaf
}

# K5 (the generated constraint fragment, merge mode), a domain point:
# the field ops of the AIR's traced transition program and of the merge
# (a constraint 2 multiplies and 2 adds, an assertion 3 multiplies, 2
# adds and a subtract, one multiply once); and the words a point reads
# and writes (its frame rows, the divisor and x^adj rows, zt, the merged
# row).
FRAG_EVAL_OPS = {
    "miden": {"mul": 948, "add": 777, "sub": 210},
}
FRAG_EVAL_WORDS = {"miden": 148}

MAX_L = 4096                  # kernel 1's longest pass


def bound_seconds(ops: Dict[str, float], nbytes: float) -> float:
    """The least seconds the card takes for `ops` (operation -> count) and
    `nbytes` moved: the larger of the instruction and the bytes bound."""
    alu = sum(n * PRICES[k][0] for k, n in ops.items())
    fma = sum(n * PRICES[k][1] for k, n in ops.items())
    clocks = max(alu / ALU_PER_CLOCK, fma / FMA_PER_CLOCK,
                 (alu + fma) / SLOTS_PER_CLOCK)
    return max(clocks / (SMS * CLOCK_HZ), nbytes / HBM_BYTES_PER_S)


# ------------------------------------------------- kernel 1: the NTT

def _pass_lengths(n: int, max_l: int = MAX_L) -> List[int]:
    """The lengths of the passes of a size-n transform, first pass first:
    two passes (n2 = n / n1, n1 = 2^ceil(log n / 2)) where both fit
    `max_l`, else an outer pass of 2^floor(log n / 3) and the inner
    transform's two."""
    if n == 1:
        return []
    log_n = n.bit_length() - 1
    if (log_n + 1) // 2 <= max_l.bit_length() - 1:
        log1 = (log_n + 1) // 2
        return [n >> log1, 1 << log1]
    log3 = log_n // 3
    log1 = (log_n - log3 + 1) // 2
    return [1 << log3, n >> (log3 + log1), 1 << log1]


def ntt_field_ops(log_n: int, batch: int = 1, log_blowup: int = 0,
                  lde: bool = False, max_l: int = MAX_L) -> Dict[str, int]:
    """The field operations a transform of 2^log_n points needs, `batch`
    rows: each radix-2 stage's butterflies, an add and a subtract each and
    a multiply unless its twiddle is 1 (stage s has one twiddle index
    j < 2^(s-1) a block of 2^s, and j = 0 is 1), and a multiply an element
    for each cross table between passes. With `lde`, the coset LDE of
    2^(log_n - log_blowup) coefficients: the first log_blowup stages only
    copy and need nothing, and each coefficient takes one multiply by
    offset^i. A frozen copy of the port's `_sass.ntt_field_ops` at its
    defaults; the multiplies by +-2^e are counted as multiplies."""
    n = 1 << log_n
    logs = [L.bit_length() - 1 for L in _pass_lengths(n, max_l)]
    if lde and logs and log_blowup > logs[0]:
        raise ValueError("the copying stages reach past the first pass")
    bfly = mul = 0
    for k, lg in enumerate(logs):
        for s in range((log_blowup if lde and k == 0 else 0) + 1, lg + 1):
            bfly += n // 2
            mul += n // 2 - (n >> s)
        if k < len(logs) - 1:
            mul += n
    if lde and logs:
        mul += n >> log_blowup
    return {"mul": batch * mul, "add": batch * bfly, "sub": batch * bfly}


def ntt_call_bound(log_n: int, batch: int, log_blowup: int = 0,
                   lde: bool = False) -> float:
    """Least seconds of one transform call (`ntt`/`intt` of (batch, 2^log_n)
    or, with `lde`, the LDE of (batch, 2^(log_n - log_blowup)) to 2^log_n):
    its inputs read once (the coefficients alone for an LDE) and its
    outputs written once."""
    n = 1 << log_n
    n_in = n >> log_blowup if lde else n
    return bound_seconds(ntt_field_ops(log_n, batch, log_blowup, lde),
                         8 * batch * (n_in + n))


# ------------------------------------------------- blake2s leaf hashes

def leaf_compressions(width: int) -> int:
    """blake2s compressions to hash one leaf of `width` field elements:
    each element takes 32 bytes of the message, two to a 64-byte block."""
    return (width + 1) // 2


def hash_columns_bound(width: int, leaves: int) -> float:
    """Least seconds to hash `leaves` rows of `width` elements: the
    columns read once, a 32-byte digest a leaf written once."""
    return bound_seconds({"compress": leaves * leaf_compressions(width)},
                         leaves * (8 * width + 32))


# ------------------------------------------------- K5

def frag_eval_bound(air: str, points: int) -> float:
    """Least seconds of K5's merge over `points` domain points of `air`."""
    ops = {k: v * points for k, v in FRAG_EVAL_OPS[air].items()}
    return bound_seconds(ops, 8 * FRAG_EVAL_WORDS[air] * points)
