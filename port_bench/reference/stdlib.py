"""Miden-style standard library modules for the aero-tpu assembler.

The reference's miden fork assembles programs with
`Assembler::with_module_provider(StdLibrary)` (SURVEY §2.10) so user
programs can `use.std::math::u64` and call `exec.u64::wrapping_add`.
This module provides the same mechanism for our ISA: `resolve_imports`
textually resolves `use.<path>` statements by injecting the module's
procedure definitions (alias-qualified names, e.g. `u64::wrapping_add`)
ahead of the user program. Procedures are written in the constrained
core ISA, so every stdlib op is SOUND in-AIR for free (u32 family ops
post range-check requests to the chiplet bus).

u64 convention (matching miden std::math::u64): a u64 value is two
32-bit limbs on the stack as [hi, lo] with hi on top; binary ops take
[b_hi, b_lo, a_hi, a_lo] (b = top pair) and compute a OP b.

Frozen copy of the port's `vm/stdlib.py` for the benchmark's plain
reference: it imports nothing of the program, and a change to the
program does not change it. One line differs: `u64::lt` ends in four
`swap drop`, which drop the four operand limbs under its answer. The
port's four `movup.2 drop` drop three of them and a zero from under the
operands, so its `lt`, and `gt`, `lte` and `gte` through it, leave b_hi
under the answer. The procedures are the repo's own, not Miden's
`stdlib/asm/math/u64.masm`; the tests hold each to Python's integers.
"""

from __future__ import annotations

import re
from typing import Dict

# each proc name is alias-qualified: `use.std::math::u64` makes
# `exec.u64::wrapping_add` resolve (the assembler treats "u64::..." as
# an opaque procedure name — no dots, so it tokenizes cleanly)
_U64 = """
proc.u64::wrapping_add
    # [b_hi, b_lo, a_hi, a_lo] -> [c_hi, c_lo], c = (a + b) mod 2^64
    swap movup.3 add            # [t=a_lo+b_lo, b_hi, a_hi]
    dup.0 u32hi                 # [carry, t, b_hi, a_hi]
    swap u32lo                  # [c_lo, carry, b_hi, a_hi]
    movdn.3                     # [carry, b_hi, a_hi, c_lo]
    add add u32lo               # [c_hi, c_lo]
end
proc.u64::overflowing_add
    # -> [overflowed, c_hi, c_lo]
    swap movup.3 add
    dup.0 u32hi
    swap u32lo
    movdn.3                     # [carry, b_hi, a_hi, c_lo]
    add add                     # [s, c_lo]
    dup.0 u32hi                 # [ovf, s, c_lo]
    swap u32lo                  # [c_hi, ovf, c_lo]
    swap                        # [ovf, c_hi, c_lo]
end
proc.u64::wrapping_sub
    # [b_hi, b_lo, a_hi, a_lo] -> [c_hi, c_lo], c = (a - b) mod 2^64
    swap movup.3                # [a_lo, b_lo, b_hi, a_hi]
    push.4294967296 add         # [a_lo + 2^32, b_lo, b_hi, a_hi]
    swap sub                    # [t = 2^32 + a_lo - b_lo, b_hi, a_hi]
    dup.0 u32hi                 # [nb = 1-borrow, t, b_hi, a_hi]
    swap u32lo                  # [c_lo, nb, b_hi, a_hi]
    movdn.3                     # [nb, b_hi, a_hi, c_lo]
    push.4294967295 add         # [nb + 2^32 - 1, b_hi, a_hi, c_lo]
    movup.2 add                 # [a_hi + nb + 2^32 - 1, b_hi, c_lo]
    swap sub u32lo              # [c_hi, c_lo]
end
proc.u64::wrapping_mul
    # [b_hi, b_lo, a_hi, a_lo] -> [c_hi, c_lo], c = (a * b) mod 2^64
    dup.3 dup.2 mul             # [p0 = a_lo*b_lo, b_hi, b_lo, a_hi, a_lo]
    dup.0 u32lo                 # [c_lo, p0, ...]
    swap u32hi                  # [p0_hi, c_lo, b_hi, b_lo, a_hi, a_lo]
    dup.5 dup.3 mul u32lo       # [p1_lo = lo(a_lo*b_hi), p0_hi, c_lo, ...]
    dup.5 dup.5 mul u32lo       # [p2_lo = lo(a_hi*b_lo), p1_lo, p0_hi, c_lo, b_hi, b_lo, a_hi, a_lo]
    add add u32lo               # [c_hi, c_lo, b_hi, b_lo, a_hi, a_lo]
    movup.2 drop movup.2 drop movup.2 drop movup.2 drop
end
proc.u64::eq
    movup.2 eq                  # [heq, b_lo, a_lo]
    movdn.2 eq and              # [a == b]
end
proc.u64::eqz
    # [a_hi, a_lo] -> [a == 0]
    eqz swap eqz and
end
proc.u64::lt
    dup.2 dup.1 u32lt           # [a_hi < b_hi, b_hi, b_lo, a_hi, a_lo]
    dup.3 dup.2 eq              # [a_hi == b_hi, hlt, ...]
    dup.5 dup.4 u32lt           # [a_lo < b_lo, heq, hlt, ...]
    and or                      # [lt, b_hi, b_lo, a_hi, a_lo]
    swap drop swap drop swap drop swap drop
end
proc.u64::gt
    movup.2 movup.3 swap exec.u64::lt
end
proc.u64::lte
    exec.u64::gt not
end
proc.u64::gte
    exec.u64::lt not
end
"""

MODULES: Dict[str, str] = {
    "std::math::u64": _U64,
}


class StdlibError(Exception):
    pass


_USE_RE = re.compile(r"^\s*use\.([A-Za-z0-9_:]+)\s*$", re.MULTILINE)


def resolve_imports(source: str) -> str:
    """Resolve `use.<module>` statements: strip them and prepend the
    module procedure definitions (each exactly once, in deterministic
    order). No-op for programs without imports."""
    mods = _USE_RE.findall(source)
    if not mods:
        return source
    seen = []
    for m in mods:
        if m not in MODULES:
            raise StdlibError(f"unknown stdlib module: {m}")
        if m not in seen:
            seen.append(m)
    body = _USE_RE.sub("", source)
    return "\n".join(MODULES[m] for m in seen) + "\n" + body
