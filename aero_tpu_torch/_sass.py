"""Instruction counts of the built kernels, read from their machine code.

`cuobjdump -sass` lists the SASS of every kernel in the library that
`_build.build()` made. `chip_smoke.py` turns these counts into each kernel's
arithmetic bound: instructions per unit of work (one blake2s compress, one
field op) times the units the call needs, over the card's rates.
A Hopper SM starts at most 128 thread-instructions a clock (four
schedulers, one warp instruction each), of which at most 64 go to the
integer ALU lanes (IADD3, LOP3, SHF, ISETP, SEL, LEA ...) and at most 64 to
the lanes that take integer multiply-adds (every IMAD form, which is also
how the compiler moves plain adds and moves off the ALU lanes). So the
counts are kept by pipe: `alu`, `fma`, `uniform` (once per warp, on the
uniform datapath), `memory` and `control`.

- A kernel with no loop around its work (one compress per thread) is
  counted whole: `count_instructions(function_body)`.
- A kernel whose work sits in a loop is counted by that loop: `loops()`
  finds each backward branch and the instructions between its target and
  itself; the caller picks the loop by what it holds and divides by the
  units per trip.
- Kernel 1, the NTT, is bound by what the transform needs, not by its code:
  `ntt_field_ops` counts the field multiplies (those by a twiddle +-2^e
  apart, which may be done by shifts), adds and subtracts from the shape
  alone, and `chip_smoke.py` prices each at its straight-line count from
  the field-op probe.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

_INSTR = re.compile(
    r"^\s*/\*([0-9a-fA-F]{4,})\*/\s+(?:@!?U?P[0-9T]+\s+)?([A-Z][A-Z0-9_]*)"
    r"((?:\.[A-Za-z0-9_]+)*)\s*([^;]*);")
_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_TARGET = re.compile(r"0x([0-9a-fA-F]+)\s*$")

# opcodes that move data or steer control: everything else is arithmetic
MEMORY = {"LD", "LDG", "LDS", "LDL", "LDC", "LDSM", "ST", "STG", "STS", "STL",
          "ATOM", "ATOMG", "ATOMS", "RED", "REDG", "LDGSTS", "LDGDEPBAR",
          "ULDC"}
CONTROL = {"BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "CALL", "BAR", "BSSY",
           "BSYNC", "BREAK", "WARPSYNC", "NOP", "NANOSLEEP", "DEPBAR",
           "MEMBAR", "ERRBAR", "YIELD", "KILL", "BPT", "BMOV"}
# opcodes that go to the multiply-add lanes, by prefix
FMA_PREFIXES = ("IMAD", "IMUL", "FFMA", "FMUL", "FADD", "HFMA2", "IDP")


@dataclass(frozen=True)
class Instr:
    addr: int
    op: str          # base opcode, e.g. "IMAD"
    mods: str        # ".WIDE.U32"
    operands: str


@dataclass(frozen=True)
class Counts:
    alu: int
    fma: int
    uniform: int
    memory: int
    control: int
    shared_stores: int

    @property
    def total(self) -> int:
        """Scheduler slots: every instruction takes one."""
        return self.alu + self.fma + self.uniform + self.memory + self.control

    def sm_clocks(self) -> float:
        """Least SM clocks per thread for these instructions: the fuller of
        the two 64-lane pipes, or the schedulers' 128 slots."""
        return max(self.alu / 64, self.fma / 64, self.total / 128)


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "cuobjdump"
    if cand.exists():
        return str(cand)
    raise RuntimeError("cuobjdump not found: the kernels' SASS cannot be read")


def dump_sass(library: Path) -> str:
    """The text `cuobjdump -sass` prints for the kernel library."""
    res = subprocess.run([_cuobjdump(), "-sass", str(library)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed ({res.returncode}):\n"
                           f"{res.stderr}")
    return res.stdout


def parse_functions(sass: str) -> Dict[str, List[Instr]]:
    """Mangled kernel name -> its instructions in address order."""
    out: Dict[str, List[Instr]] = {}
    cur = None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            cur.append(Instr(int(m.group(1), 16), m.group(2), m.group(3),
                             m.group(4).strip()))
    return out


def find_function(functions: Dict[str, List[Instr]],
                  name: str) -> List[Instr]:
    """The one kernel whose mangled name holds `name`."""
    hits = [k for k in functions if name in k]
    if len(hits) != 1:
        raise RuntimeError(f"SASS: {len(hits)} kernels match {name!r}: {hits}")
    return functions[hits[0]]


def count_instructions(body: List[Instr]) -> Counts:
    mem = sum(i.op in MEMORY for i in body)
    ctl = sum(i.op in CONTROL for i in body)
    rest = [i for i in body if i.op not in MEMORY and i.op not in CONTROL]
    fma = sum(i.op.startswith(FMA_PREFIXES) for i in rest)
    uni = sum(i.op.startswith("U") for i in rest)
    sts = sum(i.op == "STS" for i in body)
    return Counts(len(rest) - fma - uni, fma, uni, mem, ctl, sts)


def loops(body: List[Instr]) -> List[List[Instr]]:
    """Each backward branch's loop: the instructions from its target up to
    and including the branch."""
    out = []
    for ins in body:
        if ins.op != "BRA":
            continue
        m = _TARGET.search(ins.operands)
        if m and int(m.group(1), 16) <= ins.addr:
            lo = int(m.group(1), 16)
            out.append([j for j in body if lo <= j.addr <= ins.addr])
    return out


def ntt_field_ops(log_n: int, batch: int = 1, log_blowup: int = 0,
                  lde: bool = False, max_l: int = 4096,
                  passes: int | None = None) -> Dict[str, int]:
    """The field operations a transform of 2^log_n points needs, `batch`
    rows, counted from its shape: the butterflies of each radix-2 stage,
    each an add and a subtract and, unless its twiddle is 1, a multiply
    (stage s of a column transform has one twiddle index j < 2^(s-1) a
    block of 2^s, and j = 0 is 1); one multiply an element for each cross
    table between passes. "mul_pow2": those of the multiplies whose
    twiddle is a root of unity of order at most 64, which is +-2^e (at
    stage s, min(2^(s-1), 32) - 1 of its indices); the cross tables count
    as general multiplies. With `lde`, the coset LDE of
    2^(log_n - log_blowup) coefficients: the first log_blowup stages only
    copy (the padded input is 1 - 2^-log_blowup zeros) and need nothing,
    and each coefficient takes one multiply by offset^i. With `passes`, the
    first `passes` passes only, each with the cross table it applies."""
    from .ntt.tables import pass_lengths
    n = 1 << log_n
    logs = [L.bit_length() - 1 for L in pass_lengths(n, max_l)]
    if lde and logs and log_blowup > logs[0]:
        raise ValueError("the copying stages reach past the first pass")
    done = logs if passes is None else logs[:passes]
    bfly = mul = pow2 = 0
    for k, lg in enumerate(done):
        for s in range((log_blowup if lde and k == 0 else 0) + 1, lg + 1):
            bfly += n // 2
            mul += n // 2 - (n >> s)
            pow2 += (min(1 << (s - 1), 32) - 1) * (n >> s)
        if k < len(logs) - 1:
            mul += n
    if lde and done:
        mul += n >> log_blowup
    return {"mul": batch * mul, "mul_pow2": batch * pow2,
            "add": batch * bfly, "sub": batch * bfly}
