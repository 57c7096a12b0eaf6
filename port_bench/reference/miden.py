"""What a Miden program's proof must state, worked out in plain Python.

The reference's own reading of the programs the cells prove: a
tokenizer and assembler for the subset of the assembly those programs
use, lowered to the program ROM as the VM documents it (a loop head is a
conditional `drop` whose immediate is the exit, a loop's end a `nop`
whose immediate is the head; ordinary `drop` and `nop` rows carry pc + 1;
the listing ends in `halt`; only `push`, `drop` and `nop` rows list an
immediate, so a `u32lo` or `u32hi` row, which carries a witness in the
trace's immediate column, lists 0), and an interpreter of the same rows
over a 16-slot stack with the overflow table the AIR's bus describes (a
window-down row at clock c parks s15 under address c + 1, a window-up row
takes the newest entry back, or 0) and a memory that starts at zero.
From these come the public inputs a proof of the program must carry: the
program hash (`mast.py`), the stack inputs, the 16 output slots, the
parked values and their addresses.

The subset, each token lowered to the rows the VM gives it:

- field and stack: `push.N`, `dup.k` (k <= 7), `swap`, `movup.k`,
  `movdn.k` (k = 2, 3, 4), `drop`, `add`, `sub`, `mul`, `eq`, `neq`,
  `eqz`, `not`, `and`, `or` (the last three on booleans only);
- the u32 family, checked: `u32lo`, `u32hi`, `u32split` (four rows:
  `dup0 u32hi swap u32lo`), `u32not`, and the binary `u32add`, `u32sub`,
  `u32mul`, `u32div`, `u32mod`, `u32and`, `u32or`, `u32xor`, `u32shl`,
  `u32shr`, `u32lt`, each also as `op.N` (a `push.N` row, then the op);
  a binary op takes s1 op s0 and raises on an operand of 2^32 or more,
  a division or remainder by 0 and a shift of 32 or more;
- memory: `mem.load` (s0 = mem[s0]), `mem.store` (pops the address,
  mem[address] = the new s0, which stays), and `mem.load.A`,
  `mem.store.A` (a `push.A` row first); an address of 2^32 or more
  raises;
- control: `while.true`, `if.true`/`else`, `repeat.N`, `proc` and
  `exec`, and `use.std::math::u64`, resolved from the procedures'
  source as `stdlib.py` holds it before the ROM, the run and the
  program hash are taken, as the VM resolves it.

An instruction outside the subset raises.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

from .field import P
from .mast import mast_root_felts
from .miden_air import OPS
from .proof import PublicInputs
from .stdlib import resolve_imports

_OP = {name: i for i, name in enumerate(OPS)}
_DOWN = {"push", "dup0", "dup1", "dup2", "dup3", "dup4", "dup5", "dup6",
         "dup7"}
_U32_BINARY = ("u32add", "u32sub", "u32mul", "u32div", "u32mod", "u32and",
               "u32or", "u32xor", "u32shl", "u32shr", "u32lt")
_UP = {"drop", "add", "sub", "mul", "eq", "neq", "and", "or", "memstore",
       *_U32_BINARY}
_STAY = {"u32lo", "u32hi", "u32not", "eqz", "not", "memload"}
M32 = (1 << 32) - 1
_NUMBER = re.compile(r"[0-9]+")
_PERM = {"swap": (1, 0), "movup2": (2, 0, 1), "movdn2": (1, 2, 0),
         "movup3": (3, 0, 1, 2), "movdn3": (1, 2, 3, 0),
         "movup4": (4, 0, 1, 2, 3), "movdn4": (1, 2, 3, 4, 0)}


def _tokens(source: str) -> List[str]:
    out: List[str] = []
    for line in source.splitlines():
        out.extend(line.split("#", 1)[0].split())
    return out


def _lower(tok: str) -> List[Tuple[str, int]]:
    """The rows (op name, immediate) a token lowers to."""
    if tok.startswith("push."):
        return [("push", int(tok[5:]) % P)]
    if tok.startswith("dup."):
        k = int(tok[4:])
        if not 0 <= k <= 7:
            raise ValueError(f"{tok}: dup reaches 7 deep at most")
        return [(f"dup{k}", 0)]
    if tok in ("swap", "movup.2", "movup.3", "movup.4", "movdn.2",
               "movdn.3", "movdn.4", "drop", "add", "sub", "mul", "eq",
               "neq", "eqz", "not", "and", "or", "u32lo", "u32hi",
               "u32not", "mem.load", "mem.store", *_U32_BINARY):
        return [(tok.replace(".", ""), 0)]
    if tok == "u32split":
        return [("dup0", 0), ("u32hi", 0), ("swap", 0), ("u32lo", 0)]
    base, _, arg = tok.rpartition(".")
    if _NUMBER.fullmatch(arg) and (base in _U32_BINARY
                                   or base in ("mem.load", "mem.store")):
        return [("push", int(arg) % P), (base.replace(".", ""), 0)]
    raise ValueError(f"instruction outside the reference's subset: {tok}")


def _flatten(toks: Sequence[str], i: int, procs: dict, out: list,
             stop: Tuple[str, ...]) -> int:
    while i < len(toks):
        t = toks[i]
        if t in stop:
            return i
        if t.startswith("repeat."):
            body: list = []
            i = _flatten(toks, i + 1, procs, body, ("end",)) + 1
            out.extend(body * int(t[7:]))
        elif t == "while.true":
            out.append("<while>")
            i = _flatten(toks, i + 1, procs, out, ("end",)) + 1
            out.append("<endwhile>")
        elif t == "if.true":
            out.append("<if>")
            i = _flatten(toks, i + 1, procs, out, ("end", "else"))
            out.append("<else>")
            if toks[i] == "else":
                i = _flatten(toks, i + 1, procs, out, ("end",))
            out.append("<endif>")
            i += 1
        elif t.startswith("exec."):
            out.extend(procs[t[5:]])
            i += 1
        else:
            out.append(t)
            i += 1
    return i


def assemble(source: str) -> List[Tuple[str, int]]:
    """The program's rows as (op name, immediate), without the halt."""
    toks = _tokens(resolve_imports(source))
    procs: dict = {}
    main: list = []
    i = 0
    while i < len(toks):
        if toks[i].startswith("proc."):
            body: list = []
            name = toks[i].split(".")[1]
            i = _flatten(toks, i + 1, procs, body, ("end",)) + 1
            procs[name] = body
        elif toks[i] == "begin":
            i = _flatten(toks, i + 1, procs, main, ("end",)) + 1
        else:
            i += 1
    rows: List[list] = []
    heads: list = []
    drops: list = []
    jumps: list = []
    for t in main:
        if t == "<while>":
            heads.append(len(rows))
            rows.append(["drop", 0, True])
        elif t == "<endwhile>":
            head = heads.pop()
            rows.append(["nop", head, True])
            rows[head][1] = len(rows)
        elif t == "<if>":
            drops.append(len(rows))
            rows.append(["drop", 0, True])
        elif t == "<else>":
            jumps.append(len(rows))
            rows.append(["nop", 0, True])
            rows[drops.pop()][1] = len(rows)
        elif t == "<endif>":
            rows[jumps.pop()][1] = len(rows)
        else:
            rows.extend([op, imm, False] for op, imm in _lower(t))
    if heads or drops or jumps:
        raise ValueError("unterminated control block")
    return [(op, imm if branch or op not in ("drop", "nop") else pc + 1)
            for pc, (op, imm, branch) in enumerate(rows)]


def rom_listing(source: str) -> List[Tuple[int, int, int]]:
    """(pc, op index, imm) of every row of the program, then the halt."""
    rows = assemble(source)
    return ([(pc, _OP[op], imm) for pc, (op, imm) in enumerate(rows)]
            + [(len(rows), _OP["halt"], 0)])


def _address(a: int) -> int:
    if a > M32:
        raise ValueError("memory address of 2^32 or more")
    return a


def _u32(op: str, x: int, y: int) -> int:
    """x op y for the binary u32 ops (x = s1, y = s0), checked as the VM
    checks them."""
    if x > M32 or y > M32:
        raise ValueError(f"{op} on a non-u32 operand")
    if op in ("u32div", "u32mod") and y == 0:
        raise ValueError(f"{op} by zero")
    if op in ("u32shl", "u32shr") and y >= 32:
        raise ValueError(f"{op} by 32 or more")
    if op == "u32div":
        return x // y
    if op == "u32mod":
        return x % y
    if op == "u32shl":
        return (x << y) & M32
    if op == "u32shr":
        return x >> y
    return {"u32add": (x + y) & M32, "u32sub": (x - y) & M32,
            "u32mul": (x * y) & M32, "u32and": x & y, "u32or": x | y,
            "u32xor": x ^ y, "u32lt": int(x < y)}[op]


def _stay(op: str, a: int, memory: Dict[int, int]) -> int:
    """The new s0 of an op that leaves the other slots in place."""
    if op == "u32lo":
        return a & M32
    if op == "u32hi":
        return a >> 32
    if op == "u32not":
        if a > M32:
            raise ValueError("u32not on a non-u32 operand")
        return ~a & M32
    if op == "eqz":
        return int(a == 0)
    if op == "not":
        if a > 1:
            raise ValueError("not on a non-boolean")
        return 1 - a
    return memory.get(_address(a), 0)            # memload


def run(source: str, stack_topfirst: Sequence[int],
        max_rows: int = 1 << 23):
    """(16 output slots top-first, the overflow table bottom-first as
    (address, value) pairs) of the program on the given stack."""
    rows = assemble(source)
    s = ([int(v) % P for v in stack_topfirst] + [0] * 16)[:16]
    if len(stack_topfirst) > 16:
        raise ValueError("more than 16 stack inputs")
    table: List[Tuple[int, int]] = []
    memory: Dict[int, int] = {}
    pc = clk = 0
    while pc < len(rows):
        if clk >= max_rows:
            raise ValueError("the program does not halt within the rows")
        op, imm = rows[pc]
        nxt = pc + 1
        if op in _DOWN:
            table.append((clk + 1, s[15]))
            top = imm if op == "push" else s[int(op[3:])]
            s = [top] + s[:15]
        elif op in _UP:
            a, b = s[0], s[1]
            if op == "drop":
                if imm != pc + 1:            # a branch: the popped condition
                    if a not in (0, 1):
                        raise ValueError("branch condition not boolean")
                    nxt = pc + 1 if a == 1 else imm
                res = None
            elif op == "memstore":
                memory[_address(a)] = b      # b, the new top, stays
                res = None
            elif op in _U32_BINARY:
                res = _u32(op, b, a)
            elif op in ("and", "or"):
                if a > 1 or b > 1:
                    raise ValueError(f"{op} on a non-boolean")
                res = a * b if op == "and" else a + b - a * b
            else:
                res = {"add": (a + b) % P, "sub": (b - a) % P,
                       "mul": a * b % P, "eq": int(a == b),
                       "neq": int(a != b)}[op]
            fill = table.pop()[1] if table else 0
            s = (s[1:] + [fill]) if res is None else ([res] + s[2:] + [fill])
        elif op in _STAY:
            s[0] = _stay(op, s[0], memory)
        elif op in _PERM:
            perm = _PERM[op]
            s = [s[perm[j]] for j in range(len(perm))] + s[len(perm):]
        elif op == "nop":
            nxt = imm
        clk += 1
        pc = nxt
    return s, table


def public_inputs(source: str, stack_topfirst: Sequence[int]
                  ) -> PublicInputs:
    """The public inputs a proof of `source` on `stack_topfirst` states:
    stack inputs bottom-first, the 16 output slots then the parked values
    newest-first, their addresses newest-first."""
    out, table = run(source, stack_topfirst)
    return PublicInputs(
        program_hash=mast_root_felts(resolve_imports(source)),
        stack_inputs=[int(v) % P for v in reversed(list(stack_topfirst))],
        output_stack=out + [v for _, v in reversed(table)],
        overflow_addrs=[a for a, _ in reversed(table)])
