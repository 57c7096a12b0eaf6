"""What a Miden program's proof must state, worked out in plain Python.

The reference's own reading of the programs the cells prove: a
tokenizer and assembler for the subset of the assembly those programs
use (`push.N`, `dup.k`, `swap`, `movup.k`, `movdn.k`, `drop`, `add`,
`sub`, `mul`, `eq`, `neq`, `while.true`, `if.true`/`else`, `repeat.N`),
lowered to the program ROM as the VM documents it (a loop head is a
conditional `drop` whose immediate is the exit, a loop's end a `nop`
whose immediate is the head; ordinary `drop` and `nop` rows carry pc + 1;
the listing ends in `halt`), and an interpreter of the same rows over a
16-slot stack with the overflow table the AIR's bus describes (a
window-down row at clock c parks s15 under address c + 1, a window-up row
takes the newest entry back, or 0). From these come the public inputs a
proof of the program must carry: the program hash (`mast.py`), the stack
inputs, the 16 output slots, the parked values and their addresses.

An instruction outside the subset raises: a program that needs more
brings its own reference.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .field import P
from .mast import mast_root_felts
from .miden_air import OPS
from .proof import PublicInputs

_OP = {name: i for i, name in enumerate(OPS)}
_DOWN = {"push", "dup0", "dup1", "dup2", "dup3", "dup4", "dup5", "dup6",
         "dup7"}
_UP = {"drop", "add", "sub", "mul", "eq", "neq"}
_PERM = {"swap": (1, 0), "movup2": (2, 0, 1), "movdn2": (1, 2, 0),
         "movup3": (3, 0, 1, 2), "movdn3": (1, 2, 3, 0),
         "movup4": (4, 0, 1, 2, 3), "movdn4": (1, 2, 3, 4, 0)}


def _tokens(source: str) -> List[str]:
    out: List[str] = []
    for line in source.splitlines():
        out.extend(line.split("#", 1)[0].split())
    return out


def _instr(tok: str) -> Tuple[str, int]:
    if tok.startswith("push."):
        return "push", int(tok[5:]) % P
    if tok.startswith("dup."):
        return f"dup{int(tok[4:])}", 0
    if tok in ("swap", "movup.2", "movup.3", "movup.4", "movdn.2",
               "movdn.3", "movdn.4", "drop", "add", "sub", "mul", "eq",
               "neq"):
        return tok.replace(".", ""), 0
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
    toks = _tokens(source)
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
            rows.append([*_instr(t), False])
    if heads or drops or jumps:
        raise ValueError("unterminated control block")
    return [(op, imm if branch or op not in ("drop", "nop") else pc + 1)
            for pc, (op, imm, branch) in enumerate(rows)]


def rom_listing(source: str) -> List[Tuple[int, int, int]]:
    """(pc, op index, imm) of every row of the program, then the halt."""
    rows = assemble(source)
    return ([(pc, _OP[op], imm) for pc, (op, imm) in enumerate(rows)]
            + [(len(rows), _OP["halt"], 0)])


def run(source: str, stack_topfirst: Sequence[int],
        max_rows: int = 1 << 23):
    """(16 output slots top-first, the overflow table bottom-first as
    (address, value) pairs) of the program on the given stack."""
    rows = assemble(source)
    s = ([int(v) % P for v in stack_topfirst] + [0] * 16)[:16]
    if len(stack_topfirst) > 16:
        raise ValueError("more than 16 stack inputs")
    table: List[Tuple[int, int]] = []
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
            else:
                res = {"add": (a + b) % P, "sub": (b - a) % P,
                       "mul": a * b % P, "eq": int(a == b),
                       "neq": int(a != b)}[op]
            fill = table.pop()[1] if table else 0
            s = (s[1:] + [fill]) if res is None else ([res] + s[2:] + [fill])
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
        program_hash=mast_root_felts(source),
        stack_inputs=[int(v) % P for v in reversed(list(stack_topfirst))],
        output_stack=out + [v for _, v in reversed(table)],
        overflow_addrs=[a for a, _ in reversed(table)])
