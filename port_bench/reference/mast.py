"""MAST-style program commitment: a block-tree hash over the assembly AST.

The reference binds proofs to `program.hash()` — the Miden MAST root
(miden-proof-generator/src/main.rs:35), a Merkle-style hash over the
program's block tree (join/loop/split nodes), NOT a flat hash of the
source text. The forked miden-vm's exact MAST constants are
unrecoverable (empty submodule), so this is the same COMMITMENT
STRUCTURE over our own AST with blake2s as the node hash:

    leaf      H(0x00 || "tok tok ...")       straight-line statement run
    join      H(0x01 || H(left) || H(right)) sequence (binary, left-assoc)
    repeat    H(0x02 || n_le8 || H(body))
    loop      H(0x03 || H(body))             while.true
    split     H(0x04 || H(then) || H(else))  if.true / else
    exec      H(0x05 || H(proc_body))        proc call by body commitment

Properties a flat source hash lacks:
structural identity (formatting/comment changes don't alter the
commitment), and procedure bodies committed by hash — the same
dedup-by-digest shape as Miden's MAST, where `exec` references a
digest rather than inlined text.

The root digest is exposed as 4 Goldilocks felts exactly like the
reference's 32-byte program hash (pub_inputs.cairo encoding).

Frozen copy of the port's `vm/mast.py` for the benchmark's plain
reference: it imports nothing of the program, and a change to the
program does not change it.
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple

P = (1 << 64) - (1 << 32) + 1

_LEAF, _JOIN, _REPEAT, _LOOP, _SPLIT, _EXEC = (b"\x00", b"\x01", b"\x02",
                                               b"\x03", b"\x04", b"\x05")


def _h(*parts: bytes) -> bytes:
    return hashlib.blake2s(b"".join(parts)).digest()


def _parse_block(toks: List[str], i: int, procs) -> Tuple[bytes, int]:
    """Parse statements until an unmatched `end`/`else`; returns
    (digest, next_index). Sequences fold left-associatively into JOIN
    nodes; straight-line runs collapse into one LEAF."""
    digest = None
    run: List[str] = []

    def flush():
        nonlocal digest, run
        if run:
            leaf = _h(_LEAF, " ".join(run).encode())
            digest = leaf if digest is None else _h(_JOIN, digest, leaf)
            run = []

    def join(d: bytes):
        nonlocal digest
        flush()
        digest = d if digest is None else _h(_JOIN, digest, d)

    while i < len(toks):
        t = toks[i]
        if t in ("end", "else"):
            break
        if t.startswith("repeat."):
            n = int(t.split(".")[1])
            body, i = _parse_block(toks, i + 1, procs)
            if i >= len(toks) or toks[i] != "end":
                raise ValueError("unterminated repeat")
            i += 1
            join(_h(_REPEAT, n.to_bytes(8, "little"), body))
        elif t == "while.true":
            body, i = _parse_block(toks, i + 1, procs)
            if i >= len(toks) or toks[i] != "end":
                raise ValueError("unterminated while")
            i += 1
            join(_h(_LOOP, body))
        elif t == "if.true":
            then, i = _parse_block(toks, i + 1, procs)
            els = _h(_LEAF, b"")
            if i < len(toks) and toks[i] == "else":
                els, i = _parse_block(toks, i + 1, procs)
            if i >= len(toks) or toks[i] != "end":
                raise ValueError("unterminated if")
            i += 1
            join(_h(_SPLIT, then, els))
        elif t.startswith("exec."):
            name = t.split(".", 1)[1]
            if name not in procs:
                raise ValueError(f"unknown proc {name}")
            join(_h(_EXEC, procs[name]))
            i += 1
        else:
            run.append(t)
            i += 1
    flush()
    return (digest if digest is not None else _h(_LEAF, b"")), i


def mast_root(source: str) -> bytes:
    """32-byte MAST-style root of the program."""
    toks = source.split()
    # strip comments (the assembler's tokenizer drops `# ...` lines; the
    # canonical token stream here must match what executes)
    clean: List[str] = []
    skip_line = False
    for raw in source.splitlines():
        line = raw.split("#", 1)[0]
        clean.extend(line.split())
    toks = clean
    procs = {}
    i = 0
    main_digest = None
    while i < len(toks):
        if toks[i].startswith("proc."):
            decl = toks[i]
            name = decl.split(".")[1]
            body, i = _parse_block(toks, i + 1, procs)
            if i >= len(toks) or toks[i] != "end":
                raise ValueError(f"unterminated proc {name}")
            i += 1
            # the locals count is part of the committed decl
            procs[name] = _h(_EXEC, decl.encode(), body)
        elif toks[i] == "begin":
            main_digest, i = _parse_block(toks, i + 1, procs)
            if i >= len(toks) or toks[i] != "end":
                raise ValueError("unterminated begin")
            i += 1
        else:
            i += 1
    if main_digest is None:
        raise ValueError("program has no begin block")
    return main_digest


def mast_root_felts(source: str) -> List[int]:
    d = mast_root(source)
    return [int.from_bytes(d[k * 8:(k + 1) * 8], "little") % P
            for k in range(4)]
