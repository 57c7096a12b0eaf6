"""Symbolic trace of an AIR's transition constraints.

`trace(air_cls)` runs the AIR's own, unchanged `evaluate_transitions` on
symbolic frames and rands (`field/sym.py`): the field ops record a
hash-consed DAG of loads, rands, constants and add / sub / neg / mul
instead of computing. The result, a `Program`, is what `air/codegen.py`
turns into the straight-line C++ of kernel K5, so the AIR method stays the
one source of its constraints. `interpret` evaluates a program with the
plain torch ops, and `Program.digest` names it: the generated files carry
the digest of the program they were made from, and the K5 route refuses a
file whose digest the AIR no longer traces to.

A program holds the nodes the constraints reach, in the order
`schedule` emits them: each constraint's operands depth first, the
constraints in their order, so a value is computed shortly before its
first use. `square` and `mul_scalar` arrive as a `mul` of a node by itself
or by a constant.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..field import gl
from ..field.sym import (ADD, CONST, LOAD, MUL, NEG, RAND, SUB, Sym,
                         SymFrame, SymGraph)

SEGMENTS = ("main_cur", "main_nxt", "aux_cur", "aux_nxt")


@dataclass(frozen=True)
class Node:
    """One emitted value: `kind` and `args` as in `sym.Sym`, operands by
    their position in `Program.nodes`."""
    kind: str
    args: tuple


@dataclass(frozen=True)
class Program:
    """The traced constraints of one AIR class: `nodes` in emission order;
    `outputs[k]` the node of constraint k; `classes[k]` the index of
    constraint k's degree in `degrees` (its x^adj row in the merge)."""
    air: str
    main_width: int
    aux_width: int
    rands: int
    nodes: Tuple[Node, ...]
    outputs: Tuple[int, ...]
    degrees: Tuple[int, ...]
    classes: Tuple[int, ...]

    def text(self) -> str:
        """One line a node, then the outputs and the degree classes: the
        text the digest is taken of."""
        lines = [f"air {self.air} main {self.main_width} aux "
                 f"{self.aux_width} rands {self.rands}"]
        for i, n in enumerate(self.nodes):
            lines.append(f"{i} {n.kind} " + " ".join(str(a) for a in n.args))
        lines.append("outputs " + " ".join(map(str, self.outputs)))
        lines.append("degrees " + " ".join(map(str, self.degrees)))
        lines.append("classes " + " ".join(map(str, self.classes)))
        return "\n".join(lines) + "\n"

    @property
    def digest(self) -> str:
        return hashlib.sha256(self.text().encode()).hexdigest()

    def counts(self) -> Dict[str, int]:
        """Nodes by kind."""
        out: Dict[str, int] = {}
        for n in self.nodes:
            out[n.kind] = out.get(n.kind, 0) + 1
        return out

    def peak_live(self) -> int:
        """The most values alive at once when the nodes run in order: a
        value lives from its node to its last use (a constraint's value
        to its own node)."""
        last = list(range(len(self.nodes)))
        for i, n in enumerate(self.nodes):
            if n.kind in (ADD, SUB, NEG, MUL):
                for a in n.args:
                    last[a] = max(last[a], i)
        ends = [0] * (len(self.nodes) + 1)
        for i, n in enumerate(self.nodes):
            if n.kind != CONST:
                ends[last[i]] += 1
        live = peak = 0
        for i, n in enumerate(self.nodes):
            if n.kind != CONST:
                live += 1
            peak = max(peak, live)
            live -= ends[i]
        return peak


def _degree_classes(degrees: Sequence[int]) -> Tuple[tuple, tuple]:
    distinct: List[int] = []
    for d in degrees:
        if d not in distinct:
            distinct.append(d)
    return tuple(distinct), tuple(distinct.index(d) for d in degrees)


def schedule(outputs: Sequence[Sym]) -> Tuple[List[Sym], List[int]]:
    """The nodes the outputs reach, each after its operands, output by
    output (an output's operands depth first, left to right), and each
    output's position in that list."""
    order: List[Sym] = []
    pos: Dict[int, int] = {}
    for out in outputs:
        stack = [(out, False)]
        while stack:
            node, ready = stack.pop()
            if node.id in pos:
                continue
            if ready or node.kind not in (ADD, SUB, NEG, MUL):
                pos[node.id] = len(order)
                order.append(node)
                continue
            stack.append((node, True))
            for a in reversed(node.args):
                if a.id not in pos:
                    stack.append((a, False))
    return order, [pos[o.id] for o in outputs]


def trace(air_cls) -> Program:
    """Run `air_cls.evaluate_transitions` on symbolic frames. The method
    reads nothing of the instance (the constraints are the class's), so it
    runs on an instance made without `__init__`."""
    air = object.__new__(air_cls)
    graph = SymGraph()
    aux_w = air_cls.aux_width or 0
    frames = [SymFrame(graph, "main_cur", air_cls.main_width),
              SymFrame(graph, "main_nxt", air_cls.main_width),
              SymFrame(graph, "aux_cur", aux_w) if aux_w else None,
              SymFrame(graph, "aux_nxt", aux_w) if aux_w else None]
    rands = [graph.node(RAND, i) for i in range(air_cls.aux_rands)]
    outs = air.evaluate_transitions(*frames, rands)
    outs = [o if type(o) is Sym else None for o in outs]
    if any(o is None or o.graph is not graph for o in outs):
        raise TypeError(f"{air_cls.__name__}.evaluate_transitions returned "
                        "values that are not nodes of its trace")
    order, out_pos = schedule(outs)
    index = {n.id: i for i, n in enumerate(order)}
    nodes = tuple(Node(n.kind, tuple(index[a.id] for a in n.args)
                       if n.kind in (ADD, SUB, NEG, MUL) else
                       (n.args if isinstance(n.args, tuple) else (n.args,)))
                  for n in order)
    degrees, classes = _degree_classes(
        [d.base for d in air.transition_degrees()])
    if len(classes) != len(outs):
        raise ValueError(f"{air_cls.__name__}: {len(outs)} constraints but "
                         f"{len(classes)} transition degrees")
    return Program(air_cls.__name__, air_cls.main_width, aux_w,
                   air_cls.aux_rands, nodes, tuple(out_pos), degrees,
                   classes)


_PLAIN = {ADD: gl.add_plain, SUB: gl.sub_plain, NEG: gl.neg_plain,
          MUL: gl.mul_plain}


def interpret(prog: Program, main_cur: torch.Tensor, main_nxt: torch.Tensor,
              aux_cur: Optional[torch.Tensor], aux_nxt: Optional[torch.Tensor],
              rands: Sequence[int]) -> List[torch.Tensor]:
    """The program's constraint values over (width, m) frames, with the
    plain torch ops on the frames' device."""
    frames = dict(zip(SEGMENTS, (main_cur, main_nxt, aux_cur, aux_nxt)))
    device = main_cur.device
    shape = main_cur.shape[1:]
    last = {}                       # node -> the last node that reads it
    for i, n in enumerate(prog.nodes):
        if n.kind in (ADD, SUB, NEG, MUL):
            for a in n.args:
                last[a] = i
    outputs = set(prog.outputs)
    vals: List[Optional[torch.Tensor]] = []
    for i, n in enumerate(prog.nodes):
        if n.kind == LOAD:
            v = frames[n.args[0]][n.args[1]]
        elif n.kind == RAND:
            v = gl.scalar(rands[n.args[0]], device)
        elif n.kind == CONST:
            v = gl.scalar(n.args[0], device)
        else:
            v = _PLAIN[n.kind](*(vals[a] for a in n.args))
            for a in set(n.args):       # free what no later node reads
                if last[a] == i and a not in outputs:
                    vals[a] = None
        vals.append(v)
    return [vals[o].expand(shape) for o in prog.outputs]
