"""Symbolic trace of an AIR's transition constraints and of its aux rows.

`trace(air_cls)` runs the AIR's own, unchanged `evaluate_transitions` on
symbolic frames and rands (`field/sym.py`): the field ops record a
hash-consed DAG of loads, rands, constants and add / sub / neg / mul
instead of computing. The result, a `Program`, is what `air/codegen.py`
turns into the straight-line C++ of kernel K5, so the AIR method stays the
one source of its constraints. `trace_rows(fn, ...)` does the same for a
function of a row and the next row of the main trace (`MidenAir`'s bus
factors, `_bus_row_factors`), whose outputs have no degree class: the
source of kernel K6. `interpret` evaluates a program with the
plain torch ops, and `Program.digest` names it: the generated files carry
the digest of the program they were made from, and the K5 route refuses a
file whose digest the AIR no longer traces to.

A program holds the nodes the constraints reach, in the order
`schedule` emits them: each constraint's operands depth first, the
constraints in their order, so a value is computed shortly before its
first use. `square` and `mul_scalar` arrive as a `mul` of a node by itself
or by a constant.

`emission` turns a program into the statements kernel K5 runs for a point,
so that few values are live at once (the program and its digest stay as
traced): a value that is one field op of leaves and has more than one use
is computed again after one of its leaves is read again
(`rematerialized`), a frame cell or rand is read at its use and kept in a
register only for a next use within `REUSE_WINDOW` sites, and the
constraints come in a greedy order that
leaves few computed values live (`_site_order`). `interpret_emission` runs
the statements with the plain torch ops.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple, Union

import torch

from ..field import gl
from ..field.sym import (ADD, CONST, LOAD, MUL, NEG, OPS, RAND, SUB, Sym,
                         SymFrame, SymGraph)

SEGMENTS = ("main_cur", "main_nxt", "aux_cur", "aux_nxt")
LEAVES = (LOAD, RAND, CONST)

# A frame cell or rand read at one use stays in its register for the next
# use that comes within this many sites of the emission; a use further on
# reads it again.
REUSE_WINDOW = 32


@dataclass(frozen=True)
class Node:
    """One emitted value: `kind` and `args` as in `sym.Sym`, operands by
    their position in `Program.nodes`."""
    kind: str
    args: tuple


@dataclass(frozen=True)
class Program:
    """The traced constraints of one AIR class, or the traced outputs of a
    row function (`air` its name): `nodes` in emission order; `outputs[k]`
    the node of constraint k; `classes[k]` the index of constraint k's
    degree in `degrees` (its x^adj row in the merge), both empty for a row
    function."""
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


Operand = Union[str, int]           # a value's name, or a constant


@dataclass(frozen=True)
class Emission:
    """The statements of one point, in order. A statement is
    `(kind, name, args)`: kind "read" names the value of leaf node `args`
    (a frame cell or a rand, read from where it lies); an op kind names
    the op of `args` (names, or constants as ints); kind "put" hands the
    value `name` (or a constant) to constraint `args`. Names: `v<i>` for
    node i of the program, `r<k>` for the k-th read, `t<k>` for the k-th
    recomputation. `sites` are the nodes the statements compute or hand
    on, in their order."""
    steps: Tuple[tuple, ...]
    sites: Tuple[int, ...]
    remat: FrozenSet[int]
    extra_ops: int          # ops a point beyond the program's own
    frame_reads: int        # frame cells read a point
    rand_reads: int
    peak_live: int          # the most named values live at once


def _readers(prog: Program) -> List[List[int]]:
    """For each node, the nodes that read it; an output also reads itself
    (where its constraint takes it)."""
    readers: List[List[int]] = [[] for _ in prog.nodes]
    for i, n in enumerate(prog.nodes):
        if n.kind in OPS:
            for a in dict.fromkeys(n.args):
                readers[a].append(i)
    for o in dict.fromkeys(prog.outputs):
        readers[o].append(o)
    return readers


def rematerialized(prog: Program) -> FrozenSet[int]:
    """The op nodes that are one field op of leaves (frame cells, rands,
    constants) and have more than one use: computed again at each use
    rather than held from the first to the last."""
    readers = _readers(prog)
    return frozenset(
        i for i, n in enumerate(prog.nodes)
        if n.kind in OPS and len(readers[i]) > 1
        and all(prog.nodes[a].kind in LEAVES for a in n.args))


def _site_order(prog: Program, held: List[bool]) -> List[int]:
    """The sites in emission order: constraint by constraint, a
    constraint's held operands depth first and then its output, as
    `schedule` orders the nodes; the constraints in a greedy order that
    keeps few computed values live: next comes the constraint whose new
    sites leave the fewest values live after it (values it computes that a
    later site reads, less the values whose last reader it holds), the
    first in the AIR's order among equals."""
    nodes = prog.nodes
    readers: List[List[int]] = [[] for _ in nodes]
    for i, n in enumerate(nodes):
        if held[i]:
            for a in dict.fromkeys(n.args):
                if held[a]:
                    readers[a].append(i)
    placed = set()
    left = [len(r) for r in readers]    # readers not yet placed

    def cone(o: int) -> List[int]:
        out: List[int] = []
        seen = set()
        stack = [(o, False)]
        while stack:
            x, ready = stack.pop()
            if x in placed or x in seen:
                continue
            if ready or not held[x]:
                seen.add(x)
                if held[x] or x == o:
                    out.append(x)
                continue
            stack.append((x, True))
            for a in reversed(nodes[x].args):
                stack.append((a, False))
        return out

    live = set()
    sites: List[int] = []
    todo = list(dict.fromkeys(o for o in prog.outputs
                              if nodes[o].kind != CONST))
    while todo:
        best = None
        for o in todo:
            new = cone(o)
            inside = set(new)
            keeps = sum(1 for v in new if held[v] and any(
                r not in inside for r in readers[v] if r not in placed))
            dies = sum(1 for v in live if left[v] == sum(
                r in inside for r in readers[v]))
            if best is None or keeps - dies < best[0]:
                best = (keeps - dies, o, new)
        _, o, new = best
        todo.remove(o)
        for v in new:
            placed.add(v)
            if held[v]:
                for a in dict.fromkeys(nodes[v].args):
                    if held[a]:
                        left[a] -= 1
                live.add(v)
        live = {v for v in live if left[v] > 0}
        sites.extend(new)
    return sites


def emission(prog: Program) -> Emission:
    """The per-point statements of `prog` as kernel K5 runs them, site by
    site in the order of `_site_order`. A site is a node that is computed
    and held (an op node not rematerialized) or a constraint output that
    is not (a leaf or a rematerialized value). At a site each leaf it
    needs is read, unless the same leaf was read or kept at an earlier
    site at most `REUSE_WINDOW` sites back, and each rematerialized
    operand is computed again from those reads. Where the same op was
    already computed from the same reads (up to the order of a commutative
    op's operands), the site names that computation instead: the compiler
    would merge the two, so the statements hold no computation twice."""
    nodes = prog.nodes
    remat = rematerialized(prog)
    held = [n.kind in OPS and i not in remat for i, n in enumerate(nodes)]
    outs: Dict[int, List[int]] = {}
    for k, o in enumerate(prog.outputs):
        outs.setdefault(o, []).append(k)
    sites = _site_order(prog, held)

    def leaves(a: int) -> List[int]:
        if a in remat:
            return [b for b in dict.fromkeys(nodes[a].args)
                    if nodes[b].kind in (LOAD, RAND)]
        return [a] if nodes[a].kind in (LOAD, RAND) else []

    def operands(i: int) -> List[int]:
        return list(dict.fromkeys(nodes[i].args)) if held[i] else [i]

    last_use: Dict[int, int] = {}
    fresh = set()                   # (leaf, site) where the leaf is read
    for t, s in enumerate(sites):
        for a in operands(s):
            for leaf in leaves(a):
                if t - last_use.get(leaf, -REUSE_WINDOW - 1) > REUSE_WINDOW:
                    fresh.add((leaf, s))
                last_use[leaf] = t

    steps: List[tuple] = []
    current: Dict[int, str] = {}    # leaf -> the name of its last read
    computed: Dict[tuple, str] = {}  # (op, operands) -> its recomputation
    counter = {"r": 0, "t": 0}

    def new(prefix: str) -> str:
        counter[prefix] += 1
        return f"{prefix}{counter[prefix] - 1}"

    def resolve(a: int, s: int, done: Dict[int, Operand]) -> Operand:
        if a in done:
            return done[a]
        n = nodes[a]
        if n.kind == CONST:
            name: Operand = n.args[0]
        elif n.kind in (LOAD, RAND):
            if (a, s) in fresh:
                current[a] = new("r")
                steps.append(("read", current[a], a))
            name = current[a]
        elif held[a]:
            name = f"v{a}"
        else:                       # rematerialized
            args = tuple(resolve(b, s, done) for b in n.args)
            key = (n.kind, tuple(sorted(args, key=str))
                   if n.kind in (ADD, MUL) else args)
            if key not in computed:
                computed[key] = new("t")
                steps.append((n.kind, computed[key], args))
            name = computed[key]
        done[a] = name
        return name

    for s in sites:
        done: Dict[int, Operand] = {}
        if held[s]:
            args = tuple(resolve(a, s, done) for a in nodes[s].args)
            name = f"v{s}"
            steps.append((nodes[s].kind, name, args))
        else:
            name = resolve(s, s, done)
        for k in outs.get(s, ()):
            steps.append(("put", name, k))
    for o, ks in outs.items():      # a constraint that folded to a constant
        if nodes[o].kind == CONST:
            steps.extend(("put", nodes[o].args[0], k) for k in ks)

    # live ranges over the statements: a name from its statement to the
    # last statement that reads it
    last: Dict[str, int] = {}
    for t, (kind, name, args) in enumerate(steps):
        used = (name,) if kind == "put" else args if kind in OPS else ()
        for u in used:
            if isinstance(u, str):
                last[u] = t
    live = peak = 0
    ends = [0] * (len(steps) + 1)
    for t, (kind, name, _) in enumerate(steps):
        if kind != "put":
            live += 1
            ends[last.get(name, t)] += 1
        peak = max(peak, live)
        live -= ends[t]
    n_ops = sum(n.kind in OPS for n in nodes)
    reads = [nodes[a].kind for kind, _, a in steps if kind == "read"]
    return Emission(tuple(steps), tuple(sites), remat,
                    sum(kind in OPS for kind, _, _ in steps) - n_ops,
                    reads.count(LOAD), reads.count(RAND), peak)


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


def _nodes(graph: SymGraph, outs, what: str) -> Tuple[tuple, tuple]:
    """(the nodes the outputs reach in `schedule`'s order, each output's
    position among them)."""
    outs = [o if type(o) is Sym else None for o in outs]
    if any(o is None or o.graph is not graph for o in outs):
        raise TypeError(f"{what} returned values that are not nodes of its "
                        "trace")
    order, out_pos = schedule(outs)
    index = {n.id: i for i, n in enumerate(order)}
    nodes = tuple(Node(n.kind, tuple(index[a.id] for a in n.args)
                       if n.kind in (ADD, SUB, NEG, MUL) else
                       (n.args if isinstance(n.args, tuple) else (n.args,)))
                  for n in order)
    return nodes, tuple(out_pos)


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
    nodes, outputs = _nodes(graph, air.evaluate_transitions(*frames, rands),
                            f"{air_cls.__name__}.evaluate_transitions")
    degrees, classes = _degree_classes(
        [d.base for d in air.transition_degrees()])
    if len(classes) != len(outputs):
        raise ValueError(f"{air_cls.__name__}: {len(outputs)} constraints "
                         f"but {len(classes)} transition degrees")
    return Program(air_cls.__name__, air_cls.main_width, aux_w,
                   air_cls.aux_rands, nodes, outputs, degrees, classes)


def trace_rows(fn, main_width: int, rands: int) -> Program:
    """Run `fn(cur, nxt, g)`, a function of one row of the main trace, the
    row after it and `rands` rands that returns field values (the aux
    build's `_bus_row_factors`), on symbolic frames of `main_width`
    columns. Its outputs have no degree class."""
    graph = SymGraph()
    g = [graph.node(RAND, i) for i in range(rands)]
    nodes, outputs = _nodes(graph, fn(SymFrame(graph, "main_cur", main_width),
                                      SymFrame(graph, "main_nxt", main_width),
                                      g), fn.__qualname__)
    return Program(fn.__qualname__, main_width, 0, rands, nodes, outputs,
                   (), ())


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


def interpret_emission(prog: Program, em: Emission, main_cur: torch.Tensor,
                       main_nxt: torch.Tensor,
                       aux_cur: Optional[torch.Tensor],
                       aux_nxt: Optional[torch.Tensor],
                       rands: Sequence[int]) -> List[torch.Tensor]:
    """The constraint values that the statements of `em` compute, read
    and recomputed as they say, with the plain torch ops."""
    frames = dict(zip(SEGMENTS, (main_cur, main_nxt, aux_cur, aux_nxt)))
    device = main_cur.device
    vals: Dict[str, torch.Tensor] = {}

    def value(x: Operand) -> torch.Tensor:
        return vals[x] if isinstance(x, str) else gl.scalar(x, device)

    outs: List[Optional[torch.Tensor]] = [None] * len(prog.outputs)
    for kind, name, args in em.steps:
        if kind == "read":
            n = prog.nodes[args]
            vals[name] = (frames[n.args[0]][n.args[1]] if n.kind == LOAD
                          else gl.scalar(rands[n.args[0]], device))
        elif kind == "put":
            outs[args] = value(name)
        else:
            vals[name] = _PLAIN[kind](*(value(a) for a in args))
    return [o.expand(main_cur.shape[1:]) for o in outs]
