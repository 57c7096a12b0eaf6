"""Symbolic field elements: the node type the field ops record.

`air/symbolic.py` traces an AIR's `evaluate_transitions` by handing it
frames whose rows are `Sym` nodes and rands that are `Sym` nodes. The field
ops of `gl.py` that the AIRs call (`add`, `sub`, `neg`, `mul`, and through
them `square`, `mul_scalar`; `scalar`, `gf_full`, `gf_zeros` for
constants) test `type(x) is Sym` first and then record one node here
instead of computing. A node belongs to the `SymGraph` of its trace, which
also stands in for the torch device (`frame.device`, `x.device`), so
constants made from a device land in the same graph; nothing is global,
and two traces may run at once.

The graph is hash-consed: an op on the same operands returns the node
already recorded. Four identities are folded, the ones that hold on every
canonical value: x + 0, x - 0, x * 1 are x, and x * 0 is 0.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

P = (1 << 64) - (1 << 32) + 1

# node kinds: leaves, then the ops
LOAD, RAND, CONST = "load", "rand", "const"
ADD, SUB, NEG, MUL = "add", "sub", "neg", "mul"
OPS = (ADD, SUB, NEG, MUL)


class Sym:
    """One node: `kind`, and `args` (operand nodes for an op; for a load
    (segment, column), segment one of "main_cur", "main_nxt", "aux_cur",
    "aux_nxt"; for a rand its index; for a constant its value in
    [0, p))."""

    __slots__ = ("graph", "id", "kind", "args")

    def __init__(self, graph: "SymGraph", nid: int, kind: str, args):
        self.graph = graph
        self.id = nid
        self.kind = kind
        self.args = args

    @property
    def device(self) -> "SymGraph":
        return self.graph

    def __repr__(self) -> str:
        return f"Sym({self.id}, {self.kind})"


class SymGraph:
    """The nodes of one trace, in the order they were first recorded
    (operands before their uses)."""

    def __init__(self):
        self.nodes: List[Sym] = []
        self._index: Dict[Tuple, Sym] = {}

    def node(self, kind: str, args) -> Sym:
        key = (kind, tuple(a.id if isinstance(a, Sym) else a for a in args)
               if kind in OPS else args)
        found = self._index.get(key)
        if found is None:
            found = Sym(self, len(self.nodes), kind, args)
            self.nodes.append(found)
            self._index[key] = found
        return found

    def const(self, v: int) -> Sym:
        return self.node(CONST, int(v) % P)


class SymFrame:
    """A (width, m) frame of symbolic loads: row c is the load of column c
    of `segment` at the point under evaluation."""

    def __init__(self, graph: SymGraph, segment: str, width: int):
        self.graph = graph
        self.segment = segment
        self.shape = (width, 1)

    @property
    def device(self) -> SymGraph:
        return self.graph

    def __getitem__(self, c: int) -> Sym:
        if not 0 <= c < self.shape[0]:
            raise IndexError(f"{self.segment}[{c}] outside its "
                             f"{self.shape[0]} columns")
        return self.graph.node(LOAD, (self.segment, c))


def _is_const(x: Sym, v: int) -> bool:
    return x.kind == CONST and x.args == v


def _operands(a, b) -> Tuple[Sym, Sym]:
    graph = a.graph if type(a) is Sym else b.graph
    if type(a) is not Sym or type(b) is not Sym or b.graph is not graph:
        raise TypeError(f"symbolic op on {a!r} and {b!r}: both operands "
                        "must be nodes of one trace")
    return a, b


def add(a, b) -> Sym:
    a, b = _operands(a, b)
    if _is_const(b, 0):
        return a
    if _is_const(a, 0):
        return b
    return a.graph.node(ADD, (a, b))


def sub(a, b) -> Sym:
    a, b = _operands(a, b)
    if _is_const(b, 0):
        return a
    return a.graph.node(SUB, (a, b))


def neg(a) -> Sym:
    return a.graph.node(NEG, (a,))


def mul(a, b) -> Sym:
    a, b = _operands(a, b)
    if _is_const(b, 1) or _is_const(a, 0):
        return a
    if _is_const(a, 1) or _is_const(b, 0):
        return b
    return a.graph.node(MUL, (a, b))


def scalar(v, graph: SymGraph) -> Sym:
    """`gl.scalar` on a symbolic device: a rand node stays itself (the
    AIRs turn their rands into scalars), an integer becomes a constant."""
    if type(v) is Sym:
        return v
    return graph.const(v)
