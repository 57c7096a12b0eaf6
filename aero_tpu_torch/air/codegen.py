"""Generate kernel K5's per-AIR CUDA sources from the AIRs' own constraints.

    python -m aero_tpu_torch.air.codegen --write   # (re)write csrc/air_*
    python -m aero_tpu_torch.air.codegen --check   # exit 1 if one is stale

For each AIR class in `GENERATED`, `air/symbolic.py` traces its
`evaluate_transitions` into a DAG of field ops, and this module writes the
statements of its `emission` out as straight-line C++ over `gl_add`,
`gl_sub`, `gl_mul` (`csrc/goldilocks.cuh`):

- `csrc/air_<name>_transitions.cuh`: a struct with the AIR's sizes and
  `eval(in, out)`, the per-point function: it reads the frame cells and
  rands through `in` and hands constraint k's value to
  `out.put<k, class>()` as soon as it is computed. `csrc/frag_eval.cuh`
  holds the two `out`s (the merge of kernel K5, and a store of the raw
  values) and compiles on the host as well, which the CPU tests do with
  g++;
- `csrc/air_<name>.cu`: the `extern "C"` entry `<name>_frag_eval` of K5
  for that AIR (`csrc/frag_eval.cuh` holds the kernels).

The emission keeps a point's live set small enough for registers, so the
kernel runs without spilling. Its rules are fixed (`symbolic.emission`):

- a frame cell or rand is read where it is used, and kept in a register
  for its next use only when that use comes within
  `symbolic.REUSE_WINDOW` sites (statements that compute a held value or
  hand on a constraint). The cells used most (the opcode bits) are used
  that densely and so stay in registers over their runs of uses; a cell
  used again far away is read again;
- a value that is one field op of leaves (frame cells, rands, constants)
  and has more than one use is not held from its first use to its last:
  it is computed again from the leaves' new reads once one of them has
  been read again. While the same reads are held, the statements name
  its earlier computation, as the compiler would: no statement repeats
  the op of another on the same operands;
- every other value is computed once, and the constraints come in a
  greedy order: next the one whose new values leave the fewest values
  live (`symbolic._site_order`).

On the card a read is an opaque load (`frag_read` in `csrc/frag_eval.cuh`),
so the compiler cannot merge two reads of one cell, nor therefore two
computations from them. The header states what the statements cost: the
extra ops, the frame and rand reads a point, and the most values they
hold live at once.

Each file opens with the AIR class it was made from and the digest of the
traced program. At first use on the card, `generated.kernel_for` traces
the AIR again and raises if the digest differs: an edit to
`evaluate_transitions` or `transition_degrees` needs a regeneration before
the card proves with that AIR again. To generate a kernel for another AIR,
add its class to `GENERATED` and run `--write`: the build, the launch
counts and the prover's route follow the committed files.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Dict

from .fib import FibAir
from .generated import COMMAND, CSRC, class_key, paths
from .miden import MidenAir
from .symbolic import REUSE_WINDOW, Emission, Program, emission, trace
from ..field.sym import ADD, CONST, LOAD, MUL, NEG, RAND, SUB

# AIR class -> the name of its generated files and entry point
GENERATED: Dict[type, str] = {MidenAir: "miden", FibAir: "fib"}

_OPS = {ADD: "gl_add", SUB: "gl_sub", MUL: "gl_mul"}


def struct_name(name: str) -> str:
    return name.capitalize() + "Transitions"


def _header(prog: Program, em: Emission, air_cls, what: str) -> str:
    c = prog.counts()
    ops = ", ".join(f"{c.get(k, 0)} {k}" for k in (MUL, ADD, SUB, NEG))
    return (
        f"// GENERATED FILE, do not edit: {what} of kernel K5 for\n"
        f"// {air_cls.__module__}.{air_cls.__name__}.evaluate_transitions,"
        f"\n// traced by aero_tpu_torch/air/symbolic.py and written by\n"
        f"//   {COMMAND}\n"
        f"// {len(prog.outputs)} constraints; {ops}; "
        f"{c.get(LOAD, 0)} frame loads, {c.get(RAND, 0)} rands, "
        f"{c.get(CONST, 0)} constants;\n"
        f"// at most {prog.peak_live()} values live at once in this order.\n"
        f"// emission: {len(em.remat)} values computed at their uses (again "
        f"after a re-read), reuse window {REUSE_WINDOW} sites;\n"
        f"// a point: {em.extra_ops} extra ops, {em.frame_reads} frame reads, "
        f"{em.rand_reads} rand reads; at most {em.peak_live} values live.\n"
        f"// air-class: {class_key(air_cls)}\n"
        f"// dag-digest: {prog.digest}\n")


def _operand(x) -> str:
    return f"0x{x:x}ULL" if isinstance(x, int) else x


def emit_transitions(prog: Program, em: Emission, air_cls,
                     name: str) -> str:
    """The per-point header of AIR `name`: the statements of `em`."""
    body = []
    for kind, val, args in em.steps:
        if kind == "read":
            n = prog.nodes[args]
            src = n.args[0] if n.kind == LOAD else "rand"
            col = n.args[1] if n.kind == LOAD else n.args[0]
            body.append(f"    const u64 {val} = in.{src}({col});")
        elif kind == "put":
            body.append(f"    out.template put<{args}, {prog.classes[args]}>"
                        f"({_operand(val)});")
        else:
            a = [_operand(x) for x in args]
            rhs = (f"gl_sub(0ULL, {a[0]})" if kind == NEG
                   else f"{_OPS[kind]}({a[0]}, {a[1]})")
            body.append(f"    const u64 {val} = {rhs};")
    degrees = ", ".join(map(str, prog.degrees))
    return (_header(prog, em, air_cls, "the per-point constraint values")
            + "#pragma once\n\n#include \"frag_eval.cuh\"\n\n"
            f"struct {struct_name(name)} {{\n"
            f"  static constexpr int kConstraints = {len(prog.outputs)};\n"
            f"  static constexpr int kClasses = {len(prog.degrees)};\n"
            f"  static constexpr int kMainWidth = {prog.main_width};\n"
            f"  static constexpr int kAuxWidth = {prog.aux_width};\n"
            f"  static constexpr int kRands = {prog.rands};\n\n"
            "  // constraint k's value goes to out.put<k, c>(), c the index"
            " of its\n"
            f"  // degree in {{{degrees}}}, the row of its x^adj in the "
            "merge\n"
            "  template <class In, class Out>\n"
            "  static GL_FN void eval(const In& in, Out& out) {\n"
            + "\n".join(body) + "\n  }\n};\n")


def emit_kernel(prog: Program, em: Emission, air_cls, name: str) -> str:
    """The `extern "C"` entry of K5 for AIR `name`."""
    return (_header(prog, em, air_cls, "the entry point") + "\n"
            f"#include \"air_{name}_transitions.cuh\"\n\n"
            "// Kernel K5 over one fragment of m points: mode 0 writes the "
            "merged row,\n// mode 1 the (T, m) constraint values "
            "(csrc/frag_eval.cuh).\n"
            f"extern \"C\" int {name}_frag_eval(FRAG_EVAL_PARAMS) {{\n"
            f"  return frag_eval_launch<{struct_name(name)}>(FRAG_EVAL_ARGS);"
            "\n}\n")


def generate(air_cls) -> Dict[Path, str]:
    """path -> text of the generated files of one AIR class."""
    name = GENERATED[air_cls]
    prog = trace(air_cls)
    em = emission(prog)
    head, entry = paths(name)
    return {head: emit_transitions(prog, em, air_cls, name),
            entry: emit_kernel(prog, em, air_cls, name)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--write", action="store_true",
                      help="write the generated files under csrc/")
    mode.add_argument("--check", action="store_true",
                      help="exit 1 if a committed file differs from what "
                           "would be written")
    args = ap.parse_args(argv)
    stale = []
    for cls in GENERATED:
        for path, text in generate(cls).items():
            if args.write:
                path.write_text(text)
                print(f"wrote {path.relative_to(CSRC.parent.parent)}")
            elif not path.exists() or path.read_text() != text:
                stale.append(path)
    for path in stale:
        print(f"stale: {path.relative_to(CSRC.parent.parent)} (run "
              f"`{COMMAND}`)", file=sys.stderr)
    if args.check and not stale:
        print("generated kernels are up to date")
    return 1 if stale else 0


if __name__ == "__main__":
    sys.exit(main())
