"""Generate kernels K5 and K6's per-AIR CUDA sources from the AIRs' own code.

    python -m aero_tpu_torch.air.codegen --write   # (re)write the files
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

For each AIR class in `ROW_GENERATED`, `symbolic.trace_rows` traces the
function of a row and the next row that its aux build runs (`MidenAir`'s
`_bus_row_factors`, the bus factors), and this module writes kernel K6:

- `csrc/aux_<name>_factors.cuh`: a struct with `eval(in, out)` over one
  row, handing output k to `out.put<k>()` (`StoreOut` of
  `csrc/frag_eval.cuh`, which writes row k of the (outputs, n) result);
- `csrc/aux_<name>.cu`: the `extern "C"` entry `<name>_aux_factors`, one
  thread a row, the next row read in place at (i + 1) mod n.

The file names keep K6 out of `_build.FRAG_EVAL_AIRS`'s glob
(`air_*.cu`); `_build.ROW_EVAL_AIRS` globs `aux_*.cu`.

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

Each file opens with the AIR class it was made from (K6's also with the
function traced) and the digest of the traced program. At first use on
the card, `generated.kernel_for` (`row_kernel_for`) traces again and
raises if the digest differs: an edit to `evaluate_transitions`,
`transition_degrees` or the row function needs a regeneration before the
card proves with that AIR again. To generate a kernel for another AIR,
add its class to `GENERATED` (`ROW_GENERATED`) and run `--write`: the
build, the launch counts and the routes follow the committed files.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

from .fib import FibAir
from .generated import (COMMAND, CSRC, class_key, function_key, paths,
                        row_paths)
from .miden import MidenAir, _bus_row_factors
from .symbolic import (REUSE_WINDOW, Emission, Program, emission, trace,
                       trace_rows)
from ..field.sym import ADD, CONST, LOAD, MUL, NEG, RAND, SUB

# AIR class -> the name of its generated K5 files and entry point
GENERATED: Dict[type, str] = {MidenAir: "miden", FibAir: "fib"}
# AIR class -> (the name of its generated K6 files and entry point, the row
# function of its aux build)
ROW_GENERATED: Dict[type, Tuple[str, Callable]] = {
    MidenAir: ("miden", _bus_row_factors)}

_OPS = {ADD: "gl_add", SUB: "gl_sub", MUL: "gl_mul"}


def struct_name(name: str) -> str:
    return name.capitalize() + "Transitions"


def row_struct_name(name: str) -> str:
    return name.capitalize() + "AuxFactors"


def _header(prog: Program, em: Emission, air_cls, what: str,
            fn: Optional[Callable] = None) -> str:
    """K5's header, or with the row function `fn` K6's."""
    c = prog.counts()
    ops = ", ".join(f"{c.get(k, 0)} {k}" for k in (MUL, ADD, SUB, NEG))
    source = (f"{air_cls.__module__}.{air_cls.__name__}.evaluate_transitions"
              if fn is None else function_key(fn))
    return (
        f"// GENERATED FILE, do not edit: {what} of kernel "
        f"{'K5' if fn is None else 'K6'} for\n"
        f"// {source},"
        f"\n// traced by aero_tpu_torch/air/symbolic.py and written by\n"
        f"//   {COMMAND}\n"
        f"// {len(prog.outputs)} "
        f"{'constraints' if fn is None else 'outputs'}; {ops}; "
        f"{c.get(LOAD, 0)} frame loads, {c.get(RAND, 0)} rands, "
        f"{c.get(CONST, 0)} constants;\n"
        f"// at most {prog.peak_live()} values live at once in this order.\n"
        f"// emission: {len(em.remat)} values computed at their uses (again "
        f"after a re-read), reuse window {REUSE_WINDOW} sites;\n"
        f"// {'a point' if fn is None else 'a row'}: {em.extra_ops} extra "
        f"ops, {em.frame_reads} frame reads, "
        f"{em.rand_reads} rand reads; at most {em.peak_live} values live.\n"
        f"// air-class: {class_key(air_cls)}\n"
        + (f"// traced: {function_key(fn)}\n" if fn is not None else "")
        + f"// dag-digest: {prog.digest}\n")


def _operand(x) -> str:
    return f"0x{x:x}ULL" if isinstance(x, int) else x


def _body(prog: Program, em: Emission) -> str:
    """The statements of `em` as C++: output k goes to
    `out.put<k, its degree class>()`, or `out.put<k>()` in a program
    without classes."""
    body = []
    for kind, val, args in em.steps:
        if kind == "read":
            n = prog.nodes[args]
            src = n.args[0] if n.kind == LOAD else "rand"
            col = n.args[1] if n.kind == LOAD else n.args[0]
            body.append(f"    const u64 {val} = in.{src}({col});")
        elif kind == "put":
            cls = f", {prog.classes[args]}" if prog.classes else ""
            body.append(f"    out.template put<{args}{cls}>"
                        f"({_operand(val)});")
        else:
            a = [_operand(x) for x in args]
            rhs = (f"gl_sub(0ULL, {a[0]})" if kind == NEG
                   else f"{_OPS[kind]}({a[0]}, {a[1]})")
            body.append(f"    const u64 {val} = {rhs};")
    return "\n".join(body)


def emit_transitions(prog: Program, em: Emission, air_cls,
                     name: str) -> str:
    """The per-point header of AIR `name`: the statements of `em`."""
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
            f"  // degree in {{{degrees}}}, the slot of its x^adj in the "
            "merge\n"
            "  template <class In, class Out>\n"
            "  static GL_FN void eval(const In& in, Out& out) {\n"
            + _body(prog, em) + "\n  }\n};\n")


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


def emit_row_factors(prog: Program, em: Emission, air_cls, fn,
                     name: str) -> str:
    """The per-row header of AIR `name`'s K6: the statements of `em`."""
    return (_header(prog, em, air_cls, "the per-row values", fn)
            + "#pragma once\n\n#include \"frag_eval.cuh\"\n\n"
            f"struct {row_struct_name(name)} {{\n"
            f"  static constexpr int kOutputs = {len(prog.outputs)};\n"
            f"  static constexpr int kMainWidth = {prog.main_width};\n"
            f"  static constexpr int kRands = {prog.rands};\n\n"
            "  // output k of the row goes to out.put<k>(); the row's cells\n"
            "  // come from in.main_cur, the next row's from in.main_nxt\n"
            "  template <class In, class Out>\n"
            "  static GL_FN void eval(const In& in, Out& out) {\n"
            + _body(prog, em) + "\n  }\n};\n")


def emit_row_kernel(prog: Program, em: Emission, air_cls, fn,
                    name: str) -> str:
    """The `extern "C"` entry of K6 for AIR `name`."""
    return (_header(prog, em, air_cls, "the entry point", fn) + "\n"
            f"#include \"aux_{name}_factors.cuh\"\n\n"
            "// Kernel K6 over the n rows of the main trace: the (outputs, n)"
            " values,\n// one thread a row (csrc/frag_eval.cuh).\n"
            f"extern \"C\" int {name}_aux_factors(ROW_EVAL_PARAMS) {{\n"
            f"  return row_eval_launch<{row_struct_name(name)}>"
            "(ROW_EVAL_ARGS);\n}\n")


def generate(air_cls) -> Dict[Path, str]:
    """path -> text of the generated K5 files of one AIR class."""
    name = GENERATED[air_cls]
    prog = trace(air_cls)
    em = emission(prog)
    head, entry = paths(name)
    return {head: emit_transitions(prog, em, air_cls, name),
            entry: emit_kernel(prog, em, air_cls, name)}


def generate_rows(air_cls) -> Dict[Path, str]:
    """path -> text of the generated K6 files of one AIR class."""
    name, fn = ROW_GENERATED[air_cls]
    prog = trace_rows(fn, air_cls.main_width, air_cls.aux_rands)
    em = emission(prog)
    head, entry = row_paths(name)
    return {head: emit_row_factors(prog, em, air_cls, fn, name),
            entry: emit_row_kernel(prog, em, air_cls, fn, name)}


def generated_files() -> Dict[Path, str]:
    """path -> text of every generated file, K5's and K6's."""
    out: Dict[Path, str] = {}
    for cls in GENERATED:
        out.update(generate(cls))
    for cls in ROW_GENERATED:
        out.update(generate_rows(cls))
    return out


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
    for path, text in generated_files().items():
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
