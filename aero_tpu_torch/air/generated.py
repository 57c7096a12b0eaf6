"""Which AIR classes have generated kernels K5 and K6, and whether they are
current.

`air/codegen.py` writes two files under `csrc/` for each AIR whose
constraints it generates (kernel K5): `air_<name>_transitions.cuh` (the
per-point constraint values) and `air_<name>.cu` (the `extern "C"` entry
`<name>_frag_eval`); and two for each AIR whose aux rows it generates
(kernel K6): `aux_<name>_factors.cuh` (the per-row bus factors) and
`aux_<name>.cu` (the entry `<name>_aux_factors`). Each opens with a header
that names the AIR class (`// air-class: module.Class`), for K6 the
function traced (`// traced: module.function`), and the digest of the
traced program (`// dag-digest: ...`). The committed entry files are the
one list of generated kernels: `_build.FRAG_EVAL_AIRS` and
`_build.ROW_EVAL_AIRS` read their names, and this module reads their
headers, so it imports no AIR.

`kernel_for(air)` is the prover's lookup: the entry name and traced
program of the exact class of `air` (a subclass may change the
constraints), or None. `row_kernel_for(air, fn)` is the aux build's: the
K6 of `air`'s exact class traced from `fn`, or None. At the first lookup
each traces again and raises if either committed file carries another
digest, so a stale generated file never computes a proof.
"""

from __future__ import annotations

import re
from functools import lru_cache
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

from .. import _build
from .symbolic import Program, trace, trace_rows

CSRC = _build.CSRC
COMMAND = "python -m aero_tpu_torch.air.codegen --write"
_FIELD = re.compile(r"^// (air-class|traced|dag-digest): (\S+)$", re.M)


def paths(name: str, csrc: Path = CSRC) -> Tuple[Path, Path]:
    """(the per-point header, the kernel entry) of AIR `name`'s K5."""
    return (csrc / f"air_{name}_transitions.cuh", csrc / f"air_{name}.cu")


def row_paths(name: str, csrc: Path = CSRC) -> Tuple[Path, Path]:
    """(the per-row header, the kernel entry) of AIR `name`'s K6."""
    return (csrc / f"aux_{name}_factors.cuh", csrc / f"aux_{name}.cu")


def class_key(air_cls) -> str:
    return f"{air_cls.__module__}.{air_cls.__qualname__}"


def function_key(fn) -> str:
    return f"{fn.__module__}.{fn.__qualname__}"


def header_field(path: Path, key: str) -> Optional[str]:
    """The `// <key>: value` line of a generated file's header, None
    without one (or without the file)."""
    if not path.exists():
        return None
    for k, v in _FIELD.findall(path.read_text()):
        if k == key:
            return v
    return None


def _key(path: Path, key: str) -> str:
    got = header_field(path, key)
    if got is None:
        raise RuntimeError(f"{path.name} has no `{key}` line; regenerate "
                           f"it with `{COMMAND}`")
    return got


@lru_cache(maxsize=None)
def names() -> Dict[str, str]:
    """AIR class (`module.Class`) -> the name of its generated K5."""
    return {_key(paths(name)[1], "air-class"): name
            for name in _build.FRAG_EVAL_AIRS}


@lru_cache(maxsize=None)
def row_names() -> Dict[Tuple[str, str], str]:
    """(AIR class, traced function) -> the name of its generated K6."""
    return {(_key(row_paths(name)[1], "air-class"),
             _key(row_paths(name)[1], "traced")): name
            for name in _build.ROW_EVAL_AIRS}


def _check(files, prog: Program, source: str) -> None:
    for path in files:
        got = header_field(path, "dag-digest")
        if got != prog.digest:
            raise RuntimeError(
                f"{path.name} is stale: it was generated from a DAG with "
                f"digest {got}, but {source} now traces to {prog.digest}. "
                f"Regenerate it with `{COMMAND}`.")


def check_current(air_cls, prog: Program, csrc: Path = CSRC) -> None:
    """Raise unless both K5 files of `air_cls` under `csrc` carry the
    digest of `prog`."""
    _check(paths(names()[class_key(air_cls)], csrc), prog,
           f"{air_cls.__name__}.evaluate_transitions")


def check_rows_current(air_cls, fn: Callable, prog: Program,
                       csrc: Path = CSRC) -> None:
    """Raise unless both K6 files of `air_cls` and `fn` under `csrc` carry
    the digest of `prog`."""
    _check(row_paths(row_names()[class_key(air_cls), function_key(fn)],
                     csrc), prog, function_key(fn))


_current: Dict[type, Program] = {}
_rows_current: Dict[Tuple[type, Callable], Program] = {}


def kernel_for(air) -> Optional[Tuple[str, Program]]:
    """(entry-point prefix, traced program) of the generated K5 of `air`'s
    exact class, None for a class without one; raises if its committed
    files are stale."""
    cls = type(air)
    name = names().get(class_key(cls))
    if name is None:
        return None
    prog = _current.get(cls)
    if prog is None:
        prog = trace(cls)
        check_current(cls, prog)
        _current[cls] = prog
    return name, prog


def row_kernel_for(air, fn: Callable) -> Optional[Tuple[str, Program]]:
    """(entry-point prefix, traced program) of the generated K6 of `air`'s
    exact class traced from the row function `fn` (called as
    `fn(cur, nxt, rands)` over the main trace's columns), None for a class
    without one; raises if its committed files are stale."""
    cls = type(air)
    name = row_names().get((class_key(cls), function_key(fn)))
    if name is None:
        return None
    prog = _rows_current.get((cls, fn))
    if prog is None:
        prog = trace_rows(fn, cls.main_width, cls.aux_rands)
        check_rows_current(cls, fn, prog)
        _rows_current[cls, fn] = prog
    return name, prog
