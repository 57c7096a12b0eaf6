"""Which AIR classes have a generated kernel K5, and whether it is current.

`air/codegen.py` writes two files under `csrc/` for each AIR it generates:
`air_<name>_transitions.cuh` (the per-point constraint values) and
`air_<name>.cu` (the `extern "C"` entry `<name>_frag_eval`). Each opens
with a header that names the AIR class (`// air-class: module.Class`) and
the digest of the program traced from its `evaluate_transitions`
(`// dag-digest: ...`). The committed entry files are the one list of
generated AIRs: `_build.FRAG_EVAL_AIRS` reads their names, and this module
reads their headers, so it imports no AIR.

`kernel_for(air)` is the prover's lookup: the entry name and traced
program of the exact class of `air` (a subclass may change the
constraints), or None. At the first lookup of a class it traces the class
again and raises if either committed file carries another digest, so a
stale generated file never computes a proof.
"""

from __future__ import annotations

import re
from functools import lru_cache
from pathlib import Path
from typing import Dict, Optional, Tuple

from .. import _build
from .symbolic import Program, trace

CSRC = _build.CSRC
COMMAND = "python -m aero_tpu_torch.air.codegen --write"
_FIELD = re.compile(r"^// (air-class|dag-digest): (\S+)$", re.M)


def paths(name: str, csrc: Path = CSRC) -> Tuple[Path, Path]:
    """(the per-point header, the kernel entry) of AIR `name`."""
    return (csrc / f"air_{name}_transitions.cuh", csrc / f"air_{name}.cu")


def class_key(air_cls) -> str:
    return f"{air_cls.__module__}.{air_cls.__qualname__}"


def header_field(path: Path, key: str) -> Optional[str]:
    """The `// <key>: value` line of a generated file's header, None
    without one (or without the file)."""
    if not path.exists():
        return None
    for k, v in _FIELD.findall(path.read_text()):
        if k == key:
            return v
    return None


@lru_cache(maxsize=None)
def names() -> Dict[str, str]:
    """AIR class (`module.Class`) -> the name of its generated kernel."""
    out = {}
    for name in _build.FRAG_EVAL_AIRS:
        key = header_field(paths(name)[1], "air-class")
        if key is None:
            raise RuntimeError(f"air_{name}.cu names no AIR class; "
                               f"regenerate it with `{COMMAND}`")
        out[key] = name
    return out


def check_current(air_cls, prog: Program, csrc: Path = CSRC) -> None:
    """Raise unless both generated files of `air_cls` under `csrc` carry
    the digest of `prog`."""
    for path in paths(names()[class_key(air_cls)], csrc):
        got = header_field(path, "dag-digest")
        if got != prog.digest:
            raise RuntimeError(
                f"{path.name} is stale: it was generated from a DAG with "
                f"digest {got}, but {air_cls.__name__}.evaluate_transitions "
                f"now traces to {prog.digest}. Regenerate it with "
                f"`{COMMAND}`.")


_current: Dict[type, Program] = {}


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
