"""The Miden programs the configurations name, as assembly source.

A configuration's `program` is {"name": N, and N's parameters}; the
source is `programs/N.masm` with each `{parameter}` filled in. The same
source goes to the program under test and to the reference, and a new
program is a new file.
"""

from __future__ import annotations

from pathlib import Path

HERE = Path(__file__).resolve().parent / "programs"


def program_source(spec: dict) -> str:
    params = {k: v for k, v in spec.items() if k != "name"}
    return (HERE / f"{spec['name']}.masm").read_text().format(**params)
