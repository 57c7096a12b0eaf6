"""The adversarial forgery suite of tests/test_forgery.py, run through the
port: the same trace-surgery attacks, proved by aero_tpu_torch's prover
with aero_tpu_torch's MidenAir, must each be rejected by the full verifier.

The attacks are not copied: each case calls the original test method with
the module's prover, air, public-input and trace-conversion names pointed
at the port. The port proves a 64-row trace in a few seconds on the CPU,
so these run in the fast lane (the JAX originals are `slow`).
"""

import pytest
import torch

import test_forgery as original
from aero_tpu_torch.air.miden import MidenAir, make_public_inputs
from aero_tpu_torch.field import from_u64
from aero_tpu_torch.prover import prove

torch.set_num_threads(1)   # one thread per xdist worker: no oversubscription

CASES = [(cls, name)
         for cls in (original.TestU32Forgeries, original.TestMemoryForgeries,
                     original.TestProgramForgeries)
         for name in sorted(vars(cls)) if name.startswith("test_")]


@pytest.mark.parametrize("cls,name", CASES,
                         ids=[f"{c.__name__}.{n}" for c, n in CASES])
def test_forgery_is_rejected_with_the_port(cls, name, monkeypatch):
    monkeypatch.setattr(original, "prove", prove)
    monkeypatch.setattr(original, "MidenAir", MidenAir)
    monkeypatch.setattr(original, "make_public_inputs", make_public_inputs)
    monkeypatch.setattr(original, "to_gf",
                        lambda trace: from_u64(trace, "cpu"))
    getattr(cls(), name)()


def test_every_attack_is_covered():
    assert len(CASES) == 11
