"""aero_tpu_torch.air vs aero_tpu.air (JAX, CPU): the carried constants,
all 112 Miden transition constraints, the aux trace, the assertions and the
scalar (verifier-side) evaluation, on a real VM trace and on random frames.
Exact equality throughout."""

from dataclasses import asdict

import jax
import numpy as np
import pytest
import torch

from aero_tpu.air import fib as JF
from aero_tpu.air import miden as JM
from aero_tpu.field import from_gf, to_gf
from aero_tpu.sdk import DEFAULT_OPTIONS
from aero_tpu.spec.proof import ProofOptions
from aero_tpu.vm import execute_full, fibonacci_source, program_hash
from aero_tpu_torch.air import fib as TF
from aero_tpu_torch.air import miden as TM
from aero_tpu_torch.field import from_u64, to_u64
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


P = (1 << 64) - (1 << 32) + 1
SRC = fibonacci_source(10)


@pytest.mark.parametrize("name", [
    "OP", "P", "L_RANGE4", "L_AND", "L_OR", "L_XOR", "L_SHL", "L_SHR",
    "L_MEM", "POW2_W", "M32", "DOWN_OPS", "UP_OPS", "STAY_OPS",
    "NONDET_TOP_OPS", "PERM", "H0_USERS"])
def test_carried_constant_equals_aero_tpu(name):
    assert getattr(TM, name) == getattr(JM, name)


@pytest.fixture(scope="module")
def miden():
    trace, out, ovf = execute_full(SRC, [0, 1], min_rows=64)
    jpub = JM.make_public_inputs(program_hash(SRC), [0, 1], out, overflow=ovf)
    tpub = TM.make_public_inputs(program_hash(SRC), [0, 1], out, overflow=ovf)
    jair = JM.MidenAir(trace.shape[1], jpub, DEFAULT_OPTIONS, program=SRC)
    tair = TM.MidenAir(trace.shape[1], tpub, DEFAULT_OPTIONS, program=SRC)
    rands = [int(r) for r in np.random.default_rng(42).integers(
        0, P, size=16, dtype=np.uint64)]
    return trace, jpub, tpub, jair, tair, rands


def test_public_inputs_equal(miden):
    _, jpub, tpub, _, _, _ = miden
    # each package has its own PublicInputs class: equal field by field
    assert asdict(tpub) == asdict(jpub)
    assert tpub.to_bytes() == jpub.to_bytes()
    ovf = [(5, 11), (9, 13)]
    assert asdict(TM.make_public_inputs([1, 2, 3, 4], [7], [8],
                                        overflow=ovf)) == \
        asdict(JM.make_public_inputs([1, 2, 3, 4], [7], [8], overflow=ovf))


def test_aux_trace_matches_jax_and_host_oracle(miden):
    trace, _, _, jair, tair, rands = miden
    got = to_u64(tair.build_aux_trace(from_u64(trace, "cpu"), rands))
    host = from_gf(jair.build_aux_trace_host(to_gf(trace), rands))
    assert got.shape == (9, 64)
    assert np.array_equal(got, host)
    with jax.disable_jit():
        dev = from_gf(jair.build_aux_trace(to_gf(trace), rands))
    assert np.array_equal(got, dev)


def test_assertions_equal(miden):
    _, _, _, jair, tair, rands = miden
    assert tair.get_assertions() != [] and \
        [tuple(a.__dict__.values()) for a in tair.get_assertions()] == \
        [tuple(a.__dict__.values()) for a in jair.get_assertions()]
    jair._aux_rand = tair._aux_rand = rands
    assert [(a.column, a.step, a.value, a.is_aux)
            for a in tair.get_assertions()] == \
        [(a.column, a.step, a.value, a.is_aux)
         for a in jair.get_assertions()]
    assert tair.num_assertions == 46
    assert tair.num_transition_constraints == 112
    assert [d.base for d in tair.transition_degrees()] == \
        [d.base for d in jair.transition_degrees()]


def _frames_from_trace(trace, aux):
    nxt = np.roll(trace, -1, axis=1)
    anx = np.roll(aux, -1, axis=1)
    return trace, nxt, aux, anx


def _check_transitions(jair, tair, mc, mn, ac, an, rands):
    got = tair.evaluate_transitions(from_u64(mc, "cpu"), from_u64(mn, "cpu"),
                                    from_u64(ac, "cpu"), from_u64(an, "cpu"),
                                    rands)
    with jax.disable_jit():
        want = jair.evaluate_transitions(to_gf(mc), to_gf(mn), to_gf(ac),
                                         to_gf(an), rands)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(to_u64(g), from_gf(w)), f"constraint {i}"
    return got


def test_transitions_on_real_trace(miden):
    trace, _, _, jair, tair, rands = miden
    aux = from_gf(jair.build_aux_trace_host(to_gf(trace), rands))
    got = _check_transitions(jair, tair,
                             *_frames_from_trace(trace, aux), rands)
    assert len(got) == 112
    # a valid trace satisfies every constraint on all rows but the last
    for i, g in enumerate(got):
        assert not to_u64(g)[:-1].any(), f"constraint {i}"


def test_transitions_on_random_frames(miden):
    _, _, _, jair, tair, rands = miden
    rng = np.random.default_rng(9)
    mc, mn = (rng.integers(0, P, size=(72, 32), dtype=np.uint64)
              for _ in range(2))
    ac, an = (rng.integers(0, P, size=(9, 32), dtype=np.uint64)
              for _ in range(2))
    _check_transitions(jair, tair, mc, mn, ac, an, rands)


def test_scalar_evaluation_matches(miden):
    _, _, _, jair, tair, rands = miden
    rng = np.random.default_rng(10)
    mc, mn = ([int(v) for v in rng.integers(0, P, size=72, dtype=np.uint64)]
              for _ in range(2))
    ac, an = ([int(v) for v in rng.integers(0, P, size=9, dtype=np.uint64)]
              for _ in range(2))
    assert tair.evaluate_transitions_scalar(mc, mn, ac, an, rands) == \
        jair.evaluate_transitions_scalar(mc, mn, ac, an, rands)


def test_fib_air_matches():
    opts = ProofOptions(num_queries=27, blowup_factor=8, grinding_factor=8)
    n = 32
    jpub = JF.FibPublicInputs(JF.fib_result(n), n)
    tpub = TF.FibPublicInputs(TF.fib_result(n), n)
    assert tpub.to_bytes() == jpub.to_bytes()
    jair, tair = JF.FibAir(n, jpub, opts), TF.FibAir(n, tpub, opts)
    trace = from_gf(JF.build_fib_trace(n))
    assert np.array_equal(to_u64(TF.build_fib_trace(n)), trace)
    rands = [123456789, P - 5]
    aux = to_u64(tair.build_aux_trace(from_u64(trace, "cpu"), rands))
    assert np.array_equal(aux, from_gf(jair.build_aux_trace(to_gf(trace),
                                                            rands)))
    rng = np.random.default_rng(4)
    mc, mn = (rng.integers(0, P, size=(2, 16), dtype=np.uint64)
              for _ in range(2))
    ac, an = (rng.integers(0, P, size=(1, 16), dtype=np.uint64)
              for _ in range(2))
    _check_transitions(jair, tair, mc, mn, ac, an, rands)
    assert [(a.column, a.step, a.value) for a in tair.get_assertions()] == \
        [(a.column, a.step, a.value) for a in jair.get_assertions()]
    assert tair.ce_blowup == jair.ce_blowup
    assert tair.transition_adjustments() == jair.transition_adjustments()
    assert tair.boundary_adjustments() == jair.boundary_adjustments()
    assert tair.context().to_bytes() == jair.context().to_bytes()
