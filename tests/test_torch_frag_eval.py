"""Kernel K5's generated constraint code (`air/symbolic.py`,
`air/codegen.py`, `csrc/frag_eval.cuh`, `csrc/air_*`) against `aero_tpu`,
on the CPU. Exact equality throughout.

- the traced program, interpreted with the plain ops, equals `aero_tpu`'s
  `evaluate_transitions` (all 112 Miden and 3 Fib constraints) on random
  frames and on frames of a real trace;
- the emission K5 runs (`symbolic.emission`: a value that is one op of
  leaves and has more than one use computed again after a re-read of its
  leaves, a leaf read again past the reuse window), interpreted with the plain ops, equals
  `aero_tpu`'s transitions; the generated header states its costs;
- the committed generated files are what `codegen --check` would write;
- the committed per-point C++ (`frag_eval.cuh` and the generated headers),
  compiled with g++ against a host shim, equals `aero_tpu`'s transitions
  and the merge of its fragment runner on the same frames and
  coefficients;
- a generated file whose digest the AIR no longer traces to raises.
"""

import ctypes
import re
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from aero_tpu.air import fib as JF
from aero_tpu.air import miden as JM
from aero_tpu.field import from_gf, to_gf
from aero_tpu.field import jax_gl as J
from aero_tpu.sdk import DEFAULT_OPTIONS
from aero_tpu.vm import execute_full, fibonacci_source, program_hash
from aero_tpu_torch.air import codegen, generated, symbolic
from aero_tpu_torch.air import fib as TF
from aero_tpu_torch.air import miden as TM
from aero_tpu_torch.field import gl
from aero_tpu_torch.field.sym import OPS
from aero_tpu_torch.ntt import intt, lde
from aero_tpu_torch.prover import prover as TP
from aero_tpu_torch.spec.proof import ProofOptions
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs

P = (1 << 64) - (1 << 32) + 1
LEAVES = ("load", "rand", "const")
ROWS = 64
SRC = fibonacci_source(10)


def _rand_cols(rng, shape):
    return rng.integers(0, P, size=shape, dtype=np.uint64)


def _fib_trace(n):
    tr = np.zeros((2, n), dtype=np.uint64)
    a, b = 1, 2
    for i in range(n):
        tr[0, i], tr[1, i] = a, b
        a, b = (a + b) % P, (a + 2 * b) % P
    return tr


@pytest.fixture(scope="module")
def airs():
    """For each AIR: the port's air, the JAX air, a real trace with its aux
    segment, and seeded rands."""
    trace, out, ovf = execute_full(SRC, [0, 1], min_rows=ROWS)
    pub_t = TM.make_public_inputs(program_hash(SRC), [0, 1], out,
                                  overflow=ovf)
    pub_j = JM.make_public_inputs(program_hash(SRC), [0, 1], out,
                                  overflow=ovf)
    tm = TM.MidenAir(ROWS, pub_t, DEFAULT_OPTIONS, program=SRC)
    jm = JM.MidenAir(ROWS, pub_j, DEFAULT_OPTIONS, program=SRC)
    opts = ProofOptions(num_queries=7, blowup_factor=8, grinding_factor=2)
    ftr = _fib_trace(ROWS)
    fpub = TF.FibPublicInputs(int(ftr[1, -1]), ROWS)
    tf = TF.FibAir(ROWS, fpub, opts)
    jf = JF.FibAir(ROWS, JF.FibPublicInputs(int(ftr[1, -1]), ROWS), opts)
    rng = np.random.default_rng(8)
    out = {}
    for name, tair, jair, tr in (("miden", tm, jm, trace),
                                 ("fib", tf, jf, ftr)):
        rands = [int(r) for r in _rand_cols(rng, tair.aux_rands)]
        tair._aux_rand = jair._aux_rand = rands
        aux = gl.to_u64(tair.build_aux_trace(gl.from_u64(tr, "cpu"), rands))
        out[name] = (tair, jair, tr, aux, rands)
    return out


def _frames(kind, tair, trace, aux, rng):
    """(main_cur, main_nxt, aux_cur, aux_nxt) as uint64 arrays: 32 random
    points, or every row of the real trace beside its next row."""
    if kind == "random":
        return (_rand_cols(rng, (tair.main_width, 32)),
                _rand_cols(rng, (tair.main_width, 32)),
                _rand_cols(rng, (tair.aux_width, 32)),
                _rand_cols(rng, (tair.aux_width, 32)))
    return (trace, np.roll(trace, -1, axis=1), aux, np.roll(aux, -1, axis=1))


def _jax_transitions(jair, frames, rands):
    with jax.disable_jit():
        return [from_gf(v) for v in jair.evaluate_transitions(
            *(to_gf(f) for f in frames), rands)]


CASES = [(a, k) for a in ("miden", "fib") for k in ("random", "trace")]


@pytest.mark.parametrize("air,kind", CASES)
def test_traced_program_equals_aero_tpu(airs, air, kind):
    tair, jair, trace, aux, rands = airs[air]
    frames = _frames(kind, tair, trace, aux, np.random.default_rng(3))
    prog = symbolic.trace(type(tair))
    got = symbolic.interpret(prog, *(gl.from_u64(f, "cpu") for f in frames),
                             rands)
    want = _jax_transitions(jair, frames, rands)
    assert len(got) == len(want) == tair.num_transition_constraints
    for k, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(gl.to_u64(g), w), f"constraint {k}"
    if kind == "trace":        # a valid trace: zero on every row but the last
        assert not any(gl.to_u64(g)[:-1].any() for g in got)


def test_trace_records_the_expected_program():
    prog = symbolic.trace(TM.MidenAir)
    counts = prog.counts()
    assert len(prog.outputs) == 112 and prog.degrees[0] == 1
    assert counts["rand"] == 16 and counts["load"] == 134
    assert counts["mul"] + counts["add"] + counts["sub"] > 1200
    # operands come before their uses, and the trace is deterministic
    for i, n in enumerate(prog.nodes):
        if n.kind in ("add", "sub", "neg", "mul"):
            assert all(a < i for a in n.args)
    assert symbolic.trace(TM.MidenAir).digest == prog.digest
    # the symbolic branch leaves the ops on tensors as they were
    a = gl.from_u64(np.array([3, P - 1], dtype=np.uint64), "cpu")
    assert gl.to_u64(gl.add(a, a)).tolist() == [6, P - 2]


EMITTED = {"miden": TM.MidenAir, "fib": TF.FibAir}


@pytest.mark.parametrize("air", ["miden", "fib"])
def test_rematerialized_values_are_one_op_of_leaves_used_more_than_once(air):
    """The emission computes again exactly the values that are one field
    op of leaves and have more than one use (the readers of a node, and
    its own constraint if it is an output): at a use, unless the same op
    of the same reads was computed before. No two statements compute one
    op of the same operands (up to a commutative op's order), so the
    compiler has none to merge, and the extra ops are what runs."""
    prog = symbolic.trace(EMITTED[air])
    em = symbolic.emission(prog)
    uses = {i: set() for i in range(len(prog.nodes))}
    for i, n in enumerate(prog.nodes):
        if n.kind in OPS:
            for a in n.args:
                uses[a].add(i)
    for o in prog.outputs:
        uses[o].add(("out", o))
    leafy = {i for i, n in enumerate(prog.nodes)
             if n.kind in OPS and all(prog.nodes[a].kind in LEAVES
                                      for a in n.args)}
    assert em.remat == {i for i in leafy if len(uses[i]) > 1}
    assert len(em.remat) == {"miden": 79, "fib": 0}[air]
    # every remaining op node is computed once, a rematerialized value at
    # most at each of its uses: the extra ops at most the uses beyond the
    # first
    ops = sum(n.kind in OPS for n in prog.nodes)
    assert 0 <= em.extra_ops <= sum(len(uses[i]) - 1 for i in em.remat)
    assert sum(k in OPS for k, _, _ in em.steps) == ops + em.extra_ops
    computed = [(k, tuple(sorted(map(str, a))) if k in ("add", "mul")
                 else a) for k, name, a in em.steps
                if k in OPS and name.startswith("t")]
    assert len(set(computed)) == len(computed)
    assert {name for k, name, _ in em.steps if k in OPS
            and name.startswith("v")} == {
        f"v{i}" for i, n in enumerate(prog.nodes)
        if n.kind in OPS and i not in em.remat}


@pytest.mark.parametrize("air", ["miden", "fib"])
def test_emission_reads_a_leaf_again_only_past_the_reuse_window(air):
    """The sites are each held op node once and each other non-constant
    output once, every held operand before its reader. A frame cell or
    rand is read at its first use and again at a use more than
    REUSE_WINDOW sites after the one before; between, the statements name
    the value of its last read. Every name is defined before it is
    used."""
    prog = symbolic.trace(EMITTED[air])
    em = symbolic.emission(prog)
    window = symbolic.REUSE_WINDOW
    held = {i for i, n in enumerate(prog.nodes)
            if n.kind in OPS and i not in em.remat}
    outputs = set(prog.outputs)
    assert sorted(em.sites) == sorted(
        held | {o for o in outputs if prog.nodes[o].kind != "const"})
    pos = {s: t for t, s in enumerate(em.sites)}
    for s in held:
        assert all(pos[a] < pos[s] for a in prog.nodes[s].args if a in held)
    prev = {}
    want_reads = []
    for t, s in enumerate(em.sites):
        ops = set(prog.nodes[s].args) if s in held else {s}
        leaves = set()
        for a in ops:
            leaves |= ({b for b in prog.nodes[a].args} if a in em.remat
                       else {a})
        for leaf in sorted(x for x in leaves
                           if prog.nodes[x].kind in ("load", "rand")):
            if leaf not in prev or t - prev[leaf] > window:
                want_reads.append(leaf)
            prev[leaf] = t
    reads = [a for k, _, a in em.steps if k == "read"]
    assert sorted(reads) == sorted(want_reads)
    assert em.frame_reads == sum(prog.nodes[a].kind == "load"
                                 for a in reads)
    assert em.rand_reads == len(reads) - em.frame_reads
    defined = set()
    for kind, name, args in em.steps:
        used = [name] if kind == "put" else list(args) if kind in OPS else []
        assert all(u in defined for u in used if isinstance(u, str))
        if kind != "put":
            assert name not in defined
            defined.add(name)
    assert sorted(a for k, _, a in em.steps if k == "put") == list(
        range(len(prog.outputs)))


@pytest.mark.parametrize("air,kind", CASES)
def test_emission_interpreted_equals_aero_tpu(airs, air, kind):
    """The statements K5 runs (values computed again, cells read again),
    interpreted with the plain ops, equal aero_tpu's transitions."""
    tair, jair, trace, aux, rands = airs[air]
    frames = _frames(kind, tair, trace, aux, np.random.default_rng(4))
    prog = symbolic.trace(type(tair))
    got = symbolic.interpret_emission(
        prog, symbolic.emission(prog),
        *(gl.from_u64(f, "cpu") for f in frames), rands)
    want = _jax_transitions(jair, frames, rands)
    assert len(got) == len(want) == tair.num_transition_constraints
    for k, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(gl.to_u64(g), w), f"constraint {k}"


@pytest.mark.parametrize("air", ["miden", "fib"])
def test_header_states_what_the_emission_costs(air):
    """The committed header's counts are the generator's: extra ops, frame
    and rand reads a point, the emission's and the traced order's peaks."""
    prog = symbolic.trace(EMITTED[air])
    em = symbolic.emission(prog)
    head = generated.paths(air)[0].read_text()
    found = re.search(r"// emission: (\d+) values computed at their uses "
                      r"\(again after a re-read\), reuse window (\d+) "
                      r"sites;\n// a point: (\d+) extra "
                      r"ops, (\d+) frame reads, (\d+) rand reads; at most "
                      r"(\d+) values live\.", head)
    assert found is not None
    assert tuple(map(int, found.groups())) == (
        len(em.remat), symbolic.REUSE_WINDOW, em.extra_ops, em.frame_reads,
        em.rand_reads, em.peak_live)
    assert f"at most {prog.peak_live()} values live at once" in head
    if air == "miden":          # what the emission is for: a small live set
        assert prog.peak_live() == 85 and em.peak_live <= 27
        assert em.extra_ops == 116


@pytest.mark.parametrize("air", ["miden", "fib"])
def test_committed_generated_files_are_current(air):
    cls = {"miden": TM.MidenAir, "fib": TF.FibAir}[air]
    for path, text in codegen.generate(cls).items():
        assert path.read_text() == text, (
            f"{path.name} differs from `python -m aero_tpu_torch.air.codegen "
            "--write`")
    assert codegen.main(["--check"]) == 0


SHIM = r"""
#define __device__
#define __forceinline__ inline
static inline unsigned long long __umul64hi(unsigned long long a,
                                            unsigned long long b) {
  return (unsigned long long)(((unsigned __int128)a * b) >> 64);
}
#include "air_miden_transitions.cuh"
#include "air_fib_transitions.cuh"

template <class Air>
static void run(const FrameIn& f, const MergeArgs& a, u64* out,
                long long m, int mode) {
  u64 slots[Air::kClasses + 1];
  for (long long e = 0; e < m; ++e) {
    FrameIn in = f;
    in.e = e;
    if (mode == 0) out[e] = frag_merge_point<Air>(in, a, Slots{slots});
    else frag_store_point<Air>(in, out, m);
  }
}

extern "C" void host_frag_eval(int air, const u64* mc, long long smc,
    const u64* mn, long long smn, const u64* ac, long long sac,
    const u64* an, long long san, const u64* mt, long long smt,
    const u64* at, long long sat, long long nb, const u64* rands,
    const u64* cc_t, const u64* cc_b, const u64* bvals, const u64* zt,
    const u64* dinv, long long sd, const u64* lo, const u64* hi,
    const u64* pw, int X, int h, long long m_dom, long long first,
    const int* idx, int B, u64* out, long long m, int mode) {
  const FrameIn f{mc, mn, ac, an, smc, smn, sac, san, mt, at, smt, sat, nb,
                  rands, 0};
  const XPow xp{lo, hi, pw, first, (u64)(m_dom - 1), h, X};
  const MergeArgs a{cc_t, cc_b, bvals, zt, dinv, sd, xp, idx, B};
  if (air == 0) run<MidenTransitions>(f, a, out, m, mode);
  else run<FibTransitions>(f, a, out, m, mode);
}

// slot r's value at the m positions first .. first + m - 1, into out (X, m)
extern "C" void host_xpow(const u64* lo, const u64* hi, const u64* pw, int X,
    int h, long long m_dom, long long first, u64* out, long long m) {
  const XPow xp{lo, hi, pw, first, (u64)(m_dom - 1), h, X};
  for (int r = 0; r < X; ++r)
    for (long long e = 0; e < m; ++e) out[r * m + e] = xp.at(r, first + e);
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The committed per-point code built for the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build the host shim")
    d = tmp_path_factory.mktemp("k5_host")
    (d / "shim.cpp").write_text(SHIM)
    subprocess.run([gxx, "-O1", "-std=c++17", "-fPIC", "-shared",
                    "-I", str(codegen.CSRC), str(d / "shim.cpp"), "-o",
                    str(d / "shim.so")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "shim.so"))
    lib.host_frag_eval.restype = None
    lib.host_xpow.restype = None
    return lib


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _xpow_args(xpow):
    """The C arguments of a `gl_cuda.XPow` (`csrc/frag_eval.cuh` XPow)."""
    h = xpow.lo.shape[0].bit_length() - 1
    return (_ptr(xpow.lo), _ptr(xpow.hi), _ptr(xpow.pw),
            ctypes.c_int(xpow.pw.shape[0]), ctypes.c_int(h),
            ctypes.c_longlong(xpow.m_dom), ctypes.c_longlong(xpow.first))


def _host_call(lib, air, frames, rands, merger, a0, transitions):
    """K5's per-point code on the host over one fragment, with the
    arguments `k5_inputs` makes: a `Wrapped` frame read in place as its
    body and tail."""
    name, frames, rand_t, cc_t, cc_b, bvals, zt, dinv, xpow, idx, T = \
        merger.k5_inputs(*frames, a0)
    assert rand_t.tolist() == [gl.as_i64(r) for r in rands]
    m = zt.shape[-1]
    out = torch.empty((T, m) if transitions else (m,), dtype=torch.int64)

    def pieces(f):                  # (body, tail), each a view as it lies
        return tuple(f) if isinstance(f, TP.Wrapped) else (f, f[:, :0])

    mc, ac = frames[0], frames[2]
    (mn, mt), (an, at) = pieces(frames[1]), pieces(frames[3])
    assert all(t.stride(-1) == 1 for t in (mc, ac, mn, mt, an, at))
    nb = mn.shape[-1]
    zt_c = zt.contiguous()
    lib.host_frag_eval(
        ctypes.c_int(0 if air == "miden" else 1),
        _ptr(mc), ctypes.c_longlong(mc.stride(0)),
        _ptr(mn), ctypes.c_longlong(mn.stride(0)),
        _ptr(ac), ctypes.c_longlong(ac.stride(0)),
        _ptr(an), ctypes.c_longlong(an.stride(0)),
        _ptr(mt), ctypes.c_longlong(mt.stride(0)),
        _ptr(at), ctypes.c_longlong(at.stride(0)), ctypes.c_longlong(nb),
        _ptr(rand_t), _ptr(cc_t), _ptr(cc_b), _ptr(bvals), _ptr(zt_c),
        _ptr(dinv), ctypes.c_longlong(dinv.stride(0)), *_xpow_args(xpow),
        _ptr(idx), ctypes.c_int(bvals.shape[0]), _ptr(out),
        ctypes.c_longlong(m), ctypes.c_int(int(transitions)))
    return out


def _merger(tair, rands, rng, first=0, length=None):
    """A merger with seeded coefficients over the domain positions first ..
    first + length - 1 (the whole domain by default), as a mesh block's."""
    cc_t = [tuple(int(v) for v in _rand_cols(rng, 2))
            for _ in range(tair.num_transition_constraints)]
    cc_b = [tuple(int(v) for v in _rand_cols(rng, 2))
            for _ in range(tair.num_assertions)]
    return TP.ConstraintMerger(tair, rands, cc_t, cc_b,
                               TP.ceval_domain(tair, "cpu", first, length),
                               "cpu", first=first)


def _jax_merge(jair, merger, frames, rands):
    """The merge of `aero_tpu`'s fragment runner (prover.py:407-429),
    in jax_gl ops on the same frames, rows and coefficients."""
    g = [J.to_gf(gl.to_u64(f)) for f in frames]
    t_evals = jair.evaluate_transitions(*g, rands)
    x = J.to_gf(gl.to_u64(merger.x_dom))
    xp = {adj: J.pow_loop(x, adj)
          for adj in set(merger.t_adjust) | set(merger.b_adjust)}
    cc_t, cc_b, bvals, zt, dinv = (J.to_gf(gl.to_u64(t)) for t in (
        merger.cc_t, merger.cc_b, merger.bvals, merger.zt_inv,
        merger.denom_inv))
    merged = J.gf_full(x.shape, 0)
    for i, (ev, adj) in enumerate(zip(t_evals, merger.t_adjust)):
        k = J.add(cc_t[i, 0], J.mul(xp[adj], cc_t[i, 1]))
        merged = J.add(merged, J.mul(J.mul(k, ev), zt))
    for j, ((is_main, c, prow), adj) in enumerate(zip(merger.asrt_route,
                                                      merger.b_adjust)):
        col = g[0][c] if is_main else g[2][c]
        k = J.add(cc_b[j, 0], J.mul(xp[adj], cc_b[j, 1]))
        merged = J.add(merged, J.mul(J.mul(k, J.sub(col, bvals[j])),
                                     dinv[prow]))
    return J.from_gf(merged)


@pytest.mark.parametrize("air,kind", [(a, k) for a in ("miden", "fib")
                                      for k in ("lde", "random", "block")])
def test_host_compiled_generated_code_equals_aero_tpu(airs, host_kernel,
                                                      air, kind):
    """The whole 512-point LDE domain of the 64-row trace as one fragment
    (cur the domain, nxt its wrap-around by the blowup, read in place as
    body and tail), random frames over the same domain, or a mesh block's
    last fragment: the second half of the domain (its x^adj values from
    domain position 256 on), nxt the block's tail and a random halo."""
    tair, jair, trace, aux, rands = airs[air]
    rng = np.random.default_rng(11)
    merger = _merger(tair, rands, rng)
    m = merger.x_dom.shape[-1]
    if kind == "lde":
        main_lde = lde(intt(gl.from_u64(trace, "cpu")), 3)
        aux_lde = lde(intt(gl.from_u64(aux, "cpu")), 3)
        frames = (TP._frame(main_lde, 0, m), TP._frame(main_lde, 8, m),
                  TP._frame(aux_lde, 0, m), TP._frame(aux_lde, 8, m))
        assert isinstance(frames[1], TP.Wrapped)
    elif kind == "random":
        frames = tuple(gl.from_u64(f, "cpu") for f in (
            _rand_cols(rng, (tair.main_width, m)),
            _rand_cols(rng, (tair.main_width, m)),
            _rand_cols(rng, (tair.aux_width, m)),
            _rand_cols(rng, (tair.aux_width, m))))
    else:
        m //= 2
        merger = _merger(tair, rands, rng, first=m, length=m)
        frames = []
        for w in (tair.main_width, tair.aux_width):
            block = gl.from_u64(_rand_cols(rng, (w, m)), "cpu")
            halo = gl.from_u64(_rand_cols(rng, (w, 8)), "cpu")
            frames += [block, TP.Wrapped(block[:, 8:], halo)]
    got_t = _host_call(host_kernel, air, frames, rands, merger, 0,
                       transitions=True)
    got = _host_call(host_kernel, air, frames, rands, merger, 0,
                     transitions=False)
    whole = [TP.joined(f) for f in frames]
    want_t = _jax_transitions(jair, [gl.to_u64(f) for f in whole], rands)
    for k, w in enumerate(want_t):
        assert np.array_equal(gl.to_u64(got_t[k]), w), f"constraint {k}"
    with jax.disable_jit():
        want = _jax_merge(jair, merger, whole, rands)
    assert np.array_equal(gl.to_u64(got), want)
    # the route on the CPU is K5's plain version: the same values
    assert torch.equal(merger.fragment(*frames, 0), got)
    assert torch.equal(torch.stack(tair.evaluate_transitions(
        *whole, merger.rands)), got_t)
    assert torch.equal(merger.fragment_plain(*frames, 0), got)
    assert torch.equal(torch.stack(symbolic.interpret(
        symbolic.trace(type(tair)), *whole, merger.rands)), got_t)


def _xpow_plain(xpow, m):
    """The x^adj rows (X, m) of K5's formula in plain torch ops on its
    tables: slot r at domain position i is offset^adj lo[k mod 2^h]
    hi[k >> h], k = (adj mod m_dom) i mod m_dom."""
    h = xpow.lo.shape[0].bit_length() - 1
    i = torch.arange(xpow.first, xpow.first + m, dtype=torch.int64)
    rows = []
    for r in range(xpow.pw.shape[0]):
        # adj mod m_dom and i are below 2^32: the int64 product wraps, its
        # low bits stay exact
        k = (xpow.pw[r, 0] * i) & (xpow.m_dom - 1)
        rows.append(gl.mul_plain(xpow.pw[r, 1], gl.mul_plain(
            xpow.lo[k & ((1 << h) - 1)], xpow.hi[k >> h])))
    return torch.stack(rows)


# (air, rows, fragment points, where): a whole domain; a domain's first,
# last (wrapping) and an odd fragment; a mesh block of a quarter of the
# domain (rank 2 of 4) and its last fragment
XPOW_CASES = [
    ("miden", 1024, None, "whole"), ("miden", 1 << 14, None, "whole"),
    ("fib", 1024, None, "whole"), ("fib", 1 << 14, None, "whole"),
    ("miden", 1024, 2048, "first"), ("miden", 1024, 2048, "last"),
    ("miden", 1024, 255, "odd"), ("fib", 1024, 2048, "last"),
    ("fib", 1024, 255, "odd"), ("miden", 1024, 512, "block"),
    ("fib", 1 << 14, 4096, "block")]


@pytest.mark.parametrize("air,rows,m_frag,where", XPOW_CASES)
def test_xpow_tables_give_every_exponents_powers(airs, host_kernel, air,
                                                 rows, m_frag, where):
    """K5's x^adj values from its two tables (`_xpow_static`), in the plain
    rendering of the formula and in the committed C++ built for the host,
    equal `pow_loop_plain` of the domain's x for every distinct exponent of
    the AIR (one slot a degree class, then the assertions'); each slot the
    adjustment of its class; and a fragment's frame at x g, cut where it
    wraps into views of the domain, equal to the domain's points from
    there on, read around its end."""
    tair = airs[air][0]
    cls = type(tair)
    if air == "miden":
        big = cls(rows, tair.pub_inputs, tair.options, program=SRC)
    else:
        big = cls(rows, tair.pub_inputs, tair.options)
    m_dom = rows * big.options.blowup_factor
    prog = symbolic.trace(cls)
    lo, hi, pw, adjs = TP._xpow_static(big, prog, "cpu")
    assert len(adjs) == len(prog.degrees) + 1 == pw.shape[0]
    t_adj = big.transition_adjustments()
    for k, c in enumerate(prog.classes):
        assert adjs[c] == t_adj[k]
    assert set(big.boundary_adjustments()) <= set(adjs)
    assert lo.shape[0] * hi.shape[0] == m_dom
    start, length = (2 * (m_dom // 4), m_dom // 4) if where == "block" \
        else (0, m_dom)
    m = m_frag or m_dom
    first = {"whole": 0, "first": 0, "last": m_dom - m, "odd": 3,
             "block": start + length - m}[where]
    x = TP.ceval_domain(big, "cpu", start, length)[0]
    x = x[first - start:first - start + m]
    xpow = TP.gl_cuda.XPow(lo, hi, pw, m_dom, first)
    want = torch.stack([gl.pow_loop_plain(x, a) for a in adjs])
    assert torch.equal(_xpow_plain(xpow, m), want)
    got = torch.empty((len(adjs), m), dtype=torch.int64)
    host_kernel.host_xpow(*_xpow_args(xpow), _ptr(got), ctypes.c_longlong(m))
    assert torch.equal(got, want)
    if where != "block":
        cols = gl.from_u64(_rand_cols(np.random.default_rng(rows), (3, m_dom)),
                           "cpu")
        frame = TP._frame(cols, first + 8, m)
        assert isinstance(frame, TP.Wrapped) == (first + 8 + m > m_dom)
        if isinstance(frame, TP.Wrapped):   # views of the domain, no copy
            assert frame.body.data_ptr() == cols[:, first + 8:].data_ptr()
            assert frame.tail.data_ptr() == cols.data_ptr()
        assert torch.equal(TP.joined(frame), torch.cat(
            [cols, cols], dim=-1)[:, first + 8:first + 8 + m])
        assert torch.equal(TP.joined(frame),
                           torch.roll(cols, -(first + 8), dims=-1)[:, :m])


@pytest.mark.parametrize("fault", ["edited digest", "other program",
                                   "missing file"])
def test_a_stale_generated_file_raises(tmp_path, fault):
    prog = symbolic.trace(TM.MidenAir)
    for name in ("miden", "fib"):
        for path in generated.paths(name):
            shutil.copy(path, tmp_path / path.name)
    generated.check_current(TM.MidenAir, prog, csrc=tmp_path)  # committed
    head, entry = generated.paths("miden", tmp_path)
    if fault == "edited digest":
        head.write_text(head.read_text().replace(prog.digest, "0" * 64))
    elif fault == "other program":
        prog = symbolic.trace(TF.FibAir)
    else:
        entry.unlink()
    with pytest.raises(RuntimeError, match="stale.*Regenerate it with"):
        generated.check_current(TM.MidenAir, prog, csrc=tmp_path)


def test_route_is_by_the_exact_class(airs):
    tair = airs["miden"][0]
    name, prog = generated.kernel_for(tair)
    assert name == "miden" and prog.digest == generated.header_field(
        generated.paths("miden")[0], "dag-digest")
    assert generated.names() == {"aero_tpu_torch.air.miden.MidenAir": "miden",
                                 "aero_tpu_torch.air.fib.FibAir": "fib"}

    class Edited(TM.MidenAir):
        pass

    assert generated.kernel_for(object.__new__(Edited)) is None
