"""Kernels K6 (the Miden bus factors) and K7 (multi-point evaluation)
against `aero_tpu`, on the CPU, at 64 rows. Exact equality throughout.

- the bus-factor program traced from the port's `_bus_row_factors`
  (`symbolic.trace_rows`), interpreted with the plain ops and as its
  emission, equals `aero_tpu`'s `_bus_row_factors`;
- the committed per-row C++ of K6 (`csrc/aux_miden_factors.cuh`,
  `csrc/frag_eval.cuh`), compiled with g++ against a host shim, equals it
  too, reading the next row in place at (i + 1) mod n;
- the port's `build_aux_trace` equals `aero_tpu`'s `build_aux_trace` and
  `build_aux_trace_host`;
- the port's `eval_polys_multi` (one tensor, or row blocks as they lie)
  equals `aero_tpu`'s at the proof's three points, at widths that are not a
  multiple of K7's row group, and K7's algebra, emulated with small blocks
  and a ragged end, equals it as well;
- a stale K6 file raises, and K6 is found by the exact class and function.
"""

import ctypes
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from aero_tpu.air import miden as JM
from aero_tpu.field import from_gf, to_gf
from aero_tpu.field import jax_gl as J
from aero_tpu.sdk import DEFAULT_OPTIONS
from aero_tpu.vm import execute_full, fibonacci_source, program_hash
from aero_tpu_torch.air import codegen, generated, symbolic
from aero_tpu_torch.air import miden as TM
from aero_tpu_torch.field import gl, gl_cuda
from aero_tpu_torch.spec import field as F
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs

P = (1 << 64) - (1 << 32) + 1
ROWS = 64
SRC = fibonacci_source(10)


def _rand(rng, shape):
    return rng.integers(0, P, size=shape, dtype=np.uint64)


@pytest.fixture(scope="module")
def miden():
    """The port's and the JAX MidenAir over a real 64-row trace."""
    trace, out, ovf = execute_full(SRC, [0, 1], min_rows=ROWS)
    tpub = TM.make_public_inputs(program_hash(SRC), [0, 1], out,
                                 overflow=ovf)
    jpub = JM.make_public_inputs(program_hash(SRC), [0, 1], out,
                                 overflow=ovf)
    return (np.asarray(trace, dtype=np.uint64),
            TM.MidenAir(ROWS, tpub, DEFAULT_OPTIONS, program=SRC),
            JM.MidenAir(ROWS, jpub, DEFAULT_OPTIONS, program=SRC))


def _inputs(miden, kind, seed):
    """(trace (72, 64), 16 rands): the real trace or random columns."""
    trace = miden[0]
    rng = np.random.default_rng(seed)
    if kind == "random":
        trace = _rand(rng, trace.shape)
    return trace, [int(r) for r in _rand(rng, 16)]


def _jax_factors(trace, rands):
    """`aero_tpu`'s `_bus_row_factors` on the trace and its roll, eager."""
    tr = to_gf(trace)
    g = to_gf(np.array(rands, dtype=np.uint64))
    with jax.disable_jit():
        nxt = to_gf(np.roll(trace, -1, axis=-1))
        out = JM._bus_row_factors(tr, nxt, [g[i] for i in range(16)])
        return [from_gf(x) for x in out]


@pytest.fixture(scope="module")
def program():
    return symbolic.trace_rows(TM._bus_row_factors, TM.MidenAir.main_width,
                               TM.MidenAir.aux_rands)


def test_traced_bus_factors_are_the_committed_program(program):
    c = program.counts()
    assert (len(program.nodes), c["mul"], c["add"], c["sub"], c["load"],
            c["rand"], c["const"]) == (405, 137, 155, 32, 51, 16, 14)
    assert len(program.outputs) == 8
    assert program.degrees == () and program.classes == ()
    path = generated.row_paths("miden")[1]
    assert generated.header_field(path, "dag-digest") == program.digest
    assert generated.header_field(path, "traced") == \
        "aero_tpu_torch.air.miden._bus_row_factors"


@pytest.mark.parametrize("kind,seed", [("trace", 1), ("random", 2),
                                       ("random", 3)])
def test_traced_bus_factors_equal_aero_tpu(miden, program, kind, seed):
    trace, rands = _inputs(miden, kind, seed)
    want = _jax_factors(trace, rands)
    cur = gl.from_u64(trace, "cpu")
    nxt = torch.roll(cur, -1, dims=-1)
    got = symbolic.interpret(program, cur, nxt, None, None, rands)
    em = symbolic.emission(program)
    got_em = symbolic.interpret_emission(program, em, cur, nxt, None, None,
                                         rands)
    for k in range(8):
        assert np.array_equal(gl.to_u64(got[k]), want[k]), k
        assert np.array_equal(gl.to_u64(got_em[k]), want[k]), k


SHIM = r"""
#define __device__
#define __forceinline__ inline
static inline unsigned long long __umul64hi(unsigned long long a,
                                            unsigned long long b) {
  return (unsigned long long)(((unsigned __int128)a * b) >> 64);
}
#include "aux_miden_factors.cuh"

extern "C" void host_aux_factors(const u64* tr, long long stride,
                                 const u64* rands, u64* out, long long n) {
  for (long long e = 0; e < n; ++e) {
    const RowsIn in{tr, stride, rands, e, 0};
    row_store_point<MidenAuxFactors>(in, out, n);
  }
}
"""


@pytest.fixture(scope="module")
def host_k6(tmp_path_factory):
    """The committed per-row code of K6 built for the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build the host shim")
    d = tmp_path_factory.mktemp("k6_host")
    (d / "shim.cpp").write_text(SHIM)
    subprocess.run([gxx, "-O1", "-std=c++17", "-fPIC", "-shared",
                    "-I", str(codegen.CSRC), str(d / "shim.cpp"), "-o",
                    str(d / "shim.so")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(d / "shim.so"))
    lib.host_aux_factors.restype = None
    lib.host_aux_factors.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_longlong]
    return lib


@pytest.mark.parametrize("kind,seed,pad", [("trace", 4, 0), ("random", 5, 0),
                                           ("random", 6, 3)])
def test_host_compiled_k6_equals_aero_tpu(miden, host_k6, kind, seed, pad):
    """The trace read in place at its row stride (with `pad` columns beyond
    the n rows, as a view of a wider array), the next row at (i + 1) mod
    n."""
    trace, rands = _inputs(miden, kind, seed)
    want = _jax_factors(trace, rands)
    wide = np.concatenate(
        [trace, _rand(np.random.default_rng(seed), (72, pad))], axis=1)
    tr = gl.from_u64(wide, "cpu")
    rt = gl.from_u64(np.array(rands, dtype=np.uint64), "cpu")
    out = torch.empty((8, ROWS), dtype=torch.int64)
    host_k6.host_aux_factors(tr.data_ptr(), tr.stride(0), rt.data_ptr(),
                             out.data_ptr(), ROWS)
    for k in range(8):
        assert np.array_equal(gl.to_u64(out[k]), want[k]), k


@pytest.mark.parametrize("kind,seed", [("trace", 7), ("trace", 10),
                                       ("random", 8)])
def test_build_aux_trace_equals_aero_tpu_and_host_oracle(miden, kind, seed):
    """The host oracle walks a real trace's rows (its selectors are flags),
    so a random trace is held against `build_aux_trace` alone."""
    trace, rands = _inputs(miden, kind, seed)
    tair, jair = miden[1], miden[2]
    got = gl.to_u64(tair.build_aux_trace(gl.from_u64(trace, "cpu"), rands))
    assert got.shape == (9, ROWS)
    if kind == "trace":
        host = from_gf(jair.build_aux_trace_host(to_gf(trace), rands))
        assert np.array_equal(got, host)
    with jax.disable_jit():
        dev = from_gf(jair.build_aux_trace(to_gf(trace), rands))
    assert np.array_equal(got, dev)


def test_bus_factors_on_the_cpu_are_the_plain_path(miden):
    """No kernel on the CPU: `bus_factors` is `_bus_row_factors` over the
    trace and its roll, and K6's wrapper refuses a CPU trace."""
    trace, rands = _inputs(miden, "random", 9)
    tr = gl.from_u64(trace, "cpu")
    gl_cuda.reset_launches()
    got = miden[1].bus_factors(tr, rands)
    assert sum(gl_cuda.LAUNCHES.values()) == 0
    want = _jax_factors(trace, rands)
    assert all(np.array_equal(gl.to_u64(a), b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        gl_cuda.aux_factors("miden", tr, tr[0, :16], 8)


def _jax_eval(rows, zs):
    with jax.disable_jit():
        return J.eval_polys_multi(to_gf(rows), zs)


def _zs(seed):
    """Three points as the OOD stage takes them: z, z g (g the 64-row
    trace domain's generator) and z^8."""
    z = int(_rand(np.random.default_rng(seed), 1)[0])
    return [z, z * F.get_root_of_unity(6) % P, pow(z, 8, P)]


@pytest.mark.parametrize("widths", [(89,), (72, 9, 8), (5, 3, 2), (13,),
                                    (0, 7, 1)])
def test_eval_polys_multi_equals_aero_tpu(widths):
    rng = np.random.default_rng(sum(widths) + len(widths))
    blocks = [_rand(rng, (w, ROWS)) for w in widths]
    zs = _zs(len(widths))
    want = _jax_eval(np.concatenate(blocks), zs)
    got = gl.eval_polys_multi([gl.from_u64(b, "cpu") for b in blocks], zs)
    assert got.shape == (3, sum(widths))
    assert np.array_equal(got, want)
    if len(widths) == 1:
        one = gl.eval_polys_multi(gl.from_u64(blocks[0], "cpu"), zs)
        assert np.array_equal(one, want)


def test_eval_polys_multi_reads_row_blocks_as_views():
    """Blocks that are strided views (rows of a wider array) give the
    values of their copies."""
    rng = np.random.default_rng(21)
    wide = gl.from_u64(_rand(rng, (6, 2 * ROWS)), "cpu")
    blocks = [wide[:4, :ROWS], wide[4:, ROWS:]]
    zs = _zs(22)
    want = _jax_eval(np.concatenate([gl.to_u64(b) for b in blocks]), zs)
    assert np.array_equal(gl.eval_polys_multi(blocks, zs), want)
    assert np.array_equal(gl.eval_polys_multi_plain(blocks, zs), want)


def _k7_emulated(blocks, zs, threads, steps, rows_per):
    """K7's algebra (csrc/eval_multi.cu) in the plain ops with small
    blocks: a block takes `steps` x `threads` coefficients of `rows_per`
    rows; thread t sums c_j, j = base + t + threads i, by Horner's rule in
    z^threads from the top i down, times z^(base + t) made from the table
    of z^(2^b); the block's threads are summed into a partial, and the
    partials of each (point, row) folded."""
    rows = torch.cat(blocks)
    w, n = rows.shape
    table = [[int(v) for v in r] for r in gl_cuda.power_table(zs)]
    chunk = threads * steps
    chunks = -(-n // chunk)
    log_t = threads.bit_length() - 1
    out = np.zeros((len(zs), w), dtype=np.uint64)
    for t in range(len(zs)):
        step = gl.scalar(table[t][log_t], "cpu")
        for r0 in range(0, w, rows_per):
            rr = rows[r0:r0 + rows_per]
            partials = []
            for c in range(chunks):
                base = c * chunk
                acc = torch.zeros((rr.shape[0], threads), dtype=torch.int64)
                for i in reversed(range(steps)):
                    j = base + torch.arange(threads) + i * threads
                    coef = torch.where(j < n, rr[:, j.clamp(max=n - 1)], 0)
                    acc = gl.add_plain(gl.mul_plain(acc, step), coef)
                pw = []
                for tid in range(threads):
                    s = 1
                    for b in range(gl_cuda.EVAL_POW_BITS):
                        if (base + tid) >> b & 1:
                            s = s * table[t][b] % P
                    pw.append(gl.as_i64(s))
                acc = gl.mul_plain(acc, torch.tensor(pw))
                partials.append(gl.gf_sum_plain(acc, axis=-1))
            out[t, r0:r0 + rr.shape[0]] = gl.to_u64(
                gl.gf_sum_plain(torch.stack(partials, -1), axis=-1))
    return out


@pytest.mark.parametrize("n,threads,steps,rows_per", [
    (64, 4, 4, 3), (64, 8, 2, 8), (37, 4, 3, 5), (5, 2, 4, 2)])
def test_k7_algebra_emulated_equals_aero_tpu(n, threads, steps, rows_per):
    """Ragged ends included: n not a multiple of a block's coefficients, w
    not a multiple of its rows. `aero_tpu` takes power-of-two lengths, so
    a ragged n is held against the zero-padded rows."""
    rng = np.random.default_rng(n + threads)
    blocks = [_rand(rng, (w, n)) for w in (7, 4)]
    zs = _zs(n)
    pad = 1 << (n - 1).bit_length()
    want = _jax_eval(np.pad(np.concatenate(blocks), ((0, 0), (0, pad - n))),
                     zs)
    got = _k7_emulated([gl.from_u64(b, "cpu") for b in blocks], zs, threads,
                       steps, rows_per)
    assert np.array_equal(got, want)
    plain = gl.eval_polys_multi_plain([gl.from_u64(b, "cpu")
                                       for b in blocks], zs)
    assert np.array_equal(plain, want)


def test_eval_multi_wrapper_refuses_cpu_rows():
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        gl_cuda.eval_multi([torch.zeros((2, 8), dtype=torch.int64)], [3])


def test_power_table_holds_the_squares():
    zs = _zs(30)
    table = gl_cuda.power_table(zs)
    assert table.shape == (3, gl_cuda.EVAL_POW_BITS)
    for t, z in enumerate(zs):
        for b in (0, 1, 8, 31):
            assert int(table[t, b]) == pow(z, 1 << b, P)


def test_stale_k6_file_raises(tmp_path, program):
    csrc = tmp_path / "csrc"
    shutil.copytree(codegen.CSRC, csrc)
    generated.check_rows_current(TM.MidenAir, TM._bus_row_factors, program,
                                 csrc)
    entry = generated.row_paths("miden", csrc)[1]
    text = entry.read_text()
    entry.write_text(text.replace(program.digest, "0" * 64))
    with pytest.raises(RuntimeError, match="aux_miden.cu is stale"):
        generated.check_rows_current(TM.MidenAir, TM._bus_row_factors,
                                     program, csrc)


def test_k6_is_found_by_the_exact_class_and_function(miden):
    tair = miden[1]
    name, prog = generated.row_kernel_for(tair, TM._bus_row_factors)
    assert name == "miden" and prog.digest == symbolic.trace_rows(
        TM._bus_row_factors, 72, 16).digest

    class Variant(TM.MidenAir):
        pass

    sub = object.__new__(Variant)
    assert generated.row_kernel_for(sub, TM._bus_row_factors) is None
    assert generated.row_kernel_for(tair, TM._aux_scans) is None
    assert "miden_aux_factors" in gl_cuda.LAUNCHES


def test_codegen_writes_k6_beside_k5():
    files = codegen.generated_files()
    for path in generated.row_paths("miden"):
        assert path in files and path.read_text() == files[path]
    assert "aux_miden" not in "".join(generated._build.FRAG_EVAL_AIRS)
    assert generated._build.ROW_EVAL_AIRS == ("miden",)
