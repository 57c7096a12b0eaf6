"""The SASS reader of the port (`aero_tpu_torch._sass`) on a listing in the
format `cuobjdump -sass` prints: functions, instruction counts by pipe,
loops from backward branches; and the field operations by which kernel 1,
the NTT, is bound, counted from a shape. The real listing exists only
where the kernels are built, on the card.
"""

import pytest

from aero_tpu_torch import _sass
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs

LISTING = """
Fatbin elf code:
================
arch = sm_90a

	code for sm_90a
		Function : _ZN3ns_12flat_kernelEPKyPy
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                    /* 0x00000a00ff017b82 */
                                                                             /* 0x000e220000000800 */
        /*0010*/                   S2R R2, SR_TID.X ;                        /* 0x0000000000027919 */
        /*0020*/                   IMAD.MOV.U32 R3, RZ, RZ, RZ ;             /* 0x000000ffff037224 */
        /*0030*/                   LDG.E.64.CONSTANT R4, desc[UR4][R2.64] ;  /* 0x0000000402047981 */
        /*0040*/                   LOP3.LUT R6, R4, R5, RZ, 0x3c, !PT ;      /* 0x0000000504067212 */
        /*0050*/                   SHF.L.W.U32.HI R6, R6, 0x10, R6 ;         /* 0x0000001006067819 */
        /*0060*/                   IMAD.IADD R7, R6, 0x1, R4 ;               /* 0x0000000106077824 */
        /*0070*/                   UMOV UR4, 0x400 ;                         /* 0x0000040000047882 */
        /*0080*/                   STG.E.64 desc[UR4][R2.64], R6 ;           /* 0x0000000602007986 */
        /*0090*/                   EXIT ;                                    /* 0x000000000000794d */
        /*00a0*/                   BRA 0xa0;                                 /* 0xfffffffc00fc7947 */
		Function : _ZN3ns_13colntt_kernelEPKyPy
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   S2R R0, SR_TID.X ;                        /* 0x0 */
        /*0010*/                   LDG.E.64 R2, desc[UR4][R2.64] ;           /* 0x0 */
        /*0020*/                   STS.64 [R0], R2 ;                         /* 0x0 */
        /*0030*/              @!P0 BRA 0x10 ;                                /* 0x0 */
        /*0040*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;             /* 0x0 */
        /*0050*/                   ISETP.GE.AND P1, PT, R0, R9, PT ;         /* 0x0 */
        /*0060*/                   LDS.64 R4, [R0] ;                         /* 0x0 */
        /*0070*/                   LDS.64 R6, [R0+0x8] ;                     /* 0x0 */
        /*0080*/                   IMAD.WIDE.U32 R8, R6, R10, RZ ;           /* 0x0 */
        /*0090*/                   IADD3 R4, P0, R4, R8, RZ ;                /* 0x0 */
        /*00a0*/                   SEL R5, R5, R9, P0 ;                      /* 0x0 */
        /*00b0*/                   STS.64 [R0], R4 ;                         /* 0x0 */
        /*00c0*/                   STS.64 [R0+0x8], R6 ;                     /* 0x0 */
        /*00d0*/               @P1 BRA 0x60 ;                                /* 0x0 */
        /*00e0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;             /* 0x0 */
        /*00f0*/               @P2 BRA 0x50 ;                                /* 0x0 */
        /*0100*/                   LDS.64 R4, [R0] ;                         /* 0x0 */
        /*0110*/                   STG.E.64 desc[UR4][R2.64], R4 ;           /* 0x0 */
        /*0120*/                   EXIT ;                                    /* 0x0 */
"""


@pytest.fixture(scope="module")
def functions():
    return _sass.parse_functions(LISTING)


def test_functions_and_instructions_are_parsed(functions):
    assert sorted(functions) == ["_ZN3ns_12flat_kernelEPKyPy",
                                 "_ZN3ns_13colntt_kernelEPKyPy"]
    flat = _sass.find_function(functions, "flat_kernel")
    assert [i.op for i in flat] == ["LDC", "S2R", "IMAD", "LDG", "LOP3",
                                    "SHF", "IMAD", "UMOV", "STG", "EXIT",
                                    "BRA"]
    assert flat[2].mods == ".MOV.U32" and flat[5].addr == 0x50
    with pytest.raises(RuntimeError):
        _sass.find_function(functions, "kernel")        # two match
    with pytest.raises(RuntimeError):
        _sass.find_function(functions, "absent")


def test_counts_by_pipe(functions):
    c = _sass.count_instructions(_sass.find_function(functions,
                                                     "flat_kernel"))
    assert (c.alu, c.fma, c.uniform, c.memory, c.control) == (3, 2, 1, 3, 2)
    assert c.total == 11
    assert c.sm_clocks() == max(3 / 64, 2 / 64, 11 / 128)


def test_loops_come_from_backward_branches(functions):
    body = _sass.find_function(functions, "colntt_kernel")
    spans = [(lp[0].addr, lp[-1].addr) for lp in _sass.loops(body)]
    assert spans == [(0x10, 0x30), (0x60, 0xd0), (0x50, 0xf0)]


# --------------------------- kernel 1's bound: field ops from the shape

# the multiplies by a twiddle +-2^e of a column of 2^23, stage by stage:
# min(2^(s-1), 32) - 1 indices at stage s, each in 2^23 / 2^s butterflies
POW2_2E23 = {2: 1 << 21, 3: 3 << 20, 4: 7 << 19, 5: 15 << 18, 6: 31 << 17,
             **{s: 31 << (23 - s) for s in range(7, 13)}}


def test_ntt_field_ops_of_the_72_x_2e23_transform():
    """The main LDE's transform at full size, by hand: 2^22 * 23
    butterflies a column; twiddle 1 in 4096 * 2047 (pass 1, 2048 rows) +
    2048 * 4095 (pass 2, 4096 rows) of them; one cross multiply an
    element; twiddles +-2^e at stages 2..11 of pass 1 and 2..12 of
    pass 2."""
    got = _sass.ntt_field_ops(23, 72)
    bfly = 72 * 96_468_992
    pow2 = sum(POW2_2E23[s] for s in range(2, 12)) + sum(POW2_2E23.values())
    assert pow2 == 20_844_544 + 20_908_032
    assert got == {"mul": bfly - 72 * 16_771_072 + 72 * 8_388_608,
                   "mul_pow2": 72 * pow2, "add": bfly, "sub": bfly}
    assert got["mul"] == 6_342_230_016            # 88 086 528 a column


def test_ntt_field_ops_of_the_lde_2e20_to_2e23():
    """The coset LDE of 2^20 coefficients at blowup 8, by hand: pass 1
    (2048 rows) needs 8 of its 11 stages, 4096 * 1024 * 8 butterflies, 255
    of each column's with twiddle 1; pass 2 all 12 stages; the cross and
    one multiply a coefficient."""
    got = _sass.ntt_field_ops(23, 72, log_blowup=3, lde=True)
    bfly = 33_554_432 + 50_331_648
    trivial = 4096 * 255 + 2048 * 4095
    pow2 = sum(POW2_2E23[s] for s in range(4, 12)) + sum(POW2_2E23.values())
    assert got == {"mul": 72 * (bfly - trivial + 8_388_608 + 1_048_576),
                   "mul_pow2": 72 * pow2, "add": 72 * bfly,
                   "sub": 72 * bfly}
    assert got["mul"] // 72 == 83_892_224
    # 20 of 23 stages: the LDE needs 20/23 of the transform's butterflies
    assert got["add"] * 23 == _sass.ntt_field_ops(23, 72)["add"] * 20


def test_ntt_field_ops_of_the_lde_entry_alone():
    """The LDE's first pass (the LDE entry) at 2^20 -> 2^23, by hand:
    stages 4..11 of 2048-point columns, 255 of each column's butterflies
    with twiddle 1, the cross table it applies and the scaling; the two
    passes together are the whole LDE."""
    got = _sass.ntt_field_ops(23, 72, log_blowup=3, lde=True, passes=1)
    bfly = 8 * (1 << 22)
    assert got == {"mul": 72 * (bfly - 4096 * 255 + 8_388_608 + 1_048_576),
                   "mul_pow2": 72 * sum(POW2_2E23[s] for s in range(4, 12)),
                   "add": 72 * bfly, "sub": 72 * bfly}
    whole = _sass.ntt_field_ops(23, 72, log_blowup=3, lde=True)
    rest = _sass.ntt_field_ops(23, 72)
    for op in got:
        # the second pass is the transform's last: no cross, no scaling
        last = rest[op] - _sass.ntt_field_ops(23, 72, passes=1)[op]
        assert whole[op] == got[op] + last


@pytest.mark.parametrize("log_n,max_l,lde", [
    (8, 4096, False), (16, 4096, False), (20, 4096, False), (12, 16, False),
    (9, 4096, True), (16, 4096, True)])
def test_ntt_field_ops_pow2_twiddles_by_their_values(log_n, max_l, lde):
    """The multiplies counted as by +-2^e, against the twiddles' values:
    at every counted stage s of every pass, the indices j < 2^(s-1) whose
    w_(2^s)^j is one of the 192 powers of 2 mod p."""
    from aero_tpu_torch.ntt.tables import pass_lengths
    from aero_tpu_torch.spec import field as F
    powers = {pow(2, e, F.P) for e in range(192)}
    b = 3 if lde else 0
    n = 1 << log_n
    want = 0
    for k, L in enumerate(pass_lengths(n, max_l)):
        for s in range((b if k == 0 else 0) + 1, L.bit_length()):
            w = F.get_root_of_unity(s)
            want += (n >> s) * sum(pow(w, j, F.P) in powers
                                   for j in range(1, 1 << (s - 1)))
    got = _sass.ntt_field_ops(log_n, 1, log_blowup=b, lde=lde, max_l=max_l)
    assert got["mul_pow2"] == want
    assert 0 < want < got["mul"]


@pytest.mark.parametrize("log_n,max_l,logs", [
    (1, 4096, [0, 1]), (23, 4096, [11, 12]), (24, 4096, [12, 12]),
    (25, 4096, [8, 8, 9]), (27, 4096, [9, 9, 9]), (9, 8, [3, 3, 3])])
def test_ntt_pass_lengths_follow_the_wrapper(log_n, max_l, logs):
    """The passes the bound counts are the wrapper's: two where both fit
    the pass limit, else the outer pass and the inner two."""
    from aero_tpu_torch.ntt.tables import pass_lengths
    assert [L.bit_length() - 1 for L in pass_lengths(1 << log_n, max_l)] \
        == logs


@pytest.mark.parametrize("log_n,lde", [(4, False), (10, False), (25, False),
                                       (6, True), (27, True)])
def test_ntt_field_ops_count_every_butterfly_once(log_n, lde):
    """Against a stage-by-stage count of a radix-2 transform: every stage
    of every column transform, butterflies with twiddle index 0 free."""
    from aero_tpu_torch.ntt.tables import pass_lengths
    b = 3 if lde else 0
    want = {"mul": 0, "add": 0}
    n = 1 << log_n
    for k, L in enumerate(pass_lengths(n)):
        lg = L.bit_length() - 1
        for s in range(1, lg + 1):
            if k == 0 and s <= b:
                continue
            want["add"] += n // 2
            want["mul"] += n // 2 - (n >> s)     # one j = 0 a block of 2^s
        if k:
            want["mul"] += n
    if lde:
        want["mul"] += n >> b
    got = _sass.ntt_field_ops(log_n, 1, log_blowup=b, lde=lde)
    assert {k: got[k] for k in want} == want and got["sub"] == want["add"]


def test_ntt_field_ops_refuse_copies_past_the_first_pass():
    with pytest.raises(ValueError):
        _sass.ntt_field_ops(4, log_blowup=3, lde=True)    # first pass 2^2


def test_missing_cuobjdump_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="cuobjdump"):
        _sass.dump_sass(tmp_path / "lib.so")


# ------------- the multiply by 2^e that prices kernel 1's +-2^e twiddles,
# and the lazy forms kernel 1 computes with inside a pass

SHIM = r"""
#define __device__
#define __forceinline__ inline
static inline unsigned long long __umul64hi(unsigned long long a,
                                            unsigned long long b) {
  return (unsigned long long)(((unsigned __int128)a * b) >> 64);
}
#include "goldilocks.cuh"
extern "C" u64 host_mul(u64 a, u64 b) { return gl_mul(a, b); }
extern "C" u64 host_mul_pow2(u64 a, int e) { return gl_mul_pow2(a, e); }
extern "C" u64 host_add(u64 a, u64 b) { return gl_add(a, b); }
extern "C" u64 host_sub(u64 a, u64 b) { return gl_sub(a, b); }
extern "C" u64 host_canon(u64 a) { return gl_canon(a); }
extern "C" u64 host_add_lazy(u64 a, u64 b) { return gl_add_lazy(a, b); }
extern "C" u64 host_sub_lazy(u64 a, u64 b) { return gl_sub_lazy(a, b); }
extern "C" u64 host_mul_lazy(u64 a, u64 b) { return gl_mul_lazy(a, b); }
"""

GL_P = (1 << 64) - (1 << 32) + 1
EPS = (1 << 32) - 1
# the words at the edges of the lazy forms' corrections: 2^64 - 1 plus
# itself carries twice, 0 less 2^64 - 1 borrows twice
EDGE_WORDS = (0, 1, 2, EPS, EPS + 1, GL_P - 1, GL_P, GL_P + 1, 1 << 63,
              (1 << 64) - EPS - 1, (1 << 64) - 2, (1 << 64) - 1)


@pytest.fixture(scope="module")
def host_shim(tmp_path_factory):
    """csrc/goldilocks.cuh built for the host with g++, its functions
    behind a C interface."""
    import ctypes
    import shutil
    import subprocess

    from aero_tpu_torch import _build
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is needed to build the host shim")
    tmp = tmp_path_factory.mktemp("shim")
    (tmp / "shim.cpp").write_text(SHIM)
    subprocess.run([gxx, "-O1", "-std=c++17", "-fPIC", "-shared", "-I",
                    str(_build.CSRC), str(tmp / "shim.cpp"),
                    "-o", str(tmp / "shim.so")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(tmp / "shim.so"))
    u64 = ctypes.c_uint64
    for name in ("mul", "add", "sub", "add_lazy", "sub_lazy", "mul_lazy"):
        fn = getattr(lib, f"host_{name}")
        fn.restype = u64
        fn.argtypes = [u64, u64]
    lib.host_mul_pow2.restype = lib.host_canon.restype = u64
    lib.host_mul_pow2.argtypes = [u64, ctypes.c_int]
    lib.host_canon.argtypes = [u64]
    return lib


def test_mul_pow2_is_the_multiply_by_2_to_the_e(host_shim):
    """`gl_mul_pow2` (csrc/goldilocks.cuh), which the field-op probe
    prices, built for the host with g++: a * 2^e mod p for every e in
    1..95 and edge values of a; and `gl_mul` over the same reduction."""
    import numpy as np

    from aero_tpu_torch.spec import field as F
    lib = host_shim
    rng = np.random.default_rng(11)
    values = [0, 1, 2, F.P - 1, F.P - 2, 1 << 63, 1 << 32, (1 << 32) - 1,
              *(int(v) for v in rng.integers(0, F.P, 24, dtype=np.uint64))]
    for a in values:
        for e in range(1, 96):
            assert lib.host_mul_pow2(a, e) == a * pow(2, e, F.P) % F.P, (a, e)
        for b in values:
            assert lib.host_mul(a, b) == a * b % F.P


def _words(seed, n):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.integers(0, 1 << 64, n, dtype=np.uint64)]


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_lazy_forms_are_congruent_to_the_field_ops(host_shim, op):
    """`gl_add_lazy`, `gl_sub_lazy` and `gl_mul_lazy` on any two words,
    edge words and seeded random ones, canonical or not: a word congruent
    to the op's result mod p, which one `gl_canon` makes the canonical
    op's result; on canonical words the canonical op gives it too."""
    lazy = getattr(host_shim, f"host_{op}_lazy")
    canonical = getattr(host_shim, f"host_{op}")
    exact = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
             "mul": lambda a, b: a * b}[op]
    words = list(EDGE_WORDS) + _words(21, 40)
    for a in words:
        for b in words:
            got = lazy(a, b)
            want = exact(a, b) % GL_P
            assert got % GL_P == want, (op, hex(a), hex(b))
            assert host_shim.host_canon(got) == want
            assert canonical(a % GL_P, b % GL_P) == want


def _dit_pass(a, w, add, sub, mul):
    """A radix-2 decimation-in-time transform of a[] (bit-reversed in
    place) with the twiddles of w (w[e] = w_n^e), in the given ops."""
    n = len(a)
    half = 1
    while half < n:
        step = n // (2 * half)
        for k0 in range(0, n, 2 * half):
            for j in range(half):
                u, v = a[k0 + j], a[k0 + j + half]
                if j:
                    v = mul(v, w[j * step])
                a[k0 + j], a[k0 + j + half] = add(u, v), sub(u, v)
        half *= 2
    return a


@pytest.mark.parametrize("kind", ["p_minus_1", "all_ones", "words"])
def test_lazy_chains_of_a_pass_end_canonical_and_exact(host_shim, kind):
    """A pass's chain in the lazy forms: a pre-twiddle multiply, the 12
    butterfly stages of a 4096-point transform and the cross multiply,
    then one `gl_canon`, equals the same chain in the canonical ops on the
    words reduced mod p, bit for bit, and the field's own arithmetic."""
    from aero_tpu_torch.spec import field as F
    lib = host_shim
    n = 1 << 12
    w = [F.exp(F.get_root_of_unity(12), e) for e in range(n // 2)]
    x = {"p_minus_1": [GL_P - 1] * n, "all_ones": [(1 << 64) - 1] * n,
         "words": _words(22, n)}[kind]
    pre = _words(23, n)
    cross = [GL_P - 1] * (n // 2) + [v % GL_P for v in _words(24, n // 2)]
    lazy = _dit_pass([lib.host_mul_lazy(v, t) for v, t in zip(x, pre)], w,
                     lib.host_add_lazy, lib.host_sub_lazy, lib.host_mul_lazy)
    lazy = [lib.host_canon(lib.host_mul_lazy(v, c))
            for v, c in zip(lazy, cross)]
    canonical = _dit_pass([lib.host_mul(v % GL_P, t % GL_P)
                           for v, t in zip(x, pre)], w, lib.host_add,
                          lib.host_sub, lib.host_mul)
    canonical = [lib.host_mul(v, c) for v, c in zip(canonical, cross)]
    field = _dit_pass([v * t % GL_P for v, t in zip(x, pre)], w, F.add,
                      F.sub, F.mul)
    field = [F.mul(v, c) for v, c in zip(field, cross)]
    assert lazy == canonical == field
