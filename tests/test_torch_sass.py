"""The SASS reader of the port (`aero_tpu_torch._sass`) on a listing in the
format `cuobjdump -sass` prints: functions, instruction counts by pipe,
loops from backward branches, and the butterfly loop of the NTT kernel.
The real listing exists only where the kernels are built, on the card.
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


def test_butterfly_loop_is_the_innermost_shared_memory_loop(functions):
    c = _sass.butterfly_counts(_sass.find_function(functions,
                                                   "colntt_kernel"))
    assert (c.alu, c.fma, c.memory, c.control) == (2, 1, 4, 1)
    assert c.shared_stores == 2
    with pytest.raises(RuntimeError, match="butterfly"):
        _sass.butterfly_counts(_sass.find_function(functions, "flat_kernel"))


def test_missing_cuobjdump_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="cuobjdump"):
        _sass.dump_sass(tmp_path / "lib.so")
