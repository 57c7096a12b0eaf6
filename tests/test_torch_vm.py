"""The port's VM (`aero_tpu_torch.vm`) against `aero_tpu.vm`.

Both bind the same `vm.cpp`; the port builds its own shared library under
`build/aero_tpu_torch/`. For five programs the execution trace (bytes
included), the outputs, the overflow table, the program hash and the ROM
listing are equal (tolerance 0), as are the column constants the AIR reads,
the MAST and stdlib helpers and the Rescue permutation.
"""

import numpy as np
import pytest
import torch

import aero_tpu.vm as JV
import aero_tpu_torch.vm as TV
from aero_tpu.vm import mast as JMAST
from aero_tpu.vm import rescue as JR
from aero_tpu.vm import stdlib as JS
from aero_tpu_torch.vm import mast as TMAST
from aero_tpu_torch.vm import rescue as TR
from aero_tpu_torch.vm import stdlib as TS
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


A64 = 0xDEADBEEF_CAFEBABE
B64 = 0x01234567_89ABCDEF

PROGRAMS = {
    "fib": (JV.fibonacci_source(10), [0, 1], None),
    "advice_tape": ("""
    begin
        repeat.8 swap dup.1 add end
        adv.push add
    end
    """, [1, 0], [100]),
    "u32_and_memory": ("""
    begin
        push.4294967295 push.1 u32add
        push.12 push.10 u32xor add
        mem.store.5 drop
        push.99 mem.store.7 drop push.5 mem.load.7 add
        mem.load.5 add
        push.48 push.4 u32shr u32lt
    end
    """, [3, 4], None),
    "while_true": ("""
    begin
        push.9
        dup.0 push.0 neq
        while.true
            movdn.2  swap dup.1 add  movup.2
            push.1 sub
            dup.0 push.0 neq
        end
    end
    """, [0, 1], None),
    "stdlib_import": ("""
    use.std::math::u64
    begin
        exec.u64::wrapping_mul
        exec.u64::eqz
    end
    """, [B64 >> 32, B64 & 0xFFFFFFFF, A64 >> 32, A64 & 0xFFFFFFFF], None),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_execution_hash_and_rom_equal(name):
    src, stack, advice = PROGRAMS[name]
    t_trace, t_out, t_ovf = TV.execute_full(src, stack, advice_tape=advice,
                                            min_rows=64)
    j_trace, j_out, j_ovf = JV.execute_full(src, stack, advice_tape=advice,
                                            min_rows=64)
    assert t_trace.dtype == j_trace.dtype == np.uint64
    assert t_trace.shape == j_trace.shape
    assert t_trace.tobytes() == j_trace.tobytes()
    assert (t_out, t_ovf) == (j_out, j_ovf)
    assert TV.program_hash(src) == JV.program_hash(src)
    assert TV.rom_listing(src) == JV.rom_listing(src)


def test_vm_source_is_the_same_file():
    import os
    with open(os.path.join(os.path.dirname(JV.__file__), "core",
                           "vm.cpp"), "rb") as f:
        want = f.read()
    with open(os.path.join(os.path.dirname(TV.__file__), "core",
                           "vm.cpp"), "rb") as f:
        assert f.read() == want


def test_fib_outputs():
    _, out = TV.execute(TV.fibonacci_source(10), [0, 1], min_rows=64)
    assert out[:2] == [55, 34]


def test_column_constants_and_ops_equal():
    names = [n for n in vars(JV)
             if n.startswith(("COL_", "CH_", "NUM_")) or n == "OPS"]
    assert len(names) > 30
    for n in names:
        assert getattr(TV, n) == getattr(JV, n), n
    assert TV.fibonacci_source(7) == JV.fibonacci_source(7)


def test_vm_error_is_raised_by_the_port():
    with pytest.raises(TV.VmError):
        TV.execute("begin not_an_instruction end", [])


def test_library_is_built_outside_the_package():
    import os
    TV.execute(TV.fibonacci_source(1), [0, 1])
    lib = TV.library_path()
    assert lib.exists()
    pkg = os.path.dirname(os.path.abspath(TV.__file__))
    assert not str(lib).startswith(pkg + os.sep)
    assert lib.parent.name == "aero_tpu_torch"
    assert lib.parent.parent.name == "build"


def test_stdlib_and_mast_equal():
    src = PROGRAMS["stdlib_import"][0]
    resolved = TS.resolve_imports(src)
    assert resolved == JS.resolve_imports(src)
    assert TS.MODULES == JS.MODULES
    assert TMAST.mast_root_felts(resolved) == JMAST.mast_root_felts(resolved)


def test_rescue_permutation_equal():
    rng = np.random.default_rng(7)
    state = [int(v) for v in rng.integers(0, 2**63, size=TR.RP_W)]
    assert TR.rp_permute(state) == JR.rp_permute(state)
    assert TR.rp_hash8(state[:8]) == JR.rp_hash8(state[:8])
