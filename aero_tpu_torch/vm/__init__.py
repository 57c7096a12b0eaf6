"""Miden-assembly-subset VM: Python binding over the native C++ core.

The executor (core/vm.cpp) assembles and runs the program,
emitting the 72-column execution trace — main columns, pc, AND the
chiplet regions (bits-family blocks, memory rows, program ROM) —
directly into a numpy buffer (column-major). The reference analog is the
forked miden-vm processor invoked at
aero-sdk/miden-wasm/src/proving_worker.rs:225-234; the advice tape
mirrors ProgramInputs.advice_tape (miden_prover.proto).

`g++` builds the core at first use into `build/aero_tpu_torch/` at the root
of the checkout, named by a hash of `vm.cpp` (as `_build.py` names the CUDA
kernels), so an edited source is rebuilt and nothing is written beside the
sources. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .._build import BUILD_DIR

_SRC = Path(__file__).resolve().parent / "core" / "vm.cpp"
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]

NUM_COLS = 72
# column indices (must match vm.cpp)
COL_CLK = 0
COL_G = 1        # 6 opcode group selectors
COL_M = 7        # 8 opcode member selectors
NUM_GROUPS = 6
NUM_MEMBERS = 8
COL_IMM = 15
COL_STACK = 16   # s0..s15
COL_PC = 32      # program counter (bound to the program ROM)
COL_OVF = 33
COL_H0 = 34
COL_B1 = 35   # newest overflow-row address (0 = table empty)
COL_E = 36    # emptiness flag (1 iff b1 == 0)
COL_K = 37    # inverse witness b1^-1
# chiplet region (see vm.cpp header for the full map)
CH_CA = 38    # bits-family block active
CH_CM = 39    # memory row active
CH_CF = 40    # first row of a block
CH_CL = 41    # block label
CH_C1 = 42    # bitwise z coefficients
CH_C2 = 43
CH_BITS = 44  # 16 cols of value bits (4 nibbles)
CH_ACC = 60   # 4 accumulator cols
CH_ACCZ = 64
CH_SH = 65    # 5 shift-bit cols
CH_P2 = 70
CH_CW = 71
# memory-row / ROM-row views (share 44-48 on their own rows)
CH_MA = 44    # memory addr; doubles as the ROM-row CR flag
CH_MCLK = 45  # memory clk / ROM pc
CH_MV = 46    # memory value / ROM op
CH_MW = 47    # memory is_write / ROM imm
CH_MG = 48    # memory same-addr flag / ROM multiplicity
CH_MD = 49    # sortedness diff to the next memory row

# op index = group*8 + member; order must match vm.cpp's enum
OPS = [
    # group 0: window-down
    "push", "advpush", "dup0", "dup1", "dup2", "dup3", "dup4", "dup5",
    # group 1: window-up
    "drop", "add", "sub", "mul", "and", "or", "eq", "neq",
    # group 2: in-place
    "nop", "halt", "neg", "not", "inv", "eqz", "assert", "swap",
    # group 3: permutations + high dups
    "movup2", "movup3", "movup4", "movdn2", "movdn3", "movdn4",
    "dup6", "dup7",
    # group 4: u32 family (checked-wrapping; in-place lo/hi, binary rest)
    "u32lo", "u32hi", "u32add", "u32sub", "u32mul", "u32div",
    "u32mod", "u32and",
    # group 5: u32 bitwise/shift/compare + random-access memory
    "u32or", "u32xor", "u32not", "u32shl", "u32shr", "u32lt",
    "memload", "memstore",
]
NUM_OPS = len(OPS)


def set_op_selectors(row: np.ndarray, op_name: str) -> None:
    """Zero + set the two-level selector columns of a trace row (host-side
    trace surgery in tests)."""
    idx = OPS.index(op_name)
    row[COL_G:COL_G + NUM_GROUPS] = 0
    row[COL_M:COL_M + NUM_MEMBERS] = 0
    row[COL_G + idx // 8] = 1
    row[COL_M + idx % 8] = 1


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libaerovm_{h.hexdigest()[:16]}.so"


def _ensure_built() -> Path:
    """Compile `vm.cpp` if this source has no library yet."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


_lib = None


def _load():
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(_ensure_built()))
        _lib.vm_execute.restype = ctypes.c_longlong
        _lib.vm_execute.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_longlong,
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_longlong]
        _lib.vm_rom.restype = ctypes.c_longlong
        _lib.vm_rom.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_longlong]
        _lib.vm_last_error.restype = ctypes.c_char_p
    return _lib


class VmError(Exception):
    pass


def execute_full(source: str, stack_inputs: Sequence[int],
                 advice_tape: Optional[Sequence[int]] = None,
                 max_rows: int = 1 << 22, min_rows: int = 8
                 ) -> Tuple[np.ndarray, List[int],
                            List[Tuple[int, int]]]:
    """Assemble + execute. stack_inputs are top-first; advice_tape feeds
    adv.push (nondeterministic inputs, not part of the public statement).

    Returns (trace, output_stack, overflow): trace uint64[72, n] with n a
    power of 2 (>= min_rows, sized so the chiplet regions fit),
    output_stack = final 16 stack slots (top-first), overflow = the final
    overflow table as (addr, value) pairs bottom-first (non-empty for
    programs with net-positive stack growth; carried in PublicInputs —
    reference analog: ProgramOutputs.overflow_addrs,
    miden-proof-generator/src/main.rs:35-38)."""
    from .stdlib import resolve_imports
    source = resolve_imports(source)
    lib = _load()
    inputs = np.asarray(list(stack_inputs), dtype=np.uint64)
    adv = np.asarray(list(advice_tape or []), dtype=np.uint64)
    trace = np.zeros(NUM_COLS * max_rows, dtype=np.uint64)
    stack_out = np.zeros(16, dtype=np.uint64)
    max_ovf = 1 << 16
    ovf_out = np.zeros(1 + 2 * max_ovf, dtype=np.uint64)
    n = lib.vm_execute(
        source.encode(),
        inputs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(inputs),
        adv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(adv),
        trace.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        max_rows, min_rows,
        stack_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ovf_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), max_ovf)
    if n < 0:
        raise VmError(lib.vm_last_error().decode())
    n = int(n)
    tr = trace[:NUM_COLS * n].reshape(NUM_COLS, n).copy()
    n_ovf = int(ovf_out[0])
    overflow = [(int(ovf_out[1 + 2 * j]), int(ovf_out[2 + 2 * j]))
                for j in range(n_ovf)]
    return tr, [int(x) for x in stack_out], overflow


def execute(source: str, stack_inputs: Sequence[int],
            advice_tape: Optional[Sequence[int]] = None,
            max_rows: int = 1 << 22, min_rows: int = 8
            ) -> Tuple[np.ndarray, List[int]]:
    """execute_full without the overflow table (kept for the common
    balanced-program case)."""
    tr, out, _ = execute_full(source, stack_inputs, advice_tape,
                              max_rows, min_rows)
    return tr, out


def rom_listing(source: str) -> List[Tuple[int, int, int]]:
    """Assemble `source` and return the program-ROM listing as
    (pc, op_index, imm) triples, including the final (len, halt, 0)
    entry — the static table the verifier's program-aware binding
    recomputes (aero_tpu/air/miden.py _rom_product)."""
    from .stdlib import resolve_imports
    source = resolve_imports(source)
    lib = _load()
    max_entries = 1 << 20
    buf = np.zeros(3 * max_entries, dtype=np.uint64)
    n = lib.vm_rom(source.encode(),
                   buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                   max_entries)
    if n < 0:
        raise VmError(lib.vm_last_error().decode())
    out = buf[:3 * int(n)].reshape(int(n), 3)
    return [(int(a), int(b), int(c)) for a, b, c in out]


def program_hash(source: str) -> List[int]:
    """Program commitment: the MAST-style block-tree root over the
    assembly AST (vm/mast.py), as 4 field elements — matching the
    reference's commitment STRUCTURE (program.hash() = the Miden MAST
    root, miden-proof-generator/src/main.rs:35): structural identity
    under reformatting, procedures committed by body digest.

    This hash IS bound to the executed trace: the verifier checks it
    against the supplied source, assembles the source, and pins the
    committed program-ROM chiplet to the listing via the aux3 product
    boundary (aero_tpu/air/miden.py).

    Stdlib imports (use.std::...) are resolved BEFORE hashing, so the
    commitment covers the executed procedure bodies — the analog of the
    reference's StdLibrary module provider feeding the MAST
    (Assembler::with_module_provider, SURVEY §2.10)."""
    from .mast import mast_root_felts
    from .stdlib import resolve_imports
    return mast_root_felts(resolve_imports(source))


def fibonacci_source(n_iters: int) -> str:
    """The fib program in our Miden-assembly subset (reference shape:
    miden-proof-generator/src/main.rs:55-74)."""
    return f"""
    # Computes {n_iters} Fibonacci iterations: (a, b) -> (a+b, a)
    proc.fib_iter
        swap dup.1 add
    end
    begin
        repeat.{n_iters}
            exec.fib_iter
        end
    end
    """
