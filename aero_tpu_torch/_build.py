"""Build and load the CUDA kernels of `csrc/`.

`nvcc` compiles every `csrc/*.cu` into one shared library with a plain C
interface under `build/aero_tpu_torch/` at the root of the checkout, named
by a hash of the sources, so an edited source is rebuilt at its next use.
Each source compiles in its own `nvcc` process, all started at once, and
one more links them.
The library is loaded with ctypes: each entry point takes device pointers,
sizes and the CUDA stream, launches on that stream and returns
`cudaGetLastError()`, which `launch` turns into an exception.

Nothing here falls back to the plain PyTorch versions: a missing `nvcc`, a
failed build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "aero_tpu_torch"

# the AIRs with a generated kernel K5: one committed csrc/air_<name>.cu each
FRAG_EVAL_AIRS = tuple(sorted(p.stem[len("air_"):]
                              for p in CSRC.glob("air_*.cu")))
# the AIRs with a generated kernel K6: one committed csrc/aux_<name>.cu each
ROW_EVAL_AIRS = tuple(sorted(p.stem[len("aux_"):]
                             for p in CSRC.glob("aux_*.cu")))

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
# The generated sources of kernels K5 and K6 (csrc/air_*.cu, aux_*.cu) go
# through ptxas at -O1. A point of K5 is some 40 000 instructions of
# straight-line code whose emission keeps few values live
# (air/codegen.py); at -O2 and -O3 ptxas moves reads and their addresses
# far ahead of their uses and spills; at -O1 it keeps close to the emitted
# order. K6's rows come from the same emission and take the same flags.
FRAG_EVAL_FLAGS = ["-Xptxas", "-O1"]


def _flags(src: Path) -> list:
    return NVCC_FLAGS + (FRAG_EVAL_FLAGS
                         if src.stem.startswith(("air_", "aux_")) else [])

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64
_OPERAND = [_P, _I32, _I64, _I64, _I64, _I64]   # pointer, mode, d1, s1, m0, s0
# entry point -> argtypes (pointers and the stream as c_void_p)
SIGNATURES = {
    # csrc/ntt.cu
    "gl_colntt": [_P, _P, _P, _P, _I32, _I32, _I64, _I64, _I64, _I64, _I64,
                  _I64, _I64, _I64, _I64, _P],
    "gl_colntt_lde": [_P] * 6 + [_I32, _I32, _I64, _I64, _I64, _I32, _I64,
                                 _I64, _I64, _I64, _P],
    # csrc/blake2s.cu
    "blake2s_words": [_P, _I64, _I64, _I64, _P, _P],
    "blake2s_hash_columns": [_P, _I64, _I64, _P, _P],
    "blake2s_merge_level": [_P, _I64, _P, _P],
    "blake2s_grind_pow": [_U32] * 8 + [_I64, _I64, _I64, _I32, _P, _P, _P],
    "merkle_gather": [_P, _I32, _P, _I64, _P, _P],
    # csrc/field.cu
    "gl_elementwise": _OPERAND + _OPERAND + [_P, _I64, _I32, _U64, _P],
    "gl_scan": [_P, _P, _P, _I64, _I64, _I64, _I32, _P],
    "gl_batch_inv": [_P, _P, _P, _I64, _I64, _I64, _P],
    "gl_deep_combine": [_P, _I64, _I32] * 3 + [_P] * 7 + [_I64] + [_P] * 4
                       + [_I64, _P],
    # csrc/eval_multi.cu
    "gl_eval_multi": [_P, _I64, _I32] * 4 + [_P, _I32, _P, _P, _I64, _P],
    # csrc/air_<name>.cu, generated (air/codegen.py): FRAG_EVAL_PARAMS of
    # csrc/frag_eval.cuh
    **{f"{name}_frag_eval": [_P, _I64] * 6 + [_I64] + [_P] * 6
       + [_I64, _P, _P, _P, _I32, _I32, _I64, _I64, _P, _I32, _P, _I64,
          _I32, _P]
       for name in FRAG_EVAL_AIRS},
    # csrc/aux_<name>.cu, generated: ROW_EVAL_PARAMS of csrc/frag_eval.cuh
    **{f"{name}_aux_factors": [_P, _I64, _P, _P, _I64, _P]
       for name in ROW_EVAL_AIRS},
}

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + FRAG_EVAL_FLAGS).encode())
    return BUILD_DIR / f"libaero_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source set has no library yet."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = Path(f"{tmp}.o")
    objs.mkdir(exist_ok=True)
    try:
        jobs = [(src, subprocess.Popen(
            [nvcc, *_flags(src), "-c", str(src), "-o",
             str(objs / f"{src.stem}.o")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
            for src in sorted(CSRC.glob("*.cu"))]
        failed = []
        for src, job in jobs:
            _, err = job.communicate()
            if job.returncode != 0:
                failed.append(f"{src.name} ({job.returncode}):\n{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *sorted(str(o) for o in objs.glob("*.o"))],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, out)
    finally:
        shutil.rmtree(objs, ignore_errors=True)
    return out


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call entry point `name`; raise on a non-zero cudaError_t."""
    err = getattr(load(), name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {err}")
