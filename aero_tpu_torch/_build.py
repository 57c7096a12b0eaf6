"""Build and load the CUDA kernels of `csrc/`.

`nvcc` compiles every `csrc/*.cu` into one shared library with a plain C
interface under `build/aero_tpu_torch/` at the root of the checkout, named
by a hash of the sources, so an edited source is rebuilt at its next use.
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
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "aero_tpu_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# entry point -> argtypes (pointers and the stream as c_void_p)
SIGNATURES = {
    # csrc/ntt.cu
    "gl_colntt": [_P, _P, _P, _P, _I32, _I32, _I64, _I64,
                  _I64, _I64, _I64, _I64, _I64, _P],
    # csrc/blake2s.cu
    "blake2s_words": [_P, _I64, _I64, _I64, _P, _P],
    "blake2s_hash_columns": [_P, _I64, _I64, _P, _P],
    "blake2s_merge_level": [_P, _I64, _P, _P],
    "blake2s_grind_pow": [_P, _I64, _I64, _I32, _P, _P],
}

_lib = None


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


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
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libaero_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if this source set has no library yet."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(_CSRC.glob("*.cu"))]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
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
