"""aero_tpu_torch stands without JAX, and chip_smoke.py without the CPU.

- Importing every module of the package (and chip_smoke.py) leaves `jax`
  out of sys.modules; no source of the port imports jax.
- chip_smoke.py exits non-zero and prints no result without a card.
- The kernel build raises when nvcc is missing (no silent fallback).
"""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import aero_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "aero_tpu_torch")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        aero_tpu_torch.__path__, "aero_tpu_torch."))


def test_package_has_the_slice_modules():
    mods = set(_modules())
    for m in ("field.gl", "ntt.tables", "ntt.ntt", "ntt.ntt_cuda",
              "hash.blake2s", "hash.blake2s_cuda", "merkle.tree", "air.air",
              "air.fib", "air.miden", "prover.fri", "prover.prover", "sdk",
              "_build"):
        assert "aero_tpu_torch." + m in mods, m


def test_importing_every_module_leaves_jax_out():
    code = ("import sys, importlib\n"
            f"for m in {_modules()!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "print('jax' in sys.modules, any(k.startswith('jax.') "
            "for k in sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False False"


def test_no_source_imports_jax():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    for p in paths:
        with open(p) as f:
            assert not pat.search(f.read()), p


def test_scale_program_is_bench_long_fib_source():
    import bench
    import chip_smoke
    for n in (1, 87376):
        assert chip_smoke.long_fib_source(n) == bench.long_fib_source(n)


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py would run for real")
    for cwd in (ROOT, str(tmp_path)):
        if cwd != ROOT:
            with open(os.path.join(ROOT, "chip_smoke.py")) as f:
                (tmp_path / "chip_smoke.py").write_text(f.read())
        res = _run_smoke(cwd)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from aero_tpu_torch import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
