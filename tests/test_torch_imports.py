"""aero_tpu_torch stands alone, and chip_smoke.py does not run on the CPU.

- Importing every module of the package (and chip_smoke.py, bench_gpu.py,
  dryrun_passes.py) leaves `jax`, `aero_tpu` and every `aero_tpu.*` out of
  sys.modules; no source of the port imports either.
- With only `aero_tpu_torch/` on the path (no `aero_tpu/` beside it) the
  entry points import, prove on the CPU and parse the proof, and
  `bench_gpu.main` runs its plan at a small size.
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
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs

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
              "_build", "_sass", "spec.field", "spec.hashing", "spec.coin",
              "spec.polys", "spec.merkle", "spec.proof", "spec.verifier",
              "spec.cairo_sim", "utils.tracing", "vm", "vm.mast",
              "vm.stdlib", "vm.rescue", "sdk.pb.aero_pb2", "sdk.server",
              "io.cairo_memory", "tools.generate_proof",
              "tools.stark_parser", "tools.demo", "tools.check_constraints",
              "tools.regen_dryrun_golden", "parallel.mesh",
              "parallel.dist_ntt", "parallel.sharded", "parallel.dryrun",
              "ntt.ntt_mxu", "tools.card_check", "field.sym",
              "air.symbolic", "air.codegen", "air.generated"):
        assert "aero_tpu_torch." + m in mods, m


def test_importing_every_module_leaves_jax_out():
    scripts = ["chip_smoke", "bench_gpu", "dryrun_passes"]
    code = ("import sys, importlib\n"
            f"for m in {_modules()!r} + {scripts!r}:\n"
            "    importlib.import_module(m)\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'aero_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_no_source_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|aero_tpu)(\.|\s)", re.M)
    paths = [os.path.join(ROOT, f) for f in ("chip_smoke.py", "bench_gpu.py",
                                             "dryrun_passes.py")]
    for d, _, files in os.walk(PKG):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    for p in paths:
        with open(p) as f:
            assert not pat.search(f.read()), p


def test_port_runs_with_aero_tpu_absent(tmp_path):
    """A directory that holds the port and nothing of `aero_tpu`: the entry
    points import, `generate_proof --cpu` writes a proof and `stark_parser`
    parses it."""
    os.symlink(PKG, tmp_path / "aero_tpu_torch")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = lambda *a: subprocess.run(
        [sys.executable, *a], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    res = run("-c", "import aero_tpu_torch.sdk, aero_tpu_torch.sdk.server, "
              "aero_tpu_torch.tools.generate_proof, importlib.util as u; "
              "print(u.find_spec('aero_tpu'))")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "None"
    res = run("-m", "aero_tpu_torch.tools.generate_proof", "--cpu",
              "--min-rows", "64", "--grind", "2", "--queries", "7",
              "--out", "p.bin")
    assert res.returncode == 0, res.stderr
    assert "self-verification OK" in res.stdout
    res = run("-m", "aero_tpu_torch.tools.stark_parser", "p.bin", "proof")
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith('["0x48"')


def test_bench_gpu_runs_with_aero_tpu_absent(tmp_path):
    """`bench_gpu.py` beside the port and nothing else of the repo: its
    plan runs on the CPU at a small size and records every metric."""
    os.symlink(PKG, tmp_path / "aero_tpu_torch")
    os.symlink(os.path.join(ROOT, "bench_gpu.py"), tmp_path / "bench_gpu.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys, importlib.util as u, bench_gpu as b\n"
            "assert u.find_spec('aero_tpu') is None and u.find_spec('bench') "
            "is None\n"
            "rc = b.main(['--all'], device='cpu', sizes={'ntt': dict(log_n=5, "
            "cols=2), 'merkle': dict(log_leaves=4, row_width=3), 'scale': "
            "dict(log_rows=6, grind=2), 'proof': dict(min_rows=64, grind=2), "
            "'lde24': dict(log_n=5), 'hash': dict(log_leaves=4, row_width=3),"
            " 'mul': dict(log_n=5)})\n"
            "assert not any(k.split('.')[0] in ('jax', 'aero_tpu', 'bench') "
            "for k in sys.modules)\n"
            "sys.exit(rc)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = [l for l in res.stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 9 and not any('"skipped"' in l for l in lines)


def test_parallel_exports_the_names_of_aero_tpu_parallel():
    """Every name `aero_tpu.parallel` exports but `gf_scalar` (a scalar is a
    Python int in the port); read from the source, not by importing it."""
    import aero_tpu_torch.parallel as TP
    with open(os.path.join(ROOT, "aero_tpu", "parallel", "__init__.py")) as f:
        names = re.findall(r"[a-z_]+", f.read().split("import", 1)[1])
    assert "stage_commit" in names and "gf_scalar" in names
    for name in names:
        assert hasattr(TP, name) == (name != "gf_scalar"), name


def test_dryrun_runs_with_aero_tpu_absent(tmp_path):
    """The multi-device entry point from a directory that holds the port
    alone: two CPU ranks, roots equal to the port's own golden file."""
    os.symlink(PKG, tmp_path / "aero_tpu_torch")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "aero_tpu_torch.parallel.dryrun", "--world",
         "2", "--cpu"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert "roots match the single-device pipeline: True" in res.stdout


def test_scale_program_is_bench_long_fib_source():
    import bench
    import bench_gpu
    import chip_smoke
    assert chip_smoke.long_fib_source is bench_gpu.long_fib_source
    assert chip_smoke.cuda_ms is bench_gpu.cuda_ms
    assert chip_smoke.host_ms is bench_gpu.host_ms
    for n in (1, 87376):
        assert bench_gpu.long_fib_source(n) == bench.long_fib_source(n)


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
