"""What each port test module does in its pytest worker, and tests of it.

The tier-1 lane runs every test file in one of six long-lived xdist
workers, the port's files beside `aero_tpu`'s own. Every port test module
imports `port_module`, a module-scoped autouse fixture:

- while the module runs, torch takes one thread, and so does every
  process a test starts (`OMP_NUM_THREADS=1` in the environment they
  inherit): six workers share the host's cores, and torch's default of a
  thread a core oversubscribed them. `bench_gpu`'s plan on the CPU, run in
  a child process, took 9-12 s alone and 111-206 s in the lane with a
  thread a core. The count and the variable before the module are
  restored when it ends;
- when the module ends, the programs JAX compiled for it are released
  (`release_compiled_programs`). JAX keeps every XLA executable it builds:
  one a primitive and shape when a test runs `aero_tpu` op by op under
  `jax.disable_jit`, one a function and shape under `jax.jit`. The port's
  files hold it against `aero_tpu` at many shapes, so a worker that kept
  them all grew by up to two GB a file, to 8-14 GB; six such workers
  outgrew a 62 GB host, the kernel dropped the workers' code pages and
  then killed one, and the last files of the lane ran out of time.
"""

import ctypes
import gc
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch


def release_compiled_programs() -> None:
    """Drop JAX's in-memory compilation caches (a later call compiles
    again, or reads the persistent cache) and hand the freed heap back to
    the system."""
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):   # not glibc: the heap stays as it is
        pass


def module_state():
    """The set-up and the release around one port test module."""
    threads = torch.get_num_threads()
    omp = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if omp is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = omp
    release_compiled_programs()


@pytest.fixture(scope="module", autouse=True)
def port_module():
    yield from module_state()


def test_a_port_module_and_its_child_processes_run_torch_on_one_thread():
    assert torch.get_num_threads() == 1
    out = subprocess.run([sys.executable, "-c", "import torch; "
                          "print(torch.get_num_threads())"],
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "1"


def test_release_drops_the_programs_jax_compiled():
    f = jax.jit(lambda x: x * 3 + 1)
    x = jnp.arange(7, dtype=jnp.int32)
    assert int(f(x)[2]) == 7
    assert f._cache_size() == 1
    release_compiled_programs()
    assert f._cache_size() == 0
    assert int(f(x)[3]) == 10          # compiles again when called
    assert f._cache_size() == 1


@pytest.mark.parametrize("omp", [None, "5"])
def test_the_module_state_restores_the_thread_count(monkeypatch, omp):
    before = torch.get_num_threads()
    if omp is None:
        monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    else:
        monkeypatch.setenv("OMP_NUM_THREADS", omp)
    torch.set_num_threads(3)
    try:
        state = module_state()
        next(state)
        assert torch.get_num_threads() == 1
        assert os.environ["OMP_NUM_THREADS"] == "1"
        with pytest.raises(StopIteration):
            next(state)
        assert torch.get_num_threads() == 3
        assert os.environ.get("OMP_NUM_THREADS") == omp
    finally:
        torch.set_num_threads(before)
