"""The port's `check_constraints` and `regen_dryrun_golden` tools on the CPU:
the counterparts of tools/check_constraints.py and
tools/regen_dryrun_golden.py."""

import filecmp
import os
import subprocess
import sys

import pytest
import torch

from aero_tpu_torch.parallel.dryrun import GOLDEN_PATH
from aero_tpu_torch.tools import check_constraints, regen_dryrun_golden
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_check_constraints_cli_passes_on_the_builtin_program():
    res = _run("aero_tpu_torch.tools.check_constraints", "--cpu")
    assert res.returncode == 0, res.stderr
    assert "all constraints vanish" in res.stdout
    assert "112 transition constraints" in res.stdout


def test_check_constraints_builtin_program_is_aero_tpus():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_check_constraints", os.path.join(ROOT, "tools",
                                              "check_constraints.py"))
    with open(spec.origin) as f:
        text = f.read()
    # the program text sits between the f-string quotes of DEFAULT_SRC
    body = text.split('DEFAULT_SRC = f"""')[1].split('"""')[0]
    M32 = (1 << 32) - 1
    assert eval('f"""' + body + '"""', {"M32": M32}) == \
        check_constraints.DEFAULT_SRC


def test_check_constraints_takes_a_program_file(tmp_path, capsys):
    from aero_tpu_torch.vm import fibonacci_source
    path = tmp_path / "fib.masm"
    path.write_text(fibonacci_source(10))
    assert check_constraints.main([str(path), "--cpu"]) == 0
    assert "all constraints vanish" in capsys.readouterr().out


@pytest.mark.parametrize("cell", [(16, 5, 12345), (0, 9, 7), (32, 4, 999)])
def test_check_constraints_reports_a_corrupted_row(capsys, cell):
    bad = check_constraints.check(device="cpu", corrupt=cell)
    out = capsys.readouterr().out
    assert bad > 0
    assert "NONZERO at rows" in out and "FAILURES" in out
    assert "all constraints vanish" not in out


def test_check_constraints_needs_a_card_without_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _run("aero_tpu_torch.tools.check_constraints")
    assert res.returncode != 0
    assert "constraints vanish" not in res.stdout


def test_regen_dryrun_golden_writes_the_committed_file(tmp_path):
    out = tmp_path / "golden.json"
    res = _run("aero_tpu_torch.tools.regen_dryrun_golden", "--cpu", "--out",
               str(out))
    assert res.returncode == 0, res.stderr
    assert f"wrote {out}" in res.stdout
    assert filecmp.cmp(out, GOLDEN_PATH, shallow=False)
    assert filecmp.cmp(out, os.path.join(ROOT, "aero_tpu", "parallel",
                                         "dryrun_golden.json"),
                       shallow=False)


def test_regen_dryrun_golden_defaults_to_the_committed_path(monkeypatch,
                                                            tmp_path):
    import aero_tpu_torch.parallel.dryrun as DR
    target = tmp_path / "g.json"
    monkeypatch.setattr(DR, "GOLDEN_PATH", str(target))
    roots = regen_dryrun_golden.regenerate(device="cpu")
    assert filecmp.cmp(target, GOLDEN_PATH, shallow=False)
    assert len(roots) == 4 and all(len(r) == 8 for r in roots)


def test_regen_dryrun_golden_needs_a_card_without_cpu_flag(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = tmp_path / "golden.json"
    res = _run("aero_tpu_torch.tools.regen_dryrun_golden", "--out", str(out))
    assert res.returncode != 0
    assert not out.exists()


# ------------------------------------------------------------- card_check

def test_card_check_raises_without_a_card(capsys):
    from aero_tpu_torch.tools import card_check
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        card_check.main()
    assert "PASS" not in capsys.readouterr().out


def test_card_check_cli_fails_without_a_card_and_has_no_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for args in ((), ("--cpu",)):
        res = _run("aero_tpu_torch.tools.card_check", *args)
        assert res.returncode != 0
        assert "PASS" not in res.stdout and "failures" not in res.stdout


def test_forward_step_root_equals_aero_tpus_entry():
    """The forward step of `__graft_entry__.entry` (fib trace of 256 rows ->
    LDE at blowup 8 -> Merkle root) and the port's, on the CPU."""
    import numpy as np
    import __graft_entry__ as graft
    from aero_tpu.field import from_gf
    from aero_tpu_torch.field import to_u64
    from aero_tpu_torch.merkle import commit_columns
    from aero_tpu_torch.ntt import intt, lde
    from aero_tpu_torch.tools import card_check
    jax_forward, (jax_trace,) = graft.entry()
    forward, (trace,) = card_check.entry("cpu")
    try:
        root = forward(trace)
    finally:
        forward.close()
    assert np.array_equal(to_u64(trace), from_gf(jax_trace))
    want = np.asarray(jax_forward(jax_trace)).astype("<u4").tobytes()
    assert root == want
    assert root == commit_columns(lde(intt(trace), 3)).root
