"""The dry-run pipeline of `aero_tpu_torch.parallel` at 2^14 rows, held
against `aero_tpu`'s own roots there.

`aero_tpu_torch/parallel/dryrun_golden_2e14.json` holds
`aero_tpu.parallel.sharded.single_device_dryrun_roots(trace_steps=1 << 14)`
(the four Merkle roots of the `MidenAir` pipeline: main, aux, constraint,
first FRI fold), made on the CPU with the seconds it took, the box's
`nproc` and the commit. At 64 rows the two packages were held equal before
(`tests/test_torch_sharded.py`); at 2^14 rows the trace, the LDE domain
(2^17 points) and the Merkle trees are 256 times larger, and a rank of
world 4 holds 4 096 rows. The port's trace equals `aero_tpu`'s at that
size; its worlds 2 and 4 over gloo (under a minute each, the ranks in
parallel) and its single-device pipeline (`slow`: over two minutes on one
thread, the pipeline run twice) give the committed roots; a `slow` test
re-derives the file from `aero_tpu` (its `aero_tpu_seconds` say how long),
and `PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_sharded_scale.py`
writes it anew.
"""

import json

import numpy as np
import pytest

from aero_tpu_torch.field import to_u64
from aero_tpu_torch.parallel import dryrun as DR
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


ROWS = 1 << 14
LIMIT_S = 600


def _golden():
    with open(DR.GOLDEN_PATHS[ROWS]) as f:
        return json.load(f)


def test_golden_file_names_its_size_and_four_roots():
    g = _golden()
    assert g["trace_steps"] == ROWS and len(g["roots"]) == 4
    assert all(len(r) == 8 for r in g["roots"])
    assert DR.golden_roots(ROWS) == g["roots"]
    assert DR.golden_roots(1 << 13) is None


def test_the_port_builds_aero_tpus_trace_and_aux_segment():
    """`_dryrun_air_and_traces` of both packages at 2^14 rows: the same
    trace, aux segment and rands, element for element."""
    from aero_tpu.parallel.sharded import _dryrun_air_and_traces as jax_build
    from aero_tpu.field import from_gf
    jair, jtrace, jaux, jrands = jax_build(ROWS)
    air, trace, aux, rands = DR._dryrun_air_and_traces(ROWS, "cpu")
    assert air.trace_length == jair.trace_length == ROWS
    assert rands == jrands
    np.testing.assert_array_equal(to_u64(trace), from_gf(jtrace))
    np.testing.assert_array_equal(to_u64(aux), from_gf(jaux))


@pytest.mark.slow
def test_single_device_gives_aero_tpus_roots():
    got = DR.single_device_dryrun(ROWS, "cpu")
    assert got["rows"] == ROWS
    assert got["roots"] == _golden()["roots"]


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_gives_aero_tpus_roots(world):
    out = DR.dryrun_prove_core(world, ROWS, device="cpu", timeout_s=LIMIT_S)
    want = _golden()["roots"]
    assert out.matches_single_device
    assert [list(r) for r in out[:4]] == want
    for r in out.ranks:
        assert r["roots"] == want and r["rows"] == ROWS


@pytest.mark.slow
def test_golden_file_regenerates_from_aero_tpu():
    from aero_tpu.parallel.sharded import single_device_dryrun_roots
    assert single_device_dryrun_roots(trace_steps=ROWS) == _golden()["roots"]


def main() -> None:
    """Write `dryrun_golden_2e14.json` from aero_tpu on the CPU:

        PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_sharded_scale.py
    """
    import os
    import subprocess
    import time
    import jax
    from aero_tpu.parallel.sharded import single_device_dryrun_roots
    jax.config.update("jax_platforms", "cpu")
    path = DR.GOLDEN_PATHS[ROWS]
    commit = subprocess.run(["git", "rev-parse", "HEAD"],
                            cwd=os.path.dirname(path), capture_output=True,
                            text=True).stdout.strip()
    t0 = time.perf_counter()
    roots = single_device_dryrun_roots(trace_steps=ROWS)
    golden = {"trace_steps": ROWS, "roots": roots,
              "what": "aero_tpu.parallel.sharded.single_device_dryrun_roots"
                      "(trace_steps=1 << 14) on the CPU (JAX_PLATFORMS=cpu)",
              "aero_tpu_seconds": round(time.perf_counter() - t0, 1),
              "nproc": os.cpu_count(), "commit": commit}
    with open(path, "w") as f:
        json.dump(golden, f, indent=1)
    print(json.dumps(golden))


if __name__ == "__main__":
    main()
