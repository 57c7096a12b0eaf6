"""The multi-device path: the counterpart of `aero_tpu/parallel/`.

A mesh is D ranks of a `torch.distributed` process group, one device each
(`mesh.py`); the distributed NTT (`dist_ntt.py`) and the prover's stages on
local blocks (`sharded.py`) write their exchanges out; `dryrun.py` runs the
stages end to end (`python -m aero_tpu_torch.parallel.dryrun`). The names
are those `aero_tpu.parallel` exports, but `gf_scalar`: a scalar is a
Python int here.
"""

from .mesh import (Mesh, gather_domain, join_blocks, make_mesh, run_ranks,
                   shard_domain, split_blocks)
from .sharded import (stage_commit, stage_composition, stage_deep,
                      stage_fri_fold, stage_lde)


def dryrun_prove_core(*args, **kwargs):
    """`dryrun.dryrun_prove_core`, imported at the call so that
    `python -m aero_tpu_torch.parallel.dryrun` finds the module fresh."""
    from .dryrun import dryrun_prove_core as run
    return run(*args, **kwargs)
