"""aero_tpu_torch — the aero-tpu STARK prover on PyTorch and CUDA.

A second package beside `aero_tpu`: the same Miden proof path, written as
plain PyTorch over one int64 tensor per field array, with the two hot
kernels (the Goldilocks NTT and blake2s-256) hand-written in CUDA C++ for
Hopper (`csrc/`). `aero_tpu` stays the reference: on the same trace and
options this package emits the same proof bytes.

- `field`   — Goldilocks arithmetic on int64 tensors (u64 bit patterns,
              canonical in [0, p)).
- `ntt`     — NTT / iNTT / coset LDE; CUDA tensors go through kernel 1.
              `ntt.ntt_mxu` is the int8 tensor-core 4-step, public and
              bit-exact, not on the main path (it loses to kernel 1).
- `hash`    — blake2s-256 leaf hashing, Merkle merges and PoW; CUDA
              tensors go through kernel 2.
- `merkle`  — commitments whose node levels stay on the device.
- `air`     — the AIR base, FibAir and MidenAir.
- `prover`  — FRI and the seven-stage prover.
- `spec`    — the protocol layer on Python integers: field, hashing, coin,
              Merkle batch proofs, wire format, verifier, and the
              simulation of the Cairo verifier's live sequence.
- `vm`      — the C++ Miden-subset VM (built by `g++` at first use into
              `build/aero_tpu_torch/`), MAST hashing, stdlib, Rescue.
- `utils`   — tracing spans (`AERO_TPU_TRACE=1` echoes them).
- `sdk`     — `prove(program, inputs, options)` on the protobuf wire types,
              the wire converters, `ProofSubmissionService` and the HTTP
              submission server (`python -m aero_tpu_torch.sdk.server`).
- `io`      — a proof re-encoded as Cairo-readable memory.
- `tools`   — `python -m aero_tpu_torch.tools.{generate_proof,stark_parser,demo,
              check_constraints,regen_dryrun_golden,card_check}`.
- `parallel` — the multi-device path: a mesh of `torch.distributed` ranks,
              the distributed NTT, the prover's stages on local blocks and
              the dry-run pipeline (`python -m aero_tpu_torch.parallel.dryrun`).

The package stands alone: it imports `torch`, `numpy` and the standard
library, never `jax` and nothing of `aero_tpu`, and keeps its own copy of
what it needs from there. Only `tests/test_torch_*.py` import both packages
(`JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -q`, on the CPU).

Every entry point proves on the CUDA card unless the caller names another
device (`device="cpu"`, `--cpu`), and raises where there is no card: no
fallback to the CPU. `python3 chip_smoke.py` at the root of the checkout
drives every path on the card.
"""

__version__ = "0.1.0"
