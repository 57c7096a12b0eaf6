"""aero_tpu_torch — the aero-tpu STARK prover on PyTorch and CUDA.

A second package beside `aero_tpu`: the same Miden proof path, written as
plain PyTorch over one int64 tensor per field array, with the two hot
kernels (the Goldilocks NTT and blake2s-256) hand-written in CUDA C++ for
Hopper (`csrc/`). `aero_tpu` stays the reference: on the same trace and
options this package emits the same proof bytes.

- `field`   — Goldilocks arithmetic on int64 tensors (u64 bit patterns,
              canonical in [0, p)).
- `ntt`     — NTT / iNTT / coset LDE; CUDA tensors go through kernel 1.
- `hash`    — blake2s-256 leaf hashing, Merkle merges and PoW; CUDA
              tensors go through kernel 2.
- `merkle`  — commitments whose node levels stay on the device.
- `air`     — the AIR base, FibAir and MidenAir.
- `prover`  — FRI and the seven-stage prover.
- `sdk`     — `prove(program, inputs, options)` on the protobuf wire types.

The package imports no JAX. It shares the JAX-free host code of
`aero_tpu`: the protocol specification (`aero_tpu.spec`), the C++ VM
(`aero_tpu.vm`), tracing spans and the SDK's wire converters.
"""

__version__ = "0.1.0"
