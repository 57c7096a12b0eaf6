"""card_check — known-answer tests of the built kernels, on the card.

The counterpart of `tools/tpu_check.py` and of the forward step of
`__graft_entry__.entry`. The pytest suite runs on the CPU, where every
wrapper takes its kernel's plain version; this tool builds the CUDA kernels
and holds what they return on the card against `hashlib`, the spec oracle
and the plain versions, bit for bit:

- `blake2s_words` at 40, 64, 2304 and 2592 bytes against `hashlib`;
- `hash_columns` 72 x 3000 against `hash_elements_rows` on the CPU and the
  spec's `hash_elements`;
- `merge_level` 8 x 4096 against `hashlib`;
- `grind_pow` at 12 bits against the spec's `merge_with_int`;
- the NTT kernel at 2^13 against `ntt_plain`, and the int8 tensor-core
  4-step `ntt_mxu` / `intt_mxu` at 2^13 against both;
- the forward step: `build_fib_trace(256)` -> `stage_lde(.., 3)` ->
  `stage_commit` on a mesh of one rank, its root against the plain path's
  (the same trace extended and committed with CPU tensors).

    python -m aero_tpu_torch.tools.card_check

prints PASS or FAIL a line and exits 1 on any failure. It raises without a
CUDA card: there is nothing for it to check on the CPU.
"""

import hashlib
import os
import shutil
import sys
import tempfile

import numpy as np
import torch


def forward_step(trace: torch.Tensor, mesh) -> bytes:
    """The entry point's forward step on this rank's block of the trace:
    iNTT + coset LDE at blowup 8, then the Merkle root of the extended
    columns."""
    from ..parallel.sharded import stage_commit, stage_lde
    _, lde_evals = stage_lde(mesh, trace, 3)
    root = stage_commit(mesh, lde_evals)
    return root.cpu().numpy().astype("<u4").tobytes()


def entry(device=None):
    """(forward, (trace,)) as `__graft_entry__.entry` returns them: the
    forward step over a mesh of one rank on `device` (None: the CUDA card),
    and its example argument. `forward.close()` leaves the process group
    and removes its rendezvous file."""
    from .._device import resolve_device
    from ..air.fib import build_fib_trace
    from ..parallel.mesh import make_mesh
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    tmp = tempfile.mkdtemp(prefix="card_check_")
    mesh = make_mesh(1, 0, device, "file://" + os.path.join(tmp, "rendezvous"))

    def forward(trace):
        return forward_step(trace, mesh)

    def close():
        mesh.close()
        shutil.rmtree(tmp, ignore_errors=True)

    forward.close = close
    return forward, (build_fib_trace(256, device),)


def main(argv=None) -> int:
    if argv:
        raise SystemExit("card_check takes no arguments")
    from .._device import resolve_device
    from ..field import P, from_u64
    from ..hash import hash_elements_rows
    from ..hash.blake2s_cuda import (blake2s_words, grind_pow, hash_columns,
                                     merge_level)
    from ..merkle import commit_columns
    from ..ntt import intt, lde, ntt_plain
    from ..ntt.ntt_cuda import ntt_cuda
    from ..ntt.ntt_mxu import intt_mxu, ntt_mxu
    from ..spec.hashing import hash_elements, merge_with_int

    dev = resolve_device(None)              # raises where there is no card
    rng = np.random.default_rng(0)
    failures = 0

    def check(name, ok):
        nonlocal failures
        print(f"{'PASS' if ok else 'FAIL'} {name}", flush=True)
        if not ok:
            failures += 1

    def words(arr):
        return torch.from_numpy(np.ascontiguousarray(arr, np.uint64)
                                .view(np.int64)).to(dev)

    for nbytes, B in [(40, 2048), (64, 1024), (2304, 1500), (2592, 1024)]:
        W = -(-nbytes // 4)
        msgs = rng.integers(0, 2**32, size=(B, W), dtype=np.uint64)
        d = blake2s_words(words(msgs.T), nbytes).cpu().numpy()
        check(f"blake2s_words nbytes={nbytes}", all(
            hashlib.blake2s(msgs[i].astype("<u4").tobytes()[:nbytes]).digest()
            == d[:, i].astype("<u4").tobytes()
            for i in range(0, B, max(1, B // 17))))

    vals = rng.integers(0, P, size=(72, 3000), dtype=np.uint64)
    d1 = hash_columns(from_u64(vals, dev)).cpu()
    d2 = hash_elements_rows(from_u64(vals.T, "cpu"))
    check("hash_columns vs hash_elements_rows on the CPU",
          torch.equal(d1.T, d2))
    check("hash_columns vs spec hash_elements", all(
        hash_elements([int(v) for v in vals[:, i]])
        == d1[:, i].numpy().astype("<u4").tobytes()
        for i in range(0, 3000, 173)))

    dth = rng.integers(0, 2**32, size=(8, 4096), dtype=np.uint64)
    m1 = merge_level(words(dth)).cpu().numpy()
    check("merge_level", all(
        hashlib.blake2s(dth[:, 2 * i].astype("<u4").tobytes()
                        + dth[:, 2 * i + 1].astype("<u4").tobytes()).digest()
        == m1[:, i].astype("<u4").tobytes()
        for i in range(0, 2048, 311)))

    seed = hashlib.blake2s(b"card-check").digest()
    nonce = grind_pow(seed, 12, dev)
    d = merge_with_int(seed, nonce)
    check("grind_pow", 128 - int.from_bytes(d[:16], "big").bit_length() >= 12)

    n = 1 << 13
    x = from_u64(rng.integers(0, P, size=(2, n), dtype=np.uint64), dev)
    for invert in (False, True):
        name = "intt" if invert else "ntt"
        want = ntt_plain(x, invert)
        got = ntt_cuda(x, invert)
        check(f"{name} kernel 2^13 vs ntt_plain", torch.equal(got, want))
        mxu = intt_mxu(x) if invert else ntt_mxu(x)
        check(f"{name}_mxu 2^13 vs ntt_plain", torch.equal(mxu, want))
        check(f"{name}_mxu 2^13 vs the NTT kernel", torch.equal(mxu, got))

    forward, (trace,) = entry(dev)
    try:
        root = forward(trace)
    finally:
        forward.close()
    plain = commit_columns(lde(intt(trace.cpu()), 3)).root
    check("forward step (fib 256 -> LDE x8 -> commit) vs the plain path",
          root == plain)

    print("failures:", failures)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
