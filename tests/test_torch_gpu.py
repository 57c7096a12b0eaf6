"""Kernel vs plain PyTorch version on the card (marked `gpu`).

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so it runs on a machine that has only the port's dependencies:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(`--noconftest` skips the repository conftest, which configures JAX.)
Exact equality: finite-field and hash arithmetic.
"""

import hashlib

import numpy as np
import pytest
import torch

from aero_tpu_torch.air import fib as TF
from aero_tpu_torch.field import P, from_u64
from aero_tpu_torch.hash import blake2s_cuda as TK
from aero_tpu_torch.ntt import coset_pad, lde, ntt_plain
from aero_tpu_torch.ntt import ntt_cuda
from aero_tpu_torch.prover import prove
from aero_tpu_torch.spec.proof import ProofOptions

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _words(arr, device):
    return torch.from_numpy(np.ascontiguousarray(arr, np.uint64)
                            .view(np.int64)).to(device)


@pytest.mark.parametrize("logn", [1, 2, 5, 11, 12, 13, 16, 20, 24])
def test_ntt_kernel_matches_plain(cuda_device, logn):
    rng = np.random.default_rng(logn)
    cols = 1 if logn > 20 else 4
    x = from_u64(rng.integers(0, P, size=(cols, 1 << logn), dtype=np.uint64),
                 cuda_device)
    for invert in (False, True):
        k = ntt_cuda.ntt_cuda(x, invert)
        assert torch.equal(k, ntt_cuda.ntt_four_step_plain(x, invert))
        if logn <= 16:
            assert torch.equal(k, ntt_plain(x, invert))
    assert torch.equal(ntt_cuda.ntt_cuda(ntt_cuda.ntt_cuda(x), True), x)


@pytest.mark.parametrize("max_l,logn", [(4, 5), (4, 6), (8, 7), (8, 9),
                                        (16, 10), (16, 12)])
def test_three_level_ntt_kernel_with_a_lowered_pass_limit(cuda_device, max_l,
                                                          logn):
    """Three passes of the kernel at small sizes, on a batch of rows: the
    last pass runs once a row with its own batch strides."""
    rng = np.random.default_rng(100 + logn)
    x = from_u64(rng.integers(0, P, size=(2, 3, 1 << logn), dtype=np.uint64),
                 cuda_device)
    for invert in (False, True):
        ntt_cuda.reset_launches()
        k = ntt_cuda.ntt_cuda(x, invert, max_l=max_l)
        assert ntt_cuda.LAUNCHES["gl_colntt"] == 2 + 6
        assert torch.equal(k, ntt_plain(x, invert))
        assert torch.equal(k, ntt_cuda.ntt_four_step_plain(x, invert, max_l))
        assert torch.equal(k.cpu(), ntt_cuda.ntt_cuda(x.cpu(), invert, max_l))


def test_ntt_of_2e25_points_round_trip_and_plain_equality(cuda_device):
    """Past two passes of 4096: three launches, the inverse undoes the
    forward, and both equal the plain rendering of the three passes."""
    rng = np.random.default_rng(25)
    x = from_u64(rng.integers(0, P, size=(1, 1 << 25), dtype=np.uint64),
                 cuda_device)
    ntt_cuda.reset_launches()
    k = ntt_cuda.ntt_cuda(x)
    assert ntt_cuda.LAUNCHES["gl_colntt"] == 3
    assert torch.equal(k, ntt_cuda.ntt_four_step_plain(x, False))
    back = ntt_cuda.ntt_cuda(k, True)
    assert torch.equal(back, x)
    assert torch.equal(back, ntt_cuda.ntt_four_step_plain(k, True))
    ntt_cuda.clear_table_cache()


def test_lde_past_the_two_pass_limit_on_the_card(cuda_device):
    """lde of 2^22 coefficients at blowup 8 is one 2^25-point transform:
    equal to the cosets transformed one by one at 2^22 points."""
    from aero_tpu_torch.field import mul, power_series
    from aero_tpu_torch.spec import field as F
    rng = np.random.default_rng(22)
    n = 1 << 22
    c = from_u64(rng.integers(0, P, size=(1, n), dtype=np.uint64),
                 cuda_device)
    got = lde(c, 3).reshape(n, 8)
    w_m = F.get_root_of_unity(25)
    for t in range(8):
        sc = power_series(F.mul(F.DOMAIN_OFFSET, F.exp(w_m, t)), n,
                          device=cuda_device)
        assert torch.equal(got[:, t], ntt_cuda.ntt_cuda(mul(c, sc))[0])
    ntt_cuda.clear_table_cache()


@pytest.mark.parametrize("shape", [(3, 64), (2, 256), (2, 4, 1 << 10),
                                   (8, 1 << 13), (2, 1 << 18)])
def test_ntt_mxu_on_the_card_equals_the_ntt_kernel(cuda_device, shape):
    """The int8 tensor-core 4-step (`torch._int_mm`), tiles below 32 padded,
    against kernel 1 and the plain radix-2 transform."""
    from aero_tpu_torch.ntt import ntt_mxu as mx
    rng = np.random.default_rng(shape[-1])
    x = from_u64(rng.integers(0, P, size=shape, dtype=np.uint64), cuda_device)
    mx.reset_products()
    for invert, fn in ((False, mx.ntt_mxu), (True, mx.intt_mxu)):
        got = fn(x)
        assert torch.equal(got, ntt_cuda.ntt_cuda(x, invert))
        assert torch.equal(got, ntt_plain(x, invert))
    assert mx.PRODUCTS["int8_matmul"] == 2 * 2 * 256
    assert torch.equal(mx.intt_mxu(mx.ntt_mxu(x)), x)


def test_ntt_mxu_karatsuba_route_on_the_card(cuda_device):
    from aero_tpu_torch.ntt import ntt_mxu as mx
    rng = np.random.default_rng(20)
    x = from_u64(rng.integers(0, P, size=(2, 1 << 20), dtype=np.uint64),
                 cuda_device)
    mx.reset_products()
    assert torch.equal(mx.ntt_mxu(x), ntt_cuda.ntt_cuda(x))
    assert mx.PRODUCTS["int8_matmul"] == 2 * 108


def test_card_check_exits_zero(cuda_device, capsys):
    from aero_tpu_torch.tools import card_check
    assert card_check.main() == 0
    out = capsys.readouterr().out
    assert "failures: 0" in out and "FAIL " not in out
    assert out.count("PASS") == 15


def test_row_major_hashing_takes_the_kernels(cuda_device):
    from aero_tpu_torch.hash import hash_elements_rows, merge_pairs
    from aero_tpu_torch.merkle import commit_columns, commit_rows
    rng = np.random.default_rng(4)
    vals = rng.integers(0, P, size=(300, 9), dtype=np.uint64)
    TK.reset_launches()
    on_card = hash_elements_rows(from_u64(vals, cuda_device))
    assert TK.LAUNCHES["blake2s_hash_columns"] == 1
    assert torch.equal(on_card.cpu(), hash_elements_rows(from_u64(vals,
                                                                  "cpu")))
    pairs = merge_pairs(on_card)
    assert TK.LAUNCHES["blake2s_merge_level"] == 1
    assert torch.equal(pairs.cpu(), merge_pairs(on_card.cpu()))
    rows = from_u64(vals[:256], cuda_device)
    tree = commit_rows(rows)
    assert tree.root == commit_columns(rows.t().contiguous()).root
    assert tree.root == commit_rows(rows.cpu()).root
    assert tree.prove(77) == commit_rows(rows.cpu()).prove(77)


def test_lde_kernel_path_matches_plain(cuda_device):
    rng = np.random.default_rng(3)
    c = from_u64(rng.integers(0, P, size=(9, 1 << 12), dtype=np.uint64),
                 cuda_device)
    assert torch.equal(lde(c, 3), ntt_plain(coset_pad(c, 3)))


@pytest.mark.parametrize("w", [1, 2, 8, 9, 72])
def test_hash_columns_kernel_matches_plain(cuda_device, w):
    rng = np.random.default_rng(w)
    cols = from_u64(rng.integers(0, 2**64 - 1, size=(w, 5000),
                                 dtype=np.uint64), cuda_device)
    assert torch.equal(TK.hash_columns(cols), TK.hash_columns_plain(cols))


def test_merge_level_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(8)
    d = _words(rng.integers(0, 2**32, size=(8, 1 << 14), dtype=np.uint64),
               cuda_device)
    assert torch.equal(TK.merge_level(d), TK.merge_level_plain(d))


@pytest.mark.parametrize("nbytes", [1, 40, 64, 65, 96, 2304])
def test_blake2s_words_kernel_matches_hashlib(cuda_device, nbytes):
    rng = np.random.default_rng(nbytes)
    W = -(-nbytes // 4)
    msgs = rng.integers(0, 2**32, size=(257, W), dtype=np.uint64)
    if nbytes % 4:
        msgs[:, -1] &= (1 << (8 * (nbytes % 4))) - 1    # zero past nbytes
    k = TK.blake2s_words(_words(msgs.T, cuda_device), nbytes)
    assert torch.equal(k, TK.blake2s_words_plain(_words(msgs.T, cuda_device),
                                                 nbytes))
    kh = k.cpu().numpy()
    for i in range(257):
        ref = hashlib.blake2s(msgs[i].astype("<u4").tobytes()[:nbytes])
        assert kh[:, i].astype("<u4").tobytes() == ref.digest()


@pytest.mark.parametrize("bits", [0, 1, 8, 12, 16, 17, 20])
def test_grind_kernel_returns_the_minimal_nonce(cuda_device, bits):
    seed = hashlib.blake2s(b"card-%d" % bits).digest()
    want = TK.grind_pow_plain(seed, bits, "cpu", batch=1 << 16)
    assert TK.grind_pow(seed, bits, cuda_device) == want
    # batches of 1024 nonces: the hit falls in a later batch

    def run_batch(base, count):
        return TK.grind_batch(seed, bits, cuda_device, base, count)

    assert TK.grind_search(TK.grind_batches(0, wave=1024), run_batch) == want


def test_grind_kernel_reports_a_batch_without_a_hit(cuda_device):
    seed = hashlib.blake2s(b"card-none").digest()
    want = TK.grind_pow_plain(seed, 12, "cpu", batch=1 << 16)
    assert want > 0
    assert TK.grind_batch(seed, 12, cuda_device, 0, want) == TK.NOT_FOUND
    assert TK.grind_batch(seed, 12, cuda_device, 0, want + 1) == want


def test_grind_searches_from_threads_on_their_own_streams(cuda_device):
    """Searches of one process share the kernel's state words; each still
    gets its own minimal nonce."""
    from concurrent.futures import ThreadPoolExecutor
    seeds = [hashlib.blake2s(b"thread-%d" % i).digest() for i in range(8)]
    want = [TK.grind_pow_plain(s, 12, "cpu", batch=1 << 16) for s in seeds]

    def search(seed):
        with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
            return [TK.grind_pow(seed, 12, cuda_device) for _ in range(50)]

    with ThreadPoolExecutor(max_workers=8) as pool:
        got = list(pool.map(search, seeds))
    assert got == [[w] * 50 for w in want]


def test_fib_proof_on_card_equals_cpu(cuda_device):
    opts = ProofOptions(num_queries=27, blowup_factor=8, grinding_factor=8)
    n = 64
    pub = TF.FibPublicInputs(result=TF.fib_result(n), n_steps=n)
    cpu = prove(TF.FibAir(n, pub, opts), TF.build_fib_trace(n), pub)
    card = prove(TF.FibAir(n, pub, opts),
                 TF.build_fib_trace(n, cuda_device), pub)
    assert card.to_bytes() == cpu.to_bytes()


def test_sdk_prove_defaults_to_the_card(cuda_device):
    from aero_tpu_torch import sdk
    from aero_tpu_torch.ntt import ntt_cuda as nc
    from aero_tpu_torch.sdk.pb import aero_pb2 as pb
    from aero_tpu_torch.vm import fibonacci_source
    program = pb.MidenProgram(program=fibonacci_source(10))
    inputs = pb.MidenProgramInputs(stack_init=[1, 0])
    fast = sdk.options_to_pb(ProofOptions(num_queries=7, blowup_factor=8,
                                          grinding_factor=2))
    nc.reset_launches()
    card = sdk.prove(program, inputs, fast)              # device=None
    assert nc.LAUNCHES["gl_colntt"] > 0
    cpu = sdk.prove(program, inputs, fast, device="cpu")
    assert card.native_proof.to_bytes() == cpu.native_proof.to_bytes()
    assert card.proof.SerializeToString() == cpu.proof.SerializeToString()


@pytest.mark.parametrize("world,exchange", [(1, "device"), (2, "host"),
                                            (4, "host")])
def test_dryrun_on_the_card_equals_the_golden_roots(cuda_device, world,
                                                    exchange):
    """World 1 on nccl; worlds 2 and 4 as processes sharing the card with
    the exchanges staged through pinned host memory and gloo."""
    import json
    from aero_tpu_torch.parallel import dryrun as DR
    with open(DR.GOLDEN_PATH) as f:
        want = json.load(f)["roots"]
    out = DR.dryrun_prove_core(world, 64, exchange=exchange, timeout_s=300)
    assert out.matches_single_device
    assert [list(r) for r in out[:4]] == want
    for r in out.ranks:
        assert r["launches"]["gl_colntt"] > 0
        assert r["launches"]["blake2s_hash_columns"] > 0
        assert r["launches"]["blake2s_merge_level"] > 0


def test_dryrun_never_shares_a_card_unasked(cuda_device):
    from aero_tpu_torch.parallel import dryrun as DR
    more = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="never chosen"):
        DR.rank_devices(more, None, "device")
    assert DR.rank_devices(more, None, "host") == ["cuda:0"] * more


def test_single_device_dryrun_on_the_card_equals_the_golden_roots(
        cuda_device):
    import json
    from aero_tpu_torch.parallel import dryrun as DR
    with open(DR.GOLDEN_PATH) as f:
        want = json.load(f)["roots"]
    got = DR.single_device_dryrun(64)
    assert got["roots"] == want
    assert got["launches"]["gl_colntt"] > 0
