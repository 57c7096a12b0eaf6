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


@pytest.mark.parametrize("logn", range(1, 25))
def test_ntt_kernel_matches_plain(cuda_device, logn):
    """2^1..2^24 points in both directions, batches of 1, 8 and 72 rows
    (72 up to 2^16 and at 2^20 and 2^23, the proof's main shapes; above,
    as far as the plain versions' time goes): the kernel (two launches a
    call) == the four-step plain rendering, 8 rows at a time, and up to
    2^16 == the radix-2 plain transform."""
    rng = np.random.default_rng(logn)
    batches = ((1, 8, 72) if logn <= 16 or logn in (20, 23) else
               (1, 8) if logn <= 20 else (1,))
    for cols in batches:
        x = torch.cat([from_u64(rng.integers(
            0, P, size=(min(8, cols - a), 1 << logn), dtype=np.uint64),
            cuda_device) for a in range(0, cols, 8)])
        for invert in (False, True):
            ntt_cuda.reset_launches()
            k = ntt_cuda.ntt_cuda(x, invert)
            assert ntt_cuda.LAUNCHES == {"gl_colntt": 2, "gl_colntt_lde": 0}
            for a in range(0, cols, 8):
                assert torch.equal(k[a:a + 8], ntt_cuda.ntt_four_step_plain(
                    x[a:a + 8], invert))
            if logn <= 16:
                assert torch.equal(k, ntt_plain(x, invert))
            del k
        assert torch.equal(ntt_cuda.ntt_cuda(ntt_cuda.ntt_cuda(x), True), x)
        del x
    ntt_cuda.clear_table_cache()
    torch.cuda.empty_cache()


@pytest.mark.parametrize("n,world", [(1 << 10, 4), (1 << 18, 4),
                                     (1 << 20, 2)])
def test_ntt_kernel_on_the_local_shapes_of_dist_ntt(cuda_device, n, world):
    """The local transforms of `parallel.dist_ntt` on a rank: a batch of
    (rows, k1 / world, k2) and then of (rows, k2 / world, k1), as its
    transposes hand them over, in both directions."""
    from aero_tpu_torch.parallel.dist_ntt import split_sizes
    k1, k2, l1, l2 = split_sizes(n, world)
    rng = np.random.default_rng(n + world)
    for shape in ((3, l1, k2), (3, l2, k1)):
        x = from_u64(rng.integers(0, P, size=shape, dtype=np.uint64),
                     cuda_device)
        for invert in (False, True):
            k = ntt_cuda.ntt_cuda(x, invert)
            assert torch.equal(k, ntt_cuda.ntt_four_step_plain(x, invert))
            assert torch.equal(k.cpu(), ntt_cuda.ntt_cuda(x.cpu(), invert))


@pytest.mark.parametrize("logn", [10, 12, 14, 16, 18, 20])
def test_lde_route_matches_plain(cuda_device, logn):
    """The coset LDE route (the LDE entry, then one transform pass) at
    2^10..2^20 coefficients and blowup 2..16 == ntt_plain(coset_pad(...)),
    two launches a call."""
    from aero_tpu_torch.spec import field as F
    rng = np.random.default_rng(200 + logn)
    c = from_u64(rng.integers(0, P, size=(2, 1 << logn), dtype=np.uint64),
                 cuda_device)
    for log_blowup in (1, 2, 3, 4):
        for offset in (F.DOMAIN_OFFSET, 5):
            ntt_cuda.reset_launches()
            got = lde(c, log_blowup, offset)
            assert ntt_cuda.LAUNCHES == {"gl_colntt": 1, "gl_colntt_lde": 1}
            assert torch.equal(got, ntt_plain(coset_pad(c, log_blowup,
                                                        offset)))


@pytest.mark.parametrize("max_l,logn,log_blowup", [(8, 4, 3), (8, 6, 3),
                                                   (16, 8, 4)])
def test_lde_route_in_three_passes_on_the_card(cuda_device, max_l, logn,
                                               log_blowup):
    """The pass limit lowered: the LDE entry is the outer pass, then two
    inner launches and one a row."""
    rng = np.random.default_rng(300 + logn)
    c = from_u64(rng.integers(0, P, size=(3, 1 << logn), dtype=np.uint64),
                 cuda_device)
    ntt_cuda.reset_launches()
    got = ntt_cuda.lde_cuda(c, log_blowup, max_l=max_l)
    assert ntt_cuda.LAUNCHES == {"gl_colntt": 1 + 3, "gl_colntt_lde": 1}
    assert torch.equal(got, ntt_plain(coset_pad(c, log_blowup)))
    assert torch.equal(got.cpu(), ntt_cuda.lde_cuda(c.cpu(), log_blowup,
                                                    max_l=max_l))


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
    ntt_cuda.reset_launches()
    got = lde(c, 3).reshape(n, 8)
    assert ntt_cuda.LAUNCHES == {"gl_colntt": 2, "gl_colntt_lde": 1}
    w_m = F.get_root_of_unity(25)
    for t in range(8):
        sc = power_series(F.mul(F.DOMAIN_OFFSET, F.exp(w_m, t)), n,
                          device=cuda_device)
        assert torch.equal(got[:, t], ntt_cuda.ntt_cuda(mul(c, sc))[0])
    ntt_cuda.clear_table_cache()


# words whose adds carry past 2^64, and p - 1 beside a small word, whose
# sum lands in [p, 2^64): kernel 1 holds such sums lazily between stores
CARRY_WORDS = np.array([P - 1, P - 2, 0, 1, 2, 1 << 63, P - (1 << 31), P - 7],
                       dtype=np.uint64)


def _adversarial(kind, shape, device):
    if kind == "p_minus_1":
        return _words(np.full(shape, P - 1, dtype=np.uint64), device)
    idx = np.random.default_rng(24).integers(0, len(CARRY_WORDS), size=shape)
    return _words(CARRY_WORDS[idx], device)


@pytest.mark.parametrize("kind", ["p_minus_1", "carries"])
@pytest.mark.parametrize("route,rows,logn", [
    ("lde", 72, 20), ("ntt", 8, 20), ("ntt", 1, 23), ("ntt", 8, 17)])
def test_kernel_1_on_adversarial_columns(cuda_device, kind, route, rows,
                                         logn):
    """Kernel 1's lazy words at the cells' shapes (the main LDE 72 x 2^20
    -> 2^23, 8 x 2^20, 2^23 x 1, 2^17; transforms in both directions) on
    columns of p - 1 and of words whose adds carry: torch.equal to the
    plain route, 8 rows at a time, and every word it stores canonical."""
    x = _adversarial(kind, (rows, 1 << logn), cuda_device)
    runs = ([(lde(x, 3), lambda a: ntt_cuda.ntt_four_step_plain(
        coset_pad(x[a:a + 8], 3), False))] if route == "lde" else
        [(ntt_cuda.ntt_cuda(x, inv), lambda a, inv=inv:
          ntt_cuda.ntt_four_step_plain(x[a:a + 8], inv))
         for inv in (False, True)])
    for got, plain in runs:
        # canonical: below p as a u64, so not in [p - 2^64, 0) as an int64
        assert not bool(((got < 0) & (got >= P - (1 << 64))).any())
        for a in range(0, rows, 8):
            assert torch.equal(got[a:a + 8], plain(a))
    del runs
    ntt_cuda.clear_table_cache()
    torch.cuda.empty_cache()


LAZY_CHECK = r"""
#include "goldilocks.cuh"
extern "C" __global__ void lazy_ops(const u64* a, const u64* b, u64* out,
                                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    out[3 * i] = gl_add_lazy(a[i], b[i]);
    out[3 * i + 1] = gl_sub_lazy(a[i], b[i]);
    out[3 * i + 2] = gl_mul_lazy(a[i], b[i]);
  }
}
extern "C" int run_lazy_ops(const u64* a, const u64* b, u64* out, int n) {
  lazy_ops<<<(n + 255) / 256, 256>>>(a, b, out, n);
  return (int)cudaDeviceSynchronize();
}
"""


def test_lazy_forms_on_the_card_are_congruent_to_the_field_ops(cuda_device,
                                                              tmp_path):
    """`gl_add_lazy`, `gl_sub_lazy` and `gl_mul_lazy` as the card computes
    them (csrc/goldilocks.cuh built by nvcc), on every pair of edge words
    (2^64 - 1 plus itself carries twice, 0 less 2^64 - 1 borrows twice)
    and seeded random words: each result congruent mod p to the exact
    one."""
    import ctypes
    import subprocess

    from aero_tpu_torch import _build
    src = tmp_path / "lazy.cu"
    src.write_text(LAZY_CHECK)
    so = tmp_path / "lazy.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                    str(_build.CSRC), str(src), "-o", str(so)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.run_lazy_ops.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    eps = (1 << 32) - 1
    edge = [0, 1, 2, eps, eps + 1, P - 1, P, P + 1, 1 << 63,
            (1 << 64) - eps - 1, (1 << 64) - 2, (1 << 64) - 1]
    words = edge + [int(v) for v in np.random.default_rng(25).integers(
        0, 1 << 64, 60, dtype=np.uint64)]
    a = [u for u in words for _ in words]
    b = [v for _ in words for v in words]
    out = torch.empty(3 * len(a), dtype=torch.int64, device=cuda_device)
    ta, tb = (_words(np.array(w, dtype=np.uint64), cuda_device)
              for w in (a, b))
    assert lib.run_lazy_ops(ta.data_ptr(), tb.data_ptr(), out.data_ptr(),
                            len(a)) == 0
    got = out.cpu().numpy().view(np.uint64).reshape(-1, 3)
    for i, (u, v) in enumerate(zip(a, b)):
        for k, exact in enumerate((u + v, u - v, u * v)):
            assert (int(got[i, k]) - exact) % P == 0, (k, hex(u), hex(v))


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


def test_scale_program_on_the_card_equals_aero_tpus_proof(cuda_device):
    """`long_fib_source(1360)` at 2^14 rows, default options, through
    `sdk.prove` on the card: byte for byte `aero_tpu`'s proof, committed
    under tests/golden/torch_port/."""
    import os
    from aero_tpu_torch import sdk
    from aero_tpu_torch.sdk.pb import aero_pb2 as pb
    from aero_tpu_torch.tools.proof_diff import first_difference
    from bench_gpu import long_fib_source
    log_rows = 14
    path = os.path.join(os.path.dirname(__file__), "golden", "torch_port",
                        f"miden_longfib_2e{log_rows}.bin")
    with open(path, "rb") as f:
        want = f.read()
    program = pb.MidenProgram(
        program=long_fib_source(((1 << log_rows) - 64) // 12))
    inputs = pb.MidenProgramInputs(stack_init=[1, 0])   # top-first [0, 1]
    got = sdk.prove(program, inputs, min_rows=1 << log_rows)
    data = got.native_proof.to_bytes()
    assert first_difference(data, want) is None
    assert data == want


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


@pytest.mark.parametrize("log_rows", [14, 20])
def test_the_syncs_counter_equals_the_profilers_synchronizing_calls(
        cuda_device, log_rows):
    """Two proofs of `long_fib_source` at 2^14 and 2^20 rows under
    torch.profiler, the first possibly cold: the `syncs` that the tracer
    counts inside each `prove_program` equal the stream and device
    synchronizes and synchronous copies that the profiler records inside
    that span's range. A miss is a wait the counter does not see."""
    from torch.profiler import ProfilerActivity, profile
    from aero_tpu_torch.utils import get_tracer, subtree_count
    from aero_tpu_torch.utils.tracing import profiled_syncs
    from bench_gpu import _prepare, long_fib_source
    prep = _prepare(long_fib_source(((1 << log_rows) - 64) // 12), [0, 1],
                    1 << log_rows, 16, cuda_device)
    tracer = get_tracer()
    tracer.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            prove(prep.air, prep.trace, prep.pub)
    roots = sorted((r for r in tracer.records if r.name == "prove_program"),
                   key=lambda r: r.index)
    counted = [subtree_count(tracer.records, r, "syncs") for r in roots]
    tracer.reset()
    assert len(counted) == 2 and min(counted) > 0
    assert any(e.name == "cudaLaunchKernel" for e in prof.events()), \
        "the profiler recorded no runtime calls"
    assert profiled_syncs(prof, "prove_program") == counted


def _merkle_opens(records):
    """The `syncs` counted in each `merkle_open` span, in order."""
    from aero_tpu_torch.utils import subtree_count
    return [subtree_count(records, r, "syncs") for r in
            sorted(records, key=lambda r: r.index) if r.name == "merkle_open"]


@pytest.mark.parametrize("n", [2, 8, 256, 1 << 17])
def test_openings_on_the_card_equal_the_spec_tree(cuda_device, n):
    """A CUDA tree opens in one `merkle_gather` launch and one wait, with
    the spec host tree's bytes (`prove_batch`'s leaves and serialized
    nodes, `prove`), and again after a `to("cpu")` / `to("cuda")` round
    trip of its levels."""
    from aero_tpu_torch.merkle import commit_digests
    from aero_tpu_torch.spec.merkle import MerkleTree
    from aero_tpu_torch.utils import get_tracer
    rng = np.random.default_rng(n)
    words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.int64)
    spec = MerkleTree([w.astype("<u4").tobytes() for w in words])
    tree = commit_digests(torch.from_numpy(words).to(cuda_device))
    assert tree.root == spec.root
    half = (n // 2) & ~1
    sets = [[n // 3], [half, half + 1], [(n // 4) * 2 + 1], [n - 1]]
    if n == 8:
        sets.append(list(range(8)))
    if n >= 27:
        sets.append([int(i) for i in rng.choice(n, size=27, replace=False)])
    tracer = get_tracer()
    for device in (cuda_device, "cpu", cuda_device):
        tree.to(device)
        assert all(lvl.device.type == torch.device(device).type
                   for lvl in tree.levels)
        for idxs in sets:
            tracer.reset()
            TK.reset_launches()
            got, want = tree.prove_batch(idxs), spec.prove_batch(idxs)
            on_card = torch.device(device).type == "cuda"
            assert TK.LAUNCHES["merkle_gather"] == int(on_card)
            assert _merkle_opens(tracer.records) == [int(on_card)]
            assert got.leaves == want.leaves
            assert got.serialize_nodes() == want.serialize_nodes()
            for i in idxs:
                assert tree.prove(i) == spec.prove(i)
    tracer.reset()


def test_a_proof_opens_each_tree_in_one_launch_and_one_wait(cuda_device):
    """A 2^14-row proof: its six batch openings (the trace, aux and
    constraint trees and three FRI layers) count one `syncs` each inside
    `merkle_open` and one `merkle_gather` launch each."""
    from aero_tpu_torch.utils import get_tracer
    from bench_gpu import _prepare, long_fib_source
    prep = _prepare(long_fib_source(((1 << 14) - 64) // 12), [0, 1],
                    1 << 14, 16, cuda_device)
    prove(prep.air, prep.trace, prep.pub)           # warm
    tracer = get_tracer()
    tracer.reset()
    TK.reset_launches()
    prove(prep.air, prep.trace, prep.pub)
    opens = _merkle_opens(tracer.records)
    tracer.reset()
    assert opens == [1] * 6
    assert TK.LAUNCHES["merkle_gather"] == 6


@pytest.mark.parametrize("rows", [64, 1 << 14])
@pytest.mark.parametrize("world,exchange", [(1, "device"), (2, "host"),
                                            (4, "host")])
def test_dryrun_on_the_card_equals_the_golden_roots(cuda_device, world,
                                                    exchange, rows):
    """World 1 on nccl; worlds 2 and 4 as processes sharing the card with
    the exchanges staged through pinned host memory and gloo; at 64 rows
    and at 2^14 rows (`aero_tpu`'s roots there, made on the CPU)."""
    from aero_tpu_torch.parallel import dryrun as DR
    want = DR.golden_roots(rows)
    out = DR.dryrun_prove_core(world, rows, exchange=exchange, timeout_s=300)
    assert out.matches_single_device
    assert [list(r) for r in out[:4]] == want
    for r in out.ranks:
        assert r["launches"]["gl_colntt"] > 0
        assert r["launches"]["blake2s_hash_columns"] > 0
        assert r["launches"]["blake2s_merge_level"] > 0


def test_dryrun_in_narrow_chunks_equals_one_chunk_and_bounds_its_peak(
        cuda_device):
    """World 1 on nccl at 2^20 rows: the LDEs 5 columns a chunk (the last
    of the 72 two, of the 9 four) give the roots of all columns at once
    and of the single device. Each run's pipeline peak stays below its
    set-up peak plus what its LDEs hold: the coefficients and evaluations
    of the main, aux and composition columns and one chunk's transients
    (`dist_ntt.chunk_bytes`)."""
    from aero_tpu_torch.parallel import dryrun as DR
    from aero_tpu_torch.parallel.dist_ntt import chunk_bytes
    n = 1 << 20
    m = 8 * n
    narrow = DR.dryrun_prove_core(1, n, cols_per_chunk=5, timeout_s=600)
    assert narrow.matches_single_device
    whole = DR.dryrun_prove_core(1, n, cols_per_chunk=72,
                                 reference=[list(r) for r in narrow[:4]],
                                 timeout_s=600)
    assert whole.matches_single_device
    for out, c in ((narrow, 5), (whole, 72)):
        (r,) = out.ranks
        assert r["chunk_cols"] == [c, min(c, 9), min(c, 8)]
        lde_bytes = 8 * (72 + 9 + 8) * (n + m) + chunk_bytes(c, n, m)
        assert 0 < r["peak_device_bytes"] < (r["setup_peak_device_bytes"]
                                             + lde_bytes)


def test_dryrun_never_shares_a_card_unasked(cuda_device):
    from aero_tpu_torch.parallel import dryrun as DR
    more = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="never chosen"):
        DR.rank_devices(more, None, "device")
    assert DR.rank_devices(more, None, "host") == ["cuda:0"] * more


@pytest.mark.parametrize("rows", [64, 1 << 14])
def test_single_device_dryrun_on_the_card_equals_the_golden_roots(
        cuda_device, rows):
    from aero_tpu_torch.parallel import dryrun as DR
    got = DR.single_device_dryrun(rows)
    assert got["roots"] == DR.golden_roots(rows)
    assert got["launches"]["gl_colntt"] > 0


# ------------------------------------------- field kernels (csrc/field.cu)

def _felts(rng, shape, device):
    """Canonical felts with the edge values 0, 1, p - 1 and 2^32 first."""
    vals = rng.integers(0, P, size=shape, dtype=np.uint64).reshape(-1)
    edge = np.array([0, 1, P - 1, 1 << 32, (1 << 32) - 1], dtype=np.uint64)
    vals[:min(len(edge), vals.size)] = edge[:vals.size]
    return from_u64(vals.reshape(shape), device)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("n", [1, 5, 1000, 1 << 21])
def test_elementwise_kernel_matches_plain(cuda_device, op, n):
    from aero_tpu_torch.field import gl, gl_cuda
    rng = np.random.default_rng(n)
    a, b = _felts(rng, (n,), cuda_device), _felts(rng, (n,), cuda_device)
    b = b.flip(0).contiguous()
    gl_cuda.reset_launches()
    got = getattr(gl, op)(a, b)
    assert gl_cuda.LAUNCHES["gl_elementwise"] == 1
    assert gl_cuda.LAUNCHES["gl_elementwise_copies"] == 0
    assert torch.equal(got, getattr(gl, op + "_plain")(a, b))
    # a 0-d operand on either side, read from device memory
    s = gl.scalar(P - 2, cuda_device)
    assert torch.equal(getattr(gl, op)(a, s), getattr(gl, op + "_plain")(a, s))
    assert torch.equal(getattr(gl, op)(s, a), getattr(gl, op + "_plain")(s, a))


@pytest.mark.parametrize("case", ["row", "cyclic", "both", "trailing",
                                  "column_slice", "every_other",
                                  "transposed", "three_dims"])
def test_elementwise_kernel_broadcasts_and_strides(cuda_device, case):
    """Broadcasts and strided views are read in place; an operand that
    keeps three dims after collapsing ("three_dims") is copied first and
    the copy counted."""
    from aero_tpu_torch.field import gl, gl_cuda
    rng = np.random.default_rng(7)

    def f(shape):
        return _felts(rng, shape, cuda_device)

    a, b = {"row": lambda: (f((6, 1000)), f((6, 1))),
            "cyclic": lambda: (f((6, 1000)), f((1000,))),
            "both": lambda: (f((1, 7)), f((5, 1))),
            "trailing": lambda: (f((3, 4, 5)), f((4, 5))),
            "column_slice": lambda: (f((8, 600))[:, 100:400], f((8, 300))),
            "every_other": lambda: (f((8, 600))[:, ::2], f((8, 300))),
            "transposed": lambda: (f((300, 8)).T, f((8, 300))),
            "three_dims": lambda: (f((3, 5, 64)), f((3, 1, 64)))}[case]()
    gl_cuda.reset_launches()
    for op in ("add", "sub", "mul"):
        assert torch.equal(getattr(gl, op)(a, b),
                           getattr(gl, op + "_plain")(a, b))
        assert torch.equal(getattr(gl, op)(b, a),
                           getattr(gl, op + "_plain")(b, a))
    assert gl_cuda.LAUNCHES["gl_elementwise"] == 6
    assert gl_cuda.LAUNCHES["gl_elementwise_copies"] == \
        (6 if case == "three_dims" else 0)


@pytest.mark.parametrize("e", [0, 1, 2, 3, 7, (1 << 23) + 5, P - 2,
                               (1 << 64) - 1])
def test_pow_kernel_matches_plain(cuda_device, e):
    from aero_tpu_torch.field import gl, gl_cuda
    x = _felts(np.random.default_rng(3), (4099,), cuda_device)
    gl_cuda.reset_launches()
    got = gl.pow_loop(x, e)
    assert gl_cuda.LAUNCHES["gl_elementwise"] == 1
    assert torch.equal(got, gl.pow_loop_plain(x, e))
    assert torch.equal(gl.pow_loop(x[::3], e), gl.pow_loop_plain(x[::3], e))
    if e == P - 2:
        assert torch.equal(gl.inv(x), gl.inv_plain(x))


@pytest.mark.parametrize("shape", [(1,), (7,), (2048,), (2049,), (3, 4097),
                                   (4, (1 << 20) - 1), (3, 1 << 20),
                                   (2, 1 << 23), (1024, 4097)])
def test_scan_kernel_matches_plain(cuda_device, shape):
    """One launch a scan, the chained scan's look-back across 2 048 tiles
    of 4 096 a row ((2, 2^23)) and over many short rows ((1024, 4097)); 20
    rounds on fresh inputs, since an ordering race between the tiles shows
    only now and then, as a wrong value."""
    from aero_tpu_torch.field import gl, gl_cuda
    rng = np.random.default_rng(len(shape) + shape[-1])
    for _ in range(20):
        x = _felts(rng, shape, cuda_device)
        for name in ("gf_cumprod", "gf_cumsum"):
            gl_cuda.reset_launches()
            got = getattr(gl, name)(x)
            assert gl_cuda.LAUNCHES["gl_scan"] == 1
            assert torch.equal(got, getattr(gl, name + "_plain")(x))
    if len(shape) == 2:
        assert torch.equal(gl.gf_cumprod(x, axis=0),
                           gl.gf_cumprod_plain(x, axis=0))


@pytest.mark.parametrize("shape,zero", [((4, (1 << 20) - 1), (2, 12345)),
                                        ((3, 1 << 20), (0, 0)),
                                        ((3, 9), (1, 8)), ((1,), None),
                                        ((2, 1 << 23), (1, 4097)),
                                        ((1024, 4097), (1023, 4096))])
def test_batch_inv_on_the_card_keeps_the_zero_rule(cuda_device, shape, zero):
    """A zero anywhere in a row makes that row's output all zero; the
    other rows are the inverses. One call, three launches."""
    from aero_tpu_torch.field import gl, gl_cuda
    x = _felts(np.random.default_rng(11), shape, cuda_device)
    x[x == 0] = 5
    if zero is not None:
        x[zero] = 0
    gl_cuda.reset_launches()
    got = gl.batch_inv(x, axis=-1)
    assert gl_cuda.LAUNCHES["gl_batch_inv"] == 3
    assert gl_cuda.LAUNCHES["gl_scan"] == gl_cuda.LAUNCHES["gl_elementwise"] \
        == 0
    assert torch.equal(got, gl.batch_inv_plain(x, axis=-1))
    if zero is not None:
        assert not bool(got[zero[0]].any())
        others = [r for r in range(shape[0]) if r != zero[0]]
        assert torch.equal(gl.mul(got[others], x[others]),
                           torch.ones_like(x[others]))


@pytest.mark.parametrize("at", ["first", "tile_end", "tile_start", "last"])
def test_batch_inv_kernel_zero_at_tile_edges(cuda_device, at):
    """A zero at 0, 2047, 2048 (either side of the first tile edge) or
    n - 1 of one row and none in the others, 20 rounds on fresh inputs;
    also along the first axis, which is copied to rows first."""
    from aero_tpu_torch.field import gl, gl_cuda
    rows, n = 3, 3 * 2048 + 5
    j = {"first": 0, "tile_end": 2047, "tile_start": 2048,
         "last": n - 1}[at]
    rng = np.random.default_rng(j)
    for _ in range(20):
        x = _felts(rng, (rows, n), cuda_device)
        x[x == 0] = 7
        x[1, j] = 0
        got = gl.batch_inv(x)
        assert torch.equal(got, gl.batch_inv_plain(x))
        assert not bool(got[1].any())
        assert torch.equal(gl.mul(got[::2], x[::2]),
                           torch.ones_like(x[::2]))
    t = x.T.contiguous()
    gl_cuda.reset_launches()
    assert torch.equal(gl.batch_inv(t, axis=0), gl.batch_inv_plain(t, axis=0))
    assert gl_cuda.LAUNCHES["gl_batch_inv"] == 3
    assert gl_cuda.LAUNCHES["gl_elementwise_copies"] == 1


def test_field_wrappers_refuse_a_cpu_tensor(cuda_device):
    """No fallback: the K2 wrappers take CUDA tensors only."""
    from aero_tpu_torch.field import gl_cuda
    cpu = torch.ones(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        gl_cuda.scan(cpu, gl_cuda.MUL)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        gl_cuda.batch_inv(cpu)


@pytest.mark.parametrize("widths,m,ld", [((5, 2, 2), 256, 2048),
                                         ((72, 9, 8), 4099, 4099),
                                         ((2, 0, 8), 1000, 3000),
                                         ((72, 9, 8), 1 << 20, 1 << 21)])
def test_deep_combine_kernel_matches_plain(cuda_device, widths, m, ld):
    """LDE rows read at the whole domain's row stride; no aux segment when
    its width is 0."""
    from aero_tpu_torch.prover import prover as PR
    wm, wa, wc = widths
    rng = np.random.default_rng(m + wm)
    a0 = ld - m
    main = _felts(rng, (wm, ld), cuda_device)[:, a0:]
    aux = _felts(rng, (wa, ld), cuda_device)[:, a0:] if wa else None
    comp = _felts(rng, (wc, ld), cuda_device)[:, a0:]
    x = _felts(rng, (m,), cuda_device)
    vec = [_felts(rng, (k,), cuda_device)
           for k in (wm + wa, wm + wa, wc, wm + wa, wm + wa, wc)]
    zs = [PR.scalar(int(v), cuda_device) for v in rng.integers(0, P, 5,
                                                               np.uint64)]
    PR.gl_cuda.reset_launches()
    got = PR._deep_core(main, aux, comp, x, *vec, *zs)
    assert PR.gl_cuda.LAUNCHES["gl_deep_combine"] == 1
    assert PR.gl_cuda.LAUNCHES["gl_elementwise_copies"] == 0
    assert torch.equal(got, PR._deep_core_plain(main, aux, comp, x, *vec,
                                                *zs))


def test_miden_proof_on_card_equals_cpu_through_the_field_kernels(
        cuda_device):
    """A 64-row Miden proof: equal bytes, every field kernel launched, one
    kernel a field multiply."""
    from aero_tpu_torch import sdk
    from aero_tpu_torch.field import gl, gl_cuda
    from aero_tpu_torch.sdk.pb import aero_pb2 as pb
    from aero_tpu_torch.vm import fibonacci_source
    program = pb.MidenProgram(program=fibonacci_source(10))
    inputs = pb.MidenProgramInputs(stack_init=[1, 0])
    fast = sdk.options_to_pb(ProofOptions(num_queries=7, blowup_factor=8,
                                          grinding_factor=2))
    gl_cuda.reset_launches()
    card = sdk.prove(program, inputs, fast, min_rows=64, device=cuda_device)
    for name in ("gl_elementwise", "gl_scan", "gl_batch_inv",
                 "gl_deep_combine", "miden_frag_eval"):
        assert gl_cuda.LAUNCHES[name] > 0, name
    cpu = sdk.prove(program, inputs, fast, min_rows=64, device="cpu")
    assert card.native_proof.to_bytes() == cpu.native_proof.to_bytes()
    a = _felts(np.random.default_rng(0), (1 << 10,), cuda_device)
    gl_cuda.reset_launches()
    gl.mul(a, a)
    assert gl_cuda.LAUNCHES == {**{k: 0 for k in gl_cuda.LAUNCHES},
                                "gl_elementwise": 1}


def _k5_merger(air_name, log_rows, device, rng, first=0, length=None):
    """A MidenAir or FibAir of 2^log_rows rows with seeded rands and
    coefficients, and its merger over the LDE domain's positions first ..
    first + length - 1 on the card (the whole domain by default)."""
    from aero_tpu_torch.air import miden as TM
    from aero_tpu_torch.prover import prover as PR
    from aero_tpu_torch.sdk import DEFAULT_OPTIONS
    from aero_tpu_torch.vm import execute_full, fibonacci_source, program_hash
    n = 1 << log_rows
    if air_name == "miden":
        src = fibonacci_source(10)
        _, out, ovf = execute_full(src, [0, 1], min_rows=64)
        pub = TM.make_public_inputs(program_hash(src), [0, 1], out,
                                    overflow=ovf)
        air = TM.MidenAir(n, pub, DEFAULT_OPTIONS, program=src)
    else:
        air = TF.FibAir(n, TF.FibPublicInputs(
            int(rng.integers(0, P, dtype=np.uint64)), n),
                        ProofOptions(num_queries=7, blowup_factor=8,
                                     grinding_factor=2))
    rands = [int(v) for v in rng.integers(0, P, air.aux_rands, np.uint64)]
    air._aux_rand = rands
    cc_t = [tuple(int(v) for v in rng.integers(0, P, 2, np.uint64))
            for _ in range(air.num_transition_constraints)]
    cc_b = [tuple(int(v) for v in rng.integers(0, P, 2, np.uint64))
            for _ in range(air.num_assertions)]
    return PR.ConstraintMerger(air, rands, cc_t, cc_b,
                               PR.ceval_domain(air, device, first, length),
                               device, first=first)


def _k5_fragment(merger, frames, a0):
    """K5 through `merger.fragment` under a span: (the merged row, its
    launches, the span's `frames_in_place`). No K1 launch makes its
    x^adj rows any more."""
    from aero_tpu_torch.field import gl_cuda
    from aero_tpu_torch.utils import get_tracer, span
    gl_cuda.reset_launches()
    with span("k5_probe"):
        got = merger.fragment(*frames, a0)
    rec = get_tracer().records[-1]
    assert rec.name == "k5_probe"
    return got, dict(gl_cuda.LAUNCHES), rec.counters.get("frames_in_place",
                                                          0)


@pytest.mark.parametrize("air_name,log_rows,where", [
    ("miden", 6, "start"), ("miden", 6, "wrap"), ("miden", 6, "zeros"),
    ("miden", 17, "wrap"), ("fib", 6, "wrap"), ("fib", 6, "zeros"),
    ("fib", 17, "start")])
def test_frag_eval_kernel_matches_plain_and_eager(cuda_device, air_name,
                                                  log_rows, where):
    """K5 on a fragment of half the domain (the first, or the last, whose
    nxt frame wraps around and is read in place, its body and the domain's
    head), 20 times on fresh frames: the merged row equal to the plain
    version and to the eager path (the AIR's evaluate_transitions, one K1
    launch a field op, then `constraint_merge_plain`); the transition
    values equal to
    evaluate_transitions op by op; one launch, no K1 launch (K5 makes its
    own x^adj values). "zeros": every other row of the frames zero."""
    from aero_tpu_torch.field import gl_cuda
    from aero_tpu_torch.prover import prover as PR
    rng = np.random.default_rng(log_rows * 7 + len(where))
    merger = _k5_merger(air_name, log_rows, cuda_device, rng)
    air = merger.air
    m = merger.x_dom.shape[-1]
    m_frag = m // 2
    a0 = 0 if where == "start" else m - m_frag
    for _ in range(20):
        main = _felts(rng, (air.main_width, m), cuda_device)
        aux = _felts(rng, (air.aux_width, m), cuda_device)
        if where == "zeros":
            main[::2] = 0
            aux[::2] = 0
        frames = (PR._frame(main, a0, m_frag),
                  PR._frame(main, a0 + 8, m_frag),
                  PR._frame(aux, a0, m_frag), PR._frame(aux, a0 + 8, m_frag))
        wraps = a0 + 8 + m_frag > m
        assert isinstance(frames[1], PR.Wrapped) == wraps
        got, launched, in_place = _k5_fragment(merger, frames, a0)
        assert launched[f"{air_name}_frag_eval"] == 1
        assert launched["gl_elementwise"] == 0
        assert launched["gl_elementwise_copies"] == 0
        assert in_place == int(wraps)
        whole = [PR.joined(f) for f in frames]
        assert torch.equal(got, merger.fragment_plain(*whole, a0))
        assert torch.equal(got, PR.constraint_merge_plain(
            *merger.merge_inputs(*whole, a0)))
        t_k5 = gl_cuda.frag_eval(*merger.k5_inputs(*frames, a0),
                                 transitions=True)
        eager = air.evaluate_transitions(*whole, merger.rands)
        assert t_k5.shape == (len(eager), m_frag)
        for k, ev in enumerate(eager):
            assert torch.equal(t_k5[k], ev), f"constraint {k}"


@pytest.mark.parametrize("air_name,log_rows,m_frag,where", [
    ("miden", 6, 255, "odd"), ("fib", 6, 255, "odd"),
    ("miden", 6, 129, "wrap"), ("fib", 6, 1, "odd"),
    ("miden", 18, 1 << 20, "start"), ("miden", 18, 1 << 20, "wrap"),
    ("fib", 18, 1 << 20, "wrap"), ("miden", 6, 129, "block"),
    ("miden", 18, 1 << 19, "block"), ("fib", 18, 1 << 19, "block")])
def test_frag_eval_kernel_at_odd_and_dry_run_fragments(cuda_device, air_name,
                                                       log_rows, m_frag,
                                                       where):
    """K5 on fragments of an odd number of points (from an odd offset, or
    the last points of the domain, whose nxt frame wraps and is read in
    place), where the last block holds fewer points than threads; on the
    fragments of 2^20 points of a 2^18-row trace's 2^21-point domain; and
    on a mesh block's last fragment ("block": rank 1 of 2, its merger from
    domain position m / 2 on, nxt the block's tail and the halo, the next
    block's first points copied out as `next_points` receives them): the
    merged row and the transition values equal to the plain version, no K1
    launch. A block's merged row also equals the whole domain's merger's
    at the same points (the same coefficients)."""
    from aero_tpu_torch.air import symbolic
    from aero_tpu_torch.field import gl_cuda
    from aero_tpu_torch.prover import prover as PR
    seed = log_rows * 131 + m_frag
    merger = _k5_merger(air_name, log_rows, cuda_device,
                        np.random.default_rng(seed))
    air = merger.air
    m = merger.x_dom.shape[-1]
    rng = np.random.default_rng(seed + 1)
    main = _felts(rng, (air.main_width, m), cuda_device)
    aux = _felts(rng, (air.aux_width, m), cuda_device)
    if where == "block":
        whole = merger
        m_blk = m // 2
        merger = _k5_merger(air_name, log_rows, cuda_device,
                            np.random.default_rng(seed), m_blk, m_blk)
        a0 = m_blk - m_frag
        frames = []
        for x in (main, aux):
            block, halo = x[:, m_blk:], x[:, :8].clone()
            frames += [block[:, a0:], PR.Wrapped(block[:, a0 + 8:], halo)]
    else:
        a0 = {"odd": 3, "start": 0, "wrap": m - m_frag}[where]
        frames = (PR._frame(main, a0, m_frag),
                  PR._frame(main, a0 + 8, m_frag),
                  PR._frame(aux, a0, m_frag),
                  PR._frame(aux, a0 + 8, m_frag))
    wraps = isinstance(frames[1], PR.Wrapped)
    assert wraps == (where in ("wrap", "block"))
    got, launched, in_place = _k5_fragment(merger, frames, a0)
    assert launched[f"{air_name}_frag_eval"] == 1
    assert launched["gl_elementwise"] == 0
    assert launched["gl_elementwise_copies"] == 0
    assert in_place == int(wraps)
    assert got.shape == (m_frag,)
    assert torch.equal(got, merger.fragment_plain(*frames, a0))
    if where == "block":
        assert torch.equal(got, whole.fragment(*(
            PR._frame(x, m_blk + a0 + s, m_frag) for x in (main, aux)
            for s in (0, 8)), m_blk + a0))
    t_k5 = gl_cuda.frag_eval(*merger.k5_inputs(*frames, a0),
                             transitions=True)
    assert torch.equal(t_k5, torch.stack(symbolic.interpret(
        symbolic.trace(type(air)), *(PR.joined(f) for f in frames),
        merger.rands)))


@pytest.mark.parametrize("log_frag", [10, 13])
def test_golden_proof_reads_its_wrapping_frame_in_place(cuda_device,
                                                       monkeypatch, log_frag):
    """The 1024-row golden proof (fib(10), default options, an 8192-point
    domain) in fragments of 2^10 points (8, the last wrapping) or as one:
    its bytes keep the committed sha256 of `aero_tpu`'s proof, each
    fragment is one K5 launch with no K1 launch inside `frag_eval`, and
    the span reads `frames_in_place` 1."""
    import json
    import os
    from aero_tpu_torch import sdk
    from aero_tpu_torch.field import gl_cuda
    from aero_tpu_torch.prover import prover as PR
    from aero_tpu_torch.sdk.pb import aero_pb2 as pb
    from aero_tpu_torch.utils import get_tracer
    from aero_tpu_torch.vm import fibonacci_source
    path = os.path.join(os.path.dirname(__file__), "golden", "torch_port",
                        "miden_fib10_1024.json")
    with open(path) as f:
        want = json.load(f)
    monkeypatch.setattr(PR, "FRAG", 1 << log_frag)
    seen = []
    frag_eval = gl_cuda.frag_eval

    def counted(*args, **kwargs):
        before = gl_cuda.LAUNCHES["gl_elementwise"]
        out = frag_eval(*args, **kwargs)
        seen.append(gl_cuda.LAUNCHES["gl_elementwise"] - before)
        return out

    monkeypatch.setattr(gl_cuda, "frag_eval", counted)
    gl_cuda.reset_launches()
    res = sdk.prove(pb.MidenProgram(program=fibonacci_source(10)),
                    pb.MidenProgramInputs(stack_init=[1, 0]), min_rows=1024,
                    device=cuda_device)
    data = res.native_proof.to_bytes()
    assert hashlib.sha256(data).hexdigest() == want["sha256"]
    assert len(data) == want["length"]
    n_frags = (8 << 10) >> log_frag
    assert gl_cuda.LAUNCHES["miden_frag_eval"] == n_frags
    assert seen == [0] * n_frags
    frag = [r for r in get_tracer().records if r.name == "frag_eval"][-1]
    assert frag.meta["n_frags"] == n_frags
    assert frag.counters.get("frames_in_place") == 1


def test_frag_eval_refuses_a_stale_generated_file(cuda_device, monkeypatch):
    """No fallback: a generated file the AIR no longer traces to raises on
    the card, and so does a fragment of an AIR class without a generated
    kernel: on the card every fragment is K5."""
    from aero_tpu_torch.air import generated, symbolic
    from aero_tpu_torch.air import miden as TM
    from aero_tpu_torch.prover import prover as PR
    merger = _k5_merger("fib", 6, cuda_device, np.random.default_rng(5))
    m = merger.x_dom.shape[-1]
    main = _felts(np.random.default_rng(6), (2, m), cuda_device)
    aux = _felts(np.random.default_rng(7), (1, m), cuda_device)
    frames = (main, PR.joined(PR._frame(main, 8, m)), aux,
              PR.joined(PR._frame(aux, 8, m)))
    monkeypatch.setattr(generated, "_current", {})
    monkeypatch.setattr(generated, "trace",
                        lambda cls: symbolic.trace(TM.MidenAir))
    with pytest.raises(RuntimeError, match="stale"):
        merger.fragment(*frames, 0)

    class Edited(TF.FibAir):
        pass

    merger.air = object.__new__(Edited)
    with pytest.raises(ValueError, match="no generated kernel"):
        merger.fragment(*frames, 0)


@pytest.mark.parametrize("n,pad", [(64, 0), (1000, 0), (1000, 7),
                                   (1 << 16, 0), (1 << 18, 5)])
def test_aux_factors_kernel_matches_plain_and_op_by_op(cuda_device, n, pad):
    """K6 over a random (72, n) trace, read in place (as a view of a wider
    array with `pad` extra columns): its eight rows equal the traced
    program in the plain ops (`symbolic.interpret`) and `_bus_row_factors`
    op by op on the card (one K1 launch a field op) over the trace's roll
    by one row."""
    from aero_tpu_torch.air import generated, symbolic
    from aero_tpu_torch.air import miden as TM
    from aero_tpu_torch.field import gl_cuda, scalar
    rng = np.random.default_rng(n + pad)
    wide = _felts(rng, (72, n + pad), cuda_device)
    trace = wide[:, :n]
    rands = [int(v) for v in rng.integers(0, P, 16, np.uint64)]
    air = object.__new__(TM.MidenAir)
    name, prog = generated.row_kernel_for(air, TM._bus_row_factors)
    gl_cuda.reset_launches()
    got = air.bus_factors(trace, rands)
    assert gl_cuda.LAUNCHES["miden_aux_factors"] == 1
    assert sum(gl_cuda.LAUNCHES.values()) == 1
    nxt = torch.roll(trace, -1, dims=-1)
    plain = symbolic.interpret(prog, trace, nxt, None, None, rands)
    eager = TM._bus_row_factors(trace, nxt,
                                [scalar(r, cuda_device) for r in rands])
    for k in range(8):
        assert torch.equal(got[k], plain[k]), k
        assert torch.equal(got[k], eager[k]), k


def test_build_aux_trace_on_card_equals_cpu(cuda_device):
    """The aux build of a real 64-row trace on the card (K6, then the scans)
    equals the CPU's, with one K6 launch and no roll of the trace."""
    from aero_tpu_torch.air import miden as TM
    from aero_tpu_torch.field import gl_cuda
    from aero_tpu_torch.sdk import DEFAULT_OPTIONS
    from aero_tpu_torch.vm import execute_full, fibonacci_source, program_hash
    src = fibonacci_source(10)
    trace, out, ovf = execute_full(src, [0, 1], min_rows=64)
    pub = TM.make_public_inputs(program_hash(src), [0, 1], out, overflow=ovf)
    air = TM.MidenAir(64, pub, DEFAULT_OPTIONS, program=src)
    rands = [7919 * (i + 1) ** 2 for i in range(16)]
    want = air.build_aux_trace(from_u64(trace, "cpu"), rands)
    gl_cuda.reset_launches()
    got = air.build_aux_trace(from_u64(trace, cuda_device), rands)
    assert gl_cuda.LAUNCHES["miden_aux_factors"] == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("widths,n,k,strided", [
    ((72, 9, 8), 1 << 10, 3, False), ((72, 9, 8), 1 << 20, 3, False),
    ((1,), 1, 1, False), ((5, 3), 8192, 4, False), ((7,), 1 << 14, 2, True),
    ((3, 0, 6, 2), 1000, 3, True), ((17,), 8193, 3, False)])
def test_eval_multi_kernel_matches_plain(cuda_device, widths, n, k, strided):
    """K7 on row blocks read where they lie (with `strided`, views of a
    wider array): equal to `eval_polys_multi_plain`, in one call of two
    launches."""
    from aero_tpu_torch.field import eval_polys_multi, eval_polys_multi_plain
    from aero_tpu_torch.field import gl_cuda
    rng = np.random.default_rng(n * k + len(widths))
    blocks = []
    for w in widths:
        full = _felts(rng, (w, n + (3 if strided else 0)), cuda_device)
        blocks.append(full[:, 1:n + 1] if strided else full)
    zs = [int(v) for v in rng.integers(0, P, k, np.uint64)]
    gl_cuda.reset_launches()
    got = eval_polys_multi(blocks, zs)
    assert gl_cuda.LAUNCHES["gl_eval_multi"] == 2
    assert sum(gl_cuda.LAUNCHES.values()) == 2
    assert got.shape == (k, sum(widths))
    assert np.array_equal(got, eval_polys_multi_plain(blocks, zs))
