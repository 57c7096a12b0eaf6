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
from aero_tpu.spec.proof import ProofOptions

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


@pytest.mark.parametrize("bits", [0, 1, 12, 17])
def test_grind_kernel_returns_the_minimal_nonce(cuda_device, bits):
    seed = hashlib.blake2s(b"card-%d" % bits).digest()
    want = TK.grind_pow_plain(seed, bits, "cpu", batch=1 << 16)
    assert TK.grind_pow(seed, bits, cuda_device) == want
    assert TK.grind_pow(seed, bits, cuda_device, batch=1000) == want


def test_fib_proof_on_card_equals_cpu(cuda_device):
    opts = ProofOptions(num_queries=27, blowup_factor=8, grinding_factor=8)
    n = 64
    pub = TF.FibPublicInputs(result=TF.fib_result(n), n_steps=n)
    cpu = prove(TF.FibAir(n, pub, opts), TF.build_fib_trace(n), pub)
    card = prove(TF.FibAir(n, pub, opts),
                 TF.build_fib_trace(n, cuda_device), pub)
    assert card.to_bytes() == cpu.to_bytes()
