"""Kernel 1 as redesigned for Hopper (`csrc/ntt.cu`), on the CPU.

- The coset LDE route of the card (`ntt_cuda.lde_cuda`: its first pass
  reads the coefficients, not a zero-padded input) in its plain passes,
  with the kernel's strides and tile plan, against `aero_tpu.ntt.lde`, also
  with the pass limit lowered so that three passes run.
- The fused first pass's plain version against `colntt_plain` of
  `coset_pad`'s padded input, pass for pass.
- The tables made on a device (here the CPU) against `tables.tables_np`
  and `aero_tpu`'s `ntt_pallas` tables.
- The kernel's own index arithmetic (`colntt_kernel`: its blocks, groups,
  bit reversals and the swizzle of its shared memory), transliterated line
  by line into Python and run on small shapes in place of the launches:
  every transform and LDE then equals the plain versions, and every step
  writes each slot of a tile exactly once. The transliteration carries the
  kernel's lazy words (any 64-bit word congruent to the value, with the
  corrections of `gl_add_lazy`, `gl_sub_lazy` and `gl_mul_lazy`) and
  asserts that each word stored to the output is canonical; adversarial
  columns (all p - 1, and words whose adds carry or land in [p, 2^64))
  hold it to `ntt_plain` and `aero_tpu`.

Exact equality throughout. The JAX side runs op by op (`jax.disable_jit`).
"""

import jax
import numpy as np
import pytest
import torch

from aero_tpu import field as J
from aero_tpu import ntt as JN
from aero_tpu.ntt.ntt_pallas import _tables_np as jax_tables_np
from aero_tpu.spec import field as F
from aero_tpu_torch import field as T
from aero_tpu_torch import ntt as TN
from aero_tpu_torch.ntt import ntt_cuda, tables
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs

P = F.P
OTHER_OFFSET = 5                        # a second coset, beside F.DOMAIN_OFFSET


def _jax(fn, x, *args):
    with jax.disable_jit():
        return J.from_gf(fn(J.to_gf(x), *args))


def _cols(logn, cols=2, seed=0):
    rng = np.random.default_rng(seed + logn)
    return rng.integers(0, P, size=(cols, 1 << logn), dtype=np.uint64)


# ------------------------------------------------ the LDE route vs aero_tpu

@pytest.mark.parametrize("logn", range(3, 13))
def test_lde_route_equals_jax(logn):
    """n = 2^3..2^12 coefficients, blowup 2, 4, 8 and 16, two offsets: the
    card's route in plain passes == aero_tpu.ntt.lde == the port's lde."""
    x = _cols(logn, seed=40)
    t = T.from_u64(x, "cpu")
    for log_blowup in (1, 2, 3, 4):
        for offset in (F.DOMAIN_OFFSET, OTHER_OFFSET):
            got = ntt_cuda.lde_cuda(t, log_blowup, offset)
            want = _jax(JN.lde, x, log_blowup, offset)
            assert np.array_equal(T.to_u64(got), want), (log_blowup, offset)
            assert torch.equal(got, TN.lde(t, log_blowup, offset))


@pytest.mark.parametrize("max_l,logn,log_blowup", [
    (4, 3, 3), (4, 4, 2), (8, 4, 3), (8, 6, 3), (8, 5, 4), (16, 8, 2),
    (16, 8, 4)])
def test_lde_route_past_two_passes_equals_jax(max_l, logn, log_blowup):
    """The pass limit lowered so that the LDE domain takes three passes:
    the LDE entry is then the outer pass."""
    assert logn + log_blowup > 2 * (max_l.bit_length() - 1)
    x = _cols(logn, seed=50)
    t = T.from_u64(x, "cpu")
    for offset in (F.DOMAIN_OFFSET, OTHER_OFFSET):
        got = ntt_cuda.lde_cuda(t, log_blowup, offset, max_l=max_l)
        assert np.array_equal(T.to_u64(got),
                              _jax(JN.lde, x, log_blowup, offset))
        assert torch.equal(got, ntt_cuda.ntt_cuda(
            TN.coset_pad(t, log_blowup, offset), False, max_l=max_l))


@pytest.mark.parametrize("max_l,logn,log_blowup", [
    (4096, 6, 3), (4096, 10, 1), (4096, 9, 4), (8, 5, 3), (16, 8, 2)])
def test_fused_first_pass_equals_the_padded_pass(max_l, logn, log_blowup):
    """Pass for pass: the LDE entry's first pass (scaled as it loads, its
    copy stages skipped) writes what a plain pass of `coset_pad`'s padded
    input writes, and the passes after it are the transform's own."""
    x = T.from_u64(_cols(logn, cols=3, seed=60), "cpu")
    n = x.shape[-1]
    m = n << log_blowup
    padded = TN.coset_pad(x, log_blowup, F.DOMAIN_OFFSET)
    firsts = []

    def spy(run):
        def wrapped(*args):
            run(*args)
            firsts.append(args[1].clone())        # the pass's output
        return wrapped

    orig_lde, orig_pass = ntt_cuda._pass_lde_plain, ntt_cuda._pass_plain
    try:
        ntt_cuda._pass_lde_plain = spy(orig_lde)
        got = ntt_cuda.lde_cuda(x, log_blowup, max_l=max_l)
        fused = firsts[0]
        ntt_cuda._pass_lde_plain = orig_lde
        firsts.clear()
        ntt_cuda._pass_plain = spy(orig_pass)
        want = ntt_cuda.ntt_cuda(padded, False, max_l=max_l)
    finally:
        ntt_cuda._pass_lde_plain, ntt_cuda._pass_plain = orig_lde, orig_pass
    assert torch.equal(fused, firsts[0])
    assert torch.equal(got, want)
    assert ntt_cuda.zero_stages(n, *_first_pass_shape(m, max_l)) == \
        min(ntt_cuda.step_plan(_first_pass_shape(m, max_l)[0]
                               .bit_length() - 1)[0], log_blowup)


def _first_pass_shape(m, max_l):
    """(L, C) of the first pass of a size-m transform."""
    if ntt_cuda._two_pass(m, max_l):
        log1 = (m.bit_length()) // 2
        n1 = 1 << log1
        return m // n1, n1
    return tables.three_level_split(m, max_l)


def test_zero_stages_and_the_plan():
    """The main LDE, 2^20 -> 2^23: pass 1 has 2048 rows in steps 3 + 4 + 4,
    and its first step only copies; pass 2 has 4096 rows, 4 + 4 + 4."""
    assert ntt_cuda.step_plan(11) == [3, 4, 4]
    assert ntt_cuda.step_plan(12) == [4, 4, 4]
    assert ntt_cuda.step_plan(9) == [1, 4, 4]
    assert ntt_cuda.step_plan(4) == [4]
    assert ntt_cuda.step_plan(0) == [0]
    assert ntt_cuda.zero_stages(1 << 20, 2048, 4096) == 3
    assert ntt_cuda.zero_stages(1 << 20, 4096, 2048) == 3
    assert ntt_cuda.zero_stages(1 << 20, 2048, 1024) == 1    # blowup 2
    assert ntt_cuda.zero_stages(1 << 24, 512, 1 << 18) == 1  # 2^27, r1 = 1
    assert ntt_cuda.zero_stages(4, 8, 8) == 3                # one row of 8
    assert ntt_cuda.tile_log_cols(11, 12) == 2               # 2048 x 4
    assert ntt_cuda.tile_log_cols(12, 11) == 1               # 4096 x 2
    assert ntt_cuda.tile_log_cols(3, 2) == 2                 # C is the cap


# --------------------------------------------------------------- the tables

@pytest.mark.parametrize("n", [2, 8, 1 << 7, 1 << 13, 1 << 16])
@pytest.mark.parametrize("invert", [False, True])
def test_device_tables_equal_tables_np_and_pallas(n, invert):
    """The tables made on a device by log-doubling: the cross table equals
    `tables_np`'s and `ntt_pallas`'s, and each pass table w_L^e holds the
    stage twiddles of theirs (stage s, butterfly j: w_L^(j L / 2^s))."""
    ntt_cuda.clear_table_cache()
    n1, n2, tw2, tw1, ctw = ntt_cuda._tables(n, invert, torch.device("cpu"))
    got_np = tables.tables_np(n, invert)
    want = jax_tables_np(n, invert)
    assert (n1, n2) == got_np[:2] == want[:2]
    assert np.array_equal(T.to_u64(ctw), got_np[6])
    assert np.array_equal(T.to_u64(ctw), want[6])
    for tw, stage in ((tw2, want[5]), (tw1, want[4])):
        L = tw.shape[0]
        w = T.to_u64(tw)
        for s in range(1, L.bit_length()):
            half = 1 << (s - 1)
            idx = np.arange(half) * (L >> s)
            assert np.array_equal(w[idx], stage[:half, s - 1])
    ntt_cuda.clear_table_cache()


def test_outer_and_lde_tables_on_a_device():
    """The three-pass outer table and the LDE's offset powers, against the
    field's own powers."""
    ntt_cuda.clear_table_cache()
    dev = torch.device("cpu")
    n = 1 << 9
    n3, ni, tw3, cross3 = ntt_cuda._outer_tables(n, False, dev, max_l=8)
    w = F.get_root_of_unity(9)
    assert (n3, ni) == (8, 64)
    assert [int(v) for v in T.to_u64(tw3)] == \
        [F.exp(w, ni * e) for e in range(n3)]
    c = T.to_u64(cross3)
    assert all(int(c[k, j]) == F.exp(w, k * j) for k in range(n3)
               for j in range(0, ni, 7))
    rowpow, colpow = ntt_cuda._lde_tables(F.DOMAIN_OFFSET, 16, 32, dev)
    g = F.DOMAIN_OFFSET
    assert [int(v) for v in T.to_u64(colpow)] == [F.exp(g, i)
                                                 for i in range(32)]
    assert [int(v) for v in T.to_u64(rowpow)] == [F.exp(g, 32 * r)
                                                 for r in range(16)]
    ntt_cuda.clear_table_cache()


# -------------------------------- the kernel's index arithmetic, emulated

M64 = (1 << 64) - 1
EPS = (1 << 32) - 1
# words that the emulation held in [p, 2^64) between a load and a store
LAZY_WORDS = {"noncanonical": 0}


def _add_lazy(a, b):
    """`gl_add_lazy` of csrc/goldilocks.cuh: + EPS for the 128-bit sum's
    carry, then for that sum's; a third cannot carry."""
    s = a + b
    t = (s & M64) + (EPS if s >> 64 else 0)
    r = (t & M64) + (EPS if t >> 64 else 0)
    assert r <= M64
    return r


def _sub_lazy(a, b):
    """`gl_sub_lazy`: - EPS for the borrow, then for that difference's."""
    d = a - b
    t = (d & M64) - (EPS if d < 0 else 0)
    r = (t & M64) - (EPS if t < 0 else 0)
    assert r >= 0
    return r


def _mul_lazy(a, b):
    """`gl_mul_lazy`: the reduction of the 128-bit product, 2^64 = EPS and
    2^96 = -1, with no canonicalisation."""
    ab = a * b
    lo, hi = ab & M64, ab >> 64
    d = lo - (hi >> 32)
    t = (d & M64) - (EPS if d < 0 else 0)
    assert t >= 0
    r = t + (hi & EPS) * EPS
    out = (r & M64) + (EPS if r >> 64 else 0)
    assert out <= M64
    return out


def _canon(a):
    return a - P if a >= P else a


def _held(a):
    """Count the words of a that are not canonical (the lazy form at
    work); return a."""
    LAZY_WORDS["noncanonical"] += sum(v >= P for v in a)
    return a

def _swz(p, k):
    if k <= 0:
        return p
    f, h = 0, p >> k
    while h:
        f ^= h
        h >>= k
    return p ^ (f & ((1 << k) - 1))


def _rev(x, bits):
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def _dft(a, r, w, z):
    R = 1 << r
    for t in range(z, r):
        half = 1 << t
        for k0 in range(0, R, 2 * half):
            for j in range(half):
                u, v = a[k0 + j], a[k0 + j + half]
                if j:
                    v = _mul_lazy(v, w[j * (R >> (t + 1))])
                a[k0 + j] = _add_lazy(u, v)
                a[k0 + j + half] = _sub_lazy(u, v)


def _emulate(src, dst, tw, cross, log_L, log_TC, C, B, in_s, out_s,
             cross_ld, lde=None):
    """`colntt_kernel` of csrc/ntt.cu, block by block and group by group:
    src, dst, tw, cross flat lists of ints (dst written in place); lde =
    (n, z, rowpow, colpow) for the LDE entry. Between a load and a store
    the words are the kernel's lazy ones; each is made canonical as it is
    stored. Checks that each step writes every slot of the tile once."""
    lg, ltc = log_L, log_TC
    L, TC = 1 << lg, 1 << ltc
    assert lg + ltc <= 14 and C % TC == 0
    tiles = C >> ltc
    K = max(1, -(-lg // 4))
    r1 = lg - 4 * (K - 1)
    k = 4 - ltc

    def slot(p, c):
        return ((_swz(p, k) << ltc) | c) << 3

    def store(b, c0, row, c, v, cr):
        if cross is not None:
            v = _mul_lazy(v, cr)
        v = _canon(v)
        assert 0 <= v < P
        dst[b * out_s[0] + row * out_s[1] + (c0 + c) * out_s[2]] = v

    def cross_at(c0, row, c):
        return cross[row * cross_ld + c0 + c] if cross is not None else 0

    for block in range(B * tiles):
        b, c0 = block // tiles, (block % tiles) << ltc
        R, lgr = 1 << r1, lg - r1
        w = [tw[e << lgr] for e in range(R // 2)]
        z = lde[1] if lde else 0
        nq = R >> z
        sm = {}
        for gam in range((L >> r1) << ltc):
            c, g = gam & (TC - 1), gam >> ltc
            base = slot(_rev(g, lgr) << r1, c)
            a = [None] * R
            for m in range(R):
                q = _rev(m, r1)
                if q >= nq:
                    continue
                row = g + (q << lgr)
                if lde:
                    n, _, rowpow, colpow = lde
                    i = row * C + c0 + c
                    a[m] = (_mul_lazy(_mul_lazy(src[b * n + i],
                                                colpow[c0 + c]),
                                      rowpow[row]) if i < n else 0)
                else:
                    a[m] = src[b * in_s[0] + row * in_s[1] +
                               (c0 + c) * in_s[2]]
            for m in range(R):
                if m & ((1 << z) - 1):
                    a[m] = a[m & ~((1 << z) - 1)]
            _dft(a, r1, w, z)
            _held(a)
            if K == 1:
                for m in range(R):
                    store(b, c0, m, c, a[m], cross_at(c0, m, c))
                continue
            for m in range(R):
                off = base ^ slot(m, 0)
                assert off not in sm and off < L * TC * 8
                sm[off] = a[m]
        if K == 1:
            continue
        assert len(sm) == L * TC
        w16 = [tw[e << (lg - 4)] for e in range(8)]
        for s in range(1, K):
            s0 = r1 + 4 * (s - 1)
            S, f, last = 1 << s0, lg - s0 - 4, s == K - 1
            xb = [slot(S << i, 0) for i in range(4)]
            new = {}
            for gam in range((L >> 4) << ltc):
                c, gp = gam & (TC - 1), gam >> ltc
                lo, hi = gp & (S - 1), gp >> s0
                base = slot((hi << (s0 + 4)) | lo, c)
                offs = []
                for m in range(16):
                    o = base
                    for i in range(4):
                        if m >> i & 1:
                            o ^= xb[i]
                    offs.append(o)
                a = [sm[o] for o in offs]
                if lo:
                    for m in range(1, 16):
                        a[m] = _mul_lazy(a[m], tw[(_rev(m, 4) * lo) << f])
                _dft(a, 4, w16, 0)
                _held(a)
                for m in range(16):
                    if last:
                        row = m * S + lo
                        store(b, c0, row, c, a[m], cross_at(c0, row, c))
                    else:
                        assert offs[m] not in new
                        new[offs[m]] = a[m]
            if not last:
                assert len(new) == L * TC
                sm = new


def _flat(t):
    return [int(v) for v in T.to_u64(t.reshape(-1).contiguous())]


def _storage_words(t):
    """The int64 words of t's storage from its offset on, as ints, and the
    offset: a strided pass addresses them as the kernel does."""
    base = t.storage_offset()
    n = t.untyped_storage().nbytes() // 8 - base
    return _flat(torch.as_strided(t, (n,), (1,), base)), base


def _write_back(dst, words, base):
    torch.as_strided(dst, (len(words),), (1,), base).copy_(
        T.from_u64(np.array(words, dtype=np.uint64), "cpu"))


def _emulated_pass(src, dst, tw, cross, log_L, log_C, B, in_s, out_s,
                   cross_ld):
    words, _ = _storage_words(src)
    tgt, base = _storage_words(dst)
    _emulate(words, tgt, _flat(tw),
             _flat(cross) if cross is not None else None, log_L,
             ntt_cuda.tile_log_cols(log_L, log_C), 1 << log_C, B, in_s,
             out_s, cross_ld)
    _write_back(dst, tgt, base)


def _emulated_lde_pass(coef, dst, tw, cross, rowpow, colpow, log_L, log_C,
                       B, n, z, out_s, cross_ld):
    tgt, base = _storage_words(dst)
    _emulate(_flat(coef), tgt, _flat(tw), _flat(cross), log_L,
             ntt_cuda.tile_log_cols(log_L, log_C), 1 << log_C, B, None,
             out_s, cross_ld, lde=(n, z, _flat(rowpow), _flat(colpow)))
    _write_back(dst, tgt, base)


@pytest.fixture
def emulated_kernel(monkeypatch):
    """The CPU passes replaced by the kernel's emulation, with tiles of
    2^6 elements, so that small shapes run several blocks, narrow tiles
    and the swizzle."""
    monkeypatch.setattr(ntt_cuda, "_pass_plain", _emulated_pass)
    monkeypatch.setattr(ntt_cuda, "_pass_lde_plain", _emulated_lde_pass)
    monkeypatch.setattr(ntt_cuda, "_LOG_TILE", 6)


@pytest.mark.parametrize("logn", [1, 2, 3, 4, 5, 6, 8, 10])
def test_emulated_kernel_transforms(emulated_kernel, logn):
    x = T.from_u64(_cols(logn, cols=3, seed=70), "cpu")
    for invert in (False, True):
        assert torch.equal(ntt_cuda.ntt_cuda(x, invert),
                           TN.ntt_plain(x, invert))


@pytest.mark.parametrize("max_l,logn", [(4, 5), (8, 7), (4, 6)])
def test_emulated_kernel_three_passes(emulated_kernel, max_l, logn):
    x = T.from_u64(_cols(logn, cols=2, seed=71), "cpu").reshape(2, 1, -1)
    for invert in (False, True):
        assert torch.equal(ntt_cuda.ntt_cuda(x, invert, max_l=max_l),
                           TN.ntt_plain(x, invert))


@pytest.mark.parametrize("logn,log_blowup,max_l", [
    (2, 3, 4096), (3, 1, 4096), (5, 3, 4096), (6, 4, 4096), (7, 2, 4096),
    (4, 3, 8), (3, 3, 4)])
def test_emulated_kernel_lde(emulated_kernel, logn, log_blowup, max_l):
    x = T.from_u64(_cols(logn, cols=2, seed=72), "cpu")
    for offset in (F.DOMAIN_OFFSET, OTHER_OFFSET):
        assert torch.equal(
            ntt_cuda.lde_cuda(x, log_blowup, offset, max_l=max_l),
            TN.ntt_plain(TN.coset_pad(x, log_blowup, offset)))


def test_emulated_kernel_with_wide_tiles():
    """A pass of 4096 rows in 2 columns and one of 16 rows in 16 columns
    (no swizzle): the steps and the tile plan at the kernel's own limit."""
    for log_L, log_TC, C in ((12, 1, 2), (4, 4, 16), (9, 3, 16)):
        L = 1 << log_L
        x = T.from_u64(np.random.default_rng(log_L).integers(
            0, P, size=(1, L, C), dtype=np.uint64), "cpu")
        tw = T.power_series(F.get_root_of_unity(log_L), L)
        cross = T.from_u64(np.random.default_rng(1).integers(
            0, P, size=(L, C), dtype=np.uint64), "cpu")
        got = [0] * (L * C)
        _emulate(_flat(x), got, _flat(tw), _flat(cross), log_L, log_TC, C,
                 1, (L * C, C, 1), (L * C, C, 1), C)
        want = ntt_cuda.colntt_plain(x, tw, cross)
        assert got == _flat(want)


# ---------------------------------- adversarial columns for the lazy words

ADVERSARIAL = ("p_minus_1", "carries")


def _adversarial(kind, logn, cols, seed):
    """Columns of p - 1, or of words drawn from p - 1, p - 2, 0, 1, 2,
    2^63, p - 2^31 and p - 7: pairs of them carry past 2^64, and p - 1
    beside a small word sums into [p, 2^64)."""
    if kind == "p_minus_1":
        return np.full((cols, 1 << logn), P - 1, dtype=np.uint64)
    words = np.array([P - 1, P - 2, 0, 1, 2, 1 << 63, P - (1 << 31), P - 7],
                     dtype=np.uint64)
    rng = np.random.default_rng(seed + logn)
    return words[rng.integers(0, len(words), size=(cols, 1 << logn))]


@pytest.mark.parametrize("kind", ADVERSARIAL)
@pytest.mark.parametrize("logn", [1, 4, 6, 10])
def test_emulated_kernel_adversarial_transforms(emulated_kernel, kind, logn):
    """The transform on adversarial columns == ntt_plain == aero_tpu; the
    words that carry into [p, 2^64) are held lazily between stores."""
    x_np = _adversarial(kind, logn, 3, 80)
    x = T.from_u64(x_np, "cpu")
    held = LAZY_WORDS["noncanonical"]
    for invert, jfn in ((False, JN.ntt), (True, JN.intt)):
        got = ntt_cuda.ntt_cuda(x, invert)
        assert torch.equal(got, TN.ntt_plain(x, invert))
        assert np.array_equal(T.to_u64(got), _jax(jfn, x_np))
    if kind == "carries" and logn >= 4:
        assert LAZY_WORDS["noncanonical"] > held


@pytest.mark.parametrize("kind", ADVERSARIAL)
@pytest.mark.parametrize("max_l,logn", [(4, 5), (8, 7)])
def test_emulated_kernel_adversarial_three_passes(emulated_kernel, kind,
                                                  max_l, logn):
    x_np = _adversarial(kind, logn, 2, 81)
    x = T.from_u64(x_np, "cpu").reshape(2, 1, -1)
    for invert, jfn in ((False, JN.ntt), (True, JN.intt)):
        got = ntt_cuda.ntt_cuda(x, invert, max_l=max_l)
        assert torch.equal(got, TN.ntt_plain(x, invert))
        assert np.array_equal(T.to_u64(got).reshape(2, -1),
                              _jax(jfn, x_np))


@pytest.mark.parametrize("kind", ADVERSARIAL)
@pytest.mark.parametrize("logn,log_blowup,max_l", [
    (5, 3, 4096), (6, 4, 4096), (4, 3, 8)])
def test_emulated_kernel_adversarial_lde(emulated_kernel, kind, logn,
                                         log_blowup, max_l):
    x_np = _adversarial(kind, logn, 2, 82)
    x = T.from_u64(x_np, "cpu")
    for offset in (F.DOMAIN_OFFSET, OTHER_OFFSET):
        got = ntt_cuda.lde_cuda(x, log_blowup, offset, max_l=max_l)
        assert torch.equal(got, TN.ntt_plain(TN.coset_pad(x, log_blowup,
                                                          offset)))
        assert np.array_equal(T.to_u64(got),
                              _jax(JN.lde, x_np, log_blowup, offset))


@pytest.mark.parametrize("kind", ADVERSARIAL)
def test_emulated_kernel_with_wide_tiles_on_adversarial_columns(kind):
    """The wide tiles of `test_emulated_kernel_with_wide_tiles` with
    adversarial columns and a cross table of p - 1."""
    for log_L, log_TC, C in ((12, 1, 2), (4, 4, 16), (9, 3, 16)):
        L = 1 << log_L
        x = T.from_u64(_adversarial(kind, (L * C).bit_length() - 1, 1, 83)
                       .reshape(1, L, C), "cpu")
        tw = T.power_series(F.get_root_of_unity(log_L), L)
        cross = T.from_u64(np.full((L, C), P - 1, dtype=np.uint64), "cpu")
        got = [0] * (L * C)
        _emulate(_flat(x), got, _flat(tw), _flat(cross), log_L, log_TC, C,
                 1, (L * C, C, 1), (L * C, C, 1), C)
        assert got == _flat(ntt_cuda.colntt_plain(x, tw, cross))
