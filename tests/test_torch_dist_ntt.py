"""aero_tpu_torch.parallel.dist_ntt on a gloo group of CPU processes vs the
single-device transforms of both packages: the cases of
tests/test_dist_ntt.py that are not `slow`, at 2^9-2^12, for 2, 4 and 8
ranks, and the LDE in chunks of columns at forced widths (on the CPU a
chunk takes all the columns unless asked). Exact equality throughout.

Each world size starts its ranks once (`run_ranks`, which kills them after
its time limit): every rank runs all the cases on its local blocks of the
same numpy inputs, made from seeds here, and the tests compare the joined
blocks. This file imports JAX only inside the reference fixture, so the
rank processes, which import it to find `_rank_cases`, start without it.
"""

import numpy as np
import pytest
import torch

from aero_tpu_torch import field as T
from aero_tpu_torch import ntt as TN
from aero_tpu_torch.parallel import dist_ntt as DN
from aero_tpu_torch.parallel.mesh import (gather_domain, join_blocks,
                                          run_ranks, shard_domain,
                                          split_blocks)
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


P = T.P
WORLDS = (2, 4, 8)
CHUNKS = (1, 5, 12)         # columns an LDE chunk takes in the chunked cases
LIMIT_S = 240              # per world: a stuck rank fails one fixture


def _inputs():
    def rand(seed, *shape):
        return np.random.default_rng(seed).integers(0, P, size=shape,
                                                    dtype=np.uint64)
    return {"forward": rand(0, 1 << 10), "inverse": rand(1, 1 << 11),
            "roundtrip": rand(2, 1 << 12), "batched": rand(11, 3, 1 << 9),
            "lde": rand(3, 1 << 10), "lde_cols": rand(12, 13, 1 << 6),
            "lde_blowup2": rand(13, 2, 1 << 6), "pad": rand(14, 2, 1 << 5)}


def _rank_cases(mesh, inputs):
    """Runs in every rank: each case on this rank's blocks."""
    from aero_tpu_torch.parallel.sharded import dist_lde_cols

    def local(name):
        return split_blocks(inputs[name], mesh.world)[mesh.rank]

    out = {}
    out["forward"] = DN.dist_ntt(mesh, local("forward"))
    out["inverse"] = DN.dist_ntt(mesh, local("inverse"), invert=True)
    out["roundtrip"] = DN.dist_ntt(
        mesh, DN.dist_ntt(mesh, local("roundtrip")), invert=True)
    out["batched"] = DN.dist_ntt(mesh, local("batched"))
    out["lde"] = DN.dist_lde(mesh, local("lde"), 3)
    out["lde_cols_polys"], out["lde_cols"] = dist_lde_cols(
        mesh, local("lde_cols"), 3)
    out["lde_blowup2"] = DN.dist_lde(mesh, local("lde_blowup2"), 1)
    out["pad1"] = DN.pad_domain(mesh, local("pad"), 1)
    out["pad3"] = DN.pad_domain(mesh, local("pad"), 3)
    k1, k2, _, _ = DN.split_sizes(1 << 10, mesh.world)
    out["mid_twiddles"] = DN._mid_twiddles(k1, k2, False, mesh.rank,
                                           mesh.world, "cpu")
    out["mid_twiddles_inv"] = DN._mid_twiddles(k1, k2, True, mesh.rank,
                                               mesh.world, "cpu")
    out["traffic"] = {k: list(v) for k, v in mesh.traffic.items()}
    # the LDE of the 13 columns in chunks: 12 is aero_tpu's width, 5 and
    # 12 leave a narrower last chunk; each chunk's exchanges counted apart
    for cw in CHUNKS:
        before = {k: list(v) for k, v in mesh.traffic.items()}
        out[f"lde_cols_polys_c{cw}"], out[f"lde_cols_c{cw}"] = dist_lde_cols(
            mesh, local("lde_cols"), 3, cols_per_chunk=cw)
        out[f"traffic_c{cw}"] = {
            k: [now - was for now, was in zip(v, before.get(k, [0, 0]))]
            for k, v in mesh.traffic.items()}
    out["coeffs_lde_c2"] = DN.dist_lde_coeffs(mesh, local("batched"), 3,
                                              cols_per_chunk=2)
    whole = T.from_u64(inputs["batched"], "cpu")
    mine = shard_domain(mesh, whole)
    out["shard_is_my_block"] = torch.equal(mine, local("batched"))
    out["gathered"] = gather_domain(mesh, mine)
    # the chunk width every rank agrees on: the least free memory, and on
    # the CPU all the rows
    out["least_free"] = DN.least_free_bytes(mesh, 1000 + 7 * mesh.rank)
    out["lde_chunk_cols"] = DN.lde_chunk_cols(mesh, 13, 1 << 6, 1 << 9)
    return {k: T.to_u64(v) if torch.is_tensor(v) else v
            for k, v in out.items()}


@pytest.fixture(scope="module", params=WORLDS)
def ranks(request):
    world = request.param
    got = run_ranks(_rank_cases, world, ["cpu"] * world, (_inputs(),),
                    timeout_s=LIMIT_S)
    return world, got


def _joined(ranks, name):
    _, got = ranks
    return np.concatenate([g[name] for g in got], axis=-1)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's single-device transforms of the same inputs, op by
    op (XLA:CPU takes about a minute to compile each jitted size)."""
    import jax
    from aero_tpu import field as J
    from aero_tpu import ntt as JN
    from aero_tpu.parallel.dist_ntt import _mid_twiddles as jax_mid

    x = _inputs()

    def run(fn, a, *args):
        with jax.disable_jit():
            return J.from_gf(fn(J.to_gf(a), *args))

    ref = {"forward": run(JN.ntt, x["forward"]),
           "inverse": run(JN.intt, x["inverse"]),
           "batched": run(JN.ntt, x["batched"]),
           "lde": run(JN.lde_from_evals, x["lde"], 3),
           "lde_cols_polys": run(JN.intt, x["lde_cols"]),
           "lde_cols": run(JN.lde_from_evals, x["lde_cols"], 3),
           "coeffs_lde": run(JN.lde, x["batched"], 3),
           "lde_blowup2": run(JN.lde_from_evals, x["lde_blowup2"], 1)}
    for inv in (False, True):
        lo, hi = jax_mid(32, 32, inv)
        ref["mid_twiddles_inv" if inv else "mid_twiddles"] = (
            lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
        ).reshape(32, 32)
    return ref


@pytest.mark.parametrize("case", ["forward", "inverse", "batched", "lde",
                                  "lde_cols_polys", "lde_cols",
                                  "lde_blowup2"])
def test_dist_transform_matches_aero_tpu(ranks, jax_ref, case):
    assert np.array_equal(_joined(ranks, case), jax_ref[case])


@pytest.mark.parametrize("case,fn", [
    ("forward", lambda t: TN.ntt(t)), ("inverse", lambda t: TN.intt(t)),
    ("batched", lambda t: TN.ntt(t)),
    ("lde", lambda t: TN.lde_from_evals(t, 3)),
    ("lde_cols", lambda t: TN.lde_from_evals(t, 3)),
    ("lde_blowup2", lambda t: TN.lde_from_evals(t, 1))])
def test_dist_transform_matches_the_port_single_device(ranks, case, fn):
    want = T.to_u64(fn(T.from_u64(_inputs()[case], "cpu")))
    assert np.array_equal(_joined(ranks, case), want)


@pytest.mark.parametrize("part", ["lde_cols_polys", "lde_cols"])
@pytest.mark.parametrize("cw", CHUNKS)
def test_lde_cols_in_chunks_equals_aero_tpu_and_the_unchunked(ranks, jax_ref,
                                                              cw, part):
    """13 columns `cw` at a time: the coefficients and the LDE equal
    `aero_tpu`'s intt / lde_from_evals and the all-columns result."""
    got = _joined(ranks, f"{part}_c{cw}")
    assert np.array_equal(got, jax_ref[part])
    assert np.array_equal(got, _joined(ranks, part))


def test_coefficient_lde_in_chunks_equals_both_packages(ranks, jax_ref):
    """`dist_lde_coeffs` of 3 rows, 2 at a time (the last chunk one)."""
    got = _joined(ranks, "coeffs_lde_c2")
    assert np.array_equal(got, jax_ref["coeffs_lde"])
    want = T.to_u64(TN.lde(T.from_u64(_inputs()["batched"], "cpu"), 3))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("cw", CHUNKS)
def test_chunks_keep_the_bytes_and_exchange_three_times_a_transform(ranks,
                                                                    cw):
    """Chunking moves the same bytes as one batch of 13 columns; each
    chunk's iNTT and forward transform are three exchanges each, and its
    padding one."""
    world, got = ranks
    chunks = -(-13 // cw)
    pts = 13 * ((1 << 6) + (1 << 9))
    for g in got:
        t = g[f"traffic_c{cw}"]
        assert t["ntt"] == [3 * 2 * chunks, 3 * 8 * pts // world]
        assert t["lde_pad"][0] == chunks


def test_chunk_width_rule():
    """`chunk_cols`: 12 columns (aero_tpu's width), fewer where a quarter
    of the free memory cannot hold a chunk's `chunk_bytes`, at least 1, at
    most the width; all columns where no free memory is given (the CPU)."""
    n, m = 1 << 20, 1 << 23
    one = DN.chunk_bytes(1, n, m)
    assert one == 8 * (3 * m + 2 * n)
    assert DN.chunk_bytes(12, n, m) == 12 * one
    assert DN.chunk_cols(72, n, m, None) == 72
    assert DN.chunk_cols(72, n, m, 80 << 30) == 12
    assert DN.chunk_cols(9, n, m, 80 << 30) == 9
    assert DN.chunk_cols(8, n >> 2, m >> 2, 80 << 30) == 8
    assert DN.chunk_cols(72, n, m, 4 * 5 * one) == 5
    assert DN.chunk_cols(72, n, m, 4 * 5 * one - 1) == 4
    assert DN.chunk_cols(72, n, m, 0) == 1
    # a world-4 block: exactly 12 columns' transients in a quarter
    assert DN.chunk_cols(72, n >> 2, m >> 2, 4 * 12 * (one >> 2)) == 12
    with pytest.raises(ValueError, match="positive"):
        DN.dist_lde_coeffs(None, torch.zeros(13, 64, dtype=torch.int64), 3,
                           cols_per_chunk=0)


def test_every_rank_takes_the_least_free_memory_and_the_cpu_all_rows(
        ranks):
    """`least_free_bytes` gives each rank the least of every rank's figure
    (so ranks sharing a card make the same chunks and the same exchanges);
    `lde_chunk_cols` on a CPU mesh takes all the rows."""
    for g in ranks[1]:
        assert g["least_free"] == 1000
        assert g["lde_chunk_cols"] == 13


def test_roundtrip_is_the_identity(ranks):
    assert np.array_equal(_joined(ranks, "roundtrip"),
                          _inputs()["roundtrip"])


@pytest.mark.parametrize("lb", [1, 3])
def test_pad_domain_puts_the_zeros_at_the_global_tail(ranks, lb):
    x = _inputs()["pad"]
    want = np.concatenate(
        [x, np.zeros((2, (32 << lb) - 32), dtype=np.uint64)], axis=-1)
    assert np.array_equal(_joined(ranks, f"pad{lb}"), want)


@pytest.mark.parametrize("name", ["mid_twiddles", "mid_twiddles_inv"])
def test_each_rank_builds_its_own_twiddle_block(ranks, jax_ref, name):
    world, got = ranks
    l1 = 32 // world
    for r, g in enumerate(got):
        assert g[name].shape == (l1, 32)
        assert np.array_equal(g[name], jax_ref[name][r * l1:(r + 1) * l1])


def test_three_all_to_alls_of_the_local_block_per_transform(ranks):
    """The traffic counters: every transform is three exchanges of the
    rank's whole block (8 B a point)."""
    world, got = ranks
    points = 0
    transforms = 0
    for name, per_call, calls in (
            ("forward", 1 << 10, 1), ("inverse", 1 << 11, 1),
            ("roundtrip", 1 << 12, 2), ("batched", 3 << 9, 1),
            ("lde", (1 << 10) + (1 << 13), 1),
            ("lde_cols", 13 * ((1 << 6) + (1 << 9)), 1),
            ("lde_blowup2", 2 * ((1 << 6) + (1 << 7)), 1)):
        points += per_call * calls
        transforms += calls * (1 if "lde" not in name else 2)
    for g in got:
        calls, nbytes = g["traffic"]["ntt"]
        assert calls == 3 * transforms
        assert nbytes == 3 * 8 * points // world


def test_shard_and_gather_domain_round_trip_on_every_rank(ranks):
    for g in ranks[1]:
        assert g["shard_is_my_block"] is True
        assert np.array_equal(g["gathered"], _inputs()["batched"])


def test_split_and_join_blocks_round_trip():
    x = _inputs()["batched"]
    blocks = split_blocks(x, 4)
    assert [tuple(b.shape) for b in blocks] == [(3, 128)] * 4
    assert np.array_equal(join_blocks(blocks), x)
    with pytest.raises(ValueError):
        split_blocks(x, 3)


def test_too_many_ranks_for_a_small_transform_raise():
    with pytest.raises(ValueError, match="too many"):
        DN.split_sizes(16, 8)
    assert DN.split_sizes(1 << 10, 4) == (32, 32, 8, 8)
    assert DN.split_sizes(1 << 11, 2) == (32, 64, 16, 32)


def _raises_in_rank_one(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 gives up")
    return DN.dist_ntt(mesh, torch.zeros(32, dtype=torch.int64))


def test_a_rank_that_raises_fails_the_run_and_leaves_nothing_waiting():
    """Rank 0 is inside an all-to-all when rank 1 raises: the run fails
    with rank 1's own error under its rank (whatever rank 0 says of its
    lost connection) well inside its time limit, and no process is left
    behind."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match="rank 1: RuntimeError: rank 1 gives up"):
        run_ranks(_raises_in_rank_one, 2, ["cpu"] * 2, timeout_s=60)
    assert time.monotonic() - t0 < 60
