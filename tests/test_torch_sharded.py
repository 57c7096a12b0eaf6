"""aero_tpu_torch.parallel.sharded on a gloo group of CPU processes: each
stage on local blocks vs the JAX package's stage (as tests/test_sharded.py
holds them, FibAir at 32 rows) and vs the port's single-device prover code,
each redistribution on its own vs a whole-tensor numpy rendering, and the
dry-run pipeline as a whole vs the committed golden roots. Exact equality.

Each world size starts its ranks once (`run_ranks`, which kills them after
its time limit). This file imports JAX only inside the reference fixture,
so the rank processes, which import it to find `_rank_cases`, start
without it. The JAX stages run op by op (`jax.disable_jit`).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from aero_tpu_torch import field as T
from aero_tpu_torch import ntt as TN
from aero_tpu_torch.air import fib as TF
from aero_tpu_torch.merkle import commit_columns
from aero_tpu_torch.parallel import dist_ntt as DN
from aero_tpu_torch.parallel import dryrun as DR
from aero_tpu_torch.parallel import sharded as SH
from aero_tpu_torch.parallel.mesh import run_ranks, split_blocks
from aero_tpu_torch.prover import prover as prover_mod
from aero_tpu_torch.prover.fri import fold_evals
from aero_tpu_torch.spec.proof import ProofOptions
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = T.P
N = 32
M = N * 8
OPTS = ProofOptions(num_queries=7, blowup_factor=8, grinding_factor=1)
WORLDS = (2, 4)
LIMIT_S = 240              # per spawn: a stuck rank fails one fixture
AUX_RAND = [3, 5]
ALPHA = 31337
CC_T = [(11 + i, 13 + i) for i in range(3)]
CC_B = [(17 + i, 19 + i) for i in range(4)]


def _port_air():
    pub = TF.FibPublicInputs(result=TF.fib_result(N), n_steps=N)
    return TF.FibAir(N, pub, OPTS)


def _inputs():
    rng = np.random.default_rng(41)

    def rand(*shape):
        return rng.integers(0, P, size=shape, dtype=np.uint64)

    air = _port_air()
    trace = TF.build_fib_trace(N)
    aux = air.build_aux_trace(trace, AUX_RAND)
    w, ce = 3, air.ce_blowup
    deep = dict(z=int(rand()), zg=int(rand()), zm=int(rand()),
                cur_vals=rand(w).tolist(), nxt_vals=rand(w).tolist(),
                ood_vals=rand(ce).tolist(), deep_a=rand(w).tolist(),
                deep_b=rand(w).tolist(), deep_c=rand(ce).tolist(),
                lam=int(rand()), mu=int(rand()))
    return {"trace": T.to_u64(trace), "aux": T.to_u64(aux), "deep": deep,
            "halo": rand(3, 64), "coeffs": rand(M), "layer": rand(512)}


def _rank_cases(mesh, inp):
    """Runs in every rank: each stage and each redistribution on this
    rank's blocks."""
    def local(name):
        return split_blocks(inp[name], mesh.world)[mesh.rank]

    air = _port_air()
    out = {}
    out["polys"], main_lde = SH.stage_lde(mesh, local("trace"), 3)
    _, aux_lde = SH.stage_lde(mesh, local("aux"), 3)
    out["main_lde"], out["aux_lde"] = main_lde, aux_lde
    out["main_root"] = SH.stage_commit(mesh, main_lde)
    comp = SH.stage_composition(mesh, air, main_lde, aux_lde, AUX_RAND, CC_T,
                                CC_B, 3)
    out["composition"] = comp
    out["deep"] = SH.stage_deep(mesh, main_lde, aux_lde, comp,
                                w_lde=air.lde_generator, **inp["deep"])
    folded = SH.stage_fri_fold(mesh, main_lde[0].contiguous(), ALPHA, 8)
    out["folded"] = folded
    leaf_cols = SH.fold_leaf_columns(mesh, folded, 8)
    out["fold_leaf_cols"] = leaf_cols
    out["fold_root"] = SH.stage_commit(mesh, leaf_cols)
    out["halo"] = SH.next_points(mesh, local("halo"), 8)
    for ce in (2, 4, 8):
        out[f"deinterleave{ce}"] = SH.deinterleave_columns(
            mesh, local("coeffs"), N, ce)
    out["layer_cols"] = SH.fold_leaf_columns(mesh, local("layer"), 8)
    out["traffic"] = {k: list(v) for k, v in mesh.traffic.items()}
    # the block in fragments of 16 points, then of 4 (shorter than the
    # blowup, 8): the frames at x * g of the last fragments read the next
    # block's first points; the LDEs a column a chunk
    frag = SH.FRAG
    try:
        for f in (16, 4):
            SH.FRAG = f
            out[f"composition_frag{f}"] = SH.stage_composition(
                mesh, air, main_lde, aux_lde, AUX_RAND, CC_T, CC_B, 3)
    finally:
        SH.FRAG = frag
    out["polys_c1"], out["main_lde_c1"] = SH.stage_lde(
        mesh, local("trace"), 3, cols_per_chunk=1)
    out["composition_c1"] = SH.stage_composition(
        mesh, air, main_lde, aux_lde, AUX_RAND, CC_T, CC_B, 3,
        cols_per_chunk=1)
    out["chunk_cols"] = [DN.lde_chunk_cols(mesh, w, N // mesh.world,
                                           M // mesh.world)
                         for w in (2, 1, air.ce_blowup)]
    return {k: T.to_u64(v) if torch.is_tensor(v) else v
            for k, v in out.items()}


@pytest.fixture(scope="module", params=WORLDS)
def ranks(request):
    world = request.param
    return world, run_ranks(_rank_cases, world, ["cpu"] * world,
                            (_inputs(),), timeout_s=LIMIT_S)


def _joined(ranks, name):
    return np.concatenate([g[name] for g in ranks[1]], axis=-1)


def _root(words: np.ndarray) -> bytes:
    return words.astype("<u4").tobytes()


@pytest.fixture(scope="module")
def port_ref():
    """The port's single-device prover code on the same inputs."""
    inp = _inputs()
    air = _port_air()
    trace = T.from_u64(inp["trace"], "cpu")
    aux = T.from_u64(inp["aux"], "cpu")
    st = prover_mod.ProverState(pub_inputs=air.pub_inputs)
    st.main_polys = TN.intt(trace)
    st.main_lde = TN.lde(st.main_polys, 3)
    st.aux_lde = TN.lde(TN.intt(aux), 3)
    st.aux_rand = list(AUX_RAND)
    st.coin = DR._FixedCoin(CC_T + CC_B)
    prover_mod.stage_constraint_eval(air, st)
    d = inp["deep"]

    def vec(v):
        return T.from_u64(np.array(v, dtype=np.uint64), "cpu")

    deep = prover_mod._deep_core(
        st.main_lde, st.aux_lde, st.constraint_lde,
        prover_mod._ceval_static(air, "cpu")[0], vec(d["cur_vals"]),
        vec(d["nxt_vals"]), vec(d["ood_vals"]), vec(d["deep_a"]),
        vec(d["deep_b"]), vec(d["deep_c"]),
        *(T.scalar(d[k], "cpu") for k in ("z", "zg", "zm", "lam", "mu")))
    folded = fold_evals(st.main_lde[0], ALPHA, 8)
    return {"polys": T.to_u64(st.main_polys),
            "main_lde": T.to_u64(st.main_lde),
            "aux_lde": T.to_u64(st.aux_lde),
            "main_root": commit_columns(st.main_lde).root,
            "composition": T.to_u64(st.constraint_lde),
            "deep": T.to_u64(deep), "folded": T.to_u64(folded),
            "fold_root": commit_columns(folded.reshape(8, -1)).root}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's stages on the same inputs, single device."""
    import jax
    from aero_tpu import field as J
    from aero_tpu.air import fib as JF
    from aero_tpu.parallel import sharded as JS
    from aero_tpu.spec.proof import ProofOptions as JOpts

    inp = _inputs()
    opts = JOpts(num_queries=7, blowup_factor=8, grinding_factor=1)
    pub = JF.FibPublicInputs(result=JF.fib_result(N), n_steps=N)
    air = JF.FibAir(N, pub, opts)
    gs = JS.gf_scalar
    with jax.disable_jit():
        polys, main_lde = JS.stage_lde(J.to_gf(inp["trace"]), 3)
        _, aux_lde = JS.stage_lde(J.to_gf(inp["aux"]), 3)
        main_root = JS.stage_commit(main_lde)
        comp = JS.stage_composition(
            air, main_lde, aux_lde, [gs(r) for r in AUX_RAND],
            [(gs(a), gs(b)) for a, b in CC_T],
            [(gs(a), gs(b)) for a, b in CC_B], log_blowup=3)
        d = inp["deep"]

        def vec(v):
            return J.to_gf(np.array(v, dtype=np.uint64))

        deep = JS.stage_deep(
            J.gf_concat([main_lde, aux_lde], axis=0), comp, gs(d["z"]),
            gs(d["zg"]), gs(d["zm"]), vec(d["cur_vals"]), vec(d["nxt_vals"]),
            vec(d["ood_vals"]), vec(d["deep_a"]), vec(d["deep_b"]),
            vec(d["deep_c"]), gs(d["lam"]), gs(d["mu"]),
            w_lde=air.lde_generator)
        folded = JS.stage_fri_fold(main_lde[0], gs(ALPHA), ff=8)
    # jitted: the fori_loop of the multi-block leaf hash (8 felts a row)
    # does not run op by op
    fold_root = JS.stage_commit(folded.reshape(8, -1))

    def root(t):
        return b"".join(int(np.asarray(w).reshape(())).to_bytes(4, "little")
                        for w in t)

    return {"polys": J.from_gf(polys), "main_lde": J.from_gf(main_lde),
            "aux_lde": J.from_gf(aux_lde), "main_root": root(main_root),
            "composition": J.from_gf(comp), "deep": J.from_gf(deep),
            "folded": J.from_gf(folded), "fold_root": root(fold_root)}


STAGE_OUTPUTS = ["polys", "main_lde", "aux_lde", "composition", "deep",
                 "folded"]


@pytest.mark.parametrize("name", STAGE_OUTPUTS)
def test_stage_matches_aero_tpu(ranks, jax_ref, name):
    assert np.array_equal(_joined(ranks, name), jax_ref[name])


@pytest.mark.parametrize("name", STAGE_OUTPUTS)
def test_stage_matches_the_port_single_device(ranks, port_ref, name):
    assert np.array_equal(_joined(ranks, name), port_ref[name])


@pytest.mark.parametrize("name", ["main_root", "fold_root"])
def test_commit_root_matches_both_and_every_rank_agrees(ranks, jax_ref,
                                                        port_ref, name):
    for g in ranks[1]:
        assert _root(g[name]) == jax_ref[name] == port_ref[name]


@pytest.mark.parametrize("name,ref", [
    ("composition_frag16", "composition"),
    ("composition_frag4", "composition"), ("polys_c1", "polys"),
    ("main_lde_c1", "main_lde"), ("composition_c1", "composition")])
def test_fragments_and_chunks_leave_the_stages_equal_to_both(
        ranks, jax_ref, port_ref, name, ref):
    """Fragments of 16 and of 4 points, smaller than the block and than
    the blowup (the last ones read the halo), and LDEs a column at a time
    give what the JAX stages and the single-device prover give."""
    got = _joined(ranks, name)
    assert np.array_equal(got, jax_ref[ref])
    assert np.array_equal(got, port_ref[ref])


def test_each_lde_reports_its_chunk_width(ranks):
    """On the CPU an LDE takes all its columns unless asked: main 2, aux
    1, composition columns ce."""
    ce = _port_air().ce_blowup
    for g in ranks[1]:
        assert g["chunk_cols"] == [2, 1, ce]


def test_halo_is_the_next_ranks_first_points(ranks):
    x = _inputs()["halo"]
    world, got = ranks
    blk = 64 // world
    rolled = np.roll(x, -8, axis=-1)
    for r, g in enumerate(got):
        # the last 8 points of rank r's block of roll(x, -8)
        want = rolled[:, (r + 1) * blk - 8:(r + 1) * blk]
        assert np.array_equal(g["halo"], want)


@pytest.mark.parametrize("ce", [2, 4, 8])
def test_deinterleave_matches_the_whole_tensor_reshape(ranks, ce):
    c = _inputs()["coeffs"]
    want = c[:ce * N].reshape(N, ce).T
    assert np.array_equal(_joined(ranks, f"deinterleave{ce}"), want)


def test_fold_leaf_columns_match_the_whole_tensor_reshape(ranks):
    layer = _inputs()["layer"]
    assert np.array_equal(_joined(ranks, "layer_cols"), layer.reshape(8, 64))
    folded = _joined(ranks, "folded")
    assert np.array_equal(_joined(ranks, "fold_leaf_cols"),
                          folded.reshape(8, -1))


def test_traffic_counts_every_exchange(ranks):
    world, got = ranks
    for g in got:
        t = g["traffic"]
        assert set(t) == {"ntt", "lde_pad", "roots", "halo", "deinterleave",
                          "fold_leaves"}
        assert t["halo"] == [3, 8 * 8 * (2 + 1 + 3)]
        assert t["roots"] == [2, 2 * 8 * 8]
        # main, aux, composition (iNTT + LDE), one fold: 3 exchanges each
        assert t["ntt"][0] == 3 * (2 + 2 + 2 + 2)


# ------------------------------------------------------- the slice as a whole

def _golden(path):
    with open(path) as f:
        return json.load(f)


def test_golden_file_is_a_copy_of_aero_tpus():
    theirs = _golden(os.path.join(ROOT, "aero_tpu", "parallel",
                                  "dryrun_golden.json"))
    assert _golden(DR.GOLDEN_PATH) == theirs
    assert theirs["trace_steps"] == 64 and len(theirs["roots"]) == 4


@pytest.mark.parametrize("world", [2, 4, 8])
def test_dryrun_roots_equal_the_golden_roots(world):
    out = DR.dryrun_prove_core(world, 64, device="cpu", timeout_s=LIMIT_S)
    assert out.matches_single_device
    want = _golden(DR.GOLDEN_PATH)["roots"]
    assert [list(r) for r in out[:4]] == want
    assert len(out.ranks) == world
    for r in out.ranks:
        assert r["roots"] == want and r["rows"] == 64
        assert set(r["seconds"]) == {"lde", "commit", "composition", "deep",
                                     "fri_fold"}
        assert set(r["seconds_warm"]) == set(r["seconds"])
        assert r["chunk_cols"] == [72, 9, 8]    # the CPU: all the columns


def test_single_device_mode_equals_the_golden_roots():
    got = DR.single_device_dryrun(64, "cpu")
    assert got["roots"] == _golden(DR.GOLDEN_PATH)["roots"]
    assert got["rows"] == 64


def test_a_wrong_reference_is_reported():
    want = _golden(DR.GOLDEN_PATH)["roots"]
    bad = [list(r) for r in want]
    bad[2][0] ^= 1
    out = DR.dryrun_prove_core(2, 64, device="cpu", reference=bad,
                               timeout_s=LIMIT_S)
    assert not out.matches_single_device
    assert [list(r) for r in out[:4]] == want


def _cli(*args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "aero_tpu_torch.parallel.dryrun", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=LIMIT_S)


def test_dryrun_cli_on_the_cpu():
    res = _cli("--world", "2", "--cpu")
    assert res.returncode == 0, res.stderr
    assert "roots match the single-device pipeline: True" in res.stdout
    want = _golden(DR.GOLDEN_PATH)["roots"]
    for name, root in zip(DR.ROOT_NAMES, want):
        assert f"{name}_root {DR.root_hex(root)}" in res.stdout


def test_dryrun_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _cli("--world", "2")
    assert res.returncode != 0
    assert "roots match" not in res.stdout
    with pytest.raises(RuntimeError):
        DR.rank_devices(2, None, "device")
    with pytest.raises(ValueError):
        DR.rank_devices(2, "cpu", "host")
    assert DR.rank_devices(2, "cpu", "device") == ["cpu", "cpu"]
