"""Every public name of `aero_tpu` has a counterpart in `aero_tpu_torch`.

The public names of a module are its functions and classes without a
leading underscore (jitted functions included) and, for a package, what its
`__init__` imports from its own modules. For each of them the port has
either a name spelled the same somewhere in the same subpackage, or an
entry in one of the two tables below: `RENAMED` gives the port's name for
it, `NO_COUNTERPART` the reason it has none. One case a name, so a later
gap fails by name; a table entry that no longer answers a gap fails too.
"""

import ast
import importlib
import inspect
import pkgutil

import pytest

import aero_tpu
from test_torch_worker import port_module  # noqa: F401  one torch thread; releases JAX's programs


# (aero_tpu module, name) -> "port module:attribute"
RENAMED = {
    ("field.jax_gl", "to_gf"): "field.gl:from_u64",
    ("field.jax_gl", "from_gf"): "field.gl:to_u64",
    ("field.jax_gl", "power_series_dyn"): "field.gl:power_series_rows",
    ("hash.blake2s_jax", "felt_rows_to_word_cols"):
        "hash.blake2s:felt_rows_to_words",
    ("hash.blake2s_jax", "hash_rows_tuple"): "hash.blake2s:hash_elements_rows",
    ("hash.blake2s_jax", "merge_level_tuple"): "hash.blake2s:merge_pairs",
    ("hash.blake2s_jax", "merkle_root_tuple"): "merkle.tree:commit_digests",
    ("hash.blake2s_pallas", "blake2s_t"): "hash.blake2s_cuda:blake2s_words",
    ("hash.blake2s_pallas", "merkle_levels_t"): "merkle.tree:commit_digests",
    ("merkle.tree", "DeviceMerkleTree"): "merkle.tree:ResidentMerkleTree",
    ("ntt.ntt", "Twiddles"): "ntt.tables:radix2_twiddles",
    ("ntt.gl_np", "mul"): "ntt.tables:np_mul",
    ("ntt.gl_np", "power_series"): "ntt.tables:np_power_series",
    ("ntt.ntt_pallas", "ntt_pallas"): "ntt.ntt_cuda:ntt_cuda",
    ("parallel.sharded", "dist_lde_coeffs_cols"):
        "parallel.dist_ntt:dist_lde_coeffs",
}

# (aero_tpu module, name) -> why the port has nothing of that name
NO_COUNTERPART = {
    ("field.jax_gl", "GF"):
        "the (lo, hi) u32 limb pair of a TPU without 64-bit integers; a field "
        "array of the port is one int64 tensor, so there is no type to name",
    ("hash.blake2s_pallas", "felt_cols_to_words_t"):
        "it materialized eight u32 words a felt for the TPU kernel to read; "
        "the CUDA leaf kernel builds the message words in registers from the "
        "felts that `hash_columns` hands it",
    ("ntt.ntt_pallas", "supported"):
        "it told the dispatch which sizes the TPU kernel took so that the "
        "others went to the jnp path; `ntt_cuda` is the only route for a "
        "CUDA tensor, takes every power of two that three passes of 4096 reach "
        "(2^36) and raises beyond",
    ("parallel.sharded", "gf_scalar"):
        "it made the traced GF scalars of a jitted stage; the port's stages "
        "take their Fiat-Shamir scalars as Python ints (`field.scalar` makes "
        "a 0-d device element where one is wanted)",
}


def _submodules(pkg):
    return [pkg.__name__] + [m.name for m in pkgutil.walk_packages(
        pkg.__path__, pkg.__name__ + ".")]


def _is_generated(modname: str) -> bool:
    return modname.endswith("_pb2") or ".pb." in modname


def _public_names(modname: str):
    mod = importlib.import_module(modname)
    names = {n for n, obj in vars(mod).items()
             if not n.startswith("_") and callable(obj)
             and not inspect.ismodule(obj)
             and getattr(obj, "__module__", None) == modname}
    if hasattr(mod, "__path__"):                # a package: its own imports
        with open(mod.__file__) as f:
            tree = ast.parse(f.read())
        for node in tree.body:
            if isinstance(node, ast.ImportFrom) and node.level >= 1:
                for alias in node.names:
                    n = alias.asname or alias.name
                    if not n.startswith("_") and \
                            not inspect.ismodule(getattr(mod, n)):
                        names.add(n)
    return names


def _cases():
    """(subpackage, module below aero_tpu, name) for every public name; a
    name a package re-exports is listed under the module that defines it."""
    seen, out = set(), []
    for sub in sorted(m.name for m in pkgutil.iter_modules(aero_tpu.__path__)
                      if m.ispkg):
        pkg = importlib.import_module(f"aero_tpu.{sub}")
        for modname in _submodules(pkg):
            if _is_generated(modname):
                continue
            for name in sorted(_public_names(modname)):
                obj = getattr(importlib.import_module(modname), name)
                home = getattr(obj, "__module__", None) or modname
                if not str(home).startswith("aero_tpu."):
                    home = modname
                key = (sub, home[len("aero_tpu."):], name)
                if key not in seen:
                    seen.add(key)
                    out.append(key)
    return out


CASES = _cases()


def _port_names(sub: str):
    pkg = importlib.import_module(f"aero_tpu_torch.{sub}")
    names = set()
    for modname in _submodules(pkg):
        if not _is_generated(modname):
            names |= {n for n in vars(importlib.import_module(modname))
                      if not n.startswith("_")}
    return names


def _resolve(target: str):
    modname, attr = target.split(":")
    return getattr(importlib.import_module(f"aero_tpu_torch.{modname}"), attr)


def test_the_walk_sees_the_package():
    subs = {c[0] for c in CASES}
    assert subs == {"air", "field", "hash", "io", "merkle", "ntt", "parallel",
                    "prover", "sdk", "spec", "utils", "vm"}
    assert len(CASES) > 150
    for probe in (("field", "field.jax_gl", "mul_pow2_const"),
                  ("ntt", "ntt.ntt_mxu", "ntt_mxu"),
                  ("merkle", "merkle.tree", "commit_rows"),
                  ("prover", "prover.fri", "fold_evals_gf"),
                  ("field", "field.jax_gl", "power_series_dyn")):
        assert probe in CASES, probe


@pytest.mark.parametrize("sub,module,name", CASES,
                         ids=[f"{m}.{n}" for _, m, n in CASES])
def test_public_name_has_a_counterpart(sub, module, name):
    key = (module, name)
    if key in RENAMED:
        assert key not in NO_COUNTERPART
        assert callable(_resolve(RENAMED[key])), RENAMED[key]
        return
    if key in NO_COUNTERPART:
        reason = NO_COUNTERPART[key]
        assert len(reason) > 40 and "not needed" not in reason.lower()
        assert name not in _port_names(sub), \
            f"{name} exists in the port: drop its NO_COUNTERPART entry"
        return
    assert name in _port_names(sub), (
        f"aero_tpu.{module}.{name} has no counterpart in aero_tpu_torch.{sub}"
        " and no entry in RENAMED or NO_COUNTERPART")


def test_the_tables_hold_no_stale_entry():
    known = {(m, n) for _, m, n in CASES}
    for key in list(RENAMED) + list(NO_COUNTERPART):
        assert key in known, f"{key} is not a public name of aero_tpu"


@pytest.mark.parametrize("entry,port", [
    ("tools/check_constraints.py", "tools.check_constraints:main"),
    ("tools/demo.py", "tools.demo:main"),
    ("tools/generate_proof.py", "tools.generate_proof:main"),
    ("tools/regen_dryrun_golden.py", "tools.regen_dryrun_golden:main"),
    ("tools/stark_parser.py", "tools.stark_parser:main"),
    ("tools/tpu_check.py", "tools.card_check:main"),
    ("__graft_entry__.py:entry", "tools.card_check:entry"),
    ("__graft_entry__.py:dryrun_multichip",
     "parallel.dryrun:dryrun_prove_core"),
])
def test_entry_points_beside_the_package_have_counterparts(entry, port):
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.exists(os.path.join(root, entry.split(":")[0]))
    assert callable(_resolve(port))
