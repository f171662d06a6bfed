"""Name parity of the port with the JAX package, by AST: every public
top-level def or class of every kaamer_tpu/**/*.py has a counterpart at
the same relative path in kaamer_tpu_torch/, or one under another name
(RENAMES: JAX-only idioms, such as the jnp twins and the make_* builders
of jitted steps, ported as plain torch functions), or stands in EXCLUDED
with its reason.  EXCLUDED may hold only code with no caller in the JAX
package or code that names the TPU runtime; nothing that computes a
search result, writes an artifact or serves a route."""

import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = "kaamer_tpu", "kaamer_tpu_torch"

# (JAX module, name) -> (port module, name)
RENAMES = {
    ("codec.py", "encode_kmers"): ("codec.py", "encode_kmers_np"),
    ("codec.py", "encode_kmers_jnp"): ("codec.py", "encode_kmers"),
    ("codec.py", "unpack_codes3_jnp"): ("codec.py", "unpack_codes3"),
    ("codec.py", "unpack_codes7_jnp"): ("codec.py", "unpack_codes7"),
    ("parallel/mesh.py", "make_sharded_totals"):
        ("parallel/mesh.py", "sharded_totals"),
    ("parallel/mesh.py", "make_sharded_group"):
        ("parallel/mesh.py", "sharded_group"),
    ("parallel/mesh.py", "make_sharded_search"):
        ("parallel/mesh.py", "sharded_search"),
    # the Pallas wavefront's batch API: dispatch then resolve on the card
    ("ops/swalign_pallas.py", "sw_batch_device"):
        ("ops/swalign_cuda.py", "sw_batch_dispatch"),
    ("ops/swalign_pallas.py", "sw_batch_dispatch"):
        ("ops/swalign_cuda.py", "sw_batch_dispatch"),
    ("ops/swalign_pallas.py", "sw_batch_resolve"):
        ("ops/swalign_cuda.py", "sw_batch_resolve"),
    # string pairs in, alignments out
    ("ops/swalign_pallas.py", "align_pairs"):
        ("ops/swalign.py", "align_batch"),
}

# (JAX module, name) -> reason; each is checked to have no caller
EXCLUDED = {
    ("search/engine.py", "_cap_clamp"):
        "no caller: nothing in kaamer_tpu calls it",
}


def _modules(pkg):
    base = os.path.join(ROOT, pkg)
    for root, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), base)


def _top_level(pkg, rel):
    """Names bound at module level: defs, classes and assignments."""
    path = os.path.join(ROOT, pkg, rel)
    if not os.path.exists(path):
        return set(), set()
    tree = ast.parse(open(path).read())
    defs = {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))}
    bound = set(defs)
    for n in tree.body:
        if isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            bound |= {t.id for t in targets if isinstance(t, ast.Name)}
    return defs, bound


JAX_PUBLIC = sorted((rel, name) for rel in _modules(JAX)
                    for name in _top_level(JAX, rel)[0]
                    if not name.startswith("_"))


@pytest.mark.parametrize("rel", sorted(set(_modules(JAX))))
def test_every_public_name_has_a_port(rel):
    missing = []
    for name in sorted(_top_level(JAX, rel)[0]):
        if name.startswith("_") or (rel, name) in EXCLUDED:
            continue
        port_rel, port_name = RENAMES.get((rel, name), (rel, name))
        if port_name not in _top_level(PORT, port_rel)[1]:
            missing.append(f"{rel}:{name} -> {port_rel}:{port_name}")
    assert not missing, missing


def test_renames_and_exclusions_name_real_code():
    """Every entry of the maps names a JAX function that exists; no
    renamed name is excluded too."""
    for rel, name in list(RENAMES) + list(EXCLUDED):
        assert name in _top_level(JAX, rel)[0], (rel, name)
    assert not set(RENAMES) & set(EXCLUDED)
    assert len(JAX_PUBLIC) > 100  # the walk found the package


@pytest.mark.parametrize("key", list(EXCLUDED))
def test_exclusions_have_no_caller(key):
    """An excluded name appears in the JAX package only where it is
    defined, and has no port."""
    rel, name = key
    assert EXCLUDED[key]
    uses = []
    for mod in _modules(JAX):
        src = open(os.path.join(ROOT, JAX, mod)).read()
        uses += [(mod, m.start()) for m in re.finditer(rf"\b{name}\b", src)]
    assert len(uses) == 1 and uses[0][0] == rel, uses
    assert name not in _top_level(PORT, rel)[1]
