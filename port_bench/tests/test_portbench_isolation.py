"""Nothing in port_bench imports JAX or the JAX package, and the plain
reference imports nothing of the program: top-level module names compared
whole (popcorn_tpu_torch is the port, popcorn_tpu the JAX package)."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "popcorn_tpu"}


def _sources():
    for d, _, files in os.walk(BENCH):
        if ".cache" in d.split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    """Top-level names of every absolute import in the file."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_walk_sees_the_harness():
    files = {os.path.relpath(p, BENCH) for p in _sources()}
    assert "run.py" in files and os.path.join("reference", "model.py") in files


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    bad = top_level_imports(path) & FORBIDDEN
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted(p for p in _sources()
                                        if os.sep + "reference" + os.sep in p),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "popcorn_tpu_torch" not in names and not names & FORBIDDEN


def test_whole_names_are_compared():
    assert "popcorn_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "jax_helpers".split(".")[0] not in FORBIDDEN
