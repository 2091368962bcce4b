"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import os

from .conftest import REPO

BENCH = os.path.join(REPO, "benchmark")


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    bad = {(p, m) for p in _sources(BENCH) for m in _imports(p)
           if m in ("jax", "jaxlib", "flax", "colate_tpu")}
    assert not bad


def test_reference_imports_nothing_of_the_program():
    bad = {(p, m) for p in _sources(os.path.join(BENCH, "reference")) for m in _imports(p)
           if m not in ("__future__", "dataclasses", "math", "numpy", "torch", "benchmark")}
    assert not bad


def test_reference_imports_only_the_reference():
    for p in _sources(os.path.join(BENCH, "reference")):
        with open(p) as fh:
            tree = ast.parse(fh.read(), p)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("benchmark"):
                assert node.module == "benchmark.reference", (p, node.module)


def test_a_loaded_jax_is_found():
    import sys

    from benchmark.harness.main import forbidden_modules

    sys.modules["colate_tpu.fake"] = object()
    try:
        assert forbidden_modules() == ["colate_tpu.fake"]
    finally:
        del sys.modules["colate_tpu.fake"]
    assert "colate_tpu_torch" not in forbidden_modules()
