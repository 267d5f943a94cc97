"""No file of the benchmark imports JAX or the JAX package, and the plain
references import nothing of the program either: an `ast` walk of every
import, comparing the top-level name whole (the program's name begins with
the JAX package's)."""

import ast
import os

import pytest

import harness

FILES = sorted(
    os.path.join(d, f)
    for d, _, fs in os.walk(harness.BENCH) for f in fs if f.endswith(".py"))


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, harness.BENCH))
def test_imports(path):
    refused = {"jax", "jaxlib", "flax", "wgatools_tpu"}
    if os.path.relpath(path, harness.BENCH).startswith("reference"):
        refused.add("wgatools_tpu_torch")
    assert not set(imported(path)) & refused


def test_walk_sees_a_forbidden_import(tmp_path):
    p = tmp_path / "bad.py"
    p.write_text("import os\nfrom wgatools_tpu.core import cigar\n")
    assert "wgatools_tpu" in set(imported(str(p)))
    assert harness.forbidden_modules(["wgatools_tpu_torch.cli", "numpy"]) == []
    assert harness.forbidden_modules(["jax._src", "wgatools_tpu.io"]) == [
        "jax", "wgatools_tpu"]
