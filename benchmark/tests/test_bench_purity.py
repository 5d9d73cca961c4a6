"""The check of loaded modules, and what the benchmark's own files import."""

from __future__ import annotations

import ast
from pathlib import Path

import bench_helpers  # noqa: F401  (the repository's root on sys.path)
from benchmark import harness

BENCH = harness.HERE
# the yardstick: none of it may import the program
YARDSTICK = ("reference", "inputs", "counts", "metrics")


def imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


def test_check_finds_a_planted_jax_and_passes_the_port():
    assert harness.forbidden_modules(["jax.numpy", "torch", "ihmr_tpu_torch.ops"]) == ["jax.numpy"]
    assert harness.forbidden_modules(["ihmr_tpu.refine", "ihmr_tpu_torch", "flax", "optax.x", "chex"]) == [
        "chex", "flax", "ihmr_tpu.refine", "optax.x"]
    assert harness.forbidden_modules(["ihmr_tpu_torch", "ihmr_tpu_torch.refine.opt_engine", "jaxtyping"]) == []


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        roots = set(imported_roots(path))
        assert not roots & set(harness.FORBIDDEN), path


def test_the_yardstick_imports_nothing_of_the_program():
    for part in YARDSTICK:
        for path in (BENCH / part).rglob("*.py"):
            assert "ihmr_tpu_torch" not in set(imported_roots(path)), path
