"""The port stands alone: ``ihmr_tpu_torch/`` and ``chip_smoke.py`` import
nothing of jax, flax, optax or the JAX package ``ihmr_tpu`` (an AST scan of
every import statement, including ones inside functions)."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ihmr_tpu")
SOURCES = sorted((ROOT / "ihmr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", None)) in (
            "import_module",
            "__import__",
        ):
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert "chip_smoke.py" in names
    assert {
        "ihmr_tpu_torch/core/procrustes.py",
        "ihmr_tpu_torch/eval/evaluator.py",
        "ihmr_tpu_torch/eval/export.py",
        "ihmr_tpu_torch/eval/metrics.py",
        "ihmr_tpu_torch/eval/result_stat.py",
        "ihmr_tpu_torch/mano/layer.py",
        "ihmr_tpu_torch/ops/bn_stats.py",
        "ihmr_tpu_torch/ops/exact_collision.py",
        "ihmr_tpu_torch/ops/nearest_centroid.py",
        "ihmr_tpu_torch/refine/adam.py",
        "ihmr_tpu_torch/refine/mlp_engine.py",
        "ihmr_tpu_torch/refine/opt_engine.py",
        "ihmr_tpu_torch/train/baseline.py",
        "ihmr_tpu_torch/train/checkpoint.py",
        "ihmr_tpu_torch/train/loops.py",
        "ihmr_tpu_torch/train/mlp.py",
        "ihmr_tpu_torch/train/profiling.py",
        "ihmr_tpu_torch/train/stats.py",
        "ihmr_tpu_torch/utils/io_utils.py",
    } <= names
