"""The port stands alone: ``ihmr_tpu_torch/`` and ``chip_smoke.py`` import
nothing of jax, flax, optax or the JAX package ``ihmr_tpu`` (an AST scan of
every import statement, including ones inside functions); and its data
layer and command line run without cv2 or PIL (the card's machine has
neither): a fresh interpreter where both imports fail reads a PNG corpus
through every dataset, and a JPEG raises naming the file and cv2."""

import ast
import pathlib
import subprocess
import sys

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
        "ihmr_tpu_torch/cli.py",
        "ihmr_tpu_torch/core/procrustes.py",
        "ihmr_tpu_torch/data/compose.py",
        "ihmr_tpu_torch/data/datasets.py",
        "ihmr_tpu_torch/data/image_io.py",
        "ihmr_tpu_torch/data/loader.py",
        "ihmr_tpu_torch/data/native.py",
        "ihmr_tpu_torch/data/preprocess.py",
        "ihmr_tpu_torch/eval/evaluator.py",
        "ihmr_tpu_torch/eval/export.py",
        "ihmr_tpu_torch/eval/metrics.py",
        "ihmr_tpu_torch/eval/result_stat.py",
        "ihmr_tpu_torch/mano/layer.py",
        "ihmr_tpu_torch/mano/loader.py",
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


_NO_IMAGE_LIBRARIES = r"""
import os, sys
sys.modules["cv2"] = None
sys.modules["PIL"] = None
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(1)
import ihmr_tpu_torch.cli
from ihmr_tpu_torch.data import BaselineDataset, DataConfig, MLPDataset, OPTDataset
from ihmr_tpu_torch.data.image_io import imread
from ihmr_tpu_torch.data.synthetic import write_corpus

root = sys.argv[2]
write_corpus(root, 3, seed=2)
for cls, extra in ((BaselineDataset, dict(is_train=True, use_random_flip=True, use_random_rescale=True)),
                   (OPTDataset, dict(pred_path="pred.pkl")), (MLPDataset, dict(pred_path="pred.pkl"))):
    ds = cls(DataConfig(data_root=root, anno_path="anno.pkl", batch_size=2, **extra))
    ds.load_data()
    items = [ds[i] for i in range(len(ds))]
    assert all(v.dtype.kind in "fiu" for item in items for v in item.values())
jpg = os.path.join(root, "x.jpg")
with open(jpg, "wb") as f:
    f.write(bytes([0xFF, 0xD8, 0xFF, 0xE0]) + bytes(16))
try:
    imread(jpg)
except RuntimeError as err:
    assert jpg in str(err) and "cv2" in str(err), err
else:
    raise AssertionError("a JPEG without cv2 did not raise")
assert sys.modules["cv2"] is None and sys.modules["PIL"] is None
print("ok")
"""


def test_data_layer_and_cli_run_without_cv2_or_pil(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _NO_IMAGE_LIBRARIES, str(ROOT), str(tmp_path / "corpus")],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
