"""The port stands alone: ``ihmr_tpu_torch/`` and ``chip_smoke.py`` import
nothing of jax, flax, optax or the JAX package ``ihmr_tpu``, and neither
cv2 nor PIL (an AST scan of every import statement, including ones inside
functions); and its data
layer, command line and renderer run without cv2 or PIL (the card's
machine has neither): a fresh interpreter where both imports fail reads a
PNG corpus through every dataset, decodes every committed JPEG fixture to
the bytes cv2 gives and runs the augmentation cases
(``image_cases.check_fixtures``), writes the encoder's cases as the bytes
cv2 writes (``image_cases.check_encoder``), trains through the CLI on a
JPEG corpus with the rotation, colour-jitter and motion-blur flags on,
renders one result to a ``.jpg`` (``Evaluator.render_results``), writes a
gallery and its loss curves through ``Visualizer`` (the curves skipped:
matplotlib cannot be imported without PIL), and raises on a broken JPEG,
naming the file."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ihmr_tpu")
IMAGE_LIBRARIES = ("cv2", "PIL")
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


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_cv2_or_pil_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in IMAGE_LIBRARIES]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert "chip_smoke.py" in names
    assert {
        "ihmr_tpu_torch/cli.py",
        "ihmr_tpu_torch/core/procrustes.py",
        "ihmr_tpu_torch/core/rotations.py",
        "ihmr_tpu_torch/data/compose.py",
        "ihmr_tpu_torch/data/cv_ops.py",
        "ihmr_tpu_torch/data/datasets.py",
        "ihmr_tpu_torch/data/image_cases.py",
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
        "ihmr_tpu_torch/ops/grid_sdf.py",
        "ihmr_tpu_torch/ops/nearest_centroid.py",
        "ihmr_tpu_torch/refine/adam.py",
        "ihmr_tpu_torch/refine/escalation.py",
        "ihmr_tpu_torch/refine/mlp_engine.py",
        "ihmr_tpu_torch/refine/opt_engine.py",
        "ihmr_tpu_torch/refine/tracker.py",
        "ihmr_tpu_torch/serve.py",
        "ihmr_tpu_torch/train/baseline.py",
        "ihmr_tpu_torch/train/checkpoint.py",
        "ihmr_tpu_torch/train/loops.py",
        "ihmr_tpu_torch/train/mlp.py",
        "ihmr_tpu_torch/train/profiling.py",
        "ihmr_tpu_torch/train/stats.py",
        "ihmr_tpu_torch/utils/io_utils.py",
        "ihmr_tpu_torch/utils/live_dashboard.py",
        "ihmr_tpu_torch/utils/train_visuals.py",
        "ihmr_tpu_torch/utils/vis.py",
        "ihmr_tpu_torch/utils/visualizer.py",
        "ihmr_tpu_torch/parallel/dist.py",
        "ihmr_tpu_torch/parallel/__init__.py",
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
from ihmr_tpu_torch.data.image_cases import FIXTURE_DIR, check_encoder, check_fixtures
from ihmr_tpu_torch.data.image_io import imread
from ihmr_tpu_torch.data.synthetic import use_jpeg_images, write_blur_kernels, write_corpus

root = sys.argv[2]
write_corpus(root, 3, seed=2)
for cls, extra in ((BaselineDataset, dict(is_train=True, use_random_flip=True, use_random_rescale=True)),
                   (OPTDataset, dict(pred_path="pred.pkl")), (MLPDataset, dict(pred_path="pred.pkl"))):
    ds = cls(DataConfig(data_root=root, anno_path="anno.pkl", batch_size=2, **extra))
    ds.load_data()
    items = [ds[i] for i in range(len(ds))]
    assert all(v.dtype.kind in "fiu" for item in items for v in item.values())
check_fixtures()
jpeg_root, blur = os.path.join(root, "jpeg"), os.path.join(root, "blur")
write_corpus(jpeg_root, 4, seed=3)
use_jpeg_images(jpeg_root, [os.path.join(FIXTURE_DIR, n) for n in ("corpus_256x192.jpg", "corpus_192x256.jpg")])
write_blur_kernels(blur)
out = ihmr_tpu_torch.cli.main([
    "train-baseline", "--data_root", jpeg_root, "--anno_path", "anno.pkl", "--batchSize", "2", "--synthetic_mano",
    "--inputSize", "64", "--main_encoder", "resnet18", "--checkpoints_dir", os.path.join(root, "ckpt"),
    "--device", "cpu", "--total_epoch", "1", "--use_random_flip", "--use_random_rescale", "--use_random_position",
    "--use_random_rotation", "--use_color_jittering", "--use_motion_blur", "--blur_kernel_dir", blur,
])
assert out["epoch_stats"][0]["steps"] == 2, out
check_encoder()

import numpy as np
from ihmr_tpu_torch.data import make_opt_inputs
from ihmr_tpu_torch.eval import Evaluator
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.refine.opt_engine import forward
from ihmr_tpu_torch.utils.train_visuals import visuals_from_eval_outputs
from ihmr_tpu_torch.utils.visualizer import Visualizer

model = synthetic_mano_model(device="cpu")
params, _ = make_opt_inputs(model, batch=1, seed=0)
with torch.no_grad():
    rv, lv, j3, j2 = forward(model, params)
ev = Evaluator([dict(img_path="corpus_256x192.jpg")], image_root=FIXTURE_DIR, input_size=64,
               right_faces=model.faces.numpy(), left_faces=model.faces.flip(-1).numpy())
ev.update(torch.arange(1), dict(
    pred_cam_params=params["cam"], pred_shape_params=torch.zeros(1, 20), pred_pose_params=torch.zeros(1, 96),
    pred_hand_trans=params["trans"], pred_joints_3d=j3, pred_joints_2d=j2, gt_joints_3d=torch.zeros(1, 42, 4),
    collision_loss_origin_scale=torch.zeros(1, 1556), pred_right_hand_verts=rv, pred_left_hand_verts=lv,
    do_flip=torch.zeros(1, dtype=torch.int32)))
ev.render_results(os.path.join(root, "render"))
assert imread(os.path.join(root, "render", "corpus_256x192.jpg")).shape == (256, 128, 3)
vis = Visualizer(os.path.join(root, "gallery"))
batch = type("B", (), dict(img=torch.zeros(1, 64, 64, 3), joints_2d=torch.zeros(1, 42, 3)))
outputs = dict(pred_joints_2d=j2, pred_cam_params=params["cam"], gt_right_hand_verts=rv, gt_left_hand_verts=lv,
               pred_right_hand_verts=rv, pred_left_hand_verts=lv)
vis.display_current_results(visuals_from_eval_outputs(batch, outputs, model.faces, model.faces.flip(-1), input_size=64), 1)
vis.plot_current_errors(1.0, {"total_loss": 1.0})
assert len(os.listdir(vis.img_dir)) == 5 and vis.curves_skipped is not None
jpg = os.path.join(root, "x.jpg")
with open(jpg, "wb") as f:
    f.write(bytes([0xFF, 0xD8, 0xFF, 0xE0]) + bytes(16))
try:
    imread(jpg)
except ValueError as err:
    assert jpg in str(err), err
else:
    raise AssertionError("a broken JPEG did not raise")
assert sys.modules["cv2"] is None and sys.modules["PIL"] is None
print("ok")
"""


def test_data_layer_and_cli_run_without_cv2_or_pil(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _NO_IMAGE_LIBRARIES, str(ROOT), str(tmp_path / "corpus")],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
