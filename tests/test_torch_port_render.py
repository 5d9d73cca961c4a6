"""``Evaluator.render_results`` against the JAX package's on the same results.

Twelve results of the synthetic hand (the port's decode of the standard OPT
inputs, seed 0, B=12), each over a source image of its own: PNG and JPEG
files of several shapes (written by cv2), one missing file (a blank
canvas) and one that is not an image (cv2.imread's None: a blank canvas
too). Both Evaluators hold the same entries; every ``.jpg`` they write must
be the same bytes: the serial path (5 results, ``num_workers=1``) and the
forked path (12 results, 3 workers), whose files must also equal the port's
serial ones. Each is (2 size, size, 3): the letterboxed source above the
render, size = 2 input_size; input_size 56 keeps the renders small.
"""

import os
import os.path as osp

import cv2
import numpy as np
import pytest
import torch

from ihmr_tpu.eval.evaluator import Evaluator as JEvaluator
from ihmr_tpu_torch.data import image_io, make_opt_inputs
from ihmr_tpu_torch.eval import Evaluator
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.refine.opt_engine import forward
from tests.torch_threads import one_torch_thread  # noqa: F401

N = 12
SHAPES = ((120, 90), (64, 130), (112, 112), (37, 53))


@pytest.fixture(scope="module")
def evaluators(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("render_src"))
    model = synthetic_mano_model(device="cpu")
    params, _ = make_opt_inputs(model, batch=N, seed=0)
    with torch.no_grad():
        rv, lv, j3, j2 = forward(model, params)
    rng = np.random.RandomState(0)
    data_list = []
    for i in range(N):
        h, w = SHAPES[i % len(SHAPES)]
        name = f"seq{i % 3}/cam{i % 2}/image{i:04d}." + ("jpg" if i % 2 else "png")
        data_list.append(dict(img_path=name))
        if i == 4:
            continue  # a missing source image
        os.makedirs(osp.join(root, osp.dirname(name)), exist_ok=True)
        if i == 7:
            with open(osp.join(root, name), "wb") as f:
                f.write(b"not an image")
            continue
        cv2.imwrite(osp.join(root, name), rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    results = dict(
        pred_cam_params=params["cam"], pred_shape_params=torch.zeros(N, 20), pred_pose_params=torch.zeros(N, 96),
        pred_hand_trans=params["trans"], pred_joints_3d=j3, pred_joints_2d=j2,
        gt_joints_3d=torch.cat([j3, torch.ones(N, 42, 1)], -1), collision_loss_origin_scale=torch.zeros(N, 1556),
        pred_right_hand_verts=rv, pred_left_hand_verts=lv, do_flip=torch.zeros(N, dtype=torch.int32),
    )
    faces = model.faces.numpy()
    kwargs = dict(image_root=root, input_size=56, right_faces=faces, left_faces=np.ascontiguousarray(faces[:, ::-1]))
    ours = Evaluator(data_list, **kwargs)
    ours.update(torch.arange(N), results)
    ref = JEvaluator(data_list, **kwargs)
    ref.update(np.arange(N), {k: v.numpy() for k, v in results.items()})
    return ours, ref


def _files(d):
    return {n: open(osp.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


def test_serial_render_matches_jax(evaluators, tmp_path):
    ours, ref = evaluators
    ours.render_results(str(tmp_path / "port"), limit=5, num_workers=1)
    ref.render_results(str(tmp_path / "jax"), limit=5, num_workers=1)
    port, jax_files = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert list(port) == list(jax_files) and len(port) == 5 and "seq1_cam0_image0004.jpg" in port  # the missing one
    for name in port:
        assert port[name] == jax_files[name], name
        img = image_io.imread(str(tmp_path / "port" / name))
        assert img.shape == (224, 112, 3)
    blank = image_io.imread(str(tmp_path / "port" / "seq1_cam0_image0004.jpg"))
    assert blank[:112].max() <= 8 and blank[112:].max() > 100  # no source: the render on a black canvas


def test_forked_render_matches_jax_and_the_serial_one(evaluators, tmp_path):
    ours, ref = evaluators
    ours.render_results(str(tmp_path / "port"), num_workers=3)
    ref.render_results(str(tmp_path / "jax"), num_workers=3)
    ours.render_results(str(tmp_path / "serial"), num_workers=1)
    port, jax_files, serial = _files(tmp_path / "port"), _files(tmp_path / "jax"), _files(tmp_path / "serial")
    assert list(port) == list(jax_files) == list(serial) and len(port) == N
    for name in port:
        assert port[name] == jax_files[name] == serial[name], name
