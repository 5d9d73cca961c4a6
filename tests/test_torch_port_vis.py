"""The rendering and visualization slice (``utils/vis.py``,
``utils/train_visuals.py``, ``utils/visualizer.py``,
``utils/live_dashboard.py``) against the JAX package on the same inputs.

Inputs: two synthetic hand pairs from the port's decode (the standard OPT
inputs, seed 0), a seeded normalized image, seeded keypoints (some out of
the image, some of weight 0). Every array the renderer returns must be
equal to the JAX package's bit for bit (the same float64 z-buffer
arithmetic in the same order; the port's uint8 resize and radius-2 dot are
OpenCV's bit for bit), the panels' OrderedDict must have the same keys in
the same order, the gallery's PNGs the same pixels as cv2 wrote (not the
same zlib bytes) and its index.html the same text, and the live monitor's
``/`` and ``/losses.json`` the same bytes.
"""

import json
import os
import types
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from ihmr_tpu.utils import live_dashboard as JD
from ihmr_tpu.utils import train_visuals as JTV
from ihmr_tpu.utils import vis as JV
from ihmr_tpu.utils import visualizer as JVZ
from ihmr_tpu_torch.data import make_opt_inputs
from ihmr_tpu_torch.mano import synthetic_mano_model
from ihmr_tpu_torch.refine.opt_engine import forward
from ihmr_tpu_torch.utils import live_dashboard as TD
from ihmr_tpu_torch.utils import train_visuals as TTV
from ihmr_tpu_torch.utils import vis as TV
from ihmr_tpu_torch.utils import visualizer as TVZ
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def scene():
    model = synthetic_mano_model(device="cpu")
    params, _ = make_opt_inputs(model, batch=2, seed=0)
    with torch.no_grad():
        rv, lv, _, j2d = forward(model, params)
    rng = np.random.RandomState(0)
    faces = model.faces.numpy()
    kp = np.concatenate([rng.uniform(-1.2, 1.2, (42, 2)), (rng.rand(42, 1) > 0.2)], -1).astype(np.float32)
    return types.SimpleNamespace(
        rv=rv.numpy(), lv=lv.numpy(), j2d=j2d.numpy(), cam=params["cam"].numpy(), faces=faces,
        faces_l=np.ascontiguousarray(faces[:, ::-1]), img=rng.uniform(-1, 1, (224, 224, 3)).astype(np.float32),
        small=rng.uniform(-1, 1, (112, 112, 3)).astype(np.float32), kp=kp,
        bg=rng.randint(0, 256, (224, 224, 3)).astype(np.uint8),
    )


def _equal(a, b, msg=""):
    assert a.dtype == b.dtype and a.shape == b.shape, msg
    np.testing.assert_array_equal(a, b, err_msg=msg)


def test_renderer_matches_jax_bit_for_bit(scene):
    s = scene
    _equal(TV.recover_img(s.img), JV.recover_img(s.img))
    for i in range(2):
        pix_t, pix_j = TV.project_verts(s.rv[i], s.cam[i], 224), JV.project_verts(s.rv[i], s.cam[i], 224)
        _equal(pix_t, pix_j)
        for ours, ref in zip(TV.rasterize(pix_t, s.faces, 224, TV.COLORS["pink"]),
                             JV.rasterize(pix_j, s.faces, 224, JV.COLORS["pink"])):
            _equal(ours, ref)
        for bg in (None, s.bg):
            for color, alpha in (("light_green", 1.0), (np.array([0.1, 0.5, 0.9]), 0.5)):
                _equal(TV.render_mesh_to_image(224, bg, s.cam[i], s.rv[i], s.faces, color, alpha),
                       JV.render_mesh_to_image(224, bg, s.cam[i], s.rv[i], s.faces, color, alpha))
        args = ([s.rv[i], s.lv[i]], [s.faces, s.faces_l])
        ours = TV.render_together(*args, [TV.COLORS["light_green"], TV.COLORS["light_blue"]], s.cam[i], 224, s.bg)
        ref = JV.render_together(*args, [JV.COLORS["light_green"], JV.COLORS["light_blue"]], s.cam[i], 224, s.bg)
        _equal(ours, ref)
        assert (ours != s.bg).any(-1).mean() > 0.02  # the hands cover part of the image


def test_keypoints_match_jax(scene):
    s = scene
    for img, size in ((s.img, 224), (s.small, 224), (s.img, 160)):  # the last two through the uint8 resize
        for color in ("red", "green"):
            _equal(TV.draw_keypoints(img, s.kp[:, :2], s.kp[:, 2:], color, size),
                   JV.draw_keypoints(img, s.kp[:, :2], s.kp[:, 2:], color, size), f"{img.shape} {size}")


def _outputs(s):
    return {
        "pred_joints_2d": s.j2d, "pred_cam_params": s.cam, "gt_right_hand_verts": s.rv[::-1].copy(),
        "gt_left_hand_verts": s.lv[::-1].copy(), "pred_right_hand_verts": s.rv, "pred_left_hand_verts": s.lv,
    }


def test_training_panels_match_jax(scene):
    s = scene
    out = _outputs(s)
    imgs = np.stack([s.img, -s.img])
    joints = np.stack([s.kp, s.kp[::-1]])
    ref = JTV.visuals_from_eval_outputs(types.SimpleNamespace(img=imgs, joints_2d=joints), out, s.faces, s.faces_l,
                                        idx=1)
    # the port reads a batch and outputs of torch tensors (on any device), faces as tensors too
    ours = TTV.visuals_from_eval_outputs(
        types.SimpleNamespace(img=torch.as_tensor(imgs), joints_2d=torch.as_tensor(joints)),
        {k: torch.as_tensor(v) for k, v in out.items()}, torch.as_tensor(s.faces), torch.as_tensor(s.faces_l), idx=1,
    )
    assert list(ours) == list(ref) == ["img", "gt_render_img (separate)", "pred_render_img (separate)",
                                       "render together (gt / pred)", "keypoint (gt / pred)"]
    for key in ref:
        _equal(ours[key], ref[key], key)


def _read_rgb(path):
    img = cv2.imread(path)
    assert img is not None, path
    return img


def test_gallery_curves_and_tiles_match_jax(scene, tmp_path):
    s = scene
    panels = JTV.visuals_from_eval_outputs(
        types.SimpleNamespace(img=s.img[None], joints_2d=s.kp[None]), {k: v[:1] for k, v in _outputs(s).items()},
        s.faces, s.faces_l,
    )
    panels["float panel"] = (s.img * 200.0 + 40.0)  # not uint8: clipped and cast on the way
    vis = {"port": TVZ.Visualizer(str(tmp_path / "port"), name="gallery"),
           "jax": JVZ.Visualizer(str(tmp_path / "jax"), name="gallery")}
    for v in vis.values():
        for epoch, it in ((1, 0), (1, 8), (2, 3)):
            v.display_current_results(panels, epoch, it)
        for k in range(3):
            v.plot_current_errors(1 + k / 3, {"total_loss": 2.0 - k * 0.1, "joints_2d_loss": 0.5 + k})
    web = {k: v.web_dir for k, v in vis.items()}
    names = sorted(os.listdir(os.path.join(web["jax"], "images")))
    assert names == sorted(os.listdir(os.path.join(web["port"], "images"))) and len(names) == 18
    for name in names:
        _equal(_read_rgb(os.path.join(web["port"], "images", name)), _read_rgb(os.path.join(web["jax"], "images", name)),
               name)
    assert open(os.path.join(web["port"], "index.html")).read() == open(os.path.join(web["jax"], "index.html")).read()
    assert vis["port"]._loss_history == vis["jax"]._loss_history
    # matplotlib is installed here: both draw the curves
    assert vis["port"].curves_skipped is None
    assert all(os.path.exists(os.path.join(w, "loss_curves.png")) for w in web.values())

    # save_vis_result: panels of other heights resized to the tallest (uint8 resize, bit for bit)
    tiles = dict(panels)
    tiles["short"] = panels["img"][::2, ::3]
    tiles["odd"] = panels["keypoint (gt / pred)"][:150]
    TVZ.save_vis_result(tiles, str(tmp_path / "tile_port"), 3, 12)
    JVZ.save_vis_result(tiles, str(tmp_path / "tile_jax"), 3, 12)
    name = "epoch003_iter000012.png"
    _equal(_read_rgb(str(tmp_path / "tile_port" / name)), _read_rgb(str(tmp_path / "tile_jax" / name)))


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as err:
        return err.code, None, b""


def test_live_dashboard_matches_jax(tmp_path, capsys):
    dashes = {}
    for key, mod in (("port", TD), ("jax", JD)):
        web = tmp_path / key
        (web / "images").mkdir(parents=True)
        for i in range(8):
            (web / "images" / f"epoch001_{i:06d}_img.png").write_bytes(bytes([i]) * 10)
        (web / "images" / "notes.txt").write_text("not an image")
        dash = mod.LiveDashboard(str(web), name="monitor")
        for step in range(5):
            dash.update(step / 4, {"total_loss": 3.0 / (step + 1), "collision_loss": step * 0.25})
        dashes[key] = (dash, dash.start(0))
    try:
        printed = capsys.readouterr().out
        for key, (dash, port) in dashes.items():
            assert f"[live] training monitor at http://localhost:{port}/" in printed
        bodies = {}
        for key, (_, port) in dashes.items():
            bodies[key] = [_get(port, p) for p in ("/", "/index.html", "/losses.json?t=1",
                                                    "/images/epoch001_000003_img.png", "/images/missing.png", "/x")]
        assert bodies["port"] == bodies["jax"]
        page, _, losses, image, missing, other = bodies["port"]
        assert page[0] == 200 and page[1] == "text/html" and b"monitor" in page[2]
        series = json.loads(losses[2])
        # the last 6 files by name, the text file among them left out
        assert len(series["series"]["total_loss"]) == 5 and len(series["images"]) == 5
        assert image == (200, "image/png", bytes([3]) * 10) and missing[0] == 404 and other[0] == 404
    finally:
        for dash, _ in dashes.values():
            dash.stop()
