"""Training-time visual panels (port of ihmr_tpu/utils/train_visuals.py).

Builds the reference's OrderedDict of panels for one sample: the input image,
GT/pred keypoint overlays, per-hand mesh renders, and the combined two-hand
render, with the software rasterizer of ihmr_tpu_torch.utils.vis: the same
keys in the same order and every panel equal to the JAX package's bit for
bit. ``visuals_from_eval_outputs`` takes the batch and outputs as torch
tensors on any device (or numpy arrays) and reads one sample to the host.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np

import torch

from ihmr_tpu_torch.utils import vis


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_training_visuals(
    img_normalized: np.ndarray,  # (H, W, 3) in [-1, 1]
    joints_2d_gt: np.ndarray,  # (42, 3)
    joints_2d_pred: np.ndarray,  # (42, 2)
    cam_pred: np.ndarray,  # (3,)
    gt_right_verts: np.ndarray,
    gt_left_verts: np.ndarray,
    pred_right_verts: np.ndarray,
    pred_left_verts: np.ndarray,
    right_faces: np.ndarray,
    left_faces: np.ndarray,
    input_size: int = 224,
) -> "OrderedDict[str, np.ndarray]":
    show_img = vis.recover_img(img_normalized)
    visuals: "OrderedDict[str, np.ndarray]" = OrderedDict()
    visuals["img"] = np.concatenate([show_img, show_img], axis=1)

    kp_w = joints_2d_gt[:, 2:]
    kp_img = vis.draw_keypoints(img_normalized, joints_2d_gt[:, :2], kp_w, "red", input_size)
    pred_kp_img = vis.draw_keypoints(img_normalized, joints_2d_pred[:, :2], kp_w, "green", input_size)

    colors = [np.asarray(vis.COLORS["light_green"]), np.asarray(vis.COLORS["light_blue"])]
    faces = [_np(right_faces), _np(left_faces)]

    def two_hand(right_v, left_v):
        return vis.render_together(
            [np.asarray(right_v), np.asarray(left_v)], faces, colors, cam_pred, input_size, show_img
        )

    def single(v, f, color):
        return vis.render_mesh_to_image(
            input_size, show_img, cam_pred, np.asarray(v), np.asarray(f), color
        )

    gt_sep = np.concatenate(
        [single(gt_right_verts, faces[0], "light_green"), single(gt_left_verts, faces[1], "light_blue")],
        axis=1,
    )
    pred_sep = np.concatenate(
        [
            single(pred_right_verts, faces[0], "light_green"),
            single(pred_left_verts, faces[1], "light_blue"),
        ],
        axis=1,
    )
    visuals["gt_render_img (separate)"] = gt_sep
    visuals["pred_render_img (separate)"] = pred_sep
    visuals["render together (gt / pred)"] = np.concatenate(
        [two_hand(gt_right_verts, gt_left_verts), two_hand(pred_right_verts, pred_left_verts)],
        axis=1,
    )
    visuals["keypoint (gt / pred)"] = np.concatenate([kp_img, pred_kp_img], axis=1)
    return visuals


def visuals_from_eval_outputs(
    batch, outputs: Dict[str, np.ndarray], right_faces, left_faces, idx: int = 0, input_size: int = 224
):
    """Convenience: build panels from a BaselineBatch + eval_step outputs."""
    return make_training_visuals(
        _np(batch.img[idx]),
        _np(batch.joints_2d[idx]),
        _np(outputs["pred_joints_2d"][idx]),
        _np(outputs["pred_cam_params"][idx]),
        _np(outputs["gt_right_hand_verts"][idx]),
        _np(outputs["gt_left_hand_verts"][idx]),
        _np(outputs["pred_right_hand_verts"][idx]),
        _np(outputs["pred_left_hand_verts"][idx]),
        right_faces,
        left_faces,
        input_size,
    )
