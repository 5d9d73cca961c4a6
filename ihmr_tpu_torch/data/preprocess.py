"""Host-side image and annotation preprocessing (port of ihmr_tpu/data/preprocess.py).

The handedness vector, the top-left anchored letterbox
(``padding_and_resize``), the left/right flip with joint and MANO-pose
mirroring, random rescale and placement, the training augmentations
(``random_rotate``, ``color_jitter``, ``add_motion_blur`` with
``load_blur_kernels``) and the [-1, 1] normalizations. Where the JAX package
calls cv2, the port calls its own equivalents: ``image_io.resize_linear``
for ``cv2.resize`` and ``cv_ops`` for ``warpAffine``, the HSV conversions and
``filter2D`` (bit for bit, except filter2D's 1 on a few pixels in 10^5).
Every augmentation draws from the dataset's ``random.Random`` in the JAX
package's order: ``random_rotate`` one ``randint``, ``color_jitter`` four
``uniform``s (brightness, contrast, saturation, hue), ``add_motion_blur``
``random()`` and, when it blurs, ``choice``.
"""

from __future__ import annotations

import os
import os.path as osp
import random
from typing import List, Sequence

import numpy as np

from ihmr_tpu_torch.core import rotations as rot
from ihmr_tpu_torch.data import cv_ops
from ihmr_tpu_torch.data.image_io import resize_linear


def hand_type_str2array(hand_type: str) -> np.ndarray:
    if hand_type == "right":
        return np.array([1, 0], dtype=np.float32)
    if hand_type == "left":
        return np.array([0, 1], dtype=np.float32)
    if hand_type != "interacting":
        raise ValueError(f"hand_type {hand_type!r} not supported")
    return np.array([1, 1], dtype=np.float32)


def padding_and_resize(img: np.ndarray, joints_2d: np.ndarray, final_size: int = 224):
    """Letterbox to final_size, top-left anchored."""
    height, width = img.shape[:2]
    if height > width:
        ratio = final_size / height
        new_h, new_w = final_size, int(ratio * width)
    else:
        ratio = final_size / width
        new_h, new_w = int(ratio * height), final_size
    out = np.zeros((final_size, final_size, 3), dtype=np.uint8)
    out[:new_h, :new_w] = resize_linear(img, (new_w, new_h))
    joints_2d = joints_2d.copy()
    joints_2d[:, :2] *= ratio
    return out, joints_2d


def flip_hand_pose(pose: np.ndarray) -> np.ndarray:
    """Mirror a flat axis-angle pose across x=0: negate y and z of every 3-vector."""
    pose = np.asarray(pose)
    return (pose.reshape(-1, 3) * np.asarray([1.0, -1.0, -1.0], pose.dtype)).reshape(pose.shape)


def flip_sample(img, hand_type_array, joints_2d, joints_3d, mano_pose, mano_betas, mano_params_weight):
    """Mirror the image and swap the left/right annotations."""
    img_new = np.fliplr(img).copy()
    hand_type_new = np.flip(hand_type_array).copy()

    joints_2d_new = np.zeros((42, 3), dtype=np.float32)
    joints_2d_new[:21] = joints_2d[21:]
    joints_2d_new[21:] = joints_2d[:21]
    joints_2d_new[:, 0] = img.shape[1] - joints_2d_new[:, 0]

    joints_3d_new = np.zeros((42, 4), dtype=np.float32)
    joints_3d_new[:21] = joints_3d[21:]
    joints_3d_new[21:] = joints_3d[:21]
    joints_3d_new[:, 0] = -joints_3d_new[:, 0]

    pose_new = np.zeros(96, dtype=np.float32)
    pose_new[:48] = flip_hand_pose(mano_pose[48:])
    pose_new[48:] = flip_hand_pose(mano_pose[:48])
    betas_new = np.zeros(20, dtype=np.float32)
    betas_new[:10] = mano_betas[10:]
    betas_new[10:] = mano_betas[:10]
    weight_new = mano_params_weight[::-1].copy()
    return img_new, hand_type_new, joints_2d_new, joints_3d_new, pose_new, betas_new, weight_new


def random_rescale(
    img, joints_2d, rng: random.Random, final_size: int = 224,
    rescale_range=(0.6, 1.0), use_random_position: bool = False,
):
    """Shrink into a random sub-square; draws rng.random(), then (with
    ``use_random_position``) rng.randint for x, then for y."""
    min_s, max_s = rescale_range
    scale = rng.random() * (max_s - min_s) + min_s
    new_size = int(final_size * scale)
    out = np.zeros((final_size, final_size, 3), dtype=np.uint8)
    y_pos = x_pos = 0
    if use_random_position:
        end = final_size - new_size - 1
        x_pos = rng.randint(0, end)
        y_pos = rng.randint(0, end)
    out[y_pos: y_pos + new_size, x_pos: x_pos + new_size] = resize_linear(img, (new_size, new_size))
    joints_2d = joints_2d.copy()
    joints_2d[:, :2] *= scale
    joints_2d[:, 0] += x_pos
    joints_2d[:, 1] += y_pos
    return out, joints_2d


def rotate_image(image: np.ndarray, angle_deg: float) -> np.ndarray:
    """The image rotated by ``angle_deg`` (counter-clockwise) about its centre, same size."""
    center = tuple(np.array(image.shape[1::-1]) / 2)
    mat = cv_ops.get_rotation_matrix_2d(center, angle_deg, 1.0)
    return cv_ops.warp_affine_linear(image, mat, image.shape[1::-1])


def random_rotate(img, joints_2d, joints_3d, mano_pose, rng: random.Random, angle_range=(-90, 90),
                  num_slice: int = 10):
    """Rotate the image, the global orient and the 2D / 3D joints by one of
    ``num_slice`` angles in ``angle_range``; draws one rng.randint."""
    slice_id = rng.randint(0, num_slice - 1)
    angle = (angle_range[1] - angle_range[0]) / num_slice * slice_id + angle_range[0]

    img = rotate_image(img.copy(), angle)
    mano_pose = mano_pose.copy()
    mano_pose[:3] = rot.rotate_orient_z(mano_pose[:3], angle)

    origin = np.array([[img.shape[1] / 2, img.shape[0] / 2]])
    j2 = rot.rotate_joints_2d(joints_2d[:, :2], origin, angle)
    joints_2d = np.concatenate([j2, joints_2d[:, -1:]], axis=1).astype(np.float32)

    j3 = rot.rotate_joints_3d(joints_3d[:, :3], angle)
    joints_3d = np.concatenate([j3, joints_3d[:, -1:]], axis=1).astype(np.float32)
    return img, joints_2d, joints_3d, mano_pose


def color_jitter(img: np.ndarray, rng: random.Random, brightness=(0.9, 1.3), contrast=(0.8, 1.3),
                 saturation=(0.4, 1.6), hue=(-0.1, 0.1)) -> np.ndarray:
    """Brightness and contrast in float32, then saturation and hue in
    OpenCV's uint8 HSV, with uniform factors; the float32 steps are the JAX
    package's numpy ops in its order (the mean is numpy's pairwise float32
    sum and the casts truncate, so another order flips pixels)."""
    out = img.astype(np.float32)
    b = rng.uniform(*brightness)
    out = out * b
    c = rng.uniform(*contrast)
    mean = out.mean()
    out = (out - mean) * c + mean
    hsv = cv_ops.bgr_to_hsv(np.clip(out, 0, 255).astype(np.uint8)).astype(np.float32)
    s = rng.uniform(*saturation)
    hsv[..., 1] = np.clip(hsv[..., 1] * s, 0, 255)
    h = rng.uniform(*hue)
    hsv[..., 0] = (hsv[..., 0] + h * 180.0) % 180.0
    return cv_ops.hsv_to_bgr(hsv.astype(np.uint8))


def load_blur_kernels(blur_kernel_dir: str) -> List[np.ndarray]:
    """The point-spread functions of every ``.mat`` file in the directory, in
    name order: each file's ``PSFs`` cell array, first cell, as float32."""
    from scipy.io import loadmat

    kernels = []
    if blur_kernel_dir and osp.isdir(blur_kernel_dir):
        for name in sorted(os.listdir(blur_kernel_dir)):
            if name.endswith(".mat"):
                raw = loadmat(osp.join(blur_kernel_dir, name))["PSFs"][0][0]
                # MATLAB cell arrays come back as object arrays
                while isinstance(raw, np.ndarray) and raw.dtype == object and raw.size == 1:
                    raw = raw.item(0)
                if isinstance(raw, np.ndarray) and raw.dtype == object:
                    raw = np.asarray(raw.tolist(), np.float32)
                kernels.append(np.asarray(raw, np.float32))
    return kernels


def add_motion_blur(img: np.ndarray, kernels: Sequence[np.ndarray], rng: random.Random, prob: float = 0.5):
    """With probability ``prob``, the image filtered by a kernel chosen at
    random; draws rng.random() and, when it blurs, rng.choice."""
    if kernels and rng.random() < prob:
        return cv_ops.filter2d(img, rng.choice(list(kernels)))
    return img


def normalize_joints_2d(joints_2d: np.ndarray, final_size: int = 224) -> np.ndarray:
    """Pixel coordinates -> [-1, 1]."""
    out = joints_2d.copy()
    out[:, 0] = (joints_2d[:, 0] / final_size) * 2.0 - 1.0
    out[:, 1] = (joints_2d[:, 1] / final_size) * 2.0 - 1.0
    return out


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC in [-1, 1], channel order kept: the reference
    applies ToTensor + Normalize(.5, .5) to cv2's BGR array, and so trains
    and infers on BGR images."""
    x = img.astype(np.float32) / 255.0
    return (x - 0.5) / 0.5
