"""Host-side image and annotation preprocessing (port of ihmr_tpu/data/preprocess.py).

The part the datasets' main paths run: the handedness vector, the
top-left anchored letterbox (``padding_and_resize``), the left/right flip
with joint and MANO-pose mirroring, random rescale and placement, and the
[-1, 1] normalizations. Resizing is ``image_io.resize_linear``, which
computes what the JAX package's ``cv2.resize`` does, bit for bit.

Not ported yet: ``rotate_image`` / ``random_rotate``, ``color_jitter``,
``load_blur_kernels`` and ``add_motion_blur`` (cv2's ``warpAffine``, HSV
conversion and ``filter2D``); the CLI refuses the flags that select them.
"""

from __future__ import annotations

import random

import numpy as np

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
